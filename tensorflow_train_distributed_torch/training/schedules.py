"""Learning-rate schedules (counterpart of the JAX package's
``training/schedules.py``): plain ``step -> lr`` functions with optax's
semantics, evaluated on the host at the optimizer's update count.

- ``warmup_cosine``: linear warmup, then cosine decay (LLM convention).
- ``warmup_linear``: linear warmup, then linear decay to 0 (BERT).
- ``noam``: d_model^-0.5 · min(step^-0.5, step · warmup^-1.5).
- ``resnet_steps``: warmup, then 10x drops at fractional milestones.
- ``constant``: optionally warmed up.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""

    def fn(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return fn


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]
          ) -> Schedule:
    """optax.join_schedules: schedule i runs from boundary i-1, counted
    from that boundary."""

    def fn(count: int) -> float:
        i = bisect.bisect_right(boundaries, count)
        start = boundaries[i - 1] if i else 0
        return schedules[i](count - start)

    return fn


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""

    def fn(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)

    return fn


def constant(peak_lr: float, *, warmup_steps: int = 0, **_) -> Schedule:
    if warmup_steps <= 0:
        return lambda count: peak_lr
    return _join([_linear(0.0, peak_lr, warmup_steps),
                  lambda count: peak_lr], [warmup_steps])


def warmup_cosine(peak_lr: float, total_steps: int, *,
                  warmup_steps: int = 0, end_lr_ratio: float = 0.0,
                  **_) -> Schedule:
    """optax.warmup_cosine_decay_schedule from 0 to ``peak_lr``."""
    warmup = max(warmup_steps, 1)
    decay_steps = max(total_steps, warmup_steps + 1)
    end = peak_lr * end_lr_ratio
    alpha = end / peak_lr if peak_lr else 0.0
    return _join([_linear(0.0, peak_lr, warmup),
                  _cosine(peak_lr, decay_steps - warmup, alpha)], [warmup])


def warmup_linear(peak_lr: float, total_steps: int, *,
                  warmup_steps: int = 0, **_) -> Schedule:
    warmup = max(warmup_steps, 1)
    return _join([_linear(0.0, peak_lr, warmup),
                  _linear(peak_lr, 0.0, max(total_steps - warmup, 1))],
                 [warmup])


def noam(peak_lr: float, *, d_model: int = 1024, warmup_steps: int = 4000,
         **_) -> Schedule:
    """Transformer-big LR: ``peak_lr`` acts as a multiplier (1.0 = paper)."""
    warmup = max(warmup_steps, 1)

    def fn(count: int) -> float:
        s = count + 1.0
        return peak_lr * d_model ** -0.5 * min(s ** -0.5, s * warmup ** -1.5)

    return fn


def resnet_steps(peak_lr: float, total_steps: int, *,
                 warmup_steps: int = 0,
                 milestones: Sequence[float] = (0.33, 0.67, 0.89),
                 decay: float = 0.1, **_) -> Schedule:
    """Warmup then stepwise drops at fractions of the run
    (optax.piecewise_constant_schedule)."""
    bounds = sorted({max(int(m * total_steps), warmup_steps + 1): decay
                     for m in milestones}.items())

    def stepped(count: int) -> float:
        lr = peak_lr
        for b, scale in bounds:
            if count >= b:      # optax: a drop applies from its boundary on
                lr *= scale
        return lr

    if warmup_steps <= 0:
        return stepped
    return _join([_linear(0.0, peak_lr, warmup_steps),
                  lambda count: stepped(count + warmup_steps)],
                 [warmup_steps])


SCHEDULES = {
    "constant": constant,
    "warmup_cosine": warmup_cosine,
    "warmup_linear": warmup_linear,
    "noam": noam,
    "resnet_steps": resnet_steps,
}


def by_name(name: str, peak_lr: float, total_steps: int, *,
            warmup_steps: int = 0, **kwargs) -> Schedule:
    if name not in SCHEDULES:
        raise ValueError(
            f"Unknown schedule {name!r}; available: {sorted(SCHEDULES)}")
    return SCHEDULES[name](peak_lr, total_steps=total_steps,
                           warmup_steps=warmup_steps, **kwargs)
