"""Optimizers with optax's semantics, over lists of tensors.

The JAX launcher builds its optimizer from optax (``launch.py``
``_make_optimizer``): sgd, Nesterov momentum, adam or adamw, chained after
``clip_by_global_norm``.  This module writes those transformations out so
that one step of each agrees with optax (``tests/test_torch_training.py``
pins it); ``torch.optim`` differs in details that show (its clip adds
1e-6 to the norm, its Adam applies the bias corrections elsewhere).

A transformation is ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, new_state)``, functional like optax; the caller adds
the updates to the params.  The update count that schedules read is a
host integer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from tensorflow_train_distributed_torch.training.schedules import Schedule


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[list], Any]
    update: Callable[[list, Any, Optional[list]], tuple]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: scale by ``max_norm / ‖g‖`` only when
    ``‖g‖ >= max_norm`` (no epsilon)."""

    def update(grads, state, params=None):
        norm = global_norm(grads)
        trigger = norm < max_norm
        return [torch.where(trigger, g, g / norm.to(g.dtype) * max_norm)
                for g in grads], state

    return GradientTransformation(lambda params: None, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax.trace (momentum): t = g + decay * t; the update is t, or
    g + decay * t for Nesterov."""

    def init(params):
        return [torch.zeros_like(p) for p in params]

    def update(grads, state, params=None):
        new = [g + decay * t for g, t in zip(grads, state)]
        out = ([g + decay * t for g, t in zip(grads, new)] if nesterov
               else new)
        return out, new

    return GradientTransformation(init, update)


@dataclasses.dataclass
class AdamState:
    count: int
    mu: list
    nu: list


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """optax.scale_by_adam: moments ``(1 - b) * g^k + b * m``, bias
    corrections ``1 - b ** count`` in f32, ``m / (sqrt(v + eps_root) +
    eps)``."""

    def init(params):
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(grads, state, params=None):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        out = [(m / bc1) / (torch.sqrt(v / bc2 + eps_root) + eps)
               for m, v in zip(mu, nu)]
        return out, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """optax.add_decayed_weights: u + weight_decay * p."""

    def update(grads, state, params=None):
        if not weight_decay:
            return grads, state
        return [g + weight_decay * p for g, p in zip(grads, params)], state

    return GradientTransformation(lambda params: None, update)


def scale_by_learning_rate(lr: Union[float, Schedule]
                           ) -> GradientTransformation:
    """optax.scale_by_learning_rate: multiply by ``-lr(count)`` (the
    count of updates so far), rounded to the update's dtype."""

    def update(grads, count, params=None):
        step = -(lr(count) if callable(lr) else lr)
        step32 = float(np.float32(step))
        return [g * step32 for g in grads], count + 1

    return GradientTransformation(lambda params: 0, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [tx.init(params) for tx in txs]

    def update(grads, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            new_state.append(s)
        return grads, new_state

    return GradientTransformation(init, update)


def sgd(lr, *, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    parts = [] if momentum is None else [trace(momentum, nesterov)]
    return chain(*parts, scale_by_learning_rate(lr))


def adam(lr, *, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr))


def adamw(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(lr))


OPTIMIZERS = ("sgd", "momentum", "adam", "adamw")


def make_optimizer(name: str, lr, *, weight_decay: float = 0.0,
                   grad_clip_norm: Optional[float] = None
                   ) -> GradientTransformation:
    """The JAX launcher's optimizer (``launch.py`` ``_make_optimizer``):
    ``lr`` a float or a schedule; a positive ``grad_clip_norm`` chains
    ``clip_by_global_norm`` first (0/None disable it)."""
    if name == "sgd":
        tx = sgd(lr)
    elif name == "momentum":
        tx = sgd(lr, momentum=0.9, nesterov=True)
    elif name == "adam":
        tx = adam(lr)
    elif name == "adamw":
        tx = adamw(lr, weight_decay=weight_decay)
    else:
        raise ValueError(f"optimizer {name!r} is not ported; one of "
                         f"{OPTIMIZERS} (lamb and adafactor come later)")
    if grad_clip_norm is not None and (grad_clip_norm < 0
                                       or math.isnan(grad_clip_norm)):
        raise ValueError(f"grad_clip_norm must be >= 0 (0 disables), got "
                         f"{grad_clip_norm}")
    if grad_clip_norm:
        tx = chain(clip_by_global_norm(grad_clip_norm), tx)
    return tx
