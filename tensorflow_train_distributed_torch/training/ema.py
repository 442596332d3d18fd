"""Exponential moving average of the parameters (Polyak averaging; the
counterpart of the JAX package's ``training/ema.py``).

The average lives in the optimizer state, as a transformation chained
LAST: it is the identity on the updates and keeps ``ema_t = decay ·
ema_{t-1} + (1 - decay) · params_t`` of the post-update parameters, with
``ema_0 = params_0``.  Being optimizer state, the checkpoint carries it;
evaluation reads it through ``swap_ema_params`` (the launcher's
``--ema-decay``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tensorflow_train_distributed_torch.training.optimizers import (
    GradientTransformation,
    chain,
)


@dataclasses.dataclass
class EmaParamsState:
    """The averages (one tensor per parameter, in the parameters' order)
    and the count of updates applied (informational)."""

    ema: list
    count: int


def ema_of_params(decay: float = 0.999) -> GradientTransformation:
    """Identity on the updates; keeps the EMA of the post-update
    parameters ``params + updates`` in its state.  Must run last in the
    chain (``wrap_with_ema`` places it there)."""
    if not 0.0 < decay < 1.0:
        raise ValueError(f"decay must be in (0, 1), got {decay}")

    def init(params):
        return EmaParamsState([p.detach().clone() for p in params], 0)

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("ema_of_params needs params")
        ema = [decay * e + (1.0 - decay) * (p.detach() + u).to(e.dtype)
               for e, p, u in zip(state.ema, params, updates)]
        return updates, EmaParamsState(ema, state.count + 1)

    return GradientTransformation(init, update)


def wrap_with_ema(tx: GradientTransformation,
                  decay: float = 0.999) -> GradientTransformation:
    """``chain(tx, ema_of_params(decay))``: the tracker last, so it
    averages the true post-update parameters."""
    return chain(tx, ema_of_params(decay))


def find_ema_params(opt_state) -> Optional[list]:
    """The first ``EmaParamsState``'s averages in a (nested) optimizer
    state, or None."""
    if isinstance(opt_state, EmaParamsState):
        return opt_state.ema
    if isinstance(opt_state, dict):
        children = opt_state.values()
    elif isinstance(opt_state, (list, tuple)):
        children = opt_state
    elif (dataclasses.is_dataclass(opt_state)
          and not isinstance(opt_state, type)):
        children = [getattr(opt_state, f.name)
                    for f in dataclasses.fields(opt_state)]
    else:
        return None
    for child in children:
        got = find_ema_params(child)
        if got is not None:
            return got
    return None


def swap_ema_params(state):
    """A read-only view of a ``TrainState`` whose params are the EMA (for
    evaluate / predict); training continues from the original state."""
    ema = find_ema_params(state.opt_state)
    if ema is None:
        raise ValueError(
            "no EmaParamsState in opt_state — build the optimizer with "
            "wrap_with_ema(tx, decay) (CLI: --ema-decay)")
    return state.replace(params=dict(zip(state.params, ema)))
