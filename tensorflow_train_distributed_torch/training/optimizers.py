"""Optimizers with optax's semantics, over lists of tensors.

The JAX launcher builds its optimizer from optax (``launch.py``
``_make_optimizer``): sgd, Nesterov momentum, adam, adamw, lamb or
adafactor (optax's defaults), chained after ``clip_by_global_norm``.
This module writes those transformations out so that steps of each agree
with optax (``tests/test_torch_training.py`` pins it); ``torch.optim``
differs in details that show (its clip adds 1e-6 to the norm, its Adam
applies the bias corrections elsewhere).  ``inject_learning_rate`` keeps
the learning rate in the optimizer state, as ``optax.inject_hyperparams``
does, so a callback can lower it and a checkpoint carries it.

A transformation is ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, new_state)``, functional like optax; the caller adds
the updates to the params.  The update count that schedules read is a
host integer.
"""

from __future__ import annotations

import contextlib
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


# A sharded or expert-parallel step holds pieces of the gradients: the
# global norm then sums each piece's squares across the ranks that hold
# the other pieces (``parallel.state_plan``).  None: one rank holds all.
_NORM_REDUCER: Optional[Callable] = None


@contextlib.contextmanager
def norm_reducer(fn: Callable):
    """Within the block, ``global_norm(tensors)`` is ``fn(tensors)``."""
    global _NORM_REDUCER
    prev, _NORM_REDUCER = _NORM_REDUCER, fn
    try:
        yield
    finally:
        _NORM_REDUCER = prev


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm);
    None entries (frozen parameters' gradients) are left out."""
    if _NORM_REDUCER is not None:
        return _NORM_REDUCER(tensors)
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors
                          if t is not None))


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


def scale_by_learning_rate(lr: Union[float, Schedule], *,
                           flip_sign: bool = True
                           ) -> GradientTransformation:
    """optax.scale_by_learning_rate: multiply by ``-lr(count)`` (the
    count of updates so far; ``+lr`` without ``flip_sign``), rounded to
    the update's dtype."""
    sign = -1.0 if flip_sign else 1.0

    def update(grads, count, params=None):
        step = sign * (lr(count) if callable(lr) else lr)
        step32 = float(np.float32(step))
        return [g * step32 for g in grads], count + 1

    return GradientTransformation(lambda params: 0, update)


def scale(factor: float) -> GradientTransformation:
    """optax.scale: multiply every update by ``factor``."""

    def update(grads, state, params=None):
        return [g * factor for g in grads], state

    return GradientTransformation(lambda params: None, update)


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((t * t).sum())


def scale_by_trust_ratio() -> GradientTransformation:
    """optax.scale_by_trust_ratio (no minimum norm, no epsilon): each
    leaf's update times ``‖p‖ / ‖u‖``, or times 1 where either norm is
    0."""

    def update(grads, state, params=None):
        out = []
        for u, p in zip(grads, params):
            pn, un = _norm(p), _norm(u)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                pn / un)
            out.append(u * ratio)
        return out, state

    return GradientTransformation(lambda params: None, update)


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((t * t).mean())


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    """optax.clip_by_block_rms: each leaf divided by ``max(1, rms /
    threshold)``."""

    def update(grads, state, params=None):
        return [u / torch.clamp(_rms(u) / threshold, min=1.0)
                for u in grads], state

    return GradientTransformation(lambda params: None, update)


def scale_by_param_block_rms(min_scale: float = 1e-3
                             ) -> GradientTransformation:
    """optax.scale_by_param_block_rms: each leaf's update times
    ``max(rms(p), min_scale)``."""

    def update(grads, state, params=None):
        return [u * torch.clamp(_rms(p), min=min_scale)
                for u, p in zip(grads, params)], state

    return GradientTransformation(lambda params: None, update)


@dataclasses.dataclass
class FactoredState:
    """optax's ``FactoredState``: per leaf a row and a column statistic
    for a factored leaf, else the full second moment (the unused ones
    are 1-element zeros, as in optax)."""

    count: int
    v_row: list
    v_col: list
    v: list


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice: the two largest axes (second largest, largest),
    or None when the second largest is under the threshold."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def scale_by_factored_rms(decay_rate: float = 0.8,
                          min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30) -> GradientTransformation:
    """optax.scale_by_factored_rms (factored, no step offset): the
    gradient over the root of a decayed mean of its squares, the mean
    factored into row and column statistics on leaves with two axes of
    at least ``min_dim_size_to_factor``; decay ``1 - (count + 1) **
    -decay_rate`` in f32."""

    def init(params):
        def zeros(p, shape=(1,)):
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        rows, cols, vs = [], [], []
        for p in params:
            dims = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if dims is None:
                rows.append(zeros(p))
                cols.append(zeros(p))
                vs.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                rows.append(zeros(p, np.delete(p.shape, d0).tolist()))
                cols.append(zeros(p, np.delete(p.shape, d1).tolist()))
                vs.append(zeros(p))
        return FactoredState(0, rows, cols, vs)

    def update(grads, state, params=None):
        t = np.float32(state.count + 1)
        decay = np.float32(1) - t ** np.float32(-decay_rate)
        keep = float(np.float32(1) - decay)
        decay = float(decay)
        out, rows, cols, vs = [], [], [], []
        for g, vr, vc, v in zip(grads, state.v_row, state.v_col, state.v):
            dims = _factored_dims(tuple(g.shape), min_dim_size_to_factor)
            g2 = g * g + epsilon
            if dims is None:
                nv = decay * v + keep * g2
                out.append(g * torch.rsqrt(nv))
                rows.append(vr)
                cols.append(vc)
                vs.append(nv)
                continue
            d1, d0 = dims
            nr = decay * vr + keep * g2.mean(dim=d0)
            nc = decay * vc + keep * g2.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = torch.rsqrt(nr / nr.mean(dim=reduced_d1,
                                                  keepdim=True))
            col_factor = torch.rsqrt(nc)
            out.append(g * row_factor.unsqueeze(d0)
                       * col_factor.unsqueeze(d1))
            rows.append(nr)
            cols.append(nc)
            vs.append(v)
        return out, FactoredState(state.count + 1, rows, cols, vs)

    return GradientTransformation(init, update)


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


def lamb(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.0) -> GradientTransformation:
    """optax.lamb: adam's direction plus decoupled decay, scaled per
    leaf by the trust ratio ``‖p‖ / ‖u‖``."""
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_trust_ratio(), scale_by_learning_rate(lr))


def adafactor(lr, *, weight_decay_rate: Optional[float] = None
              ) -> GradientTransformation:
    """optax.adafactor at its defaults (factored second moments from 128
    wide axes, decay 0.8, block-RMS clip 1, updates scaled by the
    parameter's RMS, no momentum), with optional decoupled decay."""
    parts = [scale_by_factored_rms(), clip_by_block_rms(1.0),
             scale_by_learning_rate(lr, flip_sign=False),
             scale_by_param_block_rms()]
    if weight_decay_rate is not None:
        parts.append(add_decayed_weights(weight_decay_rate))
    return chain(*parts, scale(-1.0))


@dataclasses.dataclass
class InjectHyperparamsState:
    """``optax.inject_hyperparams``'s state: the update count, the
    injected hyperparameters (host f32 scalars) and the inner state."""

    count: int
    hyperparams: dict
    inner_state: Any


def inject_learning_rate(build: Callable[[float], GradientTransformation],
                         learning_rate: float) -> GradientTransformation:
    """``optax.inject_hyperparams(fn)(learning_rate=...)``: the learning
    rate lives in the state (``hyperparams["learning_rate"]``, a host f32
    scalar tensor) and ``build(lr)`` is the inner transformation each
    update runs with the current value."""

    def init(params):
        return InjectHyperparamsState(
            0, {"learning_rate": torch.tensor(learning_rate,
                                              dtype=torch.float32)},
            build(learning_rate).init(params))

    def update(grads, state, params=None):
        lr = float(state.hyperparams["learning_rate"])
        updates, inner = build(lr).update(grads, state.inner_state, params)
        return updates, dataclasses.replace(state, count=state.count + 1,
                                            inner_state=inner)

    return GradientTransformation(init, update)


def _walk_hyperparams(state, name: str, value=None):
    """(state with ``hyperparams[name]`` set to ``value`` where value is
    not None, the first current value or None, the count of states that
    carry it) over nested lists, tuples, dicts and dataclasses."""
    found, n = [], 0

    def rec(node):
        nonlocal n
        hp = getattr(node, "hyperparams", None)
        if isinstance(hp, dict) and name in hp:
            found.append(hp[name])
            n += 1
            if value is None:
                return node
            new = torch.tensor(value, dtype=hp[name].dtype)
            return dataclasses.replace(node, hyperparams={**hp, name: new})
        if isinstance(node, (list, tuple)):
            return type(node)(rec(x) for x in node)
        if isinstance(node, dict):
            return type(node)((k, rec(v)) for k, v in node.items())
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: rec(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        return node

    out = rec(state)
    return out, (found[0] if found else None), n


def get_injected_hyperparam(opt_state, name: str):
    """The first injected hyperparameter named ``name``, or None."""
    return _walk_hyperparams(opt_state, name)[1]


def set_injected_hyperparam(opt_state, name: str, value: float):
    """``(new_opt_state, n_set)``: every injected ``name`` set to
    ``value`` (the state is rebuilt, not mutated)."""
    out, _, n = _walk_hyperparams(opt_state, name, value)
    return out, n


OPTIMIZERS = ("sgd", "momentum", "adam", "adamw", "lamb", "adafactor")


def make_optimizer(name: str, lr, *, weight_decay: float = 0.0,
                   grad_clip_norm: Optional[float] = None,
                   inject_lr: bool = False,
                   ema_decay: Optional[float] = None
                   ) -> GradientTransformation:
    """The JAX launcher's optimizer (``launch.py`` ``_make_optimizer``):
    ``lr`` a float or a schedule; ``inject_lr`` keeps a float ``lr`` in
    the state (``inject_learning_rate``, for ReduceLROnPlateau); a
    positive ``grad_clip_norm`` chains ``clip_by_global_norm`` first
    (0/None disable it); ``ema_decay`` appends the parameter EMA last
    (``training.ema.wrap_with_ema``)."""
    # optax.inject_hyperparams holds every numeric hyperparameter as an
    # f32 array, so e.g. adam's ``1 - b1`` is taken in f32 there: under
    # ``inject_lr`` the builders get the f32-rounded values, which gives
    # the same numbers.
    hp = (lambda x: float(np.float32(x))) if inject_lr else (lambda x: x)
    adam_kw = dict(b1=hp(0.9), b2=hp(0.999), eps=hp(1e-8))
    if name == "sgd":
        build = sgd
    elif name == "momentum":
        def build(r):
            return sgd(r, momentum=hp(0.9), nesterov=True)
    elif name == "adam":
        def build(r):
            return adam(r, **adam_kw)
    elif name == "adamw":
        def build(r):
            return adamw(r, weight_decay=hp(weight_decay), **adam_kw)
    elif name == "lamb":
        def build(r):
            return lamb(r, b1=hp(0.9), b2=hp(0.999), eps=hp(1e-6),
                        weight_decay=hp(weight_decay))
    elif name == "adafactor":
        def build(r):
            return adafactor(r, weight_decay_rate=(
                hp(weight_decay) if weight_decay else None))
    else:
        raise ValueError(f"unknown optimizer {name!r}; one of {OPTIMIZERS}")
    if inject_lr:
        if callable(lr):
            raise ValueError("an injected learning rate is a constant, "
                             "not a schedule")
        tx = inject_learning_rate(build, lr)
    else:
        tx = build(lr)
    if grad_clip_norm is not None and (grad_clip_norm < 0
                                       or math.isnan(grad_clip_norm)):
        raise ValueError(f"grad_clip_norm must be >= 0 (0 disables), got "
                         f"{grad_clip_norm}")
    if grad_clip_norm:
        tx = chain(clip_by_global_norm(grad_clip_norm), tx)
    if ema_decay is not None:
        from tensorflow_train_distributed_torch.training.ema import (
            wrap_with_ema,
        )

        tx = wrap_with_ema(tx, ema_decay)
    return tx
