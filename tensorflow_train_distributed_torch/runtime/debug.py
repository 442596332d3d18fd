"""Numerics debug mode: NaN traps at the op and at the hand-written kernel
that produced them, and deterministic algorithms (the JAX package's
``runtime/debug.py``).

The JAX package traps NaNs with ``jax_debug_nans`` (a jitted computation
that produced one is re-run op by op and the culprit raises
``FloatingPointError``) and turns XLA's reordering and fusion off with
``jax_disable_most_optimizations``.  Eager PyTorch runs op by op
already, so the trap sits at each op as it returns:

- **aten ops**, forward and backward, through a ``TorchDispatchMode``:
  an op whose floating outputs hold a non-finite value while none of its
  floating inputs (tensors and Python floats) did (it produced the value,
  as an IEEE invalid or overflow trap would fire) raises
  ``FloatingPointError`` naming the op, and, in the backward, the autograd
  node it ran for.  An op that only
  carries a non-finite input along is not named: the input's producer
  was checked before it;
- **the hand-written kernels** (``ops/kernels.py``): they are ``ctypes``
  calls inside ``torch.autograd.Function``s, which no dispatch mode sees,
  so a NaN a kernel wrote would be blamed on the next aten op.  Every
  launch passes through ``kernels._count``, which under debug mode hands
  the launch's inputs and outputs to ``trap_launch`` (``kernels.NAN_TRAP``),
  which raises naming the kernel
  (``flash_attention``, ``rms_norm_bwd``, ...): "received" for a
  non-finite input, "wrote" for a non-finite output from finite inputs.
  Values that enter the step from outside it (a poisoned parameter, a
  batch) are produced by no op, so the first kernel they reach names
  them; ``assert_tree_finite`` then names the leaf.  The training
  kernels are checked (K1f/K1b, K2 and K7 forward and backward, K3f/K3b);
  the serving kernels (K4, K5) and the grouped matmuls (K6), whose
  buffers hold rows no lane or group owns, are counted but not checked;
- **the backward's autograd nodes**, through
  ``torch.autograd.set_detect_anomaly(True, check_nan=True)``: a node
  that returns NaN raises (its ``RuntimeError`` re-raised as
  ``FloatingPointError``) with the forward's traceback.

Each check reads a value on the host, so a step under ``nan_checks`` is
slow (``chip_smoke.py`` phase 29 measures how slow), but it computes the
same values: outside the context nothing is changed, and inside it every
op runs as it would without it, bit for bit.
"""

from __future__ import annotations

import contextlib
import math
import os
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_CUBLAS_ENV = "CUBLAS_WORKSPACE_CONFIG"
#: The workspace setting cuBLAS needs for deterministic results
#: (``torch.use_deterministic_algorithms``' documentation).
_CUBLAS_DETERMINISTIC = ":4096:8"

_aten = torch.ops.aten
#: Ops whose outputs are uninitialised memory by contract: a NaN there is
#: no op's doing (a kernel's output buffer before its launch).
_UNINITIALISED = {
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.resize_.default,
}


def _float_tensors(tree) -> list:
    """The strided floating tensors of ``tree`` that hold data (meta and
    fake tensors hold none)."""
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.layout == torch.strided and t.device.type != "meta"
            and t.numel() > 0]


def nonfinite_count(t: torch.Tensor) -> int:
    """Non-finite elements of a floating tensor (a host read)."""
    return int((~torch.isfinite(t)).sum().item())


def _all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all().item()) for t in tensors)


def _inputs_finite(args, kwargs) -> bool:
    """Every floating tensor and Python float an op was given is finite (a
    fill of -inf the caller asked for is carried along, not produced)."""
    leaves = tree_flatten((args, kwargs))[0]
    return (all(math.isfinite(v) for v in leaves if isinstance(v, float))
            and _all_finite(_float_tensors(leaves)))


def _where() -> str:
    """The autograd node the backward is running, if any."""
    current = getattr(torch._C, "_current_autograd_node", None)
    node = current() if current is not None else None
    return "" if node is None else f" in the backward of {node.name()}"


class _NanTrap(TorchDispatchMode):
    """Raises at the aten op that produced a non-finite value."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        mutable = func._schema.is_mutable
        before = _inputs_finite(args, kwargs) if mutable else None
        out = func(*args, **kwargs)
        if func in _UNINITIALISED or func.is_view:
            return out
        outs = _float_tensors(out)
        if not outs or _all_finite(outs):
            return out
        if before is None:
            before = _inputs_finite(args, kwargs)
        if before:
            bad = [(i, t) for i, t in enumerate(outs)
                   if nonfinite_count(t) > 0]
            i, t = bad[0]
            raise FloatingPointError(
                f"debug_mode: {func} produced {nonfinite_count(t)} "
                f"non-finite values in output {i} {tuple(t.shape)} "
                f"{t.dtype} from finite inputs{_where()}")
        return out


def trap_launch(name: str, inputs, outputs) -> None:
    """The kernel-side trap (``ops.kernels.NAN_TRAP`` under debug mode:
    ``_count`` calls it at every launch): raises ``FloatingPointError``
    naming kernel ``name`` when one of its floating ``inputs`` or
    ``outputs`` holds a non-finite value."""
    for i, t in enumerate(_float_tensors(list(inputs))):
        n = nonfinite_count(t)
        if n:
            raise FloatingPointError(
                f"debug_mode: the {name} kernel received {n} non-finite "
                f"values in input {i} {tuple(t.shape)} {t.dtype}{_where()}")
    for i, t in enumerate(_float_tensors(list(outputs))):
        n = nonfinite_count(t)
        if n:
            raise FloatingPointError(
                f"debug_mode: the {name} kernel wrote {n} non-finite "
                f"values to output {i} {tuple(t.shape)} {t.dtype} from "
                f"finite inputs{_where()}")


@contextlib.contextmanager
def debug_mode(*, nan_checks: bool = True,
               disable_optimizations: bool = False):
    """Context manager turning the traps on, restoring every setting on
    exit (after an exception too).

    ``nan_checks`` raises ``FloatingPointError`` at the aten op or the
    hand-written kernel that produced a non-finite value, forward and
    backward (the module docstring); expect a large slowdown.
    ``disable_optimizations`` turns on ``torch.use_deterministic_algorithms
    (True)`` with the cuBLAS workspace setting it needs
    (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set where unset): the nearest
    eager counterpart of XLA's ``jax_disable_most_optimizations``, which
    keeps op boundaries where the source put them (eager PyTorch fuses
    nothing), so what it changes is the choice of nondeterministic
    library algorithms.  cuBLAS reads the workspace setting when it makes
    a handle's workspace, and PyTorch keeps that workspace for the
    process: the variable must be in the environment before the
    process's first CUDA matmul.  Set here, after CUDA is initialised, it
    only satisfies PyTorch's determinism check and the workspace already
    made stays (cuBLAS's results are then repeatable on one stream, its
    documentation's condition, not across streams); that case warns.
    """
    from tensorflow_train_distributed_torch.ops import kernels as K

    saved_anomaly = (torch.is_anomaly_enabled(),
                     torch.is_anomaly_check_nan_enabled())
    saved_trap = K.NAN_TRAP
    saved_det = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    saved_env = os.environ.get(_CUBLAS_ENV)
    with contextlib.ExitStack() as stack:
        try:
            if nan_checks:
                torch.autograd.set_detect_anomaly(True, check_nan=True)
                K.NAN_TRAP = trap_launch
                stack.enter_context(_NanTrap())
            if disable_optimizations:
                if saved_env is None:
                    if torch.cuda.is_initialized():
                        warnings.warn(
                            f"debug_mode(disable_optimizations=True): "
                            f"{_CUBLAS_ENV} was unset when CUDA was "
                            f"initialised; cuBLAS keeps the workspace it "
                            f"made, so results are repeatable on one stream "
                            f"only.  Set {_CUBLAS_ENV}="
                            f"{_CUBLAS_DETERMINISTIC} before the process "
                            f"starts.", RuntimeWarning, stacklevel=3)
                    os.environ[_CUBLAS_ENV] = _CUBLAS_DETERMINISTIC
                torch.use_deterministic_algorithms(True)
            try:
                yield
            except RuntimeError as e:
                # Anomaly mode's NaN check raises RuntimeError ("Function
                # 'XBackward0' returned nan values ..."); the trap's type is
                # FloatingPointError, as JAX's.
                if nan_checks and "returned nan values" in str(e):
                    raise FloatingPointError(f"debug_mode: {e}") from e
                raise
        finally:
            K.NAN_TRAP = saved_trap
            torch.autograd.set_detect_anomaly(saved_anomaly[0],
                                              check_nan=saved_anomaly[1])
            torch.use_deterministic_algorithms(saved_det[0],
                                               warn_only=saved_det[1])
            if saved_env is None:
                os.environ.pop(_CUBLAS_ENV, None)
            else:
                os.environ[_CUBLAS_ENV] = saved_env


def _leaves(tree, prefix: str = ""):
    """``(path, tensor)`` for every tensor of ``tree``: a module's
    ``state_dict`` paths, a mapping's keys joined by dots, a sequence's
    indices."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict(keep_vars=True)
    if isinstance(tree, torch.Tensor):
        yield prefix or "<tensor>", tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}" if prefix else str(i))


def assert_tree_finite(tree, name: str = "tree") -> None:
    """Host-side finiteness check over a module's ``state_dict`` or a
    nested dict / list of tensors (params, grads, metrics).

    Raises ``FloatingPointError`` naming every offending leaf by its path,
    with its count of non-finite values (the JAX message's format): the
    post-hoc complement to ``debug_mode``'s in-flight trap, cheap enough
    for a checkpoint boundary.
    """
    bad = []
    for path, leaf in _leaves(tree):
        t = leaf.detach()
        if not t.is_floating_point() or t.device.type == "meta":
            continue
        n_bad = nonfinite_count(t)
        if n_bad:
            bad.append(f"{path}: {n_bad}/{t.numel()} non-finite")
    if bad:
        raise FloatingPointError(
            f"{name} has non-finite values:\n  " + "\n  ".join(bad))


def is_finite_scalar(value) -> bool:
    """True for finite floats/ints; False for NaN/inf (metric guard)."""
    try:
        return math.isfinite(float(value))
    except (TypeError, ValueError):
        return True
