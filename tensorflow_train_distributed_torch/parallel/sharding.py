"""Logical-axis sharding rules (counterpart of the JAX package's
``parallel/sharding.py``).

The JAX package annotates every parameter with logical axis names and
maps them onto mesh axes with one rules table; GSPMD does the rest.  The
port keeps the table (``DEFAULT_RULES``) and the names: its parameters
keep flax's names and layouts (``convert.py``), so ``logical_axes``
reads a parameter's logical axes off its name (``PARAM_AXES``, the
annotations of the JAX layers: ``tests/test_torch_mesh.py`` holds them
against ``nn.get_partition_spec``).  A parameter no pattern names is
replicated, as a JAX leaf without metadata is.

A spec is a tuple with one entry per dim: None (replicated) or the tuple
of mesh axes the dim is split over, major first (the JAX
``PartitionSpec``).  ``placements`` turns one into DTensor placements,
``Shard(dim)``/``Replicate()`` on each mesh dim.  ``shard``/``gather``
cut a full tensor to this rank's piece and put the pieces back together
(``runtime.mesh.Mesh`` groups).

How the trainer uses a spec (``training/trainer.py``): the ``expert``
axis shards the compute (an MoE block holds only its experts' stacks);
every other axis shards storage — the optimizer state and the update of
a parameter live on its piece alone, and the updated pieces are
gathered back.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Any, Optional, Sequence

import numpy as np
import torch

from tensorflow_train_distributed_torch.parallel import collectives as C
from tensorflow_train_distributed_torch.runtime.mesh import AXES, batch_axes

logger = logging.getLogger(__name__)

LogicalRules = Sequence[tuple[str, Any]]

DEFAULT_RULES: LogicalRules = (
    ("batch", ("data", "fsdp")),
    ("length", "seq"),
    ("embed", "fsdp"),
    ("heads", "tensor"),
    ("kv", None),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("expert", "expert"),
    ("conv_kernel", None),
    ("conv_in", None),
    ("conv_out", "tensor"),
    ("stage", "pipeline"),
    ("norm", None),
)

# (pattern on the port's parameter name, logical axes): the JAX layers'
# ``with_logical_partitioning`` annotations of the decoder families.
PARAM_AXES = (
    (r"(^|\.)token_embed\.embedding$", ("vocab", "embed")),
    (r"(^|\.)lm_head\.kernel$", ("embed", "vocab")),
    (r"\.attention\.(query|key|value|qkv)\.kernel$", ("embed", "heads")),
    (r"\.attention\.out\.kernel$", ("heads", "embed")),
    (r"\.(mlp|shared_mlp)\.(wi_gate|wi_up|wi)\.kernel$", ("embed", "mlp")),
    (r"\.(mlp|shared_mlp)\.wo\.kernel$", ("mlp", "embed")),
    (r"\.moe\.experts\.(wi_gate|wi_up)\.kernel$",
     ("expert", "embed", "mlp")),
    (r"\.moe\.experts\.wo\.kernel$", ("expert", "mlp", "embed")),
    (r"\.moe\.router\.kernel$", ("embed", "expert")),
    (r"\.moe\.shared_gate\.kernel$", ("embed", None)),
    (r"(norm|_norm)\.scale$", ("norm",)),
)


def logical_axes(name: str, ndim: int) -> Optional[tuple]:
    """The logical axes of parameter ``name`` (None: no annotation)."""
    for pattern, axes in PARAM_AXES:
        if re.search(pattern, name) and len(axes) == ndim:
            return axes
    return None


def _rules_for_mesh(mesh, rules: LogicalRules) -> dict:
    """logical name -> tuple of mesh axes of size > 1 (or None)."""
    out = {}
    for logical, target in rules:
        if target is None:
            out[logical] = None
            continue
        axes = (target,) if isinstance(target, str) else tuple(target)
        axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
        out[logical] = axes or None
    return out


def logical_spec(mesh, axes: Sequence[Optional[str]],
                 rules: LogicalRules = DEFAULT_RULES) -> tuple:
    """The spec of an array with these logical axes (a mesh axis splits
    one dim only: the first that asks for it)."""
    table = _rules_for_mesh(mesh, rules)
    used: set = set()
    dims = []
    for a in axes:
        target = table.get(a) if a is not None else None
        if target is None:
            dims.append(None)
            continue
        target = tuple(x for x in target if x not in used)
        used.update(target)
        dims.append(target or None)
    return tuple(dims)


def _fit(mesh, shape, spec) -> tuple:
    """Keep, per dim, the longest prefix of its mesh axes whose product
    divides the dim (a dim that does not split stays replicated)."""
    dims = []
    for size, assigned in zip(shape, spec):
        if assigned is None:
            dims.append(None)
            continue
        kept, prod = [], 1
        for a in assigned:
            if size % (prod * mesh.shape[a]):
                break
            kept.append(a)
            prod *= mesh.shape[a]
        if len(kept) != len(assigned):
            logger.warning(
                "sharding downgrade: dim of size %d cannot shard over "
                "mesh axes %s (sizes %s); keeping %s", size, assigned,
                [mesh.shape[a] for a in assigned], kept or "none")
        dims.append(tuple(kept) or None)
    return tuple(dims)


def make_state_shardings(mesh, params: dict,
                         rules: LogicalRules = DEFAULT_RULES) -> dict:
    """``{name: spec}`` for the parameters ``{name: tensor or shape}``:
    each parameter's logical axes through the rules, fitted to its shape;
    a parameter without logical axes is replicated."""
    out = {}
    for name, p in params.items():
        shape = tuple(getattr(p, "shape", p))
        axes = logical_axes(name, len(shape))
        spec = ((None,) * len(shape) if axes is None
                else _fit(mesh, shape, logical_spec(mesh, axes, rules)))
        out[name] = spec
    return out


def placements(mesh, spec: tuple) -> list:
    """DTensor placements of a spec over the mesh's six named dims:
    ``Shard(d)`` on each mesh dim that splits tensor dim d, else
    ``Replicate()`` (the ``Layout`` of the reference's DTensor)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in AXES]
    for d, axes in enumerate(spec):
        for a in axes or ():
            out[AXES.index(a)] = Shard(d)
    return out


def _data_shard(mesh, shape, spec) -> tuple:
    """Split the largest data-divisible unsplit dim of a rank>=2 leaf over
    ``data`` (the ZeRO family's mechanics); other leaves unchanged."""
    n = mesh.shape["data"]
    if len(shape) < 2:
        return spec
    used = {a for entry in spec if entry for a in entry}
    if "data" in used:
        return spec
    best = None
    for i, (size, assigned) in enumerate(zip(shape, spec)):
        if assigned is None and size % n == 0 and size >= n:
            if best is None or size > shape[best]:
                best = i
    if best is None:
        return spec
    return spec[:best] + (("data",),) + spec[best + 1:]


def zero1_opt_shardings(mesh, params: dict, specs: dict) -> dict:
    """ZeRO-1: the optimizer moments of each rank>=2 parameter split over
    ``data`` on its largest data-divisible unsplit dim (a documented
    no-op on a data=1 mesh)."""
    if mesh.shape.get("data", 1) <= 1:
        return dict(specs)
    return {k: _data_shard(mesh, tuple(getattr(params[k], "shape",
                                               params[k])), s)
            for k, s in specs.items()}


def cross_replica_update_shardings(mesh, params: dict, specs: dict) -> dict:
    """The cross-replica sharded weight update (arxiv 2004.13336): the
    spec a parameter's gradient and new value carry DURING the optimizer
    apply, ZeRO-1's moment split extended to the update computation."""
    return zero1_opt_shardings(mesh, params, specs)


def fold_leading_replicas(arr, w_new: int):
    """Refold a per-replica leading dim from ``W_old`` rows to ``w_new``,
    preserving the row-sum (the elastic restore of the error-feedback
    residual): ``W_old == k·w_new`` sums groups of k adjacent rows;
    ``w_new == k·W_old`` keeps the old rows and zeros the new; otherwise
    the whole total lands on row 0.  numpy or torch in, the same out."""
    is_torch = isinstance(arr, torch.Tensor)
    a = arr.detach().cpu().numpy() if is_torch else np.asarray(arr)
    w_old = a.shape[0]
    if w_old == w_new:
        out = a
    elif w_new < 1:
        raise ValueError(f"w_new must be >= 1, got {w_new}")
    else:
        tail = a.shape[1:]
        if w_old % w_new == 0:
            out = a.reshape((w_new, w_old // w_new) + tail).sum(axis=1)
        else:
            out = np.zeros((w_new,) + tail, a.dtype)
            if w_new % w_old == 0:
                out[:w_old] = a
            else:
                logger.warning(
                    "fold_leading_replicas: %d -> %d rows do not divide; "
                    "folding the whole residual into row 0 (sum-preserving "
                    "degrade)", w_old, w_new)
                out[0] = a.sum(axis=0)
    if is_torch:
        return torch.from_numpy(np.ascontiguousarray(out)).to(arr.device)
    return out


def shard_batch_spec(mesh) -> tuple:
    """The spec of host batches: the leading dim over the batch axes."""
    return (batch_axes(mesh),)


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's rows of a global batch: the leading dim split into
    contiguous blocks over the batch axes (data major), as the JAX
    package places a batch on its devices; ranks that differ only along
    tensor or expert get the same rows."""
    axes = batch_axes(mesh)
    n, i = mesh.group_size(axes), mesh.index(axes)
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split over "
                             f"{n} batch ranks")
        out[k] = v[i * rows // n:(i + 1) * rows // n]
    return out


def storage_axes(spec: tuple) -> tuple:
    """The spec without ``expert``: what shards storage, not compute."""
    out = []
    for entry in spec:
        kept = tuple(a for a in (entry or ()) if a != "expert")
        out.append(kept or None)
    return tuple(out)


def shard(mesh, spec: tuple, x: torch.Tensor) -> torch.Tensor:
    """This rank's piece of the full ``x`` under ``spec`` (a view)."""
    for d, axes in enumerate(spec):
        if axes:
            n = mesh.group_size(axes)
            if n > 1:
                x = x.chunk(n, dim=d)[mesh.index(axes)]
    return x


def gather(mesh, spec: tuple, x: torch.Tensor) -> torch.Tensor:
    """The full tensor from every rank's piece under ``spec``."""
    for d in reversed(range(len(spec))):
        axes = spec[d]
        if axes and mesh.group_size(axes) > 1:
            x = C.all_gather(x, mesh.group(axes), gather_dim=d)
    return x


def spec_groups(mesh, spec: tuple) -> tuple:
    """The mesh axes a spec splits over, in ``AXES`` order."""
    used = {a for entry in spec if entry for a in entry}
    return tuple(a for a in AXES if a in used and mesh.shape[a] > 1)


def num_pieces(mesh, spec: tuple) -> int:
    return math.prod(mesh.group_size(a) for a in spec_groups(mesh, spec))
