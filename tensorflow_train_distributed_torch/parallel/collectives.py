"""Named collectives over process groups (counterpart of the JAX
package's ``parallel/collectives.py``), over c10d.

The JAX functions run per shard inside ``shard_map`` and name a mesh
axis; these run per rank and take the group of that axis
(``runtime.mesh.Mesh.group(axis)``).  A group of None is a group of one
rank: every collective over it is the identity, returns its input's
value unchanged and calls nothing, so a one-rank run computes bit for bit
what a run without groups computes.

The quantized-gradient section is the JAX package's EQuARX recipe, bit
for bit: ``Q8_BLOCK`` blocks, per-block f32 scale = amax/127 with a
fallback to 1, symmetric round-half-to-even int8.  ``_q8_sum`` is its
reduce-scatter (an int8 ``all_to_all``, an exact f32 sum of the
dequantized rows) and all-gather (the owner re-quantizes its chunk once),
and ``ef_grad_sync``/``ef_bucket_sync`` carry each rank's quantization
error as an error-feedback residual.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# Elements per quantization block: the native ring's, one recipe (the
# JAX package reads its ``native.ringcoll.Q8_BLOCK`` likewise).
from tensorflow_train_distributed_torch.native.ringcoll import (
    Q8_BLOCK,
)

#: Leaves smaller than this stay on the exact f32 path.
DEFAULT_MIN_QUANT_ELEMS = 512

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# --- per-rank collectives ---------------------------------------------------


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` across ``group`` (sum, mean, max or min); a new
    tensor, ``x`` untouched."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"Unsupported reduce op: {op!r}")
    if group is None:
        return x.clone()
    out = x.clone()
    dist.all_reduce(out, op=_OPS["sum" if op == "mean" else op], group=group)
    if op == "mean":
        out = out / group_size(group)
    return out


def all_gather(x: torch.Tensor, group, *, gather_dim: int = 0
               ) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``gather_dim`` in rank order."""
    if group is None:
        return x.clone()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=gather_dim)


def reduce_scatter(x: torch.Tensor, group, *, scatter_dim: int = 0
                   ) -> torch.Tensor:
    """Sum across ``group`` and keep this rank's chunk of
    ``scatter_dim`` (equal chunks)."""
    if group is None:
        return x.clone()
    n = group_size(group)
    xs = x.movedim(scatter_dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_dim} of size "
                         f"{xs.shape[0]} does not split over {n} ranks")
    out = torch.empty((xs.shape[0] // n,) + xs.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, scatter_dim)


def all_to_all(x: torch.Tensor, group, *, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Chunk j of ``split_dim`` goes to rank j; the chunks received are
    concatenated along ``concat_dim`` in rank order (tiled).
    Differentiable: the backward sends the cotangent back with the two
    dims swapped."""
    if group is None:
        return x.clone()
    if _wants_grad(x):
        return _AllToAll.apply(x, group, split_dim, concat_dim)
    return _all_to_all(x, group, split_dim, concat_dim)


def _all_to_all(x, group, split_dim, concat_dim):
    n = group_size(group)
    chunks = [c.contiguous() for c in x.chunk(n, dim=split_dim)]
    if len(chunks) != n or any(c.shape != chunks[0].shape for c in chunks):
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over {n}")
    send = torch.stack(chunks)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


def ring_permute(x: torch.Tensor, group, *, shift: int = 1) -> torch.Tensor:
    """Rotate ``x`` around the group's ring: rank i sends to
    i + shift and receives from i - shift.  Differentiable: the backward
    rotates the cotangent by ``-shift``."""
    if group is None:
        return x.clone()
    if _wants_grad(x):
        return _RingPermute.apply(x, group, shift)
    return _ring_permute(x, group, shift)


def _ring_permute(x, group, shift):
    n, me = group_size(group), group_rank(group)
    ranks = dist.get_process_group_ranks(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + shift) % n],
                      group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# --- differentiable hops ----------------------------------------------------
#
# The JAX ring and pipeline take their backward passes from autodiff of
# ``lax.scan`` over ``ppermute``, ``all_to_all`` and ``psum`` inside
# ``shard_map``.  These are the same transposes: a rotation's is the
# opposite rotation, an all-to-all's the swapped one, a sum's a sum.  Each
# rank's loss is its own term of the objective (the sum over ranks), so
# cotangents that cross ranks are summed where they land.  A value that
# leaves the per-rank body replicated (every rank holds it and computes
# the same loss from it) counts once: ``replicated_output`` divides its
# cotangent by the group's size before the sum, as ``shard_map``'s
# transpose does for an output unmapped along the axis; an input that
# enters replicated gets its ranks' cotangents summed
# (``replicated_input``, the transpose of an unmapped input).


def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ring_permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring_permute(g.contiguous(), ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return (_all_to_all(g, group, concat_dim, split_dim),
                None, None, None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _ScaleGrad(torch.autograd.Function):
    """The identity forward; the backward scales, or sums over
    ``group`` (``scale`` None)."""

    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.group, ctx.scale = group, scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.scale is not None:
            return g * ctx.scale, None, None
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (the JAX ``lax.psum``); its
    backward sums the cotangents over the group."""
    if group is None:
        return x
    if _wants_grad(x):
        return _Psum.apply(x, group)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def broadcast_from(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of ``group``: the masked
    ``psum`` of the JAX ring's sinks and pipeline's harvest.  In the
    backward the owner receives the sum of the ranks' cotangents (each
    rank's term of the objective) and the others nothing; wrap the
    result in ``replicated_output`` where every rank computes the same
    loss from it, so the owner receives that cotangent once."""
    if group is None:
        return x
    # ``where`` on a flag tensor: every rank builds the same graph (the
    # backward's collective runs on all of them), and a non-finite value
    # off the owner does not leak through a product with 0.
    mine = torch.tensor(group_rank(group) == src, device=x.device)
    return psum(torch.where(mine, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device)), group)


def replicated_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; in the backward the ranks' cotangents are summed
    (a value every rank holds feeds per-rank work that differs)."""
    if group is None or not _wants_grad(x):
        return x
    return _ScaleGrad.apply(x, group, None)


def replicated_output(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; in the backward the cotangent is divided by the
    group's size (every rank computes the same loss from ``x``, so the
    sum over ranks that follows counts it once)."""
    if group is None or not _wants_grad(x):
        return x
    return _ScaleGrad.apply(x, group, 1.0 / group_size(group))


# --- quantized gradient collectives (EQuARX recipe) -------------------------


def _quantize_rows(x: torch.Tensor) -> tuple:
    """``quantize_q8`` of each row of ``x`` [R, c]: (q int8 [R, c],
    scales f32 [R, nb])."""
    x = x.float()
    r, n = x.shape
    nb = max(1, -(-n // Q8_BLOCK))
    xb = torch.nn.functional.pad(x, (0, nb * Q8_BLOCK - n)).reshape(
        r, nb, Q8_BLOCK)
    a = xb.abs()
    amax = torch.where(torch.isnan(a), 0.0, a).amax(dim=2)
    scale = amax / torch.tensor(127.0, dtype=torch.float32)
    inv = torch.tensor(1.0, dtype=torch.float32) / scale
    bad = ~(scale > 0) | ~torch.isfinite(inv) | ~torch.isfinite(scale)
    scale = torch.where(bad, 1.0, scale)
    inv = torch.where(bad, 1.0, inv)
    v = xb * inv[..., None]
    v = torch.where(torch.isnan(v), 0.0, v.clamp(-127.0, 127.0))
    q = torch.round(v).to(torch.int8)
    return q.reshape(r, -1)[:, :n], scale


def _dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    r, n = q.shape
    nb = scales.shape[1]
    qb = torch.nn.functional.pad(q, (0, nb * Q8_BLOCK - n)).reshape(
        r, nb, Q8_BLOCK)
    out = qb.float() * scales[..., None].float()
    return out.reshape(r, -1)[:, :n]


def quantize_q8(x: torch.Tensor) -> tuple:
    """The shared int8 recipe on a 1-D tensor: per ``Q8_BLOCK`` block,
    f32 scale = amax/127 (1.0 where that or its inverse is zero or not
    finite), values clamped to [-127, 127] (NaN → 0), rounded half to
    even.  Returns ``(q int8 [n], scales f32 [nb])``, bit for bit the
    JAX ``quantize_q8``."""
    q, s = _quantize_rows(x.reshape(1, -1))
    return q[0], s[0]


def dequantize_q8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Per-block ``q * scale`` in f32 (1-D)."""
    return _dequantize_rows(q.reshape(1, -1), scales.reshape(1, -1))[0]


def _q8_pipeline(p: torch.Tensor, group) -> tuple:
    """The int8 reduce-scatter + all-gather of ``p`` [W, c] (row j the
    chunk rank j owns).  Returns ``(summed [W, c], send_err [W, c],
    owner_err [c])``."""
    q, s = _quantize_rows(p)
    send_err = p - _dequantize_rows(q, s)
    tq = torch.empty_like(q)
    ts = torch.empty_like(s)
    dist.all_to_all_single(tq, q.contiguous(), group=group)
    dist.all_to_all_single(ts, s.contiguous(), group=group)
    red = _dequantize_rows(tq, ts).sum(dim=0)              # exact f32 sum
    q2, s2 = quantize_q8(red)
    owner_err = red - dequantize_q8(q2, s2)
    W = p.shape[0]
    fq = torch.empty(W * q2.numel(), dtype=q2.dtype, device=q2.device)
    fs = torch.empty(W * s2.numel(), dtype=s2.dtype, device=s2.device)
    dist.all_gather_into_tensor(fq, q2.contiguous(), group=group)
    dist.all_gather_into_tensor(fs, s2.contiguous(), group=group)
    return (_dequantize_rows(fq.view(W, -1), fs.view(W, -1)), send_err,
            owner_err)


def _q8_sum(flat: torch.Tensor, group) -> tuple:
    """int8-wire sum-allreduce of this rank's 1-D ``flat`` over
    ``group``, with the quantization-error terms error feedback needs:
    ``(summed [n] f32, send_err [W, c], owner_err [c])``."""
    W = group_size(group)
    n = flat.shape[0]
    c = -(-n // W)
    p = torch.nn.functional.pad(flat.float(), (0, W * c - n)).reshape(W, c)
    summed, send_err, owner_err = _q8_pipeline(p, group)
    return summed.reshape(-1)[:n], send_err, owner_err


def q8_wire_bytes(n: int, world: int) -> int:
    """Per-rank wire bytes of one ``_q8_sum`` over ``n`` f32 elements."""
    W = max(1, int(world))
    c = -(-int(n) // W)
    nb = max(1, -(-c // Q8_BLOCK))
    return 2 * (W - 1) * (c + 4 * nb)


def q8_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """int8-wire sum-allreduce of a 1-D buffer, errors discarded."""
    if group is None:
        return x.float().clone()
    return _q8_sum(x, group)[0]


def _finite_everywhere(grads: Sequence[torch.Tensor], group) -> torch.Tensor:
    """All ranks' grads finite (taken before the wire, which saturates
    inf and zeroes NaN)."""
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    flag = finite.to(torch.int32).reshape(1)
    if group is not None:
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return flag[0].bool()


def _sizes(grads) -> list:
    return [int(np.prod(tuple(g.shape), dtype=np.int64)) for g in grads]


def _exact_mean(grads, ixs, sizes, W, group, out) -> None:
    """The exact f32 path: one concatenated psum, divided by W."""
    cat = torch.cat([grads[i].float().reshape(-1) for i in ixs])
    if group is not None:
        dist.all_reduce(cat, group=group)
    offs = np.cumsum([0] + [sizes[i] for i in ixs])
    for j, i in enumerate(ixs):
        out[i] = (cat[offs[j]:offs[j + 1]] / W).reshape(grads[i].shape)


def ef_grad_sync(grads: Sequence[torch.Tensor],
                 residual: Sequence[torch.Tensor], group, *,
                 wire: str = "int8",
                 min_quant_elems: int = DEFAULT_MIN_QUANT_ELEMS):
    """Error-feedback gradient mean-allreduce, int8 on the wire.

    ``grads`` this rank's local gradients (of its local-mean loss),
    ``residual`` its carried quantization error, leaf for leaf.  Leaves
    of at least ``min_quant_elems`` elements are compensated (g + r),
    concatenated into one flat vector and summed through ``_q8_sum``;
    the new residual is this rank's send error plus, on its owned chunk,
    the owner's re-quantization error.  Smaller leaves (and all of them
    with ``wire="f32"``) take one exact f32 sum; their residual is 0.
    Returns ``(mean_grads, new_residual, finite)``; on a non-finite step
    the residual comes back unchanged."""
    if wire not in ("f32", "int8"):
        raise ValueError(f"wire must be f32|int8, got {wire!r}")
    W = group_size(group)
    idx = group_rank(group)
    finite = _finite_everywhere(grads, group)
    sizes = _sizes(grads)
    quant_ix = [i for i, n in enumerate(sizes)
                if wire == "int8" and n >= min_quant_elems and W > 1]
    exact_ix = [i for i in range(len(sizes)) if i not in set(quant_ix)]
    out: list = [None] * len(sizes)
    new_r = [torch.zeros_like(r) for r in residual]
    if exact_ix:
        _exact_mean(grads, exact_ix, sizes, W, group, out)
    if quant_ix:
        comp = torch.cat([(grads[i].float() + residual[i].float()).reshape(-1)
                          for i in quant_ix])
        n = comp.shape[0]
        summed, send_err, owner_err = _q8_sum(comp, group)
        send_err[idx] += owner_err
        err = send_err.reshape(-1)[:n]
        offs = np.cumsum([0] + [sizes[i] for i in quant_ix])
        for j, i in enumerate(quant_ix):
            shape = grads[i].shape
            out[i] = (summed[offs[j]:offs[j + 1]] / W).reshape(shape)
            piece = err[offs[j]:offs[j + 1]].reshape(shape)
            new_r[i] = torch.where(finite, piece,
                                   residual[i]).to(residual[i].dtype)
    return out, new_r, finite


def grad_sync_wire_bytes(shapes, world: int, wire: str = "int8",
                         min_quant_elems: int = DEFAULT_MIN_QUANT_ELEMS
                         ) -> int:
    """Analytic per-rank wire bytes of one ``ef_grad_sync`` step over
    leaves of these shapes (tensors or shape tuples)."""
    W = max(1, int(world))
    n_exact = n_quant = 0
    for n in _leaf_sizes(shapes):
        if wire != "int8" or n < min_quant_elems or W <= 1:
            n_exact += n
        else:
            n_quant += n
    total = 2 * (W - 1) / W * 4 * n_exact
    if n_quant:
        total += q8_wire_bytes(n_quant, W)
    return int(math.ceil(total))


def _leaf_sizes(leaves) -> list:
    out = []
    for leaf in leaves:
        shape = tuple(getattr(leaf, "shape", leaf))
        out.append(int(np.prod(shape, dtype=np.int64)) if shape else 1)
    return out


def _leaf_bytes(leaf) -> int:
    shape = tuple(getattr(leaf, "shape", leaf))
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    dtype = getattr(leaf, "dtype", torch.float32)
    return size * (dtype.itemsize if isinstance(dtype, torch.dtype)
                   else np.dtype(dtype).itemsize)


# --- bucketed gradient sync -------------------------------------------------


def plan_grad_buckets(leaves, k: int) -> list[list[int]]:
    """Partition the leaves into ``min(k, n)`` contiguous byte-balanced
    buckets, in dispatch order: runs of the reversed leaf order (bucket 0
    holds the last leaves, the first gradients the backward makes),
    indices ascending within a bucket.  Bucket ``j`` closes once the
    cumulative bytes reach ``j/k`` of the total, or when the leaves left
    are just enough to give every remaining bucket one.  The JAX
    ``plan_grad_buckets`` over the same shapes and dtypes."""
    leaves = list(leaves)
    n = len(leaves)
    if n == 0:
        return []
    k = max(1, min(int(k), n))
    order = list(range(n))[::-1]
    sizes = [_leaf_bytes(leaves[i]) for i in order]
    total = float(sum(sizes))
    buckets: list[list[int]] = [[]]
    cum = 0.0
    for pos, i in enumerate(order):
        buckets[-1].append(i)
        cum += sizes[pos]
        left = n - pos - 1
        if len(buckets) < k and left >= 1 and (
                cum >= len(buckets) * total / k
                or left == k - len(buckets)):
            buckets.append([])
    return [sorted(b) for b in buckets]


def _leaf_rank_chunk(n: int, world: int) -> int:
    """Per-rank chunk of one quantized leaf of ``n`` elements: the
    smallest whole-``Q8_BLOCK`` multiple covering ``ceil(n/W)``."""
    return Q8_BLOCK * max(1, -(-int(n) // (max(1, int(world)) * Q8_BLOCK)))


def ef_bucket_sync(grads: Sequence[torch.Tensor],
                   residual: Sequence[torch.Tensor], group, *,
                   wire: str = "int8",
                   min_quant_elems: int = DEFAULT_MIN_QUANT_ELEMS):
    """``ef_grad_sync`` of ONE bucket with the leaf-aligned layout: each
    quantized leaf gets a per-rank chunk of whole ``Q8_BLOCK``s, padded
    to (W, c), and the bucket's leaves are concatenated along the chunk
    dim into one (W, ΣC) pipeline, so no block or rank chunk spans two
    leaves and every leaf's result is the same whatever bucket it rides
    in.  ``finite`` covers this bucket's leaves and gates its residual.
    Same return as ``ef_grad_sync``."""
    if wire not in ("f32", "int8"):
        raise ValueError(f"wire must be f32|int8, got {wire!r}")
    W = group_size(group)
    idx = group_rank(group)
    finite = _finite_everywhere(grads, group)
    sizes = _sizes(grads)
    quant_ix = [i for i, n in enumerate(sizes)
                if wire == "int8" and n >= min_quant_elems and W > 1]
    exact_ix = [i for i in range(len(sizes)) if i not in set(quant_ix)]
    out: list = [None] * len(sizes)
    new_r = [torch.zeros_like(r) for r in residual]
    if exact_ix:
        _exact_mean(grads, exact_ix, sizes, W, group, out)
    if quant_ix:
        chunks = [_leaf_rank_chunk(sizes[i], W) for i in quant_ix]
        rows = []
        for i, c in zip(quant_ix, chunks):
            comp = (grads[i].float() + residual[i].float()).reshape(-1)
            rows.append(torch.nn.functional.pad(
                comp, (0, W * c - sizes[i])).reshape(W, c))
        p = torch.cat(rows, dim=1)                        # (W, C)
        summed, send_err, owner_err = _q8_pipeline(p, group)
        send_err[idx] += owner_err
        off = 0
        for i, c in zip(quant_ix, chunks):
            m, shape = sizes[i], grads[i].shape
            out[i] = (summed[:, off:off + c].reshape(-1)[:m] / W
                      ).reshape(shape)
            piece = send_err[:, off:off + c].reshape(-1)[:m].reshape(shape)
            new_r[i] = torch.where(finite, piece,
                                   residual[i]).to(residual[i].dtype)
            off += c
    return out, new_r, finite


def bucket_sync_wire_bytes(shapes, world: int, wire: str = "int8",
                           min_quant_elems: int = DEFAULT_MIN_QUANT_ELEMS
                           ) -> int:
    """Analytic per-rank wire bytes of one ``ef_bucket_sync`` call."""
    W = max(1, int(world))
    n_exact = 0
    C = 0
    for n in _leaf_sizes(shapes):
        if wire != "int8" or n < min_quant_elems or W <= 1:
            n_exact += n
        else:
            C += _leaf_rank_chunk(n, W)
    total = 2 * (W - 1) / W * 4 * n_exact
    if C:
        total += 2 * (W - 1) * (C + 4 * (C // Q8_BLOCK))
    return int(math.ceil(total))


# --- host-level helpers -----------------------------------------------------


def broadcast_from_coordinator(obj, group=None):
    """Rank 0's ``obj`` (any picklable value) on every rank of ``group``
    (the default group when None and one is up); the identity in a
    one-process run."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size(group) == 1:
        return obj
    box = [obj]
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def host_all_reduce_mean(metrics: dict, group) -> dict:
    """The mean over ``group``'s ranks of a dict of scalar metrics, as
    host floats (``Strategy.reduce(MEAN, ...)``).  Each rank's metrics
    are of its own batch shard; the global value is their mean."""
    names = sorted(metrics)
    if group is None or not names:
        return {k: float(metrics[k]) for k in names}
    vals = torch.tensor([float(metrics[k]) for k in names],
                        dtype=torch.float64)
    dist.all_reduce(vals, group=group)
    vals /= group_size(group)
    return dict(zip(names, vals.tolist()))


# --- microbenchmark ---------------------------------------------------------


def allreduce_bus_bandwidth(group, *, device="cpu", size_mb: float = 64.0,
                            iters: int = 10, warmup: int = 3,
                            dtype=torch.float32, quant: str = "none",
                            axis: str = "data") -> dict:
    """Allreduce bus bandwidth over ``group``: ``2(k-1)/k · bytes / time``
    with ``bytes`` the per-rank buffer (the NCCL benchmark convention).
    ``quant="int8"`` times ``q8_all_reduce`` instead and reports the
    effective f32 rate beside its ``wire_bytes``.  At one rank the figure
    is a copy's, not a link's."""
    if quant not in ("none", "int8"):
        raise ValueError(f"quant must be none|int8, got {quant!r}")
    k = group_size(group)
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_rank = max(1, int(size_mb * 1e6 / itemsize))
    x = torch.ones((per_rank,), dtype=dtype, device=device)

    def step():
        if quant == "int8":
            return q8_all_reduce(x, group)
        return all_reduce(x, group)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    for _ in range(warmup):
        step()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    sync()
    dt = (time.perf_counter() - t0) / iters
    nbytes = per_rank * itemsize
    bus_bw = 2 * (k - 1) / k * nbytes / dt if k > 1 else nbytes / dt
    rec = {"axis": axis, "devices": k, "message_bytes": nbytes,
           "time_s": dt, "bus_bandwidth_gbps": bus_bw / 1e9,
           "wire": "f32" if quant == "none" else "int8"}
    if quant == "int8":
        rec["wire_bytes"] = q8_wire_bytes(per_rank, k)
    return rec
