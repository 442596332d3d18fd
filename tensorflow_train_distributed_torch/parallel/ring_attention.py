"""Sequence (context) parallelism: ring attention and Ulysses
(counterpart of the JAX package's ``parallel/ring_attention.py``).

The sequence is sharded over the ``seq`` mesh axis: each rank holds S/n
tokens of every row.  Both functions are per-rank bodies over the
axis's process group (``runtime.mesh.Mesh.group("seq")``; a group of
None is a world of one), as the JAX ones are per-shard bodies inside
``shard_map``:

- **Ring attention**: each rank keeps its query block; the KV blocks
  make n-1 hops around the ring (``collectives.ring_permute``) while an
  online softmax (o, m, l) accumulates in f32.  GQA rotates the
  unrepeated KV.  A sliding window cuts the hops to
  ``ceil((window-1)/Sk)``; attention sinks come from shard 0 in one
  masked sum-broadcast (``collectives.broadcast_from``).  Each hop's
  scores are the JAX einsum, computed outside any kernel.
- **Ulysses**: an all-to-all reshards seq to heads, so each rank attends
  over the whole sequence for H/n heads through the kernel dispatch
  (``ops.attention.multihead_attention_kernel``: the flash kernel K2, or
  the splash kernel K7 under a window, on CUDA), then reshards back.

The backward is autograd through the same code: the hops are the
differentiable forms of ``parallel.collectives``, and every rank builds
the same graph, so the backward's collectives meet in the same order.
"""

from __future__ import annotations

from typing import Optional

import torch

from tensorflow_train_distributed_torch.parallel.collectives import (
    all_gather,
    all_to_all,
    broadcast_from,
    group_rank,
    group_size,
    ring_permute,
)

_NEG = float(torch.finfo(torch.float32).min) / 2


def _repeat_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    """Broadcast GQA KV heads up to ``heads`` full heads ([B, Hkv, S, D];
    each kv head repeated in place, as ``jnp.repeat``)."""
    if x.shape[1] == heads:
        return x
    return x.repeat_interleave(heads // x.shape[1], dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group=None, causal: bool = False,
                   softmax_scale: Optional[float] = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   window: Optional[int] = None,
                   sinks: int = 0) -> torch.Tensor:
    """Per-rank ring attention.  q: [B, H, Sq, D]; k/v: [B, Hkv, Sk, D]
    (Hkv divides H), this rank's blocks of a sequence sharded over
    ``group`` in rank order.  ``segment_ids`` [B, Sq] (this rank's slice)
    restricts attention to equal ids; the KV block's ids rotate with it.
    ``window`` (needs ``causal``) masks the band and shortens the ring;
    ``sinks`` (needs ``window``, at most one block) keeps the sequence's
    first keys visible past it."""
    n, idx = group_size(group), group_rank(group)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    if sinks and (window is None or sinks > sk):
        raise ValueError(
            f"ring attention sinks need a sliding window and must fit "
            f"one shard (sinks={sinks}, shard span={sk})")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    q32 = q.float() * scale
    dev = q.device

    def fold(olm, k_blk, v_blk, block_mask):
        """Online-softmax accumulation of one masked KV block (the ring
        hops and the sink block)."""
        o, m, l = olm
        s = torch.einsum("bhqd,bhkd->bhqk", q32,
                         _repeat_kv(k_blk, h).float())
        s = torch.where(block_mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # Mask again on p: a fully masked block must add exactly 0
        # (exp(s - m_new) would be 1 on its own masked rows).
        p = torch.where(block_mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(-1, keepdim=True)
        o_new = o * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p, _repeat_kv(v_blk, h).float())
        return o_new, m_new, l_new

    q_pos = idx * sq + torch.arange(sq, device=dev)[:, None]

    def attend_block(olm, k_blk, v_blk, kv_idx, kv_seg):
        if causal:
            k_pos = kv_idx * sk + torch.arange(sk, device=dev)[None, :]
            keep = q_pos >= k_pos
            if window is not None:
                keep = keep & (q_pos - k_pos < window)
            block_mask = keep[None, None]
        else:
            block_mask = torch.ones((1, 1, sq, sk), dtype=torch.bool,
                                    device=dev)
        if kv_seg is not None:
            block_mask = block_mask & (
                segment_ids[:, :, None] == kv_seg[:, None, :])[:, None]
        return fold(olm, k_blk, v_blk, block_mask)

    o0 = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    m0 = torch.full((b, h, sq, 1), float("-inf"), dtype=torch.float32,
                    device=dev)
    l0 = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=dev)
    # The local block first, then n-1 rotate-and-attend hops; the KV
    # block's segment ids ride along only when packing is on.
    olm = attend_block((o0, m0, l0), k, v, idx, segment_ids)

    if sinks:
        # The first ``sinks`` keys live on shard 0: one masked
        # sum-broadcast hands every rank the sink block, masked against
        # the band so that no key is counted twice.
        sink_k = broadcast_from(k[:, :, :sinks], group, 0)
        sink_v = broadcast_from(v[:, :, :sinks], group, 0)
        sink_seg = (None if segment_ids is None else broadcast_from(
            segment_ids[:, :sinks], group, 0))
        si = torch.arange(sinks, device=dev)[None, :]
        keep = (si <= q_pos) & (q_pos - si >= window)
        if sink_seg is not None:
            keep = keep[None, None] & (
                segment_ids[:, :, None] == sink_seg[:, None, :])[:, None]
        else:
            keep = keep[None, None].expand(1, 1, sq, sinks)
        olm = fold(olm, sink_k, sink_v, keep)

    # A block j hops back holds keys at least (j-1)·Sk + 1 positions
    # behind every local query: past ceil((window-1)/Sk) hops every block
    # is out of the window, so it is never rotated in.
    hops = n - 1
    if window is not None:
        hops = min(hops, -(-(window - 1) // sk))
    k_blk, v_blk, seg_blk = k, v, segment_ids
    for step in range(hops):
        k_blk = ring_permute(k_blk, group, shift=1)
        v_blk = ring_permute(v_blk, group, shift=1)
        if seg_blk is not None:
            seg_blk = ring_permute(seg_blk, group, shift=1)
        olm = attend_block(olm, k_blk, v_blk, (idx - step - 1) % n,
                           seg_blk)
    o, _, l = olm
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      group=None, causal: bool = False,
                      softmax_scale: Optional[float] = None,
                      segment_ids: Optional[torch.Tensor] = None,
                      window: Optional[int] = None,
                      sinks: int = 0) -> torch.Tensor:
    """Per-rank Ulysses attention.  q: [B, H, S_local, D]; k/v may carry
    fewer (GQA) heads.  Requires H divisible by the group's size.  After
    the all-to-all each rank attends over the whole sequence through the
    kernel dispatch, its segment ids all-gathered along the axis; KV
    heads are resharded unrepeated where the group's size divides them
    (the kernels read GQA heads natively), repeated up front otherwise."""
    from tensorflow_train_distributed_torch.ops.attention import (
        multihead_attention_kernel,
    )

    n = group_size(group)
    h = q.shape[1]
    if h % n:
        raise ValueError(
            f"Ulysses needs heads ({h}) divisible by seq-axis size "
            f"({n}); use ring attention instead")

    def seq_to_heads(x):  # [B, H, S/n, D] -> [B, H/n, S, D]
        if x.shape[1] % n:
            x = _repeat_kv(x, h)
        return all_to_all(x, group, split_dim=1, concat_dim=2)

    def heads_to_seq(x):  # [B, H/n, S, D] -> [B, H, S/n, D]
        return all_to_all(x, group, split_dim=2, concat_dim=1)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    full_seg = (None if segment_ids is None
                else all_gather(segment_ids, group, gather_dim=1))
    out = multihead_attention_kernel(
        qg, kg, vg, causal=causal, softmax_scale=softmax_scale,
        segment_ids=full_seg, window=window, sinks=sinks)
    return heads_to_seq(out.to(q.dtype))


METHODS = {"ring": ring_attention, "ulysses": ulysses_attention}


def shard_mapped_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, method: str = "ring",
                           causal: bool = False,
                           softmax_scale: Optional[float] = None,
                           axis: str = "seq",
                           segment_ids: Optional[torch.Tensor] = None,
                           window: Optional[int] = None,
                           sinks: int = 0) -> torch.Tensor:
    """The per-rank entry over ``mesh``: q/k/v [B, H, S, D] are this
    rank's rows, heads and sequence block (the JAX function's shards of
    its global arrays: batch over data × fsdp, heads over tensor, S over
    ``axis``), ``segment_ids`` [B, S] its slice; ``method`` "ring" or
    "ulysses" over ``mesh.group(axis)``."""
    if method not in METHODS:
        raise KeyError(method)
    return METHODS[method](q, k, v, group=mesh.group(axis), causal=causal,
                           softmax_scale=softmax_scale,
                           segment_ids=segment_ids, window=window,
                           sinks=sinks)
