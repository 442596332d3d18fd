"""Attention: the reference paths and the kernel dispatch (counterpart
of the JAX package's ``ops/attention.py``).

``multihead_attention_kernel`` takes [B, H, S, D] queries.  Full and
causal attention go to the hand-written flash kernel
(``ops.kernels.flash_attention``, K2) on CUDA when the shapes are the
ones the JAX package sends to its Pallas flash kernel on a TPU, else to
the masked reference ``dot_product_attention``.  Sliding-window
attention goes to the splash kernel (``ops.kernels.splash_attention``,
K7) on CUDA, and otherwise in the JAX package's own order to the
O(S·window) ``local_attention_chunked`` or the masked reference (always
so on the CPU, as the JAX package on a CPU).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

_MASK_VALUE = torch.finfo(torch.float32).min / 2


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          window: Optional[int] = None, sinks: int = 0,
                          softmax_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Reference attention.  q/k/v: [B, H, S, D] (q may have another S);
    ``mask`` broadcasts to [B, H, q, kv], True = visible.  ``causal`` is
    bottom-right aligned (q is the suffix of the kv sequence); ``window``
    (needs ``causal``) keeps the last ``window`` keys including the query's
    own, ``sinks`` keeps the first ``sinks`` positions past the window.

    Numerics follow the JAX function: the logits product runs in the
    input dtype and is scaled there (the scale rounded to that dtype, as
    a weakly typed constant is), then cast to f32; masked logits take
    ``finfo(f32).min / 2``; the softmax weights are cast to ``v.dtype``
    before the second product."""
    q_len, head_dim = q.shape[-2], q.shape[-1]
    kv_len = k.shape[-2]
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    if sinks and window is None:
        raise ValueError("sinks (attention sinks) only apply with a "
                         "sliding window")
    scale = softmax_scale if softmax_scale is not None else head_dim ** -0.5
    scale = torch.tensor(scale, dtype=q.dtype).item()
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    logits = logits.float()
    if causal:
        q_pos = (torch.arange(q_len, device=q.device)[:, None]
                 + (kv_len - q_len))
        k_pos = torch.arange(kv_len, device=q.device)[None, :]
        keep = q_pos >= k_pos
        if window is not None:
            band = q_pos - k_pos < window
            if sinks:
                band = band | (k_pos < sinks)
            keep = keep & band
        logits = logits.masked_fill(~keep, _MASK_VALUE)
    if mask is not None:
        logits = logits.masked_fill(~mask, _MASK_VALUE)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def local_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: int,
                            segment_ids: Optional[torch.Tensor] = None,
                            sinks: int = 0,
                            softmax_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """Sliding-window causal self-attention in O(S·window): the JAX
    function step by step.  The sequence is cut into ``window``-long
    chunks; each chunk's queries attend to (previous chunk, own chunk),
    scores [.., nc, w, 2w], kept where ``qi < kj <= qi + w`` (chunk 0's
    previous slots are padding).  ``segment_ids`` [B, S] ride the same
    shift-concat; ``sinks`` prepends the sequence's first keys to every
    chunk, dropping those the band already reaches.  q/k/v: [B, H, S, D]
    (k/v repeated to H heads), S a multiple of ``window``.  Numerics as
    ``dot_product_attention``."""
    *lead, s, d = q.shape
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not 0 <= sinks <= window:
        raise ValueError(f"sinks must be in [0, window], got sinks={sinks} "
                         f"window={window}")
    if s % window or k.shape[-2] != s:
        raise ValueError(f"local_attention_chunked wants self-attention with "
                         f"seq divisible by window, got seq={s} "
                         f"window={window}")
    w = window
    nc = s // w
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    scale = torch.tensor(scale, dtype=q.dtype).item()

    def shift_concat(tc, axis):
        """(chunk i-1, chunk i) along the window axis; chunk -1 is zeros
        (masked below)."""
        prev = torch.cat([torch.zeros_like(tc.narrow(axis, 0, 1)),
                          tc.narrow(axis, 0, nc - 1)], dim=axis)
        return torch.cat([prev, tc], dim=axis + 1)

    qc = q.reshape(*lead, nc, w, d)
    kwin = shift_concat(k.reshape(*lead, nc, w, d), -3)     # [.., nc, 2w, D]
    vwin = shift_concat(v.reshape(*lead, nc, w, d), -3)
    if sinks:
        def with_sinks(twin, t):
            sink = t[..., None, :sinks, :].expand(*lead, nc, sinks, d)
            return torch.cat([sink, twin], dim=-2)

        kwin = with_sinks(kwin, k)
        vwin = with_sinks(vwin, v)
    logits = torch.einsum("...cqd,...ckd->...cqk", qc, kwin) * scale
    logits = logits.float()
    qi = torch.arange(w, device=dev)[:, None]
    kj = torch.arange(2 * w, device=dev)[None, :]
    band = (kj > qi) & (kj <= qi + w)                       # [w, 2w]
    first = (torch.arange(nc, device=dev) == 0)[:, None, None]
    keep = band[None] & ~((kj < w)[None] & first)           # [nc, w, 2w]
    if sinks:
        base = (torch.arange(nc, device=dev) * w)[:, None, None]
        si = torch.arange(sinks, device=dev)[None, None, :]
        qg = base + qi[None]                                # [nc, w, 1]
        sink_keep = (si <= qg) & (si <= qg - w)   # causal, not in the band
        keep = torch.cat([sink_keep.expand(nc, w, sinks),
                          keep.expand(nc, w, 2 * w)], dim=-1)
    if segment_ids is not None:
        b = segment_ids.shape[0]
        segc = segment_ids.reshape(b, nc, w)
        seg_win = shift_concat(segc, -2)
        if sinks:
            seg_win = torch.cat([segment_ids[:, None, :sinks].expand(
                b, nc, sinks), seg_win], dim=-1)
        seg_keep = segc[..., :, None] == seg_win[..., None, :]
        keep = keep[None, None] & seg_keep[:, None]
    logits = logits.masked_fill(~keep, _MASK_VALUE)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("...cqk,...ckd->...cqd", weights.to(vwin.dtype), vwin)
    return out.reshape(*lead, s, d)


def _flash_friendly(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX gate of its flash kernel (``_pallas_friendly``), with the
    TPU backend replaced by a CUDA tensor: self-attention lengths that are
    multiples of 128, and the kernel's head dims and dtypes."""
    from tensorflow_train_distributed_torch.ops import kernels as K

    q_len, kv_len = q.shape[-2], k.shape[-2]
    return (q.is_cuda and q_len == kv_len and q_len % 128 == 0
            and q.shape[-1] in K.FLASH_HEAD_DIMS
            and q.dtype in K.FLASH_DTYPES)


def multihead_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = False,
                               segment_ids: Optional[torch.Tensor] = None,
                               window: Optional[int] = None, sinks: int = 0,
                               softmax_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """The kernels on CUDA, the reference paths elsewhere.

    ``q``: [B, H, S, D]; ``k``/``v``: [B, KVH, S_kv, D] with H a multiple
    of KVH (the JAX function takes k/v already repeated to H heads; here
    the kernels read kv head ``h // (H / KVH)`` themselves and the
    reference paths repeat).  ``segment_ids`` [B, S] restricts attention
    to equal ids (sequence packing): native in the kernels and the chunked
    path, a dense mask on the reference path.

    ``window`` (needs ``causal``): each query sees its last ``window``
    keys, itself included; ``sinks`` (needs ``window``) keeps the first
    ``sinks`` positions visible past it.  On a CUDA tensor that meets the
    kernels' gate, S > window takes the splash kernel, which skips the
    tiles outside the band; S <= window masks nothing beyond causality, so
    the flash kernel takes it.  Otherwise the JAX package's order: the
    chunked path when S is a multiple of the window, else the dense
    reference.
    """
    if sinks and window is None:
        raise ValueError("sinks (attention sinks) only apply with a "
                         "sliding window")
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window attention) requires "
                             "causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    s = q.shape[-2]
    if _flash_friendly(q, k) and (window is None or s <= window
                                  or sinks <= window):
        from tensorflow_train_distributed_torch.ops import kernels as K

        scale = (softmax_scale if softmax_scale is not None
                 else q.shape[-1] ** -0.5)
        seg = (None if segment_ids is None
               else segment_ids.to(torch.int32).contiguous())
        if window is not None and s > window:
            return K.splash_attention(q, k, v, window=window, sinks=sinks,
                                      segment_ids=seg, sm_scale=scale)
        return K.flash_attention(q, k, v, causal=causal, segment_ids=seg,
                                 sm_scale=scale)
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if (window is not None and s == k.shape[-2] and s % window == 0
            and s > window and sinks <= window):
        return local_attention_chunked(q, k, v, window=window,
                                       segment_ids=segment_ids, sinks=sinks,
                                       softmax_scale=softmax_scale)
    if window is not None and s >= 4 * window:
        warnings.warn(
            f"sliding-window attention fell back to the DENSE S×S path "
            f"(seq={s}, window={window}: seq not divisible by window or "
            f"cross-length); at long context this fallback can run out of "
            f"memory", stacklevel=2)
    mask = None
    if segment_ids is not None:
        mask = (segment_ids[:, None, :, None]
                == segment_ids[:, None, None, :])      # [B, 1, Sq, Skv]
    return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                 window=window, sinks=sinks,
                                 softmax_scale=softmax_scale)
