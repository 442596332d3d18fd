"""Attention: the reference path and the flash-attention dispatch
(counterpart of the JAX package's ``ops/attention.py``).

``multihead_attention_kernel`` takes [B, H, S, D] queries and routes to
the hand-written flash kernel (``ops.kernels.flash_attention``) on CUDA
when the shapes are the ones the JAX package sends to its Pallas flash
kernel on a TPU, else to the masked reference ``dot_product_attention``
(always on the CPU, as the JAX package on a CPU).  Sliding-window
attention (``local_attention_chunked`` and the splash kernel) is not
ported yet; ``models.llama.CausalLmTask`` refuses windowed configs.
"""

from __future__ import annotations

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
                               softmax_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Flash attention on CUDA, the reference path elsewhere.

    ``q``: [B, H, S, D]; ``k``/``v``: [B, KVH, S_kv, D] with H a multiple
    of KVH (the JAX function takes k/v already repeated to H heads; here
    the flash kernel reads kv head ``h // (H / KVH)`` itself and the
    reference path repeats).  ``segment_ids`` [B, S] restricts attention
    to equal ids (sequence packing): native in the flash kernel, a dense
    mask on the reference path.
    """
    if _flash_friendly(q, k):
        from tensorflow_train_distributed_torch.ops import kernels as K

        scale = (softmax_scale if softmax_scale is not None
                 else q.shape[-1] ** -0.5)
        seg = (None if segment_ids is None
               else segment_ids.to(torch.int32).contiguous())
        return K.flash_attention(q, k, v, causal=causal, segment_ids=seg,
                                 sm_scale=scale)
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    mask = None
    if segment_ids is not None:
        mask = (segment_ids[:, None, :, None]
                == segment_ids[:, None, None, :])      # [B, 1, Sq, Skv]
    return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                 softmax_scale=softmax_scale)
