"""Reference attention (counterpart of the JAX package's ``ops/attention.py``).

Only ``dot_product_attention`` with a dense mask is ported so far: the
serving engine's prefill and the paged-attention reference use it.  The
causal/window/sink options and the flash-attention dispatch come with the
training slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, mask: Optional[torch.Tensor] = None,
                          softmax_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Reference attention.  q/k/v: [B, H, S, D] (q may have another S);
    ``mask`` broadcasts to [B, H, q, kv], True = visible.

    Numerics follow the JAX function: the logits product runs in the
    input dtype and is scaled there (the scale rounded to that dtype, as
    a weakly typed constant is), then cast to f32; masked logits take
    ``finfo(f32).min / 2``; the softmax weights are cast to ``v.dtype``
    before the second product."""
    head_dim = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else head_dim ** -0.5
    scale = torch.tensor(scale, dtype=q.dtype).item()
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    logits = logits.float()
    if mask is not None:
        logits = logits.masked_fill(
            ~mask, torch.finfo(torch.float32).min / 2)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)
