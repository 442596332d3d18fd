"""Transformer building blocks for the decoder's serving modes.

Counterpart of the JAX package's ``models/layers.py``, ported for the
paged-KV serving engine: ``Embed``, RoPE (with the Llama-3 frequency
scaling), the int8 KV recipe, ``RMSNorm`` over the fused kernel, the
gated ``MlpBlock`` and the decode modes of ``MultiHeadAttention``.  The
training branch of attention waits for the training slice.

Weights keep the flax layout, so converted checkpoints load verbatim:
dense kernels are ``[in, out]`` (``y = x @ kernel``), the embedding table
``[vocab, d_model]``, norm scales ``[d]``.

KV caches are plain tensors held in a ``KVCache`` and updated IN PLACE
(the JAX package threads them functionally and donates the old buffers;
in place saves the copy):

- linear (the engine's batch-1 prefill cache): per layer ``key_cache`` /
  ``value_cache`` [B, C, kvh, hd] and, for ``kv_cache_int8``,
  ``kv_scales`` [2, B, C, kvh];
- paged (the slot grid): per layer ``key_pool`` / ``value_pool``
  [nb, bs, kvh, hd] and ``kv_pool_scales`` [2, nb, bs, kvh]; plus one
  ``block_table`` [B, n_blk] int32 shared by all layers (the JAX package
  keeps an identical copy per layer).

Both carry one ``index`` [B] int32: each row's position, advanced by the
model once per call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.ops.attention import (
    dot_product_attention,
)


@dataclasses.dataclass
class KVCache:
    """A decoder's KV cache: ``layers[i]`` maps leaf names to tensors (see
    the module docstring); ``index`` [B] int32; ``cache_len`` the logical
    rows a lane can hold; ``block_table`` [B, n_blk] int32 for the paged
    layout, None for the linear one."""

    layers: list
    index: torch.Tensor
    cache_len: int
    block_table: Optional[torch.Tensor] = None

    @property
    def paged(self) -> bool:
        return self.block_table is not None


class Dense(nn.Module):
    """``y = x @ kernel (+ bias)``, kernel ``[in, out]`` (flax layout);
    inputs and weights are promoted to ``dtype`` as flax's Dense does."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(in_features, out_features, dtype=dtype,
                        device=device), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype,
                                              device=device),
                                  requires_grad=False)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embed(nn.Module):
    """Token embedding (table ``[vocab, features]``)."""

    def __init__(self, vocab_size: int, features: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.empty(vocab_size, features, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # take-then-cast equals the JAX cast-then-take bit for bit.
        return self.embedding[ids].to(self.dtype)


def llama3_scaled_freqs(freqs: torch.Tensor, scaling) -> torch.Tensor:
    """Llama-3.x frequency-dependent RoPE scaling (HF
    ``_compute_llama3_parameters``); ``scaling`` = (factor,
    low_freq_factor, high_freq_factor, original_max_positions)."""
    factor, low, high, old_len = scaling
    wavelen = 2.0 * math.pi / freqs
    low_wl = old_len / low
    high_wl = old_len / high
    scaled = torch.where(wavelen > low_wl, freqs / factor, freqs)
    smooth = (old_len / wavelen - low) / (high - low)
    smoothed = (1.0 - smooth) / factor * freqs + smooth * freqs
    medium = (wavelen >= high_wl) & (wavelen <= low_wl)
    return torch.where(medium, smoothed, scaled)


def rope_sin_cos(positions: torch.Tensor, head_dim: int, *,
                 base: float = 10000.0, scaling=None):
    """(sin, cos) [B, S, 1, head_dim/2] in f32 for integer ``positions``
    [B, S] — computed once per model call and shared by every layer."""
    freqs = 1.0 / base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim)
    if scaling is not None:
        freqs = llama3_scaled_freqs(freqs, scaling)
    angles = positions[..., None].float() * freqs
    return torch.sin(angles)[:, :, None, :], torch.cos(angles)[:, :, None, :]


def rotate(x: torch.Tensor, sin: torch.Tensor,
           cos: torch.Tensor) -> torch.Tensor:
    """RoPE rotation of [B, S, H, D] by precomputed tables (f32 math)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               base: float = 10000.0, scaling=None) -> torch.Tensor:
    """RoPE applied to [B, S, H, D] at integer ``positions`` [B, S]."""
    sin, cos = rope_sin_cos(positions, x.shape[-1], base=base,
                            scaling=scaling)
    return rotate(x, sin, cos)


def _quantize_kv_rows(t: torch.Tensor):
    """Symmetric int8 quantization of KV rows, one f32 scale per
    (..., row, kv_head) taken over head_dim — the one KV recipe of the
    linear cache and the paged pool.  ``torch.round`` rounds half to even,
    as ``jnp.round`` does, so both frameworks store the same bytes."""
    t32 = t.float()
    amax = t32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    qt = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127)
    return qt.to(torch.int8), scale


class RMSNorm(nn.Module):
    """Llama-family norm over the fused kernel (``ops.kernels.rms_norm``).
    ``zero_centered`` (Gemma): output x̂·(1 + scale); the +1 is applied
    here, outside the kernel."""

    def __init__(self, features: int, *, epsilon: float = 1e-5,
                 dtype=torch.float32, zero_centered: bool = False,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.zero_centered = zero_centered
        self.scale = nn.Parameter(
            torch.empty(features, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.scale + 1.0 if self.zero_centered else self.scale
        return K.rms_norm(x, scale, epsilon=self.epsilon).to(self.dtype)


class MlpBlock(nn.Module):
    """Gated FFN: SwiGLU (``silu``) or GeGLU with the tanh gelu."""

    def __init__(self, features: int, hidden: int, *, dtype=torch.float32,
                 activation: str = "silu", device=None):
        super().__init__()
        if activation not in ("silu", "gelu"):
            raise ValueError(f"activation must be 'silu' or 'gelu', got "
                             f"{activation!r}")
        self.activation = activation
        self.wi_gate = Dense(features, hidden, dtype=dtype, device=device)
        self.wi_up = Dense(features, hidden, dtype=dtype, device=device)
        self.wo = Dense(hidden, features, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.wi_gate(x)
        act = (F.silu(gate) if self.activation == "silu"
               else F.gelu(gate, approximate="tanh"))
        return self.wo(act * self.wi_up(x))


class MultiHeadAttention(nn.Module):
    """MHA/GQA self-attention over a KV cache (serving modes only).

    A call appends this call's k/v rows at each row's own position
    (``index``) and attends over everything up to it: over a linear cache
    (``_slot_decode_step``, the serving engine's batch-1 prefill) or over
    the paged pool (``_paged_decode_step``, the slot-grid decode step,
    whose read is the fused paged-attention kernel)."""

    def __init__(self, features: int, num_heads: int, head_dim: int,
                 num_kv_heads: Optional[int] = None, *, dtype=torch.float32,
                 kv_cache_int8: bool = False, fused_qkv: bool = False,
                 qkv_bias: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.num_kv_heads = num_kv_heads or num_heads
        self.dtype = dtype
        self.kv_cache_int8 = kv_cache_int8
        self.fused_qkv = fused_qkv
        kvh = self.num_kv_heads
        if fused_qkv:
            self.qkv = Dense(features, (num_heads + 2 * kvh) * head_dim,
                             use_bias=qkv_bias, dtype=dtype, device=device)
        else:
            self.query = Dense(features, num_heads * head_dim,
                               use_bias=qkv_bias, dtype=dtype, device=device)
            self.key = Dense(features, kvh * head_dim, use_bias=qkv_bias,
                             dtype=dtype, device=device)
            self.value = Dense(features, kvh * head_dim, use_bias=qkv_bias,
                               dtype=dtype, device=device)
        self.out = Dense(num_heads * head_dim, features, dtype=dtype,
                         device=device)

    def _qkv(self, x: torch.Tensor):
        """q [B, S, H, D], k/v [B, S, KV, D]: three products, or one
        fused product split head-wise."""
        b, s, _ = x.shape
        h, kvh, hd = self.num_heads, self.num_kv_heads, self.head_dim
        if not self.fused_qkv:
            return (self.query(x).view(b, s, h, hd),
                    self.key(x).view(b, s, kvh, hd),
                    self.value(x).view(b, s, kvh, hd))
        y = self.qkv(x).view(b, s, h + 2 * kvh, hd)
        return y[:, :, :h], y[:, :, h:h + kvh], y[:, :, h + kvh:]

    def forward(self, x: torch.Tensor, layer_cache: dict, cache: KVCache,
                *, positions: torch.Tensor, rope) -> torch.Tensor:
        """``layer_cache``: this layer's leaves of ``cache``; ``positions``
        [B, S] = ``cache.index[:, None] + arange(S)``; ``rope`` the
        (sin, cos) tables at those positions."""
        q, k, v = self._qkv(x)
        q = rotate(q, *rope)
        k = rotate(k, *rope)
        if cache.paged:
            out = self._paged_decode_step(q, k, v, layer_cache, positions,
                                          cache)
        else:
            out = self._slot_decode_step(q, k, v, layer_cache, positions)
        return self._attn_epilogue(out)

    def _stored(self, k: torch.Tensor, v: torch.Tensor, cache_dtype):
        """Rows as the cache stores them: int8 + scales, or cast."""
        if self.kv_cache_int8:
            qk, sk = _quantize_kv_rows(k)
            qv, sv = _quantize_kv_rows(v)
            return qk, qv, torch.stack([sk, sv])
        return k.to(cache_dtype), v.to(cache_dtype), None

    def _slot_decode_step(self, q, k, v, lc, positions):
        """Per-row positions over a linear cache (the engine's batch-1
        prefill).  A position past the cache's end would be dropped by the
        JAX scatter; here it lands in the last row instead.  Only pad rows
        of a final prefill piece go there, and rows at or past the prompt
        length are rewritten before anything attends them, so the
        difference is never read."""
        kc_all, vc_all = lc["key_cache"], lc["value_cache"]
        b, c = kc_all.shape[:2]
        rows = positions.clamp(max=c - 1).long()
        bidx = torch.arange(b, device=q.device)[:, None].expand_as(rows)
        k_st, v_st, scales = self._stored(k, v, kc_all.dtype)
        kc_all[bidx, rows] = k_st
        vc_all[bidx, rows] = v_st
        if scales is not None:
            lc["kv_scales"][:, bidx, rows] = scales
            kc = (kc_all.to(self.dtype)
                  * lc["kv_scales"][0][..., None].to(self.dtype))
            vc = (vc_all.to(self.dtype)
                  * lc["kv_scales"][1][..., None].to(self.dtype))
        else:
            kc, vc = kc_all, vc_all
        kv_pos = torch.arange(c, device=q.device)
        mask = kv_pos[None, None, :] <= positions[:, :, None]   # [B, q, C]
        return self._cache_attend(q, kc, vc, mask[:, None])

    def _paged_decode_step(self, q, k, v, lc, positions, cache: KVCache):
        """Per-row positions over the paged pool: scatter each token's
        rows to ``pool[table[b, p // bs], p % bs]``, then the fused
        paged-attention kernel.  Positions past the table's reach go to
        the scratch block 0 (the JAX scatter drops them; scratch is
        garbage nobody reads as data, so both are unobservable)."""
        kpool, vpool = lc["key_pool"], lc["value_pool"]
        table = cache.block_table
        nb, bs, kvh, hd = kpool.shape
        n_blk = table.shape[1]
        blk = torch.clamp(positions // bs, 0, n_blk - 1).long()
        phys = torch.gather(table, 1, blk)                   # [B, q]
        dest = torch.where(positions < n_blk * bs,
                           phys * bs + positions % bs,
                           torch.zeros_like(phys)).reshape(-1).long()
        k_st, v_st, scales = self._stored(k, v, kpool.dtype)
        kpool.view(nb * bs, kvh, hd)[dest] = k_st.reshape(-1, kvh, hd)
        vpool.view(nb * bs, kvh, hd)[dest] = v_st.reshape(-1, kvh, hd)
        ks = vs = None
        if scales is not None:
            spool = lc["kv_pool_scales"]
            spool.view(2, nb * bs, kvh)[:, dest] = scales.reshape(2, -1, kvh)
            ks, vs = spool[0], spool[1]
        return K.paged_attention(q.contiguous(), kpool, vpool, table,
                                 cache.index, k_scales=ks, v_scales=vs,
                                 cache_len=cache.cache_len)

    def _cache_attend(self, q, kc, vc, mask):
        """Masked einsum attention of q over dense cache buffers."""
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            kc = kc.repeat_interleave(rep, dim=2)
            vc = vc.repeat_interleave(rep, dim=2)
        out = dot_product_attention(q.transpose(1, 2), kc.transpose(1, 2),
                                    vc.transpose(1, 2), mask=mask)
        return out.transpose(1, 2)

    def _attn_epilogue(self, out: torch.Tensor) -> torch.Tensor:
        """Head merge and output projection (shared by both modes)."""
        b, s = out.shape[:2]
        return self.out(out.reshape(b, s, self.num_heads * self.head_dim))
