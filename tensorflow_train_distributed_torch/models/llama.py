"""Llama-family decoder in its serving (KV-cache) modes.

Counterpart of the JAX package's ``models/llama.py``: ``LlamaConfig`` and
``LLAMA_PRESETS`` carry over field for field (``dtype`` is a
``torch.dtype``), ``DecoderBlock`` and ``LlamaModel`` run the decode
modes.  Architecture per Llama-2: RMSNorm pre-norm, RoPE, SwiGLU FFN,
untied LM head, optional GQA; plus the Gemma and Qwen knobs.

The model holds a plain list of layers: the JAX package's scanned versus
unrolled layouts differ only in its parameter tree, which
``convert.params_from_flax`` flattens (so ``scan_layers`` is not a field
here).  The training-only fields (remat, sequence and pipeline
parallelism, LoRA) come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from tensorflow_train_distributed_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32_000
    d_model: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None → MHA (llama-2-7b)
    ffn_size: int = 11_008
    max_positions: int = 4096
    rope_base: float = 10_000.0
    rms_epsilon: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Sliding-window attention / StreamingLLM sinks: generate()-only in
    # the JAX package; the serving engine refuses them.
    sliding_window: Optional[int] = None
    attention_sinks: int = 0
    # int8 KV cache: rows store int8 with one f32 scale per
    # (row, kv_head) (layers._quantize_kv_rows).
    kv_cache_int8: bool = False
    # One fused qkv projection instead of three (a different param tree).
    fused_qkv: bool = False
    # q/k/v projection biases, out-proj unbiased (Qwen2 convention).
    qkv_bias: bool = False
    # Gemma knobs: decoupled head_dim (None = d_model / num_heads),
    # sqrt(d_model) embedding scale, GeGLU ("gelu", tanh) vs SwiGLU
    # ("silu"), zero-centered norm scales.
    head_dim: Optional[int] = None
    embed_scale: bool = False
    mlp_activation: str = "silu"
    norm_zero_centered: bool = False
    # Llama-3.x RoPE scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_positions); None = plain RoPE.
    rope_scaling: Optional[tuple] = None

    def __post_init__(self):
        if self.mlp_activation not in ("silu", "gelu"):
            raise ValueError(
                f"mlp_activation must be 'silu' (SwiGLU) or 'gelu' "
                f"(GeGLU, tanh approximation), got "
                f"{self.mlp_activation!r}")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def attn_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


LLAMA_PRESETS = {
    "llama2_7b": LlamaConfig(),
    "mistral_7b": LlamaConfig(num_kv_heads=8, ffn_size=14_336,
                              max_positions=32_768, rope_base=1e6,
                              sliding_window=4096),
    "qwen25_7b": LlamaConfig(vocab_size=152_064, d_model=3584,
                             num_layers=28, num_heads=28,
                             num_kv_heads=4, ffn_size=18_944,
                             max_positions=32_768, rope_base=1e6,
                             rms_epsilon=1e-6, qkv_bias=True),
    "gemma_2b": LlamaConfig(vocab_size=256_000, d_model=2048,
                            num_layers=18, num_heads=8, num_kv_heads=1,
                            head_dim=256, ffn_size=16_384,
                            max_positions=8192, rms_epsilon=1e-6,
                            embed_scale=True, mlp_activation="gelu",
                            norm_zero_centered=True),
    "gemma_7b": LlamaConfig(vocab_size=256_000, d_model=3072,
                            num_layers=28, num_heads=16,
                            num_kv_heads=16, head_dim=256,
                            ffn_size=24_576, max_positions=8192,
                            rms_epsilon=1e-6, embed_scale=True,
                            mlp_activation="gelu",
                            norm_zero_centered=True),
    "llama31_8b": LlamaConfig(vocab_size=128_256, num_layers=32,
                              num_heads=32, num_kv_heads=8,
                              ffn_size=14_336, max_positions=131_072,
                              rope_base=500_000.0,
                              rope_scaling=(8.0, 1.0, 4.0, 8192)),
    "llama2_13b": LlamaConfig(d_model=5120, num_layers=40, num_heads=40,
                              ffn_size=13_824),
    "llama_1b": LlamaConfig(d_model=2048, num_layers=16, num_heads=16,
                            ffn_size=5504),
    "llama_350m": LlamaConfig(d_model=1024, num_layers=24, num_heads=16,
                              ffn_size=2816, max_positions=2048),
    "llama_125m": LlamaConfig(d_model=768, num_layers=12, num_heads=12,
                              ffn_size=2048, max_positions=2048),
    "llama_tiny": LlamaConfig(vocab_size=256, d_model=64, num_layers=2,
                              num_heads=4, num_kv_heads=2, ffn_size=128,
                              max_positions=128, dtype=torch.float32),
    # The JAX preset differs from llama_tiny only in its scanned
    # parameter tree.
    "llama_tiny_scan": LlamaConfig(vocab_size=256, d_model=64, num_layers=2,
                                   num_heads=4, num_kv_heads=2, ffn_size=128,
                                   max_positions=128, dtype=torch.float32),
    "llama_tiny_pp": LlamaConfig(vocab_size=256, d_model=64, num_layers=4,
                                 num_heads=4, num_kv_heads=2, ffn_size=128,
                                 max_positions=128, dtype=torch.float32),
}


class DecoderBlock(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then x + mlp(norm(x))."""

    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        cfg = config
        norm = dict(epsilon=cfg.rms_epsilon, dtype=cfg.dtype,
                    zero_centered=cfg.norm_zero_centered, device=device)
        self.attn_norm = L.RMSNorm(cfg.d_model, **norm)
        self.attention = L.MultiHeadAttention(
            cfg.d_model, cfg.num_heads, cfg.attn_head_dim, cfg.num_kv_heads,
            dtype=cfg.dtype, kv_cache_int8=cfg.kv_cache_int8,
            fused_qkv=cfg.fused_qkv, qkv_bias=cfg.qkv_bias, device=device)
        self.mlp_norm = L.RMSNorm(cfg.d_model, **norm)
        self.mlp = L.MlpBlock(cfg.d_model, cfg.ffn_size, dtype=cfg.dtype,
                              activation=cfg.mlp_activation, device=device)

    def forward(self, x, layer_cache: dict, cache: L.KVCache, *,
                positions, rope):
        h = self.attn_norm(x)
        x = x + self.attention(h, layer_cache, cache, positions=positions,
                               rope=rope)
        return x + self.mlp(self.mlp_norm(x))


class LlamaModel(nn.Module):
    """Decoder over a ``layers.KVCache``: ``model(tokens [B, S], cache)``
    appends the tokens at each row's ``cache.index``, returns logits
    [B, S, vocab] in ``config.dtype`` and advances the index by S."""

    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.token_embed = L.Embed(cfg.vocab_size, cfg.d_model,
                                   dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, device=device) for _ in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(
            cfg.d_model, epsilon=cfg.rms_epsilon, dtype=cfg.dtype,
            zero_centered=cfg.norm_zero_centered, device=device)
        self.lm_head = L.Dense(cfg.d_model, cfg.vocab_size, dtype=cfg.dtype,
                               device=device)

    def forward(self, tokens: torch.Tensor, cache: L.KVCache) -> torch.Tensor:
        cfg = self.config
        x = self.token_embed(tokens)
        if cfg.embed_scale:
            # Gemma input normalizer, the constant rounded to x's dtype.
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        positions = cache.index[:, None] + torch.arange(
            tokens.shape[1], device=tokens.device)
        rope = L.rope_sin_cos(positions, cfg.attn_head_dim,
                              base=cfg.rope_base, scaling=cfg.rope_scaling)
        for layer, lc in zip(self.layers, cache.layers):
            x = layer(x, lc, cache, positions=positions, rope=rope)
        cache.index += tokens.shape[1]
        return self.lm_head(self.final_norm(x))

    def init_cache(self, batch: int, cache_len: int, *, paged_blocks: int = 0,
                   block_size: int = 0, device=None) -> L.KVCache:
        """Zeroed cache: linear ([batch, cache_len] rows per layer) or,
        with ``paged_blocks`` (scratch block 0 included), a pool of
        ``paged_blocks`` blocks of ``block_size`` rows plus a
        [batch, ceil(cache_len / block_size)] table pointing at scratch."""
        cfg = self.config
        device = device if device is not None else self.lm_head.kernel.device
        kvh, hd = cfg.kv_heads, cfg.attn_head_dim
        dt = torch.int8 if cfg.kv_cache_int8 else cfg.dtype

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=device)

        layers = []
        for _ in range(cfg.num_layers):
            if paged_blocks:
                lc = {"key_pool": zeros(paged_blocks, block_size, kvh, hd),
                      "value_pool": zeros(paged_blocks, block_size, kvh, hd)}
                if cfg.kv_cache_int8:
                    lc["kv_pool_scales"] = zeros(
                        2, paged_blocks, block_size, kvh, dtype=torch.float32)
            else:
                lc = {"key_cache": zeros(batch, cache_len, kvh, hd),
                      "value_cache": zeros(batch, cache_len, kvh, hd)}
                if cfg.kv_cache_int8:
                    lc["kv_scales"] = zeros(2, batch, cache_len, kvh,
                                            dtype=torch.float32)
            layers.append(lc)
        table = None
        if paged_blocks:
            if paged_blocks < 2 or block_size < 1:
                raise ValueError("a paged cache needs >= 2 blocks (block 0 "
                                 "is scratch) of >= 1 row")
            table = zeros(batch, -(-cache_len // block_size),
                          dtype=torch.int32)
        return L.KVCache(layers=layers,
                         index=zeros(batch, dtype=torch.int32),
                         cache_len=cache_len, block_table=table)
