"""Llama-family decoder: training forward, serving (KV-cache) modes and
the causal-LM task.

Counterpart of the JAX package's ``models/llama.py``: ``LlamaConfig`` and
``LLAMA_PRESETS`` carry over field for field (``dtype`` is a
``torch.dtype``); ``LlamaModel`` runs the training forward
(``model(tokens, segment_ids=...)``, per-block rematerialisation) and the
decode modes (``model(tokens, cache)``); ``CausalLmTask`` holds the
next-token loss.  Architecture per Llama-2: RMSNorm pre-norm, RoPE,
SwiGLU FFN, untied LM head, optional GQA; plus the Gemma and Qwen knobs.

The model holds a plain list of layers: the JAX package's scanned versus
unrolled layouts differ only in its parameter tree, which
``convert.params_from_flax`` flattens (``scan_layers`` only names the
paths of the serving engine's KV wire manifest).  ``LlamaConfig.lora`` (a ``models.lora.LoraSpec``) builds the
model with rank-r adapters on the targeted projections and everything
else frozen (``lora.apply_lora``).

On a mesh (``set_mesh``, which the trainer calls): ``seq_parallel``
("ring" or "ulysses") attends across a ``seq`` axis above 1 through
``parallel.ring_attention`` (each rank holds S/n tokens of every row, its
RoPE positions global, given by the trainer); ``pipeline_microbatches``
under a ``pipeline`` axis above 1 keeps only this stage's L/S layers and
runs them in the GPipe schedule of ``parallel.pipeline``
(``_pipelined_blocks``).  Without those fields either axis runs the whole
model on every rank, as the JAX package's does.

Rematerialisation (``remat``, ``remat_policy``), as the JAX package's:

- "full": each block under ``torch.utils.checkpoint``, only its input
  saved; the backward runs the block's forward again;
- "dots": the same checkpoint with a selective policy that saves the
  outputs of the dense projections (``aten.mm``, the matmuls without
  batch dims: JAX's ``checkpoint_dots_with_no_batch_dims``) and
  recomputes everything else;
- "no_ffn": no block checkpoint; only the gated FFN is checkpointed
  (its input saved, its [B, S, ffn] hiddens recomputed), as JAX's
  ``wants_outer_remat`` and the inner nothing-saveable FFN region.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.ops.losses import (
    fold_sample_weight,
    softmax_cross_entropy,
)


REMAT_POLICIES = ("full", "dots", "no_ffn")


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
    # Rematerialisation in training: "full", "dots" or "no_ffn" (the
    # module docstring).
    remat: bool = True
    remat_policy: str = "full"
    # Sliding-window attention (Mistral) / StreamingLLM sinks: trained
    # through the splash kernel (K7), decoded by generate() over the
    # rolling ring; the serving engine refuses them, as the JAX one does.
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
    # LoRA fine-tuning (models.lora.LoraSpec): a frozen base and trainable
    # adapters on the targeted projections; None = full fine-tuning.
    lora: object = None
    # "ring" | "ulysses" | None: context parallelism over the seq mesh axis
    # (``set_mesh``).
    seq_parallel: Optional[str] = None
    # GPipe microbatch count: with a pipeline mesh axis above 1 the stack
    # runs the ``parallel.pipeline`` schedule, each stage holding L/S
    # layers (``set_mesh``).
    pipeline_microbatches: Optional[int] = None
    # The JAX package's layer layout (scanned or unrolled), as its preset
    # has it.  The port's model is one list of layers either way; the
    # field names the paths of the KV handoff's wire manifest
    # (``serving.ServingEngine._serialize_rows``).
    scan_layers: bool = True

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"Unknown remat_policy {self.remat_policy!r}; expected "
                f"one of {REMAT_POLICIES}")
        if self.mlp_activation not in ("silu", "gelu"):
            raise ValueError(
                f"mlp_activation must be 'silu' (SwiGLU) or 'gelu' "
                f"(GeGLU, tanh approximation), got "
                f"{self.mlp_activation!r}")
        if self.fused_qkv and self.lora is not None:
            attn = ({"query", "key", "value"}
                    & set(getattr(self.lora, "targets", ())))
            if attn:
                # One "qkv" module replaces the three: those targets would
                # match nothing, and the run would train no attention
                # adapter.
                raise ValueError(
                    f"fused_qkv replaces the q/k/v projections with one "
                    f"'qkv' module; LoRA targets {sorted(attn)} would "
                    "match nothing: fine-tune attention with "
                    "fused_qkv=False")

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
                              max_positions=128, dtype=torch.float32,
                              remat=False, scan_layers=False),
    # The JAX preset differs from llama_tiny in its scanned parameter tree
    # and in remat.
    "llama_tiny_scan": LlamaConfig(vocab_size=256, d_model=64, num_layers=2,
                                   num_heads=4, num_kv_heads=2, ffn_size=128,
                                   max_positions=128, dtype=torch.float32),
    "llama_tiny_pp": LlamaConfig(vocab_size=256, d_model=64, num_layers=4,
                                 num_heads=4, num_kv_heads=2, ffn_size=128,
                                 max_positions=128, dtype=torch.float32,
                                 pipeline_microbatches=4),
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
            fused_qkv=cfg.fused_qkv, qkv_bias=cfg.qkv_bias,
            window=cfg.sliding_window, sinks=cfg.attention_sinks,
            device=device)
        self.mlp_norm = L.RMSNorm(cfg.d_model, **norm)
        self.mlp = L.MlpBlock(cfg.d_model, cfg.ffn_size, dtype=cfg.dtype,
                              activation=cfg.mlp_activation, device=device)
        self.remat_ffn = cfg.remat and cfg.remat_policy == "no_ffn"

    def forward(self, x, layer_cache: Optional[dict],
                cache: Optional[L.KVCache], *, positions, rope,
                segment_ids=None):
        h = self.attn_norm(x)
        x = x + self.attention(h, layer_cache, cache, positions=positions,
                               rope=rope, segment_ids=segment_ids)
        h = self.mlp_norm(x)
        if self.remat_ffn and cache is None and torch.is_grad_enabled():
            return x + checkpoint(self.mlp, h, use_reentrant=False)
        return x + self.mlp(h)


def tensor_split(config: LlamaConfig, params: dict, n: int,
                 index: int) -> tuple:
    """Rank ``index``'s share of ``params`` under an ``n``-way tensor split
    of the serving forward (Megatron's layout): the config of a decoder
    with H/n query heads, KV/n kv heads and an ffn of F/n, and its
    weights.  q/k/v (and the fused qkv's three parts) and the FFN's gate
    and up projections keep their column blocks, the out and down
    projections their row blocks (each followed by a sum over the group:
    ``layers.set_tensor_parallel``), the token embedding its row block
    (``ops.embedding.sharded_lookup``); the norms and the LM head stay
    whole.  Refuses kv heads (and heads, ffn, vocab) that ``n`` does not
    divide: kv heads are not repeated across ranks."""
    cfg = config
    for what, size in (("heads", cfg.num_heads), ("kv heads", cfg.kv_heads),
                       ("ffn_size", cfg.ffn_size),
                       ("vocab_size", cfg.vocab_size)):
        if size % n:
            raise ValueError(
                f"tensor-split serving needs {what} ({size}) divisible by "
                f"the tensor axis ({n}); kv heads are not repeated")
    hd = cfg.attn_head_dim
    h, kv = cfg.num_heads // n, cfg.kv_heads // n
    local = dataclasses.replace(cfg, num_heads=h, num_kv_heads=kv,
                                ffn_size=cfg.ffn_size // n, head_dim=hd)

    def cols(t, width, offset=0):
        return t[..., offset + index * width:offset + (index + 1) * width]

    def rows(t, width):
        return t[index * width:(index + 1) * width]

    out = {}
    for k, t in params.items():
        leaf = k.rsplit(".", 2)
        mod = leaf[-2] if len(leaf) > 2 else ""
        if k == "token_embed.embedding":
            t = rows(t, cfg.vocab_size // n)
        elif ".attention." in k and mod == "query":
            t = cols(t, h * hd)
        elif ".attention." in k and mod in ("key", "value"):
            t = cols(t, kv * hd)
        elif ".attention." in k and mod == "qkv":
            qw, kw = cfg.num_heads * hd, cfg.kv_heads * hd
            t = torch.cat([cols(t, h * hd), cols(t, kv * hd, qw),
                           cols(t, kv * hd, qw + kw)], dim=-1)
        elif ".attention.out." in k and leaf[-1] == "kernel":
            t = rows(t, h * hd)
        elif ".mlp." in k and mod in ("wi_gate", "wi_up"):
            t = cols(t, cfg.ffn_size // n)
        elif ".mlp.wo." in k and leaf[-1] == "kernel":
            t = rows(t, cfg.ffn_size // n)
        out[k] = t.contiguous()
    return local, out


def segment_relative_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] segment ids → [B, S] positions restarting at each segment
    (what RoPE sees in a packed row: each document at 0..len-1)."""
    s = segment_ids.shape[-1]
    idx = torch.arange(s, device=segment_ids.device)
    restart = torch.cat(
        [torch.ones_like(segment_ids[..., :1], dtype=torch.bool),
         segment_ids[..., 1:] != segment_ids[..., :-1]], dim=-1)
    last_restart = torch.cummax(
        torch.where(restart, idx, torch.zeros_like(idx)), dim=-1).values
    return idx - last_restart


def _save_dense_projections(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of the matmuls without batch
    dims (every ``Dense``'s ``aten.mm``), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _save_dense_projections)


def wants_outer_remat(cfg: LlamaConfig) -> bool:
    """Whether each block is checkpointed whole ("full" and "dots");
    "no_ffn" checkpoints the FFN alone, inside the block."""
    return cfg.remat and cfg.remat_policy != "no_ffn"


class LlamaModel(nn.Module):
    """The decoder.  Training: ``model(tokens [B, S], segment_ids=...)``
    returns logits [B, S, vocab] in ``config.dtype``, each block
    rematerialised under ``config.remat``.  Decode: ``model(tokens,
    cache)`` over a ``layers.KVCache`` appends the tokens at each row's
    ``cache.index``, returns the logits and advances the index by S."""

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
        if cfg.lora is not None:
            from tensorflow_train_distributed_torch.models.lora import (
                apply_lora,
            )

            apply_lora(self, cfg.lora)
        # (group, stages, stage, microbatches) once ``set_mesh`` engages
        # the pipeline; ``seq_sharded`` once it engages seq parallelism.
        self.pipeline = None
        self.seq_sharded = False

    def set_mesh(self, mesh) -> None:
        """Lay the model out on ``mesh`` (the JAX ambient mesh's effect):
        ``seq_parallel`` under a ``seq`` axis above 1 sends every
        attention through ``parallel.ring_attention`` over the axis's
        group (the batch's [B, S] leaves then hold this rank's S/n
        tokens: ``seq_sharded``); ``pipeline_microbatches`` under a
        ``pipeline`` axis above 1 keeps this stage's layers alone (layer i
        on stage i // (L/S), the ``stage`` -> ``pipeline`` rule), each
        under its own name, and runs them in the GPipe schedule."""
        cfg = self.config
        if cfg.seq_parallel is not None and mesh.shape["seq"] > 1:
            L.set_seq_parallel(self, cfg.seq_parallel, mesh.group("seq"))
            self.seq_sharded = True
        n = mesh.shape["pipeline"]
        if cfg.pipeline_microbatches and n > 1:
            if cfg.num_layers % n:
                raise ValueError(
                    f"num_layers={cfg.num_layers} not divisible by the "
                    f"pipeline axis size {n}")
            stage, per = mesh.index("pipeline"), cfg.num_layers // n
            self.layers = nn.ModuleDict(
                (str(i), self.layers[i])
                for i in range(stage * per, (stage + 1) * per))
            self.pipeline = (mesh.group("pipeline"), n, stage,
                             cfg.pipeline_microbatches)

    def _pipelined_blocks(self, x, segment_ids, positions):
        """The decoder stack as the GPipe schedule over the pipeline
        group (the JAX ``_pipelined_blocks``).  Packed segment ids and
        positions ride each hop with the activation: at tick t stage s
        holds microbatch t - s, so side inputs cannot be indexed by the
        tick on later stages.  Outer remat wraps each layer as on the
        plain path."""
        from tensorflow_train_distributed_torch.parallel.pipeline import (
            pipeline_stages,
        )

        cfg = self.config
        group, _, _, m = self.pipeline
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch size {b} not divisible by "
                             f"num_microbatches={m}")
        layers = list(self.layers.values())
        extra = ({"context_fn": _DOTS_CONTEXT}
                 if cfg.remat_policy == "dots" else {})

        def stage_fn(_, carry):
            h, seg, pos = carry
            rope = L.rope_sin_cos(pos, cfg.attn_head_dim, base=cfg.rope_base,
                                  scaling=cfg.rope_scaling)
            for layer in layers:
                if wants_outer_remat(cfg) and torch.is_grad_enabled():
                    h = checkpoint(layer, h, None, None, positions=pos,
                                   rope=rope, segment_ids=seg,
                                   use_reentrant=False, **extra)
                else:
                    h = layer(h, None, None, positions=pos, rope=rope,
                              segment_ids=seg)
            return h, seg, pos

        def micro(t):
            return (None if t is None
                    else t.reshape(m, b // m, *t.shape[1:]))

        out, _, _ = pipeline_stages(
            stage_fn, None, (micro(x), micro(segment_ids), micro(positions)),
            group=group, unstack_params=False)
        return out.reshape(b, *out.shape[2:])

    def forward(self, tokens: torch.Tensor,
                cache: Optional[L.KVCache] = None, *,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        if cache is not None and (segment_ids is not None
                                  or positions is not None):
            raise ValueError("decode mode takes its positions from the "
                             "cache and no packed segments")
        x = self.token_embed(tokens)
        if cfg.embed_scale:
            # Gemma input normalizer, the constant rounded to x's dtype.
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        if cache is not None and cache.shared:
            positions = (cache.index + torch.arange(
                tokens.shape[1], device=tokens.device)).expand(tokens.shape)
        elif cache is not None:
            positions = cache.index[:, None] + torch.arange(
                tokens.shape[1], device=tokens.device)
        elif positions is None:
            if segment_ids is not None:
                positions = segment_relative_positions(segment_ids)
            else:
                positions = torch.arange(
                    tokens.shape[1], device=tokens.device).expand(
                        tokens.shape)
        if self.pipeline is not None:
            if cache is not None:
                raise ValueError(
                    "decode mode does not run under a pipeline mesh; "
                    "generate outside the pipeline strategy")
            x = self._pipelined_blocks(x, segment_ids, positions)
            return self.lm_head(self.final_norm(x))
        rope = L.rope_sin_cos(positions, cfg.attn_head_dim,
                              base=cfg.rope_base, scaling=cfg.rope_scaling)
        if cache is not None:
            for layer, lc in zip(self.layers, cache.layers):
                x = layer(x, lc, cache, positions=positions, rope=rope)
            cache.index += tokens.shape[1]
            cache.fresh = False
        else:
            extra = ({"context_fn": _DOTS_CONTEXT}
                     if cfg.remat_policy == "dots" else {})
            for layer in self.layers:
                if wants_outer_remat(cfg) and torch.is_grad_enabled():
                    x = checkpoint(layer, x, None, None, positions=positions,
                                   rope=rope, segment_ids=segment_ids,
                                   use_reentrant=False, **extra)
                else:
                    x = layer(x, None, None, positions=positions, rope=rope,
                              segment_ids=segment_ids)
        return self.lm_head(self.final_norm(x))

    def init_cache(self, batch: int, cache_len: int, *, paged_blocks: int = 0,
                   block_size: int = 0, shared: bool = False,
                   device=None) -> L.KVCache:
        """Zeroed cache: linear ([batch, cache_len] rows per layer, one
        position per row) or, with ``paged_blocks`` (scratch block 0
        included), a pool of ``paged_blocks`` blocks of ``block_size`` rows
        plus a [batch, ceil(cache_len / block_size)] table pointing at
        scratch.  ``shared``: the shared-index cache of ``generate()`` —
        one position for every row; a ring of ``sliding_window`` rows
        where the window is shorter than ``cache_len``, with sink buffers
        for ``attention_sinks`` (``layers.shared_cache_rows``)."""
        cfg = self.config
        device = device if device is not None else self.lm_head.kernel.device
        kvh, hd = cfg.kv_heads, cfg.attn_head_dim
        dt = torch.int8 if cfg.kv_cache_int8 else cfg.dtype

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=device)

        if shared:
            rows, rolling = L.shared_cache_rows(
                cfg.sliding_window, cfg.attention_sinks, cfg.kv_cache_int8,
                cache_len)
            layers = []
            for _ in range(cfg.num_layers):
                lc = {"key_cache": zeros(batch, rows, kvh, hd),
                      "value_cache": zeros(batch, rows, kvh, hd)}
                if cfg.kv_cache_int8:
                    lc["kv_scales"] = zeros(2, batch, rows, kvh,
                                            dtype=torch.float32)
                if rolling and cfg.attention_sinks:
                    for name in ("sink_key", "sink_value"):
                        lc[name] = zeros(batch, cfg.attention_sinks, kvh, hd,
                                         dtype=cfg.dtype)
                layers.append(lc)
            return L.KVCache(layers=layers, index=0, cache_len=cache_len,
                             shared=True, fresh=True)

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


class CausalLmTask:
    """Next-token objective over ``SyntheticLM`` batches (the JAX
    ``CausalLmTask``): ``loss_fn`` and ``predict_fn`` on the model this
    task holds.  ``device="meta"`` builds it without storage, for weights
    loaded later (``Trainer.create_state``)."""

    report_perplexity = True   # evaluate() adds exp(mean loss)

    def __init__(self, config: LlamaConfig, *, device=None):
        self.config = config
        self.model = LlamaModel(config, device=device)

    def loss_fn(self, batch: dict):
        """(mean loss, metrics) of one batch: ``tokens``, ``targets``
        [B, S] and optionally ``segment_ids``, ``positions`` (a
        sequence-sharded batch's global ones), ``loss_weights``,
        ``sample_weight``."""
        logits = self.model(batch["tokens"],
                            segment_ids=batch.get("segment_ids"),
                            positions=batch.get("positions")).float()
        weights = fold_sample_weight(batch, batch["targets"].shape,
                                     batch.get("loss_weights"))
        loss, acc = softmax_cross_entropy(logits, batch["targets"],
                                          weights=weights)
        metrics = {"accuracy": acc}
        if weights is not None:
            metrics["loss_weight"] = weights.sum()
        return loss, metrics

    def predict_fn(self, batch: dict) -> torch.Tensor:
        """Next-token logits (``positions``: a sequence-sharded batch's
        global ones)."""
        return self.model(batch["tokens"],
                          segment_ids=batch.get("segment_ids"),
                          positions=batch.get("positions"))
