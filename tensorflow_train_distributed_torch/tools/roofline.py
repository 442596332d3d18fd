"""The port's roofline and utilization formulas: one home for the kernel
bounds, the decode byte bound and the MFU of every model family
(``PERF.md`` §2), read by the bench tools and ``chip_smoke.py``.

The peaks are the H100's from ``training/memory.py``.  A bound is the
least time the card could take for a piece of work: the larger of its
bytes over the HBM rate and its operations over the peak for their type.
MFU counts the model's FLOPs (2 a multiply-add, 6 a parameter and token
for forward and backward, Kaplan et al. 2020), never remat's recompute:

- decoders: (6 (N - V d) + 6 L S d) a token: the embedding's gather does
  no products; attention 4 S d a token and layer forward, x3 backward,
  halved by the causal mask; a sliding window at its mean visible keys;
- an MoE at its active parameters: (6 (N_dense + N_expert k / E) +
  12 L d S / 2) a token (the embedding counted, as the JAX tool counts
  it; never all E experts);
- BERT: (6 N_non_embedding + 12 L S d) a token (full attention);
- Transformer-big: (6 N_non_embedding + 6 d V + 12 S d (L_enc + 1.5
  L_dec)) a token (the tied logits; the decoder's causal self-attention
  and its cross-attention);
- ResNet-50: 3 x 8.18 GFLOP an image (2 x 4.09 G multiply-adds forward);
- ViT: 3 x its forward (``vit_forward_flops``);
- LoRA: (4 N_non_embedding + 8 L S d) a token (forward and the input
  gradient; the frozen weights take no weight gradient).

Decode's floor is ``decode_bytes_per_step``.  Every function here is
host arithmetic on shapes: no import of torch at module level, no card.
"""

from __future__ import annotations

import math

from tensorflow_train_distributed_torch.training.memory import H100

HBM_BYTES_PER_S = H100["hbm_bytes_per_sec"]
PEAK_BF16_FLOPS = H100["tflops"]["bf16"] * 1e12    # dense tensor-core bf16
PEAK_F32_FLOPS = H100["tflops"]["f32"] * 1e12      # outside the tensor cores
# f32 products as bf16 products of an exact split into hi, mid and lo
# terms: K6's "wgmma" body splits its one f32 operand, three products an
# f32 product (hi.b + mid.b + lo.b); K2's and K7's "split" body splits
# both, six (lo.hi + mid.mid + hi.lo + mid.hi + hi.mid + hi.hi).
PEAK_F32_SPLIT_FLOPS = PEAK_BF16_FLOPS / 3
ATTENTION_SPLIT_PRODUCTS = 6

# ResNet-50's forward: 4.09 G multiply-adds an image at 224 x 224.
RESNET50_FWD_FLOPS = 2 * 4.09e9

FORMULAS = {
    "decoder": "(6 (N - V d) + 6 L S d) tokens / step_s / 989e12",
    "moe": "(6 (N_dense + N_expert k / E) + 12 L d S / 2) tokens"
           " / step_s / 989e12",
    "bert": "(6 N_non_embedding + 12 L S d) B S / step_s / peak",
    "transformer": "(6 N_non_embedding + 6 d V + 12 S d (L_enc + "
                   "1.5 L_dec)) B S / step_s / peak",
    "resnet50": "3 x 2 x 4.09e9 x B / step_s / 989e12",
    "vit": "3 x forward FLOPs x images/s / 989e12",
    "lora": "(4 N_non_embedding + 8 L S d) tokens / step_s / 989e12",
    "decode_mbu": "decode_bytes_per_step x steps/s / 3.35e12",
}


def bound(nbytes: float, flops: float, peak_flops: float):
    """(least ms, "bytes" or "operations"): the larger of ``nbytes`` over
    the HBM rate and ``flops`` over ``peak_flops``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def product_bound(nbytes: float, flops: float, f32: bool,
                  products: int = 3):
    """The bound of work that is products (attention, grouped matmuls):
    bf16 on the tensor cores, f32 as the ``products`` bf16 products of an
    exact split that the split bodies run for each f32 product (K6: 3;
    K2's and K7's f32 body: ATTENTION_SPLIT_PRODUCTS), so at that many
    times the bf16 operations.  Returns it and, for f32, the FMA route's
    bound at 67 TFLOP/s (None for bf16), logged beside it."""
    if not f32:
        return bound(nbytes, flops, PEAK_BF16_FLOPS), None
    return (bound(nbytes, products * flops, PEAK_BF16_FLOPS),
            bound(nbytes, flops, PEAK_F32_FLOPS))


def _itemsize(dtype) -> int:
    import torch

    return torch.empty((), dtype=dtype).element_size()


def decode_bytes_per_step(cfg, params, scales, slots: int,
                          context: float) -> dict:
    """Least bytes one decode step of ``slots`` lanes reads: every weight
    but the embedding (its ``slots`` rows) and the routed experts, plus
    the experts the step runs, plus the KV rows of ``context`` positions a
    lane.  The gmm dispatch runs the experts some token routed to, here
    their expected count under uniform routing (E (1 - (1 - k/E)^T) for T
    tokens); the dense dispatch runs all E; a dense decoder has none.
    int8 kernels count one byte a weight and their f32 scales four a
    channel (``quantized_bytes``); an int8 KV cache one byte an element
    and an f32 scale a row and kv head."""
    from tensorflow_train_distributed_torch.models.quant import (
        quantized_bytes,
    )

    def nbytes(keep):
        return quantized_bytes({k: v for k, v in params.items()
                                if keep(k)}) + quantized_bytes(
            {k: v for k, v in (scales or {}).items() if keep(k)})

    expert = nbytes(lambda k: ".experts." in k)
    emb = params["token_embed.embedding"]
    rest = nbytes(lambda k: ".experts." not in k and "token_embed" not in k)
    e = getattr(cfg, "num_experts", 0)
    if e:
        k = cfg.top_k
        live = e * (1 - (1 - k / e) ** slots) if cfg.dispatch == "gmm" else e
        run = expert * live / e
    else:
        live, run = 0, 0
    if cfg.kv_cache_int8:
        row = cfg.attn_head_dim + 4            # int8 elements, f32 scale
    else:
        row = cfg.attn_head_dim * _itemsize(cfg.dtype)
    kv = cfg.num_layers * 2 * cfg.kv_heads * row * context * slots
    total = rest + run + slots * emb.shape[1] * emb.element_size() + kv
    return dict(bytes=total, experts_run=live, expert_gb=expert / 1e9,
                other_weight_gb=rest / 1e9, kv_gb=kv / 1e9,
                bound_ms=total / HBM_BYTES_PER_S * 1e3)


def mean_visible_keys(seq: int, window=None) -> float:
    """Keys a query attends on average under the causal mask: S / 2, or
    under a sliding window of ``window`` keys the mean of min(i + 1, w)."""
    if not window or window >= seq:
        return seq / 2
    return sum(min(i + 1, window) for i in range(seq)) / seq


def decoder_flops_per_token(n_params: int, cfg, seq: int):
    """(FLOPs a token, formula) of a Llama-family decoder's training
    step at sequence ``seq``: 6 (N - V d) + 12 L d keys."""
    n_dense = n_params - cfg.vocab_size * cfg.d_model     # no embedding
    w = getattr(cfg, "sliding_window", None)
    keys = mean_visible_keys(seq, w)
    flops = 6 * n_dense + 12 * cfg.num_layers * cfg.d_model * keys
    if w and w < seq:
        formula = (f"(6 (N - V d) + 12 L d {keys:.1f}) tokens / step_s / "
                   f"989e12 ({keys:.1f} = mean visible keys)")
    else:
        formula = FORMULAS["decoder"]
    return flops, formula


def moe_active_params(named_numels, cfg) -> tuple:
    """(total, active) parameters of an MoE from ``{name: numel}``: the
    expert stacks (names with ``.experts.``) count k of E."""
    n_expert = sum(n for k, n in named_numels.items() if ".experts." in k)
    total = sum(named_numels.values())
    return total, total - n_expert + n_expert * cfg.top_k / cfg.num_experts


def moe_flops_per_token(active: float, cfg, seq: int) -> float:
    return 6 * active + 12 * cfg.num_layers * cfg.d_model * seq * 0.5


def bert_flops_per_token(n_non_embedding: int, cfg, seq: int) -> float:
    return 6 * n_non_embedding + 12 * cfg.num_layers * seq * cfg.hidden_size


def transformer_flops_per_token(n_non_embedding: int, cfg,
                                seq: int) -> float:
    d = cfg.d_model
    return (6 * n_non_embedding + 6 * d * cfg.vocab_size
            + 12 * seq * d * (cfg.num_encoder_layers
                              + 1.5 * cfg.num_decoder_layers))


def lora_flops_per_token(n_non_embedding: int, cfg, seq: int) -> float:
    return 4 * n_non_embedding + 8 * cfg.num_layers * seq * cfg.d_model


def vit_forward_flops(cfg) -> float:
    """FLOPs (2 per multiply-add) of one image's ViT forward: the patch
    projection, per block the q/k/v/out and MLP products over every token
    and the two attention products, and the head."""
    d, n = cfg.hidden_size, cfg.num_patches
    seq = n + (cfg.pooling == "cls")
    block = seq * (4 * d * d + 2 * d * cfg.mlp_dim) + 2 * seq * seq * d
    macs = (n * 3 * cfg.patch_size ** 2 * d + cfg.num_layers * block
            + d * cfg.num_classes)
    return 2.0 * macs


def non_embedding_params(cfg) -> int:
    """Parameters of ``cfg``'s model less its embedding tables (and
    BatchNorm's statistics, which are buffers)."""
    from tensorflow_train_distributed_torch import convert

    return sum(math.prod(shape) for name, shape in
               convert.expected_shapes(cfg).items()
               if not name.endswith(("embedding", "pos_embedding"))
               and "batch_stats" not in name)

