"""BERT masked-LM pretraining: the counterpart of the JAX package's
``models/bert.py``.

Post-LN encoder with learned positions, full (non-causal) self-attention
through the kernel dispatch (the flash kernel on CUDA at S % 128 == 0),
the plain GELU FFN, and the MLM head: dense transform, GELU, LayerNorm,
tied-embedding logits plus ``mlm_bias``.  The HF compatibility knobs
(``attention_bias``, ``type_vocab_size``, ``embed_layer_norm``,
``exact_gelu``, ``attention_dropout_rate``) and ``remat`` carry over; the
encoder computes in ``config.dtype`` (f32 by default, as the JAX config,
whose parameters the mixed-precision policy still rounds to bf16).
Names match flax's (``token_embed``, ``pos_embedding``,
``layer_{i}/attention/query``, ...; the layers are ``layers.{i}``, as
``convert`` maps ``layer_{i}``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.ops.losses import (
    fold_sample_weight,
    softmax_cross_entropy,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 512
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32
    attention_bias: bool = False
    type_vocab_size: int = 0
    embed_layer_norm: bool = False
    layer_norm_eps: float = 1e-6
    exact_gelu: bool = False
    attention_dropout_rate: Optional[float] = None
    remat: bool = False


BERT_PRESETS = {
    "bert_base": BertConfig(),
    "bert_large": BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                             intermediate_size=4096),
    "bert_tiny": BertConfig(vocab_size=256, hidden_size=32, num_layers=2,
                            num_heads=2, intermediate_size=64,
                            max_positions=64, dropout_rate=0.0),
}


def _gelu(cfg: BertConfig) -> str:
    return "gelu_exact" if cfg.exact_gelu else "gelu"


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        d = cfg.hidden_size
        attn_dropout = (cfg.dropout_rate if cfg.attention_dropout_rate is None
                        else cfg.attention_dropout_rate)
        self.attention = L.MultiHeadAttention(
            d, cfg.num_heads, d // cfg.num_heads, dtype=cfg.dtype,
            causal=False, use_rope=False, use_bias=cfg.attention_bias,
            dropout_rate=attn_dropout, device=device)
        self.attn_ln = L.LayerNorm(d, epsilon=cfg.layer_norm_eps,
                                   dtype=cfg.dtype, device=device)
        self.mlp = L.MlpBlock(d, cfg.intermediate_size, dtype=cfg.dtype,
                              activation=_gelu(cfg), gated=False,
                              dropout_rate=cfg.dropout_rate, device=device)
        self.mlp_ln = L.LayerNorm(d, epsilon=cfg.layer_norm_eps,
                                  dtype=cfg.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn_ln(x + self.attention(x))
        return self.mlp_ln(x + self.mlp(x))


class BertEncoder(L._Leaf):
    """``model(input_ids [B, S], token_type_ids=None)`` → MLM logits
    [B, S, vocab] in ``config.dtype``."""

    def __init__(self, config: BertConfig = BertConfig(), *, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        d = cfg.hidden_size
        self.token_embed = L.Embed(cfg.vocab_size, d, dtype=cfg.dtype,
                                   device=device)
        self.pos_embedding = nn.Parameter(
            torch.empty(cfg.max_positions, d, device=device))
        if cfg.type_vocab_size:
            self.type_embedding = nn.Parameter(
                torch.empty(cfg.type_vocab_size, d, device=device))
        if cfg.embed_layer_norm:
            self.embed_ln = L.LayerNorm(d, epsilon=cfg.layer_norm_eps,
                                        dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.mlm_transform = L.Dense(d, d, use_bias=True, dtype=cfg.dtype,
                                     device=device)
        self.mlm_ln = L.LayerNorm(d, epsilon=cfg.layer_norm_eps,
                                  dtype=cfg.dtype, device=device)
        self.mlm_bias = nn.Parameter(torch.empty(cfg.vocab_size,
                                                 device=device))

    def init_spec(self) -> dict:
        spec = {"pos_embedding": ("normal", 0.02), "mlm_bias": ("fill", 0.0)}
        if self.config.type_vocab_size:
            spec["type_embedding"] = ("normal", 0.02)
        return spec

    def forward(self, input_ids: torch.Tensor, *,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg = self.config
        x = self.token_embed(input_ids)
        x = x + self._cast(self.pos_embedding)[None, :input_ids.shape[1]].to(
            cfg.dtype)
        if cfg.type_vocab_size:
            if token_type_ids is None:            # single-segment default
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self._cast(self.type_embedding).to(cfg.dtype)[
                token_type_ids]
        if cfg.embed_layer_norm:
            x = self.embed_ln(x)
        for layer in self.layers:
            if cfg.remat and self.training and torch.is_grad_enabled():
                x = L.checkpoint_with_dropout(layer, x)
            else:
                x = layer(x)
        h = self.mlm_ln(L._ACTIVATIONS[_gelu(cfg)](self.mlm_transform(x)))
        return self.token_embed.attend(h) + self._cast(self.mlm_bias).to(
            cfg.dtype)


class BertMlmTask:
    """Masked-LM objective over ``SyntheticMLM`` batches (``input_ids``,
    ``labels``, ``mask_weights`` and optionally ``token_type_ids``,
    ``sample_weight``).  Dropout is on in the model's training mode."""

    report_perplexity = True   # evaluate() adds exp(mean masked loss)

    def __init__(self, config: BertConfig = BertConfig(), *, device=None):
        self.config = config
        self.model = BertEncoder(config, device=device)

    def loss_fn(self, batch: dict):
        logits = self.model(batch["input_ids"],
                            token_type_ids=batch.get("token_type_ids")
                            ).float()
        weights = fold_sample_weight(batch, batch["labels"].shape,
                                     batch["mask_weights"])
        loss, acc = softmax_cross_entropy(logits, batch["labels"],
                                          weights=weights)
        # Unclamped, so an all-pad batch weighs 0 in the accumulation.
        return loss, {"mlm_accuracy": acc, "loss_weight": weights.sum()}

    def predict_fn(self, batch: dict) -> torch.Tensor:
        """MLM logits."""
        return self.model(batch["input_ids"],
                          token_type_ids=batch.get("token_type_ids"))

