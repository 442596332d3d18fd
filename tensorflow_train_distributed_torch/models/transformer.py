"""Transformer encoder-decoder for WMT (counterpart of the JAX package's
``models/transformer.py``): pre-LN encoder and decoder, sinusoidal
positions scaled by sqrt(d_model), a shared tied embedding, label
smoothing 0.1 ("big": 6 + 6 layers, d_model 1024, 16 heads, FFN 4096).

Attention goes through the kernel dispatch: the encoder's and the
cross-attention full, the decoder's causal, each on the flash kernel on
CUDA where the lengths are equal multiples of 128.

``greedy_translate`` and ``beam_translate`` keep the JAX decoders'
semantics: the encoder runs once, and at every position the whole
decoder reruns over the fixed ``max_len`` target buffer (causal attention
makes position i's logits depend on the filled prefix only).  Eager loops
over positions replace ``fori_loop``, with the same buffer and step
order, so the tokens match; the beam's top-k is a stable descending
sort, which breaks ties toward the lower index as ``lax.top_k`` does.
Names match flax's (``shared_embed``, ``enc_{i}/LayerNorm_0``,
``dec_{i}/cross_attention``, ``enc_norm``, ...).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.ops.losses import (
    fold_sample_weight,
    softmax_cross_entropy,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 1024
    num_heads: int = 16
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    ffn_size: int = 4096
    max_positions: int = 1024
    dropout_rate: float = 0.1
    label_smoothing: float = 0.1
    dtype: torch.dtype = torch.float32
    remat: bool = False


TRANSFORMER_PRESETS = {
    "transformer_big": TransformerConfig(),
    "transformer_base": TransformerConfig(d_model=512, num_heads=8,
                                          ffn_size=2048),
    "transformer_tiny": TransformerConfig(
        vocab_size=256, d_model=32, num_heads=2, num_encoder_layers=2,
        num_decoder_layers=2, ffn_size=64, max_positions=128,
        dropout_rate=0.0),
}


def _attention(cfg: TransformerConfig, causal: bool, device):
    return L.MultiHeadAttention(
        cfg.d_model, cfg.num_heads, cfg.d_model // cfg.num_heads,
        dtype=cfg.dtype, causal=causal, use_rope=False,
        dropout_rate=cfg.dropout_rate, device=device)


def _ln(cfg: TransformerConfig, device):
    return L.LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)


def _mlp(cfg: TransformerConfig, device):
    return L.MlpBlock(cfg.d_model, cfg.ffn_size, dtype=cfg.dtype,
                      activation="gelu", gated=False,
                      dropout_rate=cfg.dropout_rate, device=device)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.LayerNorm_0 = _ln(cfg, device)
        self.self_attention = _attention(cfg, False, device)
        self.LayerNorm_1 = _ln(cfg, device)
        self.mlp = _mlp(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attention(self.LayerNorm_0(x))
        return x + self.mlp(self.LayerNorm_1(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.LayerNorm_0 = _ln(cfg, device)
        self.self_attention = _attention(cfg, True, device)
        self.LayerNorm_1 = _ln(cfg, device)
        self.cross_attention = _attention(cfg, False, device)
        self.LayerNorm_2 = _ln(cfg, device)
        self.mlp = _mlp(cfg, device)

    def forward(self, y: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        y = y + self.self_attention(self.LayerNorm_0(y))
        y = y + self.cross_attention(self.LayerNorm_1(y), x_kv=enc)
        return y + self.mlp(self.LayerNorm_2(y))


class Seq2SeqTransformer(nn.Module):
    """``model(inputs [B, S], targets_in [B, T])`` → logits [B, T, vocab]
    in ``config.dtype``; ``encode`` and ``decode`` separately."""

    def __init__(self, config: TransformerConfig = TransformerConfig(), *,
                 device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.shared_embed = L.Embed(cfg.vocab_size, cfg.d_model,
                                    dtype=cfg.dtype, device=device)
        # Not a parameter: made here (on the host), moved on first use.
        self.register_buffer("pos_table", torch.from_numpy(
            L.sinusoidal_positions(cfg.max_positions, cfg.d_model)),
            persistent=False)
        for i in range(cfg.num_encoder_layers):
            setattr(self, f"enc_{i}", EncoderLayer(cfg, device=device))
        for i in range(cfg.num_decoder_layers):
            setattr(self, f"dec_{i}", DecoderLayer(cfg, device=device))
        self.enc_norm = _ln(cfg, device)
        self.dec_norm = _ln(cfg, device)

    def _pos(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.tensor(self.config.d_model, dtype=torch.float32) ** 0.5
        if self.pos_table.device != x.device:
            self.pos_table = self.pos_table.to(x.device)
        table = self.pos_table[:x.shape[1]].to(x.dtype)
        return x * scale.to(x.dtype).item() + table[None]

    def _run(self, layer, *args):
        if self.config.remat and self.training and torch.is_grad_enabled():
            return L.checkpoint_with_dropout(layer, *args)
        return layer(*args)

    def encode(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self._pos(self.shared_embed(inputs))
        for i in range(self.config.num_encoder_layers):
            x = self._run(getattr(self, f"enc_{i}"), x)
        return self.enc_norm(x)

    def decode(self, targets_in: torch.Tensor,
               enc: torch.Tensor) -> torch.Tensor:
        y = self._pos(self.shared_embed(targets_in))
        for i in range(self.config.num_decoder_layers):
            y = self._run(getattr(self, f"dec_{i}"), y, enc)
        return self.shared_embed.attend(self.dec_norm(y))   # tied softmax

    def forward(self, inputs: torch.Tensor,
                targets_in: torch.Tensor) -> torch.Tensor:
        return self.decode(targets_in, self.encode(inputs))


class Seq2SeqTask:
    """WMT-style objective over ``SyntheticWMT`` batches (``inputs``,
    ``targets_in``, ``targets_out``, optionally ``sample_weight``)."""

    def __init__(self, config: TransformerConfig = TransformerConfig(), *,
                 device=None):
        self.config = config
        self.model = Seq2SeqTransformer(config, device=device)

    def loss_fn(self, batch: dict):
        logits = self.model(batch["inputs"], batch["targets_in"]).float()
        weights = fold_sample_weight(batch, batch["targets_out"].shape)
        loss, acc = softmax_cross_entropy(
            logits, batch["targets_out"],
            label_smoothing=self.config.label_smoothing, weights=weights)
        metrics = {"accuracy": acc}
        if weights is not None:
            metrics["loss_weight"] = weights.sum()
        return loss, metrics


@torch.no_grad()
def greedy_translate(model: Seq2SeqTransformer, inputs: torch.Tensor, *,
                     max_len: int, bos_id: int, eos_id: int,
                     pad_id: int = 0) -> torch.Tensor:
    """Greedy decoding: [B, S] source ids → [B, max_len] int32 targets
    (BOS excluded; ``pad_id`` after the first EOS).  Runs ``model`` as it
    is: the caller puts it in eval mode."""
    enc = model.encode(inputs)
    b = inputs.shape[0]
    dev = inputs.device
    ys = torch.full((b, max_len + 1), pad_id, dtype=torch.int32, device=dev)
    ys[:, 0] = bos_id
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(max_len):
        logits = model.decode(ys[:, :-1], enc)
        nxt = torch.argmax(logits[:, i].float(), dim=-1)
        nxt = torch.where(finished, pad_id, nxt).to(torch.int32)
        ys[:, i + 1] = nxt
        finished = finished | (nxt == eos_id)
    return ys[:, 1:]


@torch.no_grad()
def beam_translate(model: Seq2SeqTransformer, inputs: torch.Tensor, *,
                   max_len: int, beam_size: int = 4, bos_id: int,
                   eos_id: int, pad_id: int = 0,
                   length_alpha: float = 0.6) -> torch.Tensor:
    """Beam search: [B, S] sources → [B, max_len] int32 targets, the JAX
    single-buffer variant: beams ride the batch ([B, K] folded to B·K), a
    finished beam extends only with ``pad_id`` at zero cost, and each
    row's winner maximises cumulative log-prob over the GNMT length
    penalty ((5 + l) / 6)^alpha.  ``beam_size`` 1 is greedy."""
    b, k = inputs.shape[0], beam_size
    dev = inputs.device
    vocab = model.config.vocab_size
    enc = model.encode(inputs).repeat_interleave(k, dim=0)
    ys = torch.full((b, k, max_len + 1), pad_id, dtype=torch.int32,
                    device=dev)
    ys[:, :, 0] = bos_id
    neg_inf = -1e9
    scores = torch.tensor([0.0] + [neg_inf] * (k - 1), dtype=torch.float32,
                          device=dev).repeat(b, 1)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, k), dtype=torch.int32, device=dev)
    pad_only = torch.full((vocab,), neg_inf, dtype=torch.float32,
                          device=dev)
    pad_only[pad_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None]
    for i in range(max_len):
        logits = model.decode(ys.reshape(b * k, -1)[:, :-1], enc)
        logp = torch.log_softmax(logits[:, i].float(), dim=-1).reshape(
            b, k, vocab)
        logp = torch.where(finished[:, :, None], pad_only, logp)
        cand = (scores[:, :, None] + logp).reshape(b, k * vocab)
        top, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        beam_idx, tok = idx // vocab, (idx % vocab).to(torch.int32)
        ys = ys[rows, beam_idx]
        ys[:, :, i + 1] = tok
        was_done = finished[rows, beam_idx]
        lengths = lengths[rows, beam_idx]
        lengths = torch.where(was_done, lengths, lengths + 1)
        scores, finished = top, was_done | (tok == eos_id)
    lp = ((5.0 + lengths.float()) / 6.0) ** length_alpha
    best = torch.argmax(torch.where(scores <= neg_inf / 2,
                                    torch.tensor(neg_inf, device=dev),
                                    scores / lp), dim=1)
    return ys[torch.arange(b, device=dev), best][:, 1:]
