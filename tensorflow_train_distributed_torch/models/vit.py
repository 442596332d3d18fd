"""Vision Transformer (ViT) for image classification: the counterpart of
the JAX package's ``models/vit.py``.

The patch embedding is a stride-P "VALID" ``layers.Conv`` (one product
per patch: 224 / 16 → 196 patches), then pre-LN encoder blocks (LayerNorm
→ attention with biased q/k/v/out → +x; LayerNorm → GELU MLP → +x), a
final LayerNorm, mean pooling ("gap", the default) or the class token
("cls", the paper's variant), and a dense head that starts at zero.  The
position table is learned at the config's grid.  ``remat`` runs each
block under ``layers.checkpoint_with_dropout``.

Attention is full (non-causal) and goes through the kernel dispatch of
``ops.attention``: ViT-B/16's 196 (gap) or 197 (cls) rows are not a
multiple of 128, so it takes the dense path there, as the JAX gate does
on a TPU.  Names match flax's (``patch_embed``, ``cls_token``,
``pos_embedding``, ``layer_{i}/attn_ln``, ``…/attention/query``,
``…/mlp_ln``, ``…/mlp/wi``, ``final_ln``, ``head``; the layers are
``layers.{i}``, as ``convert`` maps ``layer_{i}``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.models.resnet import (
    MEAN_RGB,
    STDDEV_RGB,
)
from tensorflow_train_distributed_torch.models.vision_task import VisionTask


@dataclasses.dataclass(frozen=True)
class VitConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 1000
    dropout_rate: float = 0.0
    pooling: str = "gap"  # "gap" (mean-pool) | "cls" (class token)
    dtype: torch.dtype = torch.float32
    layer_norm_eps: float = 1e-6
    # Activation checkpointing per encoder layer.
    remat: bool = False

    @property
    def num_patches(self) -> int:
        side, rem = divmod(self.image_size, self.patch_size)
        if rem:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}")
        return side * side


VIT_PRESETS = {
    # Standard sizes (ViT paper / AugReg naming).
    "vit_b16": VitConfig(),
    "vit_s16": VitConfig(hidden_size=384, num_layers=12, num_heads=6,
                         mlp_dim=1536),
    "vit_l16": VitConfig(hidden_size=1024, num_layers=24, num_heads=16,
                         mlp_dim=4096),
    # The CPU test config.
    "vit_tiny": VitConfig(image_size=32, patch_size=8, hidden_size=32,
                          num_layers=2, num_heads=2, mlp_dim=64,
                          num_classes=10),
}


class VitEncoderLayer(nn.Module):
    """Pre-LN transformer block (LN → attn → +x; LN → MLP → +x)."""

    def __init__(self, cfg: VitConfig, *, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.attn_ln = L.LayerNorm(d, epsilon=cfg.layer_norm_eps,
                                   dtype=cfg.dtype, device=device)
        self.attention = L.MultiHeadAttention(
            d, cfg.num_heads, d // cfg.num_heads, dtype=cfg.dtype,
            causal=False, use_rope=False, use_bias=True,
            dropout_rate=cfg.dropout_rate, device=device)
        self.mlp_ln = L.LayerNorm(d, epsilon=cfg.layer_norm_eps,
                                  dtype=cfg.dtype, device=device)
        self.mlp = L.MlpBlock(d, cfg.mlp_dim, dtype=cfg.dtype,
                              activation="gelu", gated=False,
                              dropout_rate=cfg.dropout_rate, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.attn_ln(x))
        return x + self.mlp(self.mlp_ln(x))


class VisionTransformer(L._Leaf):
    """Input [B, H, W, C] (NHWC, as the datasets give it); logits
    [B, num_classes] in ``config.dtype``."""

    def __init__(self, config: VitConfig = VitConfig(), *, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        d = cfg.hidden_size
        self.patch_embed = L.Conv(3, d, cfg.patch_size,
                                  stride=cfg.patch_size, padding="VALID",
                                  device=device)
        seq = cfg.num_patches
        if cfg.pooling == "cls":
            self.cls_token = nn.Parameter(torch.empty(1, 1, d,
                                                      device=device))
            seq += 1
        self.pos_embedding = nn.Parameter(torch.empty(seq, d,
                                                      device=device))
        self.layers = nn.ModuleList(VitEncoderLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = L.LayerNorm(d, epsilon=cfg.layer_norm_eps,
                                    dtype=cfg.dtype, device=device)
        self.head = L.Dense(d, cfg.num_classes, use_bias=True,
                            dtype=cfg.dtype, device=device)

    def init_spec(self) -> dict:
        spec = {"pos_embedding": ("normal", 0.02),
                "head.kernel": ("fill", 0.0)}
        if self.config.pooling == "cls":
            spec["cls_token"] = ("fill", 0.0)
        return spec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        # Patch embedding: a stride-P conv is one product per patch.
        x = self.patch_embed(x.permute(0, 3, 1, 2)).to(cfg.dtype)
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)         # [B, N_patches, H], (h, w)
        seq = cfg.num_patches
        if x.shape[1] != seq:
            raise ValueError(
                f"got {x.shape[1]} patches for input {tuple(x.shape)}, "
                f"config expects {seq} ({cfg.image_size}px / "
                f"{cfg.patch_size}px grid); check the dataset image_size")
        if cfg.pooling == "cls":
            cls = self._cast(self.cls_token).to(cfg.dtype)
            x = torch.cat([cls.expand(b, 1, -1), x], dim=1)
        x = x + self._cast(self.pos_embedding)[None].to(cfg.dtype)
        x = L.dropout(x, cfg.dropout_rate, self.training)
        for layer in self.layers:
            if cfg.remat and self.training and torch.is_grad_enabled():
                x = L.checkpoint_with_dropout(layer, x)
            else:
                x = layer(x)
        x = self.final_ln(x)
        x = x[:, 0] if cfg.pooling == "cls" else x.mean(dim=1)
        return self.head(x)


def make_task(config: VitConfig = VIT_PRESETS["vit_b16"], *,
              label_smoothing: float = 0.1, weight_decay: float = 0.0,
              device=None) -> VisionTask:
    """The ViT task: label smoothing 0.1 by default, no L2 term (decoupled
    decay belongs in the optimizer), and uint8 batches normalised with
    the ImageNet statistics."""
    return VisionTask(
        VisionTransformer(config, device=device), config,
        label_smoothing=label_smoothing, weight_decay=weight_decay,
        uint8_mean_std=(tuple(m * 255.0 for m in MEAN_RGB),
                        tuple(s * 255.0 for s in STDDEV_RGB)))
