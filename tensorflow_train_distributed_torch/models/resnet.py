"""ResNet (v1.5) for ImageNet: the counterpart of the JAX package's
``models/resnet.py``.

Bottleneck blocks with the stride on the 3x3 conv, BatchNorm after every
conv (the last of each block starting at scale 0), a projection shortcut
where the shape changes, global average pooling and a dense head in f32.
The JAX module runs NHWC; this one takes the same NHWC batch and runs
NCHW views of it, which are channels-last in memory (cuDNN's fast layout
on the card), converting at the boundary.

XLA's "SAME" padding is asymmetric at stride 2 ((2, 3) for the 7x7 stem
on 224, (0, 1) for a 3x3 on an even input, and the max pool's (0, 1)
with -inf): ``layers.Conv`` and ``_max_pool_same`` pad explicitly.

BatchNorm keeps flax's conventions, not torch's: the running variance is
the biased batch variance, and each update is ``m * old + (1 - m) * new``
with momentum m = 0.9.  ``BatchNorm`` normalises through
``F.batch_norm`` in training mode and derives the update from the batch
statistics that call computes; ``stats_stride > 1`` is the JAX
``SubsampledStatsBN``: statistics over ``x[:, :, ::s, ::s]``, the whole
tensor normalised by them as one multiply-add.  Names match flax's
(``stem_conv``, ``BottleneckBlock_{k}/Conv_{i}``, ``BatchNorm_{i}``,
``proj_conv``, ``proj_bn``, ``Dense_0``); the running statistics are
buffers ``…/mean`` and ``…/var`` (flax's ``batch_stats`` collection).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.models.vision_task import VisionTask

# ImageNet channel statistics in [0, 1] pixel units (the JAX package's
# ``data/image.py`` constants).
MEAN_RGB = (0.485, 0.456, 0.406)
STDDEV_RGB = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    num_filters: int = 64
    num_classes: int = 1000
    bn_momentum: float = 0.9
    bn_epsilon: float = 1e-5
    # BatchNorm statistics over a spatially strided subset (1 = exact).
    bn_stats_stride: int = 1
    # 2x2 space-to-depth input and the equivalent stride-1 4x4 stem.
    space_to_depth: bool = False


RESNET_PRESETS = {
    "resnet18": ResNetConfig(stage_sizes=(2, 2, 2, 2)),
    "resnet50": ResNetConfig(stage_sizes=(3, 4, 6, 3)),
    "resnet50_s2d": ResNetConfig(stage_sizes=(3, 4, 6, 3),
                                 space_to_depth=True),
    "resnet50_s2d_bnsub": ResNetConfig(stage_sizes=(3, 4, 6, 3),
                                       space_to_depth=True,
                                       bn_stats_stride=2),
    "resnet101": ResNetConfig(stage_sizes=(3, 4, 23, 3)),
    "resnet_tiny": ResNetConfig(stage_sizes=(1, 1), num_filters=8,
                                num_classes=10),
}


class BatchNorm(L._Leaf):
    """flax ``nn.BatchNorm`` (or, with ``stats_stride > 1``,
    ``SubsampledStatsBN``) over NCHW: ``scale`` and ``bias`` parameters,
    ``mean`` and ``var`` buffers.  Training mode normalises by the batch
    statistics and updates the buffers; eval mode reads them.  The result
    takes the input's dtype; statistics and the affine run in f32."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, stats_stride: int = 1,
                 zero_init: bool = False, device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.stats_stride = stats_stride
        self.zero_init = zero_init
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))

    def init_spec(self) -> dict:
        return {"scale": ("fill", 0.0 if self.zero_init else 1.0),
                "bias": ("fill", 0.0), "mean": ("fill", 0.0),
                "var": ("fill", 1.0)}

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * mean)
        self.var.copy_(m * self.var + (1 - m) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self._cast(self.scale).float()
        bias = self._cast(self.bias).float()
        if self.stats_stride > 1:
            return self._subsampled(x, scale, bias)
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, scale, bias,
                                training=False, eps=self.epsilon)
        c = x.shape[1]
        mean = torch.zeros(c, dtype=torch.float32, device=x.device)
        unbiased = torch.zeros_like(mean)
        # momentum 1: the scratch buffers receive the batch mean and the
        # unbiased batch variance; flax keeps the biased one.
        y = F.batch_norm(x, mean, unbiased, scale, bias, training=True,
                         momentum=1.0, eps=self.epsilon)
        n = x.numel() // c
        self._update(mean, unbiased * ((n - 1) / n))
        return y

    def _subsampled(self, x, scale, bias):
        if self.training:
            s = self.stats_stride
            sub = (x[:, :, ::s, ::s] if x.dim() == 4 else x).float()
            axes = (0,) + tuple(range(2, sub.dim()))
            mean = sub.mean(axes)
            var = torch.clamp(torch.square(sub).mean(axes)
                              - torch.square(mean), min=0.0)
            self._update(mean.detach(), var.detach())
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        w = (scale * inv).to(x.dtype).view(shape)
        b = (bias - mean * scale * inv).to(x.dtype).view(shape)
        return x * w + b


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[N, H, W, C] → [N, H/b, W/b, b·b·C], channel-minor order (du, dv,
    c)."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims {h}x{w} not divisible by {block}")
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def stem_kernel_to_s2d(w: torch.Tensor, block: int = 2) -> torch.Tensor:
    """Map a [F, C, 7, 7] (OIHW) stem kernel to the equivalent
    [F, b·b·C, 4, 4] kernel on space-to-depth input: the JAX function's
    zero-pad to 8x8 (one leading row and column) and (m, du, n, dv)
    regrouping, in the OIHW layout."""
    f, c, kh, kw = w.shape
    assert kh == 7 and kw == 7 and block == 2, "stem transform is 7x7/b=2"
    hwio = w.permute(2, 3, 1, 0)
    padded = F.pad(hwio, (0, 0, 0, 0, 1, 0, 1, 0))     # [8, 8, C, F]
    padded = padded.reshape(4, 2, 4, 2, c, f)           # (m, du, n, dv, c, f)
    padded = padded.permute(0, 2, 1, 3, 4, 5)           # (m, n, du, dv, c, f)
    return padded.reshape(4, 4, block * block * c, f).permute(3, 2, 0, 1)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool with XLA's "SAME" padding (-inf)."""
    (t, b) = L.same_padding(x.shape[2], 3, 2)
    (lft, r) = L.same_padding(x.shape[3], 3, 2)
    x = F.pad(x, (lft, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def _conv(cin, cout, kernel, stride=1, padding="SAME", device=None):
    return L.Conv(cin, cout, kernel, stride=stride, padding=padding,
                  use_bias=False, kernel_init=("fan_out", 2.0),
                  device=device)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int,
                 config: ResNetConfig, *, device=None):
        super().__init__()
        bn = dict(momentum=config.bn_momentum, epsilon=config.bn_epsilon,
                  stats_stride=config.bn_stats_stride, device=device)
        self.Conv_0 = _conv(in_features, filters, 1, device=device)
        self.BatchNorm_0 = BatchNorm(filters, **bn)
        self.Conv_1 = _conv(filters, filters, 3, strides, device=device)
        self.BatchNorm_1 = BatchNorm(filters, **bn)
        self.Conv_2 = _conv(filters, filters * 4, 1, device=device)
        # Zero-init last BN scale: each block starts as the identity.
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_init=True, **bn)
        self.project = in_features != filters * 4 or strides != 1
        if self.project:
            self.proj_conv = _conv(in_features, filters * 4, 1, strides,
                                   device=device)
            self.proj_bn = BatchNorm(filters * 4, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.proj_bn(self.proj_conv(x)) if self.project else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Input [N, H, W, 3] (or [N, H/2, W/2, 12] already space-to-depth for
    the s2d stem); logits [N, num_classes] f32."""

    def __init__(self, config: ResNetConfig = ResNetConfig(), *,
                 device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        if cfg.space_to_depth:
            self.stem_conv = _conv(12, cfg.num_filters, 4,
                                   padding=((2, 1), (2, 1)), device=device)
        else:
            self.stem_conv = _conv(3, cfg.num_filters, 7, 2, device=device)
        self.stem_bn = BatchNorm(cfg.num_filters, momentum=cfg.bn_momentum,
                                 epsilon=cfg.bn_epsilon,
                                 stats_stride=cfg.bn_stats_stride,
                                 device=device)
        k, cin = 0, cfg.num_filters
        self.n_blocks = sum(cfg.stage_sizes)
        for i, n in enumerate(cfg.stage_sizes):
            for j in range(n):
                filters = cfg.num_filters * 2 ** i
                setattr(self, f"BottleneckBlock_{k}", BottleneckBlock(
                    cin, filters, 2 if j == 0 and i > 0 else 1, cfg,
                    device=device))
                k, cin = k + 1, filters * 4
        self.Dense_0 = L.Dense(cin, cfg.num_classes, use_bias=True,
                               dtype=torch.float32, device=device)

    def init_spec(self) -> dict:
        return {"Dense_0.kernel": ("fill", 0.0)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.space_to_depth and x.shape[-1] == 3:
            x = space_to_depth(x)                # raw input: on the fly
        x = self.stem_conv(x.permute(0, 3, 1, 2))
        x = _max_pool_same(F.relu(self.stem_bn(x)))
        for k in range(self.n_blocks):
            x = getattr(self, f"BottleneckBlock_{k}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def make_task(config: ResNetConfig = RESNET_PRESETS["resnet50"], *,
              label_smoothing: float = 0.1, weight_decay: float = 1e-4,
              device=None) -> VisionTask:
    """The MLPerf-style task: label smoothing 0.1, weight decay 1e-4, and
    uint8 batches normalised with the ImageNet statistics."""
    return VisionTask(
        ResNet(config, device=device), config,
        label_smoothing=label_smoothing, weight_decay=weight_decay,
        uint8_mean_std=(tuple(m * 255.0 for m in MEAN_RGB),
                        tuple(s * 255.0 for s in STDDEV_RGB)))

