"""LeNet-5 for MNIST (counterpart of the JAX package's ``models/lenet.py``):
conv5x5(6, SAME) → avgpool → conv5x5(16, VALID) → avgpool → 120 → 84 →
classes, ReLU between.  Parameter names are flax's (``Conv_0``,
``Dense_0``, ...)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.models.vision_task import VisionTask


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    num_classes: int = 10
    hidden: tuple = (120, 84)


class LeNet(nn.Module):
    """Input [B, 28, 28, 1] (NHWC); logits [B, num_classes]."""

    def __init__(self, config: LeNetConfig = LeNetConfig(), *, device=None):
        super().__init__()
        self.config = config
        self.Conv_0 = L.Conv(1, 6, 5, padding="SAME", device=device)
        self.Conv_1 = L.Conv(6, 16, 5, padding="VALID", device=device)
        widths = (16 * 5 * 5,) + tuple(config.hidden) + (config.num_classes,)
        for i in range(len(widths) - 1):
            setattr(self, f"Dense_{i}", L.Dense(widths[i], widths[i + 1],
                                                use_bias=True, dtype=None,
                                                device=device))
        self.n_dense = len(widths) - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)                    # NHWC -> NCHW view
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2)
        # Flatten in flax's (H, W, C) order, which Dense_0's rows follow.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i in range(self.n_dense):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_dense - 1:
                x = F.relu(x)
        return x


def make_task(config: LeNetConfig = LeNetConfig(), *,
              device=None) -> VisionTask:
    return VisionTask(LeNet(config, device=device), config)
