"""Image-classification task (LeNet, ResNet): the counterpart of the JAX
package's ``models/vision_task.py``.

Softmax cross-entropy (label-smoothed where the config says so) with
accuracy and, past 5 classes, top-5 accuracy; the L2 ``weight_decay``
term on every conv and dense kernel added to the loss (the reference
ResNet convention: no decay on BatchNorm scales or biases); uint8 batches
normalised on the device.  BatchNorm's running statistics are the
model's buffers: a forward in training mode (``model.train()``) updates
them, one in eval mode reads them (the trainer switches modes).
"""

from __future__ import annotations

from typing import Optional

import torch

from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.ops.losses import (
    fold_sample_weight,
    softmax_cross_entropy,
)


def _compute_dtype(model) -> Optional[torch.dtype]:
    for m in model.modules():
        if isinstance(m, L._Leaf):
            return m.compute_dtype
    return None


class VisionTask:
    """``loss_fn`` and ``predict_fn`` of an image classifier over
    ``{"image": [B, H, W, C], "label": [B]}`` batches (NHWC, as the JAX
    datasets give them)."""

    def __init__(self, model, config, *, label_smoothing: float = 0.0,
                 weight_decay: float = 0.0, uint8_mean_std=None):
        self.model = model
        self.config = config
        self.label_smoothing = label_smoothing
        self.weight_decay = weight_decay
        # (mean, std) per channel in 0..255 pixel units: uint8 batches
        # normalise here, in f32, then take the compute dtype.
        self.uint8_mean_std = uint8_mean_std

    def _prep_image(self, image: torch.Tensor) -> torch.Tensor:
        if image.dtype != torch.uint8:
            return image
        if self.uint8_mean_std is None:
            raise ValueError(
                "this task received a uint8 image batch but has no "
                "uint8_mean_std normalization constants")
        mean, std = self.uint8_mean_std
        reps = image.shape[-1] // len(mean)    # host-s2d ships 4x3 channels
        mean = torch.tensor(mean, dtype=torch.float32,
                            device=image.device).repeat(reps)
        std = torch.tensor(std, dtype=torch.float32,
                           device=image.device).repeat(reps)
        x = (image.float() - mean) / std
        cd = _compute_dtype(self.model)
        return x if cd is None else x.to(cd)

    def _l2(self) -> torch.Tensor:
        """Sum of squared kernels, each in the compute dtype (the JAX loss
        sees the policy-cast params)."""
        terms = [torch.sum(torch.square(m._cast(m.kernel)))
                 for m in self.model.modules()
                 if isinstance(m, L._Leaf) and hasattr(m, "kernel")]
        return sum(terms)

    def loss_fn(self, batch: dict):
        logits = self.model(self._prep_image(batch["image"]))
        labels = batch["label"]
        weights = fold_sample_weight(batch, labels.shape)
        loss, acc = softmax_cross_entropy(
            logits, labels, label_smoothing=self.label_smoothing,
            weights=weights)
        metrics = {"accuracy": acc}
        if logits.shape[-1] > 5:
            # A stable descending sort breaks ties toward the lower class,
            # as lax.top_k does (torch.topk promises no order).
            top5 = torch.sort(logits.float(), dim=-1, descending=True,
                              stable=True).indices[:, :5]
            hit5 = (top5 == labels[:, None]).any(-1).float()
            metrics["top5_accuracy"] = (
                hit5.mean() if weights is None
                else (hit5 * weights).sum() / torch.clamp(weights.sum(),
                                                          min=1.0))
        if weights is not None:
            metrics["loss_weight"] = weights.sum()
        if self.weight_decay > 0:
            loss = loss + self.weight_decay * self._l2()
        return loss, metrics

    def predict_fn(self, batch: dict) -> torch.Tensor:
        """Logits (the trainer runs it in eval mode)."""
        return self.model(self._prep_image(batch["image"]))
