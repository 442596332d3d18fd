"""Classification losses (counterpart of the JAX package's
``ops/losses.py``): optionally label-smoothed, optionally weighted
softmax cross-entropy plus accuracy, and the ``sample_weight`` fold.

Without label smoothing the loss goes through the fused kernel
(``ops.kernels.cross_entropy``: the CUDA kernel on a CUDA tensor, its
plain version on the CPU), as the JAX package takes its Pallas kernel on
a TPU without a tensor mesh; there is no tensor parallelism here.
"""

from __future__ import annotations

from typing import Optional

import torch

from tensorflow_train_distributed_torch.ops import kernels as K


def fold_sample_weight(batch, targets_shape,
                       weights: Optional[torch.Tensor] = None
                       ) -> Optional[torch.Tensor]:
    """Fold the optional ``sample_weight`` batch key ([B], 1.0 real / 0.0
    pad) into ``weights``: per-position weights broadcastable to
    ``targets_shape``, or None when neither applies."""
    sw = batch.get("sample_weight")
    if sw is None:
        return None if weights is None else weights.float()
    base = (torch.ones(targets_shape, dtype=torch.float32, device=sw.device)
            if weights is None else weights.float())
    sw = sw.float().reshape(tuple(sw.shape)
                            + (1,) * (len(targets_shape) - sw.dim()))
    return base * sw


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          label_smoothing: float = 0.0,
                          weights: Optional[torch.Tensor] = None):
    """(mean loss, accuracy) over ``labels``.  ``logits``: [..., classes];
    ``labels``: integer [...]; ``weights``: optional per-position weights,
    the mean then taken over their total (at least 1)."""
    logits = logits.float()
    if label_smoothing > 0.0:
        n = logits.shape[-1]
        onehot = torch.nn.functional.one_hot(labels.long(), n).float()
        # optax.smooth_labels, then optax.softmax_cross_entropy.
        onehot = (1.0 - label_smoothing) * onehot + label_smoothing / n
        per_example = -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    else:
        per_example = K.cross_entropy(logits,
                                      labels.to(torch.int32).contiguous())
    correct = (logits.argmax(-1) == labels).float()
    if weights is None:
        return per_example.mean(), correct.mean()
    w = weights.float()
    denom = torch.clamp(w.sum(), min=1.0)
    return (per_example * w).sum() / denom, (correct * w).sum() / denom
