"""Train state (counterpart of the JAX package's ``training/train_state.py``):
the step count, the f32 master parameters, the optimizer state, the
loss-scale state and the model state.

The parameters are the model's own ``nn.Parameter``s, keyed by their
flax-style names (``convert.py``); the trainer updates them in place.
``model_state`` holds the model's buffers that training changes
(BatchNorm's running statistics), keyed as flax's collection names them
(``batch_stats/stem_bn/mean``; ``convert.model_state_names``); a
forward in training mode updates them in place.  Empty for the
decoders.

``grad_residual`` is the quantized gradient sync's error-feedback
residual (``TrainerConfig.grad_quant``), one f32 tensor a parameter
(None for a frozen one): this rank's row in a running state, one row a
data rank (``[W, *shape]``) in the whole state a checkpoint holds; None
without grad_quant.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from tensorflow_train_distributed_torch.training.mixed_precision import (
    LossScaleState,
)


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict
    opt_state: Any
    loss_scale: Optional[LossScaleState] = None
    model_state: dict = dataclasses.field(default_factory=dict)
    grad_residual: Optional[list] = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.values())
