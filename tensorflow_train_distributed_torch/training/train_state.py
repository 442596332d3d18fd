"""Train state (counterpart of the JAX package's ``training/train_state.py``):
the step count, the f32 master parameters, the optimizer state and the
loss-scale state.

The parameters are the model's own ``nn.Parameter``s, keyed by their
flax-style names (``convert.py``); the trainer updates them in place.
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

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.values())
