"""Mixed-precision policy and dynamic loss scaling (counterpart of the JAX
package's ``training/mixed_precision.py``).

Params and optimizer state stay in f32, compute runs in the policy's
compute dtype; bfloat16 needs no loss scaling.  float16 gets the dynamic
loss scale: scale the loss, unscale the grads, skip the update and halve
the scale on non-finite grads, double it after ``growth_interval`` clean
steps.  The state is two device scalars, so the skip needs no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype policy: where params live, where compute happens."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # Loss scaling: None disables it (the right default for bf16).
    initial_loss_scale: Optional[float] = None
    growth_interval: int = 2000
    scale_factor: float = 2.0

    @classmethod
    def from_name(cls, name: str) -> "Policy":
        """Named policies matching the Keras policy strings."""
        if name in ("float32", "fp32"):
            return cls(compute_dtype=torch.float32)
        if name in ("bfloat16", "mixed_bfloat16", "bf16"):
            return cls(compute_dtype=torch.bfloat16)
        if name in ("float16", "mixed_float16", "fp16"):
            return cls(compute_dtype=torch.float16,
                       initial_loss_scale=2.0 ** 15)
        raise ValueError(f"Unknown precision policy {name!r}")

    @property
    def uses_loss_scaling(self) -> bool:
        return self.initial_loss_scale is not None

    def cast_to_compute(self, tree: dict) -> dict:
        """Floating entries of a flat dict in the compute dtype."""
        return {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                for k, v in tree.items()}


@dataclasses.dataclass
class LossScaleState:
    """Dynamic loss-scale state: the scale (f32) and the count of
    consecutive finite steps (int32), both device scalars."""

    scale: torch.Tensor
    good_steps: torch.Tensor

    @classmethod
    def create(cls, policy: Policy, device=None
               ) -> Optional["LossScaleState"]:
        if not policy.uses_loss_scaling:
            return None
        return cls(
            scale=torch.tensor(policy.initial_loss_scale,
                               dtype=torch.float32, device=device),
            good_steps=torch.zeros((), dtype=torch.int32, device=device))


def scale_loss(loss: torch.Tensor,
               ls: Optional[LossScaleState]) -> torch.Tensor:
    return loss if ls is None else loss * ls.scale.to(loss.dtype)


def unscale_grads(grads: list, ls: Optional[LossScaleState]) -> list:
    if ls is None:
        return grads
    inv = 1.0 / ls.scale
    return [None if g is None else g.float() * inv for g in grads]


def grads_finite(grads: list) -> torch.Tensor:
    """True (a device bool scalar) when every gradient is finite (None,
    a frozen parameter's, counts as finite)."""
    return torch.stack([torch.isfinite(g).all() for g in grads
                        if g is not None]).all()


def update_loss_scale(ls: Optional[LossScaleState], finite: torch.Tensor,
                      policy: Policy) -> Optional[LossScaleState]:
    """Halve on overflow; double after ``growth_interval`` clean steps."""
    if ls is None:
        return None
    grow = ls.good_steps + 1 >= policy.growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grow, ls.scale * policy.scale_factor, ls.scale),
        ls.scale / policy.scale_factor)
    new_scale = torch.clamp(new_scale, min=1.0)
    new_good = torch.where(finite & ~grow, ls.good_steps + 1,
                           torch.zeros_like(ls.good_steps))
    return LossScaleState(scale=new_scale, good_steps=new_good)
