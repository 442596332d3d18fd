"""LoRA fine-tuning of the decoders: a frozen base and trainable rank-r
adapters (the counterpart of the JAX package's ``models/lora.py``).

A full fine-tune of a 7B decoder keeps f32 weights, gradients and two
Adam moments, about 16 bytes a parameter: more than one 80 GB card.
LoRA (Hu et al., 2021) freezes the base and trains ``W + (alpha/r)·A·B``
on the targeted projections, so gradients and optimizer state shrink to
the adapters.

Mechanics, in PyTorch's idiom (the JAX package intercepts flax's Dense
calls instead):

- ``apply_lora(model, spec)`` swaps every ``layers.Dense`` whose
  attribute name is in ``spec.targets`` for a ``LoraDense``: the same
  ``kernel`` (and ``bias``), frozen, plus ``lora_a`` [in, r] (f32,
  normal 0.02) and ``lora_b`` [r, out] (f32, zeros, so step 0 is the
  base model exactly) beside it, under the JAX package's names.  Every
  other parameter of the model is frozen too (``requires_grad`` False):
  autograd keeps no gradient buffer for the base and computes no weight
  gradient for it, the counterpart of JAX's ``stop_gradient``.
  ``LlamaConfig.lora`` applies it when the model is built.
- ``freeze_base(tx)`` splits the optimizer by label: the adapters (the
  parameters that require a gradient) get ``tx``'s updates and the only
  optimizer state; the frozen parameters get no update and no state.
  Wrapped around the clip chain, the global-norm clip sees only the
  adapters' gradients, as in the JAX launcher.
- ``merge_lora(params, spec)`` folds the adapters into their kernels for
  serving; the serving engine refuses a tree with adapters left in it.

Parameters are the port's flat dicts, ``{name: tensor}`` with dotted
flax-style names (``layers.0.attention.query.lora_a``).

One difference from the JAX package shows in a logged ``grad_norm``:
JAX differentiates the embeddings, norms and untargeted kernels too and
masks their updates, so its global norm counts them; here they have no
gradient, and ``grad_norm`` is the adapters' norm, the one the clip
uses.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import torch
from torch import nn

from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.training.optimizers import (
    GradientTransformation,
)


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    """Rank, alpha and the Dense module names to adapt."""

    rank: int = 8
    alpha: float = 16.0
    # The attention and MLP Dense submodule names of models.layers
    # (query/key/value/out, wi_gate/wi_up/wo, lm_head); the LoRA paper's
    # default adapts q and v.
    targets: Tuple[str, ...] = ("query", "value")

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.alpha <= 0:
            # alpha 0 zeroes the delta and its gradients: with the base
            # frozen nothing would train.
            raise ValueError(f"alpha must be > 0, got {self.alpha}")
        if not self.targets:
            raise ValueError("targets must name at least one module")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


# The Dense submodule names the decoders use: what targets may select.
KNOWN_TARGETS = frozenset({
    "query", "key", "value", "out",
    "wi_gate", "wi_up", "wo",
    "lm_head",
})


def validate_targets(targets) -> tuple:
    """Strip and validate names against ``KNOWN_TARGETS``."""
    clean = tuple(t.strip() for t in targets if t.strip())
    unknown = [t for t in clean if t not in KNOWN_TARGETS]
    if unknown:
        raise ValueError(
            f"unknown LoRA target(s) {unknown}: valid names are "
            f"{sorted(KNOWN_TARGETS)} (the models.layers Dense submodule "
            "names; a name that matches nothing creates no adapters and a "
            "frozen-base run would train nothing)")
    return clean


def spec_of(config):
    """The config's LoraSpec, or None (configs without the field too)."""
    return getattr(config, "lora", None)


class LoraDense(L.Dense):
    """``layers.Dense`` with adapters: ``x @ kernel (+ bias) + scaling ·
    (x @ lora_a) @ lora_b``, all in the layer's dtype; the adapters are
    f32 masters, cast on use like every parameter."""

    def __init__(self, in_features: int, out_features: int, *, rank: int,
                 scaling: float, use_bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, use_bias=use_bias,
                         dtype=dtype, device=device)
        self.scaling = scaling
        self.lora_a = nn.Parameter(torch.empty(
            in_features, rank, dtype=torch.float32, device=device))
        self.lora_b = nn.Parameter(torch.empty(
            rank, out_features, dtype=torch.float32, device=device))

    def init_spec(self) -> dict:
        return {"lora_a": ("normal", 0.02), "lora_b": ("fill", 0.0)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        dt = y.dtype
        delta = torch.matmul(
            torch.matmul(x.to(dt), self._cast(self.lora_a).to(dt)),
            self._cast(self.lora_b).to(dt))
        return y + delta * self.scaling


def apply_lora(model: nn.Module, spec: LoraSpec) -> int:
    """Swap the targeted Dense modules of ``model`` for ``LoraDense``
    (sharing their kernel and bias) and freeze every other parameter;
    returns the number of adapted modules.  Raises when none matches."""
    swaps = []
    for parent_name, parent in model.named_modules():
        for name, child in parent.named_children():
            if (name in spec.targets and isinstance(child, L.Dense)
                    and not isinstance(child, LoraDense)):
                swaps.append((parent, name, child))
    if not swaps:
        raise ValueError(
            f"LoRA targets {spec.targets} matched no module in this model: "
            "no adapters were created, so a frozen-base run would train "
            "nothing")
    for parent, name, base in swaps:
        d_in, d_out = base.kernel.shape
        lora = LoraDense(d_in, d_out, rank=spec.rank, scaling=spec.scaling,
                         use_bias=base.bias is not None, dtype=base.dtype,
                         device=base.kernel.device)
        lora.kernel = base.kernel
        lora.bias = base.bias
        lora.compute_dtype = base.compute_dtype
        setattr(parent, name, lora)
    for name, p in model.named_parameters():
        p.requires_grad_(is_lora_param(name))
    return len(swaps)


SPEC_SIDECAR = "lora_spec.json"


def save_spec(checkpoint_dir: str, spec: LoraSpec) -> str:
    """Write the spec beside the checkpoints: alpha cannot be read back
    from the weights, and serving with a wrong one corrupts silently."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, SPEC_SIDECAR)
    with open(path, "w") as f:
        json.dump({"rank": spec.rank, "alpha": spec.alpha,
                   "targets": list(spec.targets)}, f)
    return path


def load_spec(checkpoint_dir: str):
    """The persisted LoraSpec, or None (a checkpoint without LoRA)."""
    path = os.path.join(checkpoint_dir, SPEC_SIDECAR)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return LoraSpec(rank=int(d["rank"]), alpha=float(d["alpha"]),
                    targets=tuple(d["targets"]))


def _split(name: str) -> tuple:
    return tuple(name.replace("/", ".").split("."))


def is_lora_param(name) -> bool:
    """``name``: a dotted (or slashed) parameter name, or a path tuple."""
    path = name if isinstance(name, tuple) else _split(name)
    return path[-1] in ("lora_a", "lora_b")


def has_lora_leaves(params: dict) -> bool:
    """Whether a flat parameter dict carries unmerged adapters."""
    return any(is_lora_param(k) for k in params)


def check_spec_matches(params: dict, spec: LoraSpec) -> None:
    """Raise unless the adapters in ``params`` agree with ``spec`` on
    targets and rank (alpha is what the sidecar records)."""
    adapters = {k: v for k, v in params.items()
                if _split(k)[-1] == "lora_a"}
    seen = {_split(k)[-2] for k in adapters}
    ranks = {v.shape[-1] for v in adapters.values()}
    if not seen:
        raise ValueError("params carry no LoRA adapters but a LoraSpec "
                         "was given")
    if seen != set(spec.targets):
        raise ValueError(
            f"LoRA spec/params mismatch: params carry adapters on "
            f"{sorted(seen)} but the spec targets {sorted(spec.targets)} "
            "(check --lora-targets against training, or use the "
            "checkpoint's lora_spec.json)")
    if ranks != {spec.rank}:
        raise ValueError(
            f"LoRA spec/params mismatch: adapter rank(s) {sorted(ranks)} in "
            f"params vs spec rank {spec.rank}")


def lora_labels(params: dict) -> dict:
    """``{name: "lora" | "frozen"}``."""
    return {k: ("lora" if is_lora_param(k) else "frozen") for k in params}


def freeze_base(tx: GradientTransformation) -> GradientTransformation:
    """``tx`` on the adapters only: the parameters that require a
    gradient (``apply_lora`` leaves exactly the adapters so) get its
    updates and its state; the others get a None update (no change) and
    no state.  Gradients of frozen parameters may be None."""

    def lora_index(params):
        return [i for i, p in enumerate(params) if p.requires_grad]

    def init(params):
        return tx.init([params[i] for i in lora_index(params)])

    def update(grads, state, params=None):
        idx = lora_index(params)
        sub, state = tx.update([grads[i] for i in idx], state,
                               [params[i] for i in idx])
        out = [None] * len(grads)
        for i, u in zip(idx, sub):
            out[i] = u
        return out, state

    return GradientTransformation(init, update)


def count_lora_params(params: dict) -> tuple[int, int]:
    """(adapter parameters, all parameters)."""
    lora = sum(v.numel() for k, v in params.items() if is_lora_param(k))
    return lora, sum(v.numel() for v in params.values())


def merge_lora(params: dict, spec: LoraSpec) -> dict:
    """Fold each ``(lora_a, lora_b)`` pair into its kernel (f32 product,
    times ``spec.scaling``, rounded to the kernel's dtype) and drop the
    adapter leaves: a plain base-model dict, on the tensors' device."""
    out = {}
    merged = 0
    for name, w in params.items():
        if is_lora_param(name):
            continue
        if name.endswith("kernel"):
            stem = name[:-len("kernel")]
            a, b = params.get(stem + "lora_a"), params.get(stem + "lora_b")
            if a is not None and b is not None:
                delta = torch.einsum("...ir,...ro->...io", a.float(),
                                     b.float()) * spec.scaling
                w = (w.float() + delta).to(w.dtype)
                merged += 1
        out[name] = w
    if merged == 0:
        raise ValueError(
            "no (lora_a, lora_b) pairs found beside any kernel: was this "
            "tree trained with a lora= config?")
    return out
