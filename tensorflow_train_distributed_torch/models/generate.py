"""Decode-model construction and sampling helpers shared by the serving
engine (counterpart of the first part of the JAX package's
``models/generate.py``; ``generate()`` itself waits for a later slice)."""

from __future__ import annotations

import torch

from tensorflow_train_distributed_torch.models.llama import (
    LlamaConfig,
    LlamaModel,
)


def _decode_model(config: LlamaConfig, params: dict, *,
                  device) -> LlamaModel:
    """The decoder for ``config`` holding ``params`` (a flat
    ``{name: tensor}`` dict in the port's layout — ``convert``).  The
    family-dispatch point (MoE joins with its slice).  The module is built
    on the meta device and takes the tensors by assignment, so weights
    are never allocated twice; serving takes no gradients, so they are
    frozen."""
    if not isinstance(config, LlamaConfig):
        raise TypeError(f"no decoder for config type {type(config).__name__}"
                        " yet (the port serves the Llama family)")
    model = LlamaModel(config, device="meta")
    model.load_state_dict({k: v.to(device) for k, v in params.items()},
                          strict=True, assign=True)
    return model.requires_grad_(False).eval()


def cast_floating(params: dict, dtype: torch.dtype) -> dict:
    """Cast floating tensors to ``dtype`` (inference precision); integer
    tensors pass through untouched."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def validate_sampling(temperature, top_k, top_p) -> None:
    """Shared sampling-knob validation."""
    if temperature < 0:
        raise ValueError(
            f"temperature must be >= 0, got {temperature} (negative "
            "values invert the distribution)")
    if temperature == 0.0 and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p filter a sampling distribution; set "
            "temperature > 0 (greedy argmax is unaffected by them)")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def filter_logits(logits: torch.Tensor, *, temperature: float,
                  top_k=None, top_p=None) -> torch.Tensor:
    """Temperature scale + top-k + nucleus filters over f32 ``logits``
    [..., V]; filtered entries become -inf.  k first, then p (the HF
    convention); the most likely token always survives the nucleus."""
    logits = logits / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs <= top_p
        cutoff = torch.where(keep, sorted_desc,
                             torch.full_like(sorted_desc, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits
