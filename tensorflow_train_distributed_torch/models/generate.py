"""Autoregressive generation over a KV cache, and the decode-model and
sampling helpers the serving engine shares (counterpart of the JAX
package's ``models/generate.py``).

``generate()`` runs the shared-index cache (``LlamaModel.init_cache(...,
shared=True)``): the prompt in one fresh call, whose attention is the
kernel dispatch (flash, or splash past a sliding window) over the prompt
zero-padded to a multiple of 128, then one single-token call a new
token; a sliding window shorter than the sequence decodes over a ring of
``window`` rows (with the sink buffers for ``attention_sinks``).

The family dispatch (``_decode_model``) serves the Llama decoders and
the MoE ones (``MoeLmModel``), in full precision or with int8 weights
(``quant_scales``, ``models.quant``), as the JAX ``generate()`` does.

Sampling draws each token by Gumbel-max from the serving engine's
counter streams (``serving.stream_uniforms``): row i of the batch draws
its t-th new token from stream (``seed`` + i, t), so a seeded call gives
the same tokens on any device.  ``jax.random``'s draws cannot be
reproduced: sampled output agrees with the JAX package in law, greedy
output token for token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tensorflow_train_distributed_torch.models.llama import (
    LlamaConfig,
    LlamaModel,
)
from tensorflow_train_distributed_torch.models.quant import (
    attach_scales,
    check_quant_pairing,
)


def _decode_model(config, params: dict, *, quant_scales=None, device,
                  prepare=None):
    """The decoder for ``config`` holding ``params`` (a flat
    ``{name: tensor}`` dict in the port's layout — ``convert``): a
    ``MoeLmModel`` for a ``MoeConfig``, a ``LlamaModel`` for a
    ``LlamaConfig`` — the one family-dispatch point, shared by
    ``generate()`` and the serving engine.  The module is built on the
    meta device, frozen (serving takes no gradients, and an int8 kernel
    cannot be a parameter that requires one), and takes the tensors by
    assignment, so weights are never allocated twice; ``quant_scales``
    go to their int8 kernels' modules (``quant.attach_scales``).
    ``prepare(model)`` lays the meta model out before the load (the
    tensor-split and expert-parallel engine's)."""
    from tensorflow_train_distributed_torch.models.moe import (
        MoeConfig,
        MoeLmModel,
    )

    if isinstance(config, MoeConfig):
        model = MoeLmModel(config, device="meta")
    elif isinstance(config, LlamaConfig):
        model = LlamaModel(config, device="meta")
    else:
        raise TypeError(f"no decoder for config type "
                        f"{type(config).__name__}")
    model.requires_grad_(False)
    if prepare is not None:
        prepare(model)
        model.requires_grad_(False)
    model.load_state_dict({k: v.to(device) for k, v in params.items()},
                          strict=True, assign=True)
    if quant_scales is not None:
        attach_scales(model, quant_scales, device)
    return model.eval()


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


def serving_params(config, params: dict):
    """(config, params) to decode with: LoRA adapters folded into their
    kernels when ``config.lora`` names them (``lora.merge_lora``, checked
    against the spec first), refused when the adapters come without it."""
    from tensorflow_train_distributed_torch.models.lora import (
        check_spec_matches,
        has_lora_leaves,
        merge_lora,
    )

    if getattr(config, "lora", None) is not None:
        if has_lora_leaves(params):
            check_spec_matches(params, config.lora)
            params = merge_lora(params, config.lora)
        return dataclasses.replace(config, lora=None), params
    if has_lora_leaves(params):
        raise ValueError(
            "params carry unmerged LoRA adapters but config.lora is not "
            "set: either serve with the training config (lora=LoraSpec) "
            "or fold them in first via models.lora.merge_lora")
    return config, params


def generate(config, params: dict, prompt, max_new_tokens: int,
             *, temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, seed: Optional[int] = None,
             cast_params: bool = True, quant_scales=None,
             device="cuda") -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations of ``prompt`` [B, S] (ids,
    any integer array); returns [B, S + max_new_tokens] int64 ids on
    ``device``.

    ``temperature`` 0: greedy argmax of the f32 logits.  > 0: a draw from
    ``filter_logits`` (``top_k``, then ``top_p``) of the logits, from the
    counter streams named by ``seed`` (required; the module docstring).
    Prompt + new tokens must fit ``config.max_positions``; the cache
    holds exactly that many positions (a ring of ``sliding_window`` rows
    when the window is shorter).  ``cast_params`` casts floating params
    to ``config.dtype``.  A LoRA config's adapters are folded in first
    (``serving_params``).  ``config`` is a Llama or an MoE decoder's.
    ``quant_scales``: the scales of ``models.quant.quantize_params``,
    passed with the int8 ``params`` that call returned (every quantized
    kernel then runs the int8 product); int8 kernels and the scales are
    untouched by ``cast_params``."""
    prompt = _ids(prompt)
    if prompt.dim() != 2 or prompt.shape[0] < 1 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be [B >= 1, S >= 1] token ids, got "
                         f"shape {tuple(prompt.shape)}")
    b, prompt_len = prompt.shape
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got "
                         f"{max_new_tokens}")
    if max_new_tokens == 0:
        return prompt.to(device)
    if prompt_len + max_new_tokens > config.max_positions:
        raise ValueError(
            f"prompt {prompt_len} + {max_new_tokens} new tokens exceeds "
            f"max_positions={config.max_positions} (the KV cache size)")
    validate_sampling(temperature, top_k, top_p)
    if temperature > 0 and seed is None:
        raise ValueError("temperature sampling needs seed=")
    if getattr(config, "lora", None) is not None and quant_scales is not None:
        raise ValueError(
            "int8 serving of a LoRA model needs the adapters folded in "
            "first: params = models.lora.merge_lora(params, spec), then "
            "quantize the merged tree with a lora=None config")
    config, params = serving_params(config, params)
    check_quant_pairing(params, quant_scales)
    if cast_params:
        params = cast_floating(params, config.dtype)
    model = _decode_model(config, params, quant_scales=quant_scales,
                          device=device)
    pick = _picker(temperature, top_k, top_p, seed, b, device)
    return _generate(model, prompt.to(device), max_new_tokens, pick)


def _ids(prompt) -> torch.Tensor:
    """Token ids as an int64 tensor (from a tensor, array or list)."""
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.as_tensor(np.asarray(prompt))
    return prompt.to(torch.int64)


def _picker(temperature, top_k, top_p, seed, batch: int, device):
    """``pick(logits [B, V], t)``: the t-th new token of every row."""
    if temperature == 0.0:
        return lambda logits, t: torch.argmax(logits.float(), dim=-1)
    from tensorflow_train_distributed_torch.models.speculative import (
        gumbel_argmax,
    )
    from tensorflow_train_distributed_torch.serving import (
        PICK_DRAW,
        stream_uniforms,
    )

    seeds = int(seed) + torch.arange(batch, dtype=torch.int64,
                                     device=device)

    def pick(logits, t):
        filt = filter_logits(logits.float(), temperature=temperature,
                             top_k=top_k, top_p=top_p)
        counts = torch.full_like(seeds, t)
        return gumbel_argmax(filt, stream_uniforms(seeds, counts, PICK_DRAW,
                                                   filt.shape[-1]))

    return pick


@torch.no_grad()
def _generate(model: LlamaModel, prompt: torch.Tensor, max_new: int, pick,
              logits_out: Optional[list] = None) -> torch.Tensor:
    """The decode loop: the prompt in one fresh call (the cache sized to
    prompt + ``max_new``), then ``max_new - 1`` single-token calls (the
    last token is never fed back).  ``logits_out`` collects each step's
    f32 logits [B, V] (the seam a teacher-forced check reads)."""
    b, s = prompt.shape
    cache = model.init_cache(b, s + max_new, shared=True,
                             device=prompt.device)
    logits = model(prompt, cache)[:, -1].float()
    toks = []
    for t in range(max_new):
        if t:
            logits = model(toks[-1][:, None], cache)[:, -1].float()
        if logits_out is not None:
            logits_out.append(logits)
        toks.append(pick(logits, t))
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)

