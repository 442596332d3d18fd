"""Decoder configs by registry name (the ``--config`` values the JAX
package's ``models/registry.py`` maps to decoder tasks), name →
``LlamaConfig``.  The other families join with their slices."""

from __future__ import annotations

import dataclasses

from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS

_DECODERS = {
    "llama2_7b_sft": LLAMA_PRESETS["llama2_7b"],
    "llama31_8b_sft": LLAMA_PRESETS["llama31_8b"],
    "gemma_2b_sft": LLAMA_PRESETS["gemma_2b"],
    "gemma_7b_sft": LLAMA_PRESETS["gemma_7b"],
    "qwen25_7b_sft": LLAMA_PRESETS["qwen25_7b"],
    "llama_125m_lm": LLAMA_PRESETS["llama_125m"],
    "llama_350m_lm": LLAMA_PRESETS["llama_350m"],
    "mistral_7b_lm": LLAMA_PRESETS["mistral_7b"],
    "mistral_tiny_lm": dataclasses.replace(
        LLAMA_PRESETS["llama_tiny"], sliding_window=16, attention_sinks=4),
    "llama_tiny_sft": LLAMA_PRESETS["llama_tiny"],
    "llama_tiny_pp": LLAMA_PRESETS["llama_tiny_pp"],
}


def get_config(name: str):
    if name not in _DECODERS:
        raise ValueError(f"Unknown decoder config {name!r}; available: "
                         f"{available()}")
    return _DECODERS[name]


def available() -> list:
    return sorted(_DECODERS)
