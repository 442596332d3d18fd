"""Decoder configs by registry name (the ``--config`` values the JAX
package's ``models/registry.py`` maps to decoder tasks): name → the
``LlamaConfig`` or ``MoeConfig`` and the training conventions of the JAX
entry (dataset and its kwargs, global batch, peak learning rate,
schedule, warmup ratio, global-norm clip).  The other families join with
their slices."""

from __future__ import annotations

import dataclasses

from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS
from tensorflow_train_distributed_torch.models.moe import MOE_PRESETS

_SFT = dict(dataset="lm", dataset_kwargs={}, global_batch_size=64,
            learning_rate=2e-5, lr_schedule="warmup_cosine",
            warmup_ratio=0.03, grad_clip_norm=1.0)
_LM_32K = dict(dataset="lm", learning_rate=3e-4,
               lr_schedule="warmup_cosine", warmup_ratio=0.01,
               grad_clip_norm=1.0)
_TINY = dict(dataset="lm", dataset_kwargs=dict(vocab_size=256, seq_len=32),
             global_batch_size=16, learning_rate=1e-3,
             lr_schedule="constant", warmup_ratio=0.0, grad_clip_norm=None)

_MOE = dict(dataset="lm", global_batch_size=64, learning_rate=1e-4,
            lr_schedule="constant", warmup_ratio=0.0, grad_clip_norm=None,
            dataset_kwargs={})

_ENTRIES = {
    "llama2_7b_sft": dict(_SFT, config=LLAMA_PRESETS["llama2_7b"]),
    "llama31_8b_sft": dict(_SFT, config=LLAMA_PRESETS["llama31_8b"]),
    "gemma_2b_sft": dict(_SFT, config=LLAMA_PRESETS["gemma_2b"]),
    "gemma_7b_sft": dict(_SFT, config=LLAMA_PRESETS["gemma_7b"]),
    "qwen25_7b_sft": dict(_SFT, config=LLAMA_PRESETS["qwen25_7b"]),
    "llama_125m_lm": dict(
        _LM_32K, config=LLAMA_PRESETS["llama_125m"], global_batch_size=8,
        dataset_kwargs=dict(vocab_size=32_000, seq_len=2048)),
    "llama_350m_lm": dict(
        _LM_32K, config=dataclasses.replace(
            LLAMA_PRESETS["llama_350m"], remat=True, remat_policy="no_ffn"),
        global_batch_size=4,
        dataset_kwargs=dict(vocab_size=32_000, seq_len=2048)),
    "mistral_7b_lm": dict(
        _LM_32K, config=LLAMA_PRESETS["mistral_7b"], global_batch_size=8,
        dataset_kwargs=dict(vocab_size=32_000, seq_len=8192)),
    "mistral_tiny_lm": dict(
        _TINY, config=dataclasses.replace(
            LLAMA_PRESETS["llama_tiny"], sliding_window=16,
            attention_sinks=4),
        dataset_kwargs=dict(vocab_size=256, seq_len=64)),
    "llama_tiny_sft": dict(_TINY, config=LLAMA_PRESETS["llama_tiny"]),
    "llama_tiny_pp": dict(_TINY, config=LLAMA_PRESETS["llama_tiny_pp"]),
    "mixtral_8x7b": dict(_MOE, config=MOE_PRESETS["mixtral_8x7b"]),
    "qwen15_moe_a27b": dict(_MOE, config=MOE_PRESETS["qwen15_moe_a27b"]),
    "moe_tiny_lm": dict(_TINY, config=MOE_PRESETS["moe_tiny"]),
    "qwen_moe_tiny_lm": dict(_TINY, config=MOE_PRESETS["qwen_moe_tiny"]),
    "moe_tiny_shared_lm": dict(_TINY, config=MOE_PRESETS["moe_tiny_shared"]),
    # The dropless (grouped-matmul) variant of moe_tiny_lm.
    "moe_tiny_lm_gmm": dict(_TINY, config=dataclasses.replace(
        MOE_PRESETS["moe_tiny"], dispatch="gmm")),
}


def get_entry(name: str) -> dict:
    """The registry entry: ``config`` plus the training fields."""
    if name not in _ENTRIES:
        raise ValueError(f"Unknown decoder config {name!r}; available: "
                         f"{available()}")
    return _ENTRIES[name]


def get_config(name: str):
    return get_entry(name)["config"]


def available() -> list:
    return sorted(_ENTRIES)
