"""Model configs by registry name (the ``--config`` values of the JAX
package's ``models/registry.py``): name → the model config, the task's
keyword arguments where they differ from its defaults (``task_kwargs``:
ResNet's label smoothing and weight decay), and the training
conventions of the JAX entry (dataset and its kwargs, global batch,
peak learning rate, schedule, warmup ratio, global-norm clip) and its
mesh preset (``strategy``, ``runtime.mesh.STRATEGY_PRESETS``; "dp" where
the JAX entry names none).  ``make_task`` builds the entry's task."""

from __future__ import annotations

import dataclasses

from tensorflow_train_distributed_torch.models.bert import BERT_PRESETS
from tensorflow_train_distributed_torch.models.lenet import LeNetConfig
from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS
from tensorflow_train_distributed_torch.models.moe import MOE_PRESETS
from tensorflow_train_distributed_torch.models.resnet import RESNET_PRESETS
from tensorflow_train_distributed_torch.models.transformer import (
    TRANSFORMER_PRESETS,
)
from tensorflow_train_distributed_torch.models.vit import VIT_PRESETS

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

_RESNET = dict(dataset="imagenet", dataset_kwargs={},
               global_batch_size=1024, learning_rate=0.4,
               lr_schedule="resnet_steps", warmup_ratio=0.05,
               grad_clip_norm=None)
_S2D = dict(_RESNET, dataset_kwargs=dict(space_to_depth=True))
# The JAX registry's defaults for an entry that names none.
_DEFAULTS = dict(dataset_kwargs={}, lr_schedule="constant", warmup_ratio=0.0,
                 grad_clip_norm=None)

_ENTRIES = {
    # Reference config[0]: MNIST LeNet.
    "mnist": dict(_DEFAULTS, config=LeNetConfig(), dataset="mnist",
                  global_batch_size=128, learning_rate=1e-3),
    # Reference config[1]: ResNet-50 / ImageNet, and its s2d stem and
    # subsampled-BN-statistics variants.
    "resnet50_imagenet": dict(_RESNET, config=RESNET_PRESETS["resnet50"]),
    "resnet50_imagenet_s2d": dict(_S2D,
                                  config=RESNET_PRESETS["resnet50_s2d"]),
    "resnet50_imagenet_s2d_bnsub": dict(
        _S2D, config=RESNET_PRESETS["resnet50_s2d_bnsub"]),
    "resnet_tiny": dict(
        _DEFAULTS, config=RESNET_PRESETS["resnet_tiny"], dataset="imagenet",
        dataset_kwargs=dict(num_classes=10, image_size=32),
        global_batch_size=64, learning_rate=1e-3,
        task_kwargs=dict(label_smoothing=0.0, weight_decay=0.0)),
    # ViT: ResNet's ImageNet pipeline under an encoder stack, trained the
    # AugReg way (warmup + cosine, global-norm clip 1.0).
    "vit_b16_imagenet": dict(
        _RESNET, config=VIT_PRESETS["vit_b16"], learning_rate=3e-3,
        lr_schedule="warmup_cosine", warmup_ratio=0.03, grad_clip_norm=1.0),
    "vit_tiny": dict(
        _DEFAULTS, config=VIT_PRESETS["vit_tiny"], dataset="imagenet",
        dataset_kwargs=dict(num_classes=10, image_size=32),
        global_batch_size=64, learning_rate=1e-3,
        task_kwargs=dict(label_smoothing=0.0)),
    # Reference config[2]: BERT-base MLM.
    "bert_base_mlm": dict(
        _DEFAULTS, config=BERT_PRESETS["bert_base"], dataset="mlm",
        global_batch_size=256, learning_rate=1e-4,
        lr_schedule="warmup_linear", warmup_ratio=0.1, grad_clip_norm=1.0),
    "bert_tiny_mlm": dict(
        _DEFAULTS, config=BERT_PRESETS["bert_tiny"], dataset="mlm",
        dataset_kwargs=dict(vocab_size=256, seq_len=64),
        global_batch_size=32, learning_rate=1e-3),
    # Reference config[3]: Transformer-big WMT en-de.
    "transformer_big_wmt": dict(
        _DEFAULTS, config=TRANSFORMER_PRESETS["transformer_big"],
        dataset="wmt", global_batch_size=512, learning_rate=2.0,
        lr_schedule="noam"),
    "transformer_tiny_wmt": dict(
        _DEFAULTS, config=TRANSFORMER_PRESETS["transformer_tiny"],
        dataset="wmt", dataset_kwargs=dict(vocab_size=256, seq_len=32),
        global_batch_size=32, learning_rate=1e-3),
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


# The JAX entries' strategies where they are not "dp".
_STRATEGIES = {
    "gemma_7b_sft": "fsdp_tp", "llama2_7b_sft": "fsdp_tp",
    "llama31_8b_sft": "fsdp_tp", "qwen25_7b_sft": "fsdp_tp",
    "mistral_7b_lm": "fsdp_tp", "llama_tiny_pp": "dp_pp",
    "llama_tiny_sft": "dp_tp", "mixtral_8x7b": "dp_ep",
    "moe_tiny_lm": "dp_ep", "moe_tiny_shared_lm": "dp_ep",
    "qwen15_moe_a27b": "dp_ep", "qwen_moe_tiny_lm": "dp_ep",
}
for _name, _entry in _ENTRIES.items():
    _entry.setdefault("strategy", _STRATEGIES.get(_name, "dp"))


def get_entry(name: str) -> dict:
    """The registry entry: ``config`` plus the training fields."""
    if name not in _ENTRIES:
        raise ValueError(f"Unknown config {name!r}; available: "
                         f"{available()}")
    return _ENTRIES[name]


def make_task(entry: dict, *, device=None):
    """The entry's task on ``device`` (``"meta"``: without storage, for
    weights loaded later by ``Trainer.create_state``)."""
    from tensorflow_train_distributed_torch.models import (
        bert,
        lenet,
        llama,
        moe,
        resnet,
        transformer,
        vit,
    )

    cfg, kw = entry["config"], entry.get("task_kwargs", {})
    for cfg_type, make in (
            (moe.MoeConfig, moe.MoeLmTask),
            (llama.LlamaConfig, llama.CausalLmTask),
            (bert.BertConfig, bert.BertMlmTask),
            (transformer.TransformerConfig, transformer.Seq2SeqTask),
            (resnet.ResNetConfig, resnet.make_task),
            (vit.VitConfig, vit.make_task),
            (lenet.LeNetConfig, lenet.make_task)):
        if isinstance(cfg, cfg_type):
            return make(cfg, device=device, **kw)
    raise TypeError(f"no task for config type {type(cfg).__name__}")


def get_config(name: str):
    return get_entry(name)["config"]


def available() -> list:
    return sorted(_ENTRIES)
