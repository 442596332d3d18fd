"""Export the port's decoders as HuggingFace checkpoints: the counterpart
of the JAX package's ``models/export_hf.py`` (the inverse of
``models.import_hf``).

``AutoModelForCausalLM.from_pretrained`` loads the written directory:
``config.json`` and the f32 weights as ``save_pretrained`` lays them out,
one ``pytorch_model.bin`` as the JAX exporter writes it up to 5 GB, else
5-GB shards and their index (``hf_io.write_checkpoint``).  Windowed
configs export as ``model_type: mistral`` so the HF side applies the same
sliding-window masking, q/k/v-biased ones as ``qwen2``; MoE configs as
Mixtral, or with a gated shared expert as Qwen2-MoE.  Kernels ``[in,
out]`` transpose back to ``[out, in]``, the expert stacks unstack to one
weight per expert, and the head is always written
(``tie_word_embeddings: false``).

The export is written a layer at a time: each layer's tensors are copied
to the host in f32 as its turn comes, from the card or from a checkpoint
file mapped into memory (``CheckpointManager.restore_params``), and a
shard is dropped once written.  The host holds one shard and one layer of
f32 tensors, not the 27 GB of Llama-2-7B's whole export.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator
from pathlib import Path

import torch

from tensorflow_train_distributed_torch.models import hf_io
from tensorflow_train_distributed_torch.models.llama import LlamaConfig


def hf_config_dict(config: LlamaConfig) -> dict:
    """``config.json`` contents for an exported Llama-family checkpoint."""
    if config.attention_sinks:
        raise ValueError(
            "attention_sinks have no HF config field — export the model "
            "without sinks (they are a decode-time technique; the "
            "weights are identical)")
    if (getattr(config, "embed_scale", False)
            or getattr(config, "norm_zero_centered", False)
            or getattr(config, "head_dim", None)
            or getattr(config, "mlp_activation", "silu") != "silu"):
        raise ValueError(
            "Gemma-convention configs (embed_scale / zero-centered "
            "norms / decoupled head_dim / GeGLU) have no HF exporter "
            "yet — the llama/mistral/qwen2 formats would silently "
            "change semantics; keep the port's own checkpoints")
    mistral = config.sliding_window is not None
    qwen2 = getattr(config, "qkv_bias", False)
    if qwen2 and mistral:
        raise ValueError(
            "qkv_bias + sliding_window exports are not supported (HF "
            "Qwen2 windows need max_window_layers plumbing) — export "
            "without the window (a decode-time technique)")
    model_type = ("qwen2" if qwen2
                  else "mistral" if mistral else "llama")
    arch = {"qwen2": "Qwen2ForCausalLM",
            "mistral": "MistralForCausalLM",
            "llama": "LlamaForCausalLM"}[model_type]
    out = {
        "model_type": model_type,
        "architectures": [arch],
        "vocab_size": config.vocab_size,
        "hidden_size": config.d_model,
        "intermediate_size": config.ffn_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads or config.num_heads,
        "head_dim": config.d_model // config.num_heads,
        "max_position_embeddings": config.max_positions,
        "rms_norm_eps": config.rms_epsilon,
        "rope_theta": config.rope_base,
        "hidden_act": "silu",
        "tie_word_embeddings": False,
        "torch_dtype": "float32",
    }
    if mistral:
        out["sliding_window"] = config.sliding_window
    if getattr(config, "rope_scaling", None):
        f, lo, hi, old = config.rope_scaling
        out["rope_scaling"] = {
            "rope_type": "llama3", "factor": f, "low_freq_factor": lo,
            "high_freq_factor": hi,
            "original_max_position_embeddings": old}
    return out


def _host(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """A compact f32 host copy of one tensor (a kernel transposed to
    torch's ``[out, in]``): never a view, which would save its whole
    storage."""
    t = t.detach()
    out = torch.empty((t.t() if transpose else t).shape,
                      dtype=torch.float32)
    return out.copy_(t.t() if transpose else t)


def _parts(params: dict, config, layer) -> Iterator[dict]:
    """The HF state dict in parts: the embedding, then ``layer(sd, i)``'s
    tensors for each layer, then the final norm and the head."""
    embed = params["token_embed.embedding"]
    yield {"model.embed_tokens.weight": _host(embed)}
    for i in range(config.num_layers):
        sd = {}
        layer(sd, i)
        yield sd
    yield {"model.norm.weight": _host(params["final_norm.scale"]),
           "lm_head.weight": _host(params["lm_head.kernel"], transpose=True)}


def _merged(parts: Iterator[dict]) -> dict:
    sd = {}
    for part in parts:
        sd.update(part)
    return sd


def _layer_common(sd: dict, params: dict, i: int, qkv_bias: bool) -> None:
    p, ours_p = f"model.layers.{i}.", f"layers.{i}."
    sd[p + "input_layernorm.weight"] = _host(
        params[ours_p + "attn_norm.scale"])
    sd[p + "post_attention_layernorm.weight"] = _host(
        params[ours_p + "mlp_norm.scale"])
    for hf, ours in (("q_proj", "query"), ("k_proj", "key"),
                     ("v_proj", "value"), ("o_proj", "out")):
        sd[p + f"self_attn.{hf}.weight"] = _host(
            params[f"{ours_p}attention.{ours}.kernel"], transpose=True)
        if qkv_bias and ours != "out":
            sd[p + f"self_attn.{hf}.bias"] = _host(
                params[f"{ours_p}attention.{ours}.bias"])


def _llama_parts(params: dict, config: LlamaConfig) -> Iterator[dict]:
    qkv_bias = getattr(config, "qkv_bias", False)

    def layer(sd, i):
        _layer_common(sd, params, i, qkv_bias)
        for hf, ours in (("gate_proj", "wi_gate"), ("up_proj", "wi_up"),
                         ("down_proj", "wo")):
            sd[f"model.layers.{i}.mlp.{hf}.weight"] = _host(
                params[f"layers.{i}.mlp.{ours}.kernel"], transpose=True)
    return _parts(params, config, layer)


def export_llama_state_dict(params: dict, config: LlamaConfig) -> dict:
    """The port's parameters → an HF ``LlamaForCausalLM`` state dict (f32
    host tensors)."""
    return _merged(_llama_parts(params, config))


def export_llama(config: LlamaConfig, params: dict, out_dir) -> Path:
    """Write an HF-loadable checkpoint directory (``config.json`` + the
    weights, layer by layer); returns its path."""
    return hf_io.write_checkpoint(out_dir, hf_config_dict(config),
                                  _llama_parts(params, config))


def hf_config_dict_mixtral(config) -> dict:
    """``config.json`` for a Mixtral (sparse-MoE) export."""
    return {
        "model_type": "mixtral",
        "architectures": ["MixtralForCausalLM"],
        "vocab_size": config.vocab_size,
        "hidden_size": config.d_model,
        "intermediate_size": config.ffn_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads or config.num_heads,
        "head_dim": config.d_model // config.num_heads,
        "num_local_experts": config.num_experts,
        "num_experts_per_tok": config.top_k,
        "max_position_embeddings": config.max_positions,
        "rms_norm_eps": config.rms_epsilon,
        "rope_theta": config.rope_base,
        "hidden_act": "silu",
        "tie_word_embeddings": False,
        "torch_dtype": "float32",
        "sliding_window": None,
    }


def _experts(sd: dict, params: dict, i: int, config, prefix: str,
             names: tuple) -> None:
    """The expert stacks of layer i unstacked under ``prefix``, HF's
    (gate, up, down) ``names``."""
    for hf, ours in zip(names, ("wi_gate", "wi_up", "wo")):
        stack = params[f"layers.{i}.moe.experts.{ours}.kernel"]
        for e in range(config.num_experts):
            sd[f"{prefix}experts.{e}.{hf}.weight"] = _host(stack[e],
                                                           transpose=True)
    sd[prefix + "gate.weight"] = _host(params[f"layers.{i}.moe.router.kernel"],
                                       transpose=True)


def _mixtral_parts(params: dict, config) -> Iterator[dict]:
    """The guards (at the call, before any tensor is written), then the
    parts of an HF ``MixtralForCausalLM`` state dict."""
    if config.moe_every != 1:
        raise ValueError(
            "HF Mixtral has MoE on EVERY layer; this config's "
            f"moe_every={config.moe_every} is not representable")
    if getattr(config, "shared_expert_size", None):
        raise ValueError(
            "HF Mixtral has no shared expert; exporting would silently "
            f"drop the shared_mlp weights (shared_expert_size="
            f"{config.shared_expert_size}) — not representable")
    if getattr(config, "qkv_bias", False):
        raise ValueError(
            "HF Mixtral attention is bias-free; exporting would "
            "silently drop the q/k/v bias params — use the Qwen2-MoE "
            "format (export_qwen2_moe) for the full Qwen convention")
    if not getattr(config, "norm_topk_prob", True):
        raise ValueError(
            "HF Mixtral renormalizes top-k gates; this config's "
            "norm_topk_prob=False (raw softmax gates) is not "
            "representable — export_qwen2_moe carries the flag")

    def layer(sd, i):
        _layer_common(sd, params, i, False)
        _experts(sd, params, i, config, f"model.layers.{i}.block_sparse_moe.",
                 ("w1", "w3", "w2"))
    return _parts(params, config, layer)


def export_mixtral_state_dict(params: dict, config) -> dict:
    """The port's MoE parameters → an HF ``MixtralForCausalLM`` state
    dict (the inverse of ``import_hf.import_mixtral_state_dict``)."""
    return _merged(_mixtral_parts(params, config))


def export_mixtral(config, params: dict, out_dir) -> Path:
    """Write an HF-loadable Mixtral checkpoint directory."""
    return hf_io.write_checkpoint(out_dir, hf_config_dict_mixtral(config),
                                  _mixtral_parts(params, config))


def hf_config_dict_qwen2_moe(config) -> dict:
    """``config.json`` for a Qwen2-MoE (gated-shared-expert) export."""
    return {
        "model_type": "qwen2_moe",
        "architectures": ["Qwen2MoeForCausalLM"],
        "vocab_size": config.vocab_size,
        "hidden_size": config.d_model,
        # HF's dense-layer width: unused at decoder_sparse_step=1 but
        # required by the config class; mirror the routed width.
        "intermediate_size": config.ffn_size,
        "moe_intermediate_size": config.ffn_size,
        "shared_expert_intermediate_size": config.shared_expert_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads or config.num_heads,
        "num_experts": config.num_experts,
        "num_experts_per_tok": config.top_k,
        "norm_topk_prob": bool(config.norm_topk_prob),
        "decoder_sparse_step": 1,
        "mlp_only_layers": [],
        "max_position_embeddings": config.max_positions,
        "rms_norm_eps": config.rms_epsilon,
        "rope_theta": config.rope_base,
        "hidden_act": "silu",
        "tie_word_embeddings": False,
        "torch_dtype": "float32",
        "use_sliding_window": False,
    }


def _qwen2_moe_parts(params: dict, config) -> Iterator[dict]:
    """The guards (at the call), then the parts of an HF
    ``Qwen2MoeForCausalLM`` state dict."""
    if config.moe_every != 1:
        raise ValueError(
            "HF Qwen2-MoE (as exported here) has MoE on every layer; "
            f"moe_every={config.moe_every} is not representable")
    if (not getattr(config, "shared_expert_size", None)
            or not getattr(config, "shared_expert_gate", False)
            or not getattr(config, "qkv_bias", False)):
        raise ValueError(
            "Qwen2-MoE format needs the full Qwen convention: "
            "shared_expert_size set, shared_expert_gate=True and "
            "qkv_bias=True (plain Mixtral-style configs export via "
            "export_mixtral)")

    def layer(sd, i):
        _layer_common(sd, params, i, True)
        p = f"model.layers.{i}.mlp."
        _experts(sd, params, i, config, p,
                 ("gate_proj", "up_proj", "down_proj"))
        for hf, ours in (("gate_proj", "wi_gate"), ("up_proj", "wi_up"),
                         ("down_proj", "wo")):
            sd[f"{p}shared_expert.{hf}.weight"] = _host(
                params[f"layers.{i}.moe.shared_mlp.{ours}.kernel"],
                transpose=True)
        sd[p + "shared_expert_gate.weight"] = _host(
            params[f"layers.{i}.moe.shared_gate.kernel"], transpose=True)
    return _parts(params, config, layer)


def export_qwen2_moe_state_dict(params: dict, config) -> dict:
    """The port's shared-expert MoE parameters → an HF
    ``Qwen2MoeForCausalLM`` state dict (the inverse of
    ``import_hf.import_qwen2_moe_state_dict``)."""
    return _merged(_qwen2_moe_parts(params, config))


def export_qwen2_moe(config, params: dict, out_dir) -> Path:
    """Write an HF-loadable Qwen2-MoE checkpoint directory."""
    return hf_io.write_checkpoint(
        out_dir, hf_config_dict_qwen2_moe(config),
        _qwen2_moe_parts(params, config))


def export_hf_from_registry(config_name: str, checkpoint_dir, out_dir, *,
                            lora_alpha: float = 16.0) -> Path:
    """A registry decoder config and the newest checkpoint the port's
    launcher wrote in ``checkpoint_dir`` → an HF directory
    (``checkpoint_dir=None`` exports random weights from seed 0, an
    interop smoke test).  Only the parameters are read.  A LoRA
    checkpoint is merged first (``lora.merge_lora``), with the spec of
    its ``lora_spec.json``, else the config's, else rank and targets read
    from the adapters and ``lora_alpha`` (the alpha it was trained with:
    the weights do not record it).  The parameters are read from the
    checkpoint's file mapped into memory, a layer as it is written (the
    merge alone makes host copies, of the adapted kernels)."""
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import lora, registry
    from tensorflow_train_distributed_torch.models.moe import MoeConfig
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    try:
        config = registry.get_config(config_name)
    except ValueError as e:
        raise SystemExit(str(e))
    is_moe = isinstance(config, MoeConfig)
    if not isinstance(config, (LlamaConfig, MoeConfig)):
        raise SystemExit(
            f"--config {config_name} is not a Llama- or MoE-family "
            "decoder (HF export maps Llama/Mistral/Mixtral ForCausalLM "
            "checkpoints only)")
    if not is_moe and config.attention_sinks:
        # Sinks are decode-time; the exported weights are identical.
        config = dataclasses.replace(config, attention_sinks=0)
    if checkpoint_dir is not None:
        params = CheckpointManager(str(checkpoint_dir)).restore_params()
        if params is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    else:
        params = convert.init_params(
            config, torch.Generator().manual_seed(0), device="cpu",
            dtype=torch.float32)
    if lora.has_lora_leaves(params):
        # A LoRA fine-tune exports as a plain HF model: HF loaders know
        # nothing of the adapter leaves and would drop them silently.
        sidecar = (lora.load_spec(checkpoint_dir)
                   if checkpoint_dir is not None else None)
        if sidecar is not None:
            spec = sidecar          # written at train time
        elif getattr(config, "lora", None) is not None:
            spec = config.lora
        else:
            adapters = {k: v for k, v in params.items()
                        if k.endswith(".lora_a")}
            spec = lora.LoraSpec(
                rank=next(iter(adapters.values())).shape[-1],
                alpha=lora_alpha,
                targets=tuple(sorted({k.split(".")[-2] for k in adapters})))
        lora.check_spec_matches(params, spec)
        params = lora.merge_lora(params, spec)
    if is_moe:
        if getattr(config, "shared_expert_size", None):
            # Gated shared expert + qkv biases = the Qwen2-MoE format.
            return export_qwen2_moe(config, params, out_dir)
        return export_mixtral(config, params, out_dir)
    return export_llama(config, params, out_dir)
