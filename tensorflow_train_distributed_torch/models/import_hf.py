"""Import HuggingFace checkpoints into the port: the counterpart of the JAX
package's ``models/import_hf.py``.

Llama-family decoders (llama, mistral, qwen2 with its q/k/v biases,
gemma, Llama-3 RoPE scaling), BERT masked-LM encoders, and the sparse-MoE
decoders Mixtral and Qwen2-MoE (its gated shared expert) load from a
local checkpoint directory, read by ``models.hf_io`` (``config.json`` and
safetensors or ``pytorch_model.bin`` files, single or sharded; no
``transformers``).  Every importer returns ``(config, params)``: the
port's config and its parameters ``{name: tensor}`` (``state_dict``
names, flax layouts) on ``device`` in ``dtype`` (default the config's),
moved there one tensor at a time.

Conventions that make the mapping exact (the forward-parity tests hold
the port's logits against transformers'):

- torch ``nn.Linear`` stores ``[out, in]``; the port's kernels are
  ``[in, out]``, so every projection transposes;
- RoPE: both use the split-half ("rotate_half") pairing with
  ``inv_freq = base^(-2i/d)``, so q and k copy over with no permutation;
- RMSNorm epsilon and scale and the SwiGLU gate/up/down order match 1:1;
- a tied head (``tie_word_embeddings``, Gemma's and BERT's default)
  reads the embedding.

Every guard of the JAX importer carries over with its wording: a
checkpoint whose options the port's model cannot represent exactly is
refused, never imported into silently different logits.  MoE imports set
``capacity_factor`` to E / k, at which the capacity dispatch drops no
token, so routing is exactly HF's dense top-k mixture.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tensorflow_train_distributed_torch.models import hf_io
from tensorflow_train_distributed_torch.models.llama import LlamaConfig


def _validate_hf_llama_family(hf_config) -> None:
    """Exact-or-rejected guards, run on every import path, including the
    CLI's ``config=task_cfg`` route (which skips config derivation); the
    Mixtral and Qwen2-MoE importers follow the same rule."""
    if getattr(hf_config, "model_type", "llama") not in (
            "llama", "mistral", "qwen2", "gemma"):
        raise ValueError(
            f"import_hf supports Llama-family checkpoints (llama, "
            f"mistral, qwen2, gemma), got model_type="
            f"{hf_config.model_type!r} (gemma2/gemma3 add logit "
            "softcapping / alternating windows the native model does "
            "not implement; BERT-style models import through "
            "import_bert)")
    # Attention-affecting options the model does not implement must fail
    # loudly, not import into silently-different logits.
    rs = getattr(hf_config, "rope_scaling", None)
    if rs and rs.get("rope_type", rs.get("type")) != "llama3":
        raise ValueError(
            f"rope_scaling type {rs.get('rope_type', rs.get('type'))!r} "
            "is not implemented natively (only the llama3 "
            "frequency-dependent rule) — importing would silently "
            "change logits at every position")
    qwen2 = getattr(hf_config, "model_type", "") == "qwen2"
    if getattr(hf_config, "attention_bias", False) and not qwen2:
        raise ValueError(
            "checkpoint has q/k/v/o projection biases; the native "
            "attention is bias-free for this family — qwen2 (qkv-bias "
            "convention) imports via the same path, others are not "
            "exactly representable")
    gemma = getattr(hf_config, "model_type", "") == "gemma"
    if not gemma:
        # The MLP for llama/mistral/qwen2 is SwiGLU (silu) only; HF honors
        # ACT2FN[hidden_act] as-is.  Gemma's activation is screened below.
        act = getattr(hf_config, "hidden_act", "silu") or "silu"
        if act != "silu":
            raise ValueError(
                f"hidden_act={act!r}: the native MLP for this family "
                "is SwiGLU (silu) only — importing would silently "
                "change every forward (Gemma's tanh-GeGLU is the one "
                "supported alternative, model_type='gemma')")
    if qwen2 and getattr(hf_config, "use_sliding_window", False):
        raise ValueError(
            "qwen2 use_sliding_window=True windows only layers past "
            "max_window_layers — a per-layer mix the native uniform "
            "window cannot represent; re-export the checkpoint with "
            "use_sliding_window=false (full attention)")
    hd = getattr(hf_config, "head_dim", None)
    derived = hf_config.hidden_size // hf_config.num_attention_heads
    if hd and hd != derived and not gemma:
        raise ValueError(
            f"checkpoint uses an explicit head_dim={hd} != hidden_size/"
            f"num_heads ({hf_config.hidden_size}/"
            f"{hf_config.num_attention_heads}) — only the Gemma family "
            "imports with a decoupled head width "
            "(LlamaConfig.head_dim)")
    if gemma:
        # HF's GemmaMLP runs gelu_pytorch_tanh whenever hidden_activation
        # is None, ignoring legacy hidden_act; only an explicit different
        # hidden_activation (exact erf gelu) is rejected.
        act = getattr(hf_config, "hidden_activation", None)
        if act is not None and act != "gelu_pytorch_tanh":
            raise ValueError(
                f"gemma hidden_activation={act!r} is honored by HF "
                "as-is; only 'gelu_pytorch_tanh' (or None, HF's "
                "default) maps exactly onto the native GeGLU")


def _rope_scaling(hf_config) -> Optional[tuple]:
    rs = getattr(hf_config, "rope_scaling", None)
    return ((float(rs["factor"]), float(rs["low_freq_factor"]),
             float(rs["high_freq_factor"]),
             int(rs["original_max_position_embeddings"]))
            if rs else None)


def config_from_hf(hf_config) -> LlamaConfig:
    """The port's ``LlamaConfig`` of an HF Llama-family config."""
    _validate_hf_llama_family(hf_config)
    qwen2 = getattr(hf_config, "model_type", "") == "qwen2"
    gemma = getattr(hf_config, "model_type", "") == "gemma"
    hd = getattr(hf_config, "head_dim", None)
    derived = hf_config.hidden_size // hf_config.num_attention_heads
    kv = getattr(hf_config, "num_key_value_heads",
                 hf_config.num_attention_heads)
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=None if kv == hf_config.num_attention_heads else kv,
        ffn_size=hf_config.intermediate_size,
        max_positions=hf_config.max_position_embeddings,
        rope_base=getattr(hf_config, "rope_theta", 10_000.0),
        rms_epsilon=hf_config.rms_norm_eps,
        # Mistral masks keys at distance >= sliding_window, the port's
        # window; sliding_window=0 means disabled.  Qwen2 windows only
        # with use_sliding_window, refused above.
        sliding_window=(
            None if (qwen2 or gemma)
            else getattr(hf_config, "sliding_window", None) or None),
        qkv_bias=qwen2,
        rope_scaling=_rope_scaling(hf_config),
        # Gemma conventions (no-ops for the other families).
        head_dim=(hd if gemma and hd and hd != derived else None),
        embed_scale=gemma,
        mlp_activation="gelu" if gemma else "silu",
        norm_zero_centered=gemma,
    )


class _Loader:
    """Checkpoint tensors by HF name, each moved to ``device`` in
    ``dtype`` as it is read (kernels transposed there)."""

    def __init__(self, sd, device, dtype):
        self.sd, self.device, self.dtype = sd, device, dtype

    def __call__(self, key: str, transpose: bool = False) -> torch.Tensor:
        t = self.sd[key].to(device=self.device, dtype=self.dtype, copy=True)
        return t.t().contiguous() if transpose else t

    def kernel(self, key: str) -> torch.Tensor:
        """An ``nn.Linear`` weight [out, in] as a kernel [in, out]."""
        return self(key, transpose=True)

    def stack(self, keys) -> torch.Tensor:
        """Kernels of the experts, stacked [E, in, out]."""
        return torch.stack([self.kernel(k) for k in keys])


def _dtype(config, dtype):
    return dtype or getattr(config, "dtype", torch.float32)


def _probe_count(sd, key_fmt: str, expected: int, what: str) -> None:
    """Two-sided presence check for indexed checkpoint entries: index
    ``expected`` must be absent and ``expected - 1`` present, else count
    the real number and fail at the boundary (not with a KeyError
    mid-mapping or a silent truncation)."""
    def _has(i):
        return key_fmt.format(i) in sd

    if _has(expected) or not _has(expected - 1):
        n = 0
        while _has(n):
            n += 1
        raise ValueError(
            f"checkpoint has {n} {what}, config expects {expected}")


def _lm_head_or_tied(sd, load: _Loader, embed: torch.Tensor,
                     tied: bool = False) -> torch.Tensor:
    """``lm_head.weight`` transposed, or the embedding's transpose where
    the config ties them (or the checkpoint has no head)."""
    if "lm_head.weight" in sd and not tied:
        return load.kernel("lm_head.weight")
    return embed.t().contiguous()


def _check_embed(embed: torch.Tensor, vocab: int, d: int) -> None:
    if tuple(embed.shape) != (vocab, d):
        raise ValueError(
            f"checkpoint embed is {tuple(embed.shape)}, config expects "
            f"{(vocab, d)}")


def _attention(load: _Loader, p: str, out: str, biases: bool) -> dict:
    """One layer's q/k/v/o projections (``biases``: q/k/v's)."""
    params = {}
    for hf, ours in (("q_proj", "query"), ("k_proj", "key"),
                     ("v_proj", "value"), ("o_proj", "out")):
        params[f"{out}attention.{ours}.kernel"] = load.kernel(
            f"{p}self_attn.{hf}.weight")
        if biases and ours != "out":
            params[f"{out}attention.{ours}.bias"] = load(
                f"{p}self_attn.{hf}.bias")
    params[f"{out}attn_norm.scale"] = load(p + "input_layernorm.weight")
    params[f"{out}mlp_norm.scale"] = load(
        p + "post_attention_layernorm.weight")
    return params


def _decoder_frame(sd, load: _Loader, config, tied: bool) -> dict:
    """Embedding, final norm and head of a decoder."""
    embed = load("model.embed_tokens.weight")
    _check_embed(embed, config.vocab_size, config.d_model)
    return {"token_embed.embedding": embed,
            "final_norm.scale": load("model.norm.weight"),
            "lm_head.kernel": _lm_head_or_tied(sd, load, embed, tied)}


def import_llama_state_dict(state_dict, config: LlamaConfig, *,
                            tied: bool = False, device="cuda",
                            dtype=None) -> dict:
    """An HF ``LlamaForCausalLM`` state dict (any mapping of HF names to
    tensors) → the port's parameters on ``device``."""
    if getattr(config, "fused_qkv", False):
        raise ValueError(
            "fused_qkv configs use one 'qkv' kernel; HF checkpoints ship "
            "split q/k/v projections — import with fused_qkv=False (the "
            "layouts are not interchangeable)")
    sd = state_dict
    load = _Loader(sd, device, _dtype(config, dtype))
    params = _decoder_frame(sd, load, config, tied)
    _probe_count(sd, "model.layers.{}.input_layernorm.weight",
                 config.num_layers, "decoder layers")
    qkv_bias = getattr(config, "qkv_bias", False)
    allowed = ("q_proj.bias", "k_proj.bias", "v_proj.bias") if qkv_bias \
        else ()
    biases = [k for k in sd
              if k.endswith("proj.bias") and not k.endswith(allowed)]
    if biases:
        raise ValueError(
            f"checkpoint has projection biases the config cannot "
            f"represent ({biases[0]}, ...); qkv_bias=True covers "
            "q/k/v biases only (the Qwen2 convention) — anything else "
            "would be silently dropped")
    if allowed and "model.layers.0.self_attn.q_proj.bias" not in sd:
        raise ValueError(
            "config sets qkv_bias=True (the Qwen2 convention) but the "
            "checkpoint has no q/k/v projection biases "
            "(model.layers.0.self_attn.q_proj.bias is absent) — import "
            "with qkv_bias=False or use a matching config/preset")
    for i in range(config.num_layers):
        p, out = f"model.layers.{i}.", f"layers.{i}."
        params.update(_attention(load, p, out, qkv_bias))
        for hf, ours in (("gate_proj", "wi_gate"), ("up_proj", "wi_up"),
                         ("down_proj", "wo")):
            params[f"{out}mlp.{ours}.kernel"] = load.kernel(
                f"{p}mlp.{hf}.weight")
    return params


def _open(path):
    """(the HF config namespace, the tensor reader) of a directory."""
    return hf_io.read_config(path), hf_io.CheckpointReader(path)


def import_llama(path, config: Optional[LlamaConfig] = None, *,
                 device="cuda", dtype=None, **config_overrides):
    """(config, params) from a local HF Llama-family checkpoint directory.
    ``config`` (a registry preset, say) must agree with the checkpoint;
    ``config_overrides`` tweak the result (anything that keeps the
    parameter shapes)."""
    hf_cfg, sd = _open(path)
    _validate_hf_llama_family(hf_cfg)
    if config is None:
        config = config_from_hf(hf_cfg)
    if config_overrides:
        config = dataclasses.replace(config, **config_overrides)
    # Checkpoint-vs-config guards run on the final config, after the
    # overrides, so an override can neither bypass them nor trip them
    # when it brings the config into agreement.  The rope-scaling rule is
    # the checkpoint's: frequencies the weights were never trained with
    # would change logits at every position.
    want = _rope_scaling(hf_cfg)
    have = getattr(config, "rope_scaling", None)
    if want != have:
        raise ValueError(
            f"config rope_scaling={have} but the checkpoint says "
            f"{want} — the checkpoint's convention wins; use a "
            "matching config/preset")
    # The norm epsilon too: shape-invisible.
    hf_eps = getattr(hf_cfg, "rms_norm_eps", None)
    if hf_eps is not None and float(hf_eps) != float(config.rms_epsilon):
        raise ValueError(
            f"config rms_epsilon={config.rms_epsilon} but the "
            f"checkpoint says rms_norm_eps={hf_eps} — the checkpoint's "
            "convention wins; use a matching config/preset")
    # And the Gemma conventions, shape-invisible as a set.
    gemma = getattr(hf_cfg, "model_type", "") == "gemma"
    want_knobs = (gemma, gemma, "gelu" if gemma else "silu")
    have_knobs = (bool(getattr(config, "embed_scale", False)),
                  bool(getattr(config, "norm_zero_centered", False)),
                  getattr(config, "mlp_activation", "silu"))
    if want_knobs != have_knobs:
        mt = getattr(hf_cfg, "model_type", "llama")
        raise ValueError(
            f"config (embed_scale, norm_zero_centered, mlp_activation)"
            f"={have_knobs} but the checkpoint's model_type={mt!r} "
            f"requires {want_knobs} (the Gemma conventions come as a "
            "set) — the checkpoint's convention wins; use a matching "
            "config/preset")
    params = import_llama_state_dict(
        sd, config, tied=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        device=device, dtype=dtype)
    return config, params


# -- BERT -------------------------------------------------------------------


def config_from_hf_bert(hf_config):
    """The port's ``BertConfig`` (HF-compat knobs on) of an HF
    ``BertConfig``."""
    from tensorflow_train_distributed_torch.models.bert import BertConfig

    if getattr(hf_config, "model_type", "bert") != "bert":
        raise ValueError(
            f"import_bert expects model_type 'bert', got "
            f"{hf_config.model_type!r}")
    if getattr(hf_config, "position_embedding_type", "absolute") != \
            "absolute":
        raise ValueError(
            "only absolute learned position embeddings are representable")
    act = getattr(hf_config, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported hidden_act {act!r}")
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_positions=hf_config.max_position_embeddings,
        dropout_rate=hf_config.hidden_dropout_prob,
        attention_dropout_rate=hf_config.attention_probs_dropout_prob,
        attention_bias=True,
        type_vocab_size=hf_config.type_vocab_size,
        embed_layer_norm=True,
        layer_norm_eps=hf_config.layer_norm_eps,
        exact_gelu=(act == "gelu"),  # HF "gelu" = erf; *_new/_tanh = tanh
    )


def import_bert_state_dict(state_dict, config, *, tied: bool = True,
                           device="cuda", dtype=None) -> dict:
    """An HF ``BertForMaskedLM`` state dict → the port's parameters.  The
    config must come from ``config_from_hf_bert`` (HF-compat knobs on);
    the MLM decoder must be tied to the word embeddings (the HF default),
    since the port's logits come from ``Embed.attend``."""
    sd = state_dict
    if not (config.attention_bias and config.embed_layer_norm
            and config.type_vocab_size):
        raise ValueError(
            "import_bert needs the HF-compat config knobs on "
            "(attention_bias, embed_layer_norm, type_vocab_size) — build "
            "the config with config_from_hf_bert()")
    load = _Loader(sd, device, _dtype(config, dtype))

    def ln(out, prefix):
        return {out + ".scale": load(prefix + ".weight"),
                out + ".bias": load(prefix + ".bias")}

    def dense(out, prefix):
        return {out + ".kernel": load.kernel(prefix + ".weight"),
                out + ".bias": load(prefix + ".bias")}

    emb = "bert.embeddings."
    embed = load(emb + "word_embeddings.weight")
    if tuple(embed.shape) != (config.vocab_size, config.hidden_size):
        raise ValueError(
            f"checkpoint embed {tuple(embed.shape)} != config "
            f"{(config.vocab_size, config.hidden_size)}")
    dec = sd.get("cls.predictions.decoder.weight")
    if not tied and dec is not None and not torch.equal(
            dec.to(device=embed.device, dtype=embed.dtype), embed):
        raise ValueError(
            "checkpoint's MLM decoder is not tied to the word embeddings; "
            "the native head computes logits from the tied embedding")
    params = {
        "token_embed.embedding": embed,
        "pos_embedding": load(emb + "position_embeddings.weight"),
        "type_embedding": load(emb + "token_type_embeddings.weight"),
        **ln("embed_ln", emb + "LayerNorm"),
        **dense("mlm_transform", "cls.predictions.transform.dense"),
        **ln("mlm_ln", "cls.predictions.transform.LayerNorm"),
        "mlm_bias": load("cls.predictions.bias"),
    }
    n = 0
    while f"bert.encoder.layer.{n}.attention.self.query.weight" in sd:
        n += 1
    if n != config.num_layers:
        raise ValueError(
            f"checkpoint has {n} encoder layers, config expects "
            f"{config.num_layers}")
    for i in range(config.num_layers):
        p, out = f"bert.encoder.layer.{i}.", f"layers.{i}."
        for hf, ours in (("attention.self.query", "query"),
                         ("attention.self.key", "key"),
                         ("attention.self.value", "value"),
                         ("attention.output.dense", "out")):
            params.update(dense(f"{out}attention.{ours}", p + hf))
        params.update(ln(out + "attn_ln", p + "attention.output.LayerNorm"))
        params.update(dense(out + "mlp.wi", p + "intermediate.dense"))
        params.update(dense(out + "mlp.wo", p + "output.dense"))
        params.update(ln(out + "mlp_ln", p + "output.LayerNorm"))
    return params


def import_bert(path, config=None, *, device="cuda", dtype=None,
                **config_overrides):
    """(config, params) from a local HF ``BertForMaskedLM`` directory."""
    hf_cfg, sd = _open(path)
    if config is None:
        config = config_from_hf_bert(hf_cfg)
    if config_overrides:
        config = dataclasses.replace(config, **config_overrides)
    params = import_bert_state_dict(
        sd, config, tied=bool(getattr(hf_cfg, "tie_word_embeddings", True)),
        device=device, dtype=dtype)
    return config, params


# -- Mixtral ----------------------------------------------------------------


def _validate_hf_mixtral(hf_config) -> None:
    """Exact-or-rejected guards, run on every import path."""
    if getattr(hf_config, "model_type", "") != "mixtral":
        raise ValueError(
            f"expected model_type='mixtral', got "
            f"{getattr(hf_config, 'model_type', None)!r}")
    if getattr(hf_config, "sliding_window", None):
        raise ValueError(
            "checkpoint sets sliding_window; the native MoE attention is "
            "full-causal — importing would silently change logits "
            "(Mixtral-8x7B weights are trained/served full-attention; "
            "re-export the checkpoint with sliding_window=null)")
    if getattr(hf_config, "rope_scaling", None):
        raise ValueError("rope_scaling is not implemented natively")


def config_from_hf_mixtral(hf_config):
    """The port's ``MoeConfig`` of an HF ``MixtralConfig``, at capacity
    E / k (no token can be dropped, so the capacity dispatch computes
    HF's dense renormalized mixture exactly)."""
    from tensorflow_train_distributed_torch.models.moe import MoeConfig

    _validate_hf_mixtral(hf_config)
    e = hf_config.num_local_experts
    k = hf_config.num_experts_per_tok
    return MoeConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=hf_config.num_key_value_heads,
        ffn_size=hf_config.intermediate_size,
        num_experts=e,
        top_k=k,
        capacity_factor=float(e) / float(k),
        moe_every=1,
        max_positions=hf_config.max_position_embeddings,
        rope_base=hf_config.rope_theta,
        rms_epsilon=hf_config.rms_norm_eps,
    )


def _moe_state_dict(sd, config, load: _Loader, tied: bool, moe: str,
                    expert_fmt: str, names: tuple, shared: bool) -> dict:
    """Decoder layers with an expert stack under ``p + moe``: experts'
    ``expert_fmt.format(e, w)`` weights for w in ``names`` (gate, up,
    down), the router ``gate.weight`` (the f32 router kernel's [d, E]),
    and with ``shared`` Qwen's gated shared expert."""
    params = _decoder_frame(sd, load, config, tied)
    _probe_count(sd, "model.layers.{}.input_layernorm.weight",
                 config.num_layers, "decoder layers")
    _probe_count(sd, "model.layers.0." + moe + expert_fmt.format(
        "{}", names[0]), config.num_experts, "experts per layer")
    for i in range(config.num_layers):
        p, out = f"model.layers.{i}.", f"layers.{i}."
        params.update(_attention(load, p, out, config.qkv_bias))
        m = p + moe
        params[f"{out}moe.router.kernel"] = load.kernel(m + "gate.weight")
        for w, ours in zip(names, ("wi_gate", "wi_up", "wo")):
            params[f"{out}moe.experts.{ours}.kernel"] = load.stack(
                m + expert_fmt.format(e, w)
                for e in range(config.num_experts))
        if shared:
            for hf, ours in (("gate_proj", "wi_gate"), ("up_proj", "wi_up"),
                             ("down_proj", "wo")):
                params[f"{out}moe.shared_mlp.{ours}.kernel"] = load.kernel(
                    f"{m}shared_expert.{hf}.weight")
            params[f"{out}moe.shared_gate.kernel"] = load.kernel(
                m + "shared_expert_gate.weight")
    return params


def import_mixtral_state_dict(state_dict, config, *, tied: bool = False,
                              device="cuda", dtype=None) -> dict:
    """An HF ``MixtralForCausalLM`` state dict → the port's MoE
    parameters: ``w1`` = gate, ``w3`` = up, ``w2`` = down, stacked over
    the expert axis."""
    if getattr(config, "shared_expert_size", None):
        raise ValueError(
            "HF Mixtral has no shared expert; import with "
            "shared_expert_size=None (the checkpoint cannot populate "
            f"shared_mlp, config asks for {config.shared_expert_size})")
    return _moe_state_dict(
        state_dict, config, _Loader(state_dict, device,
                                    _dtype(config, dtype)),
        tied, "block_sparse_moe.", "experts.{}.{}.weight",
        ("w1", "w3", "w2"), shared=False)


def import_mixtral(path, config=None, *, device="cuda", dtype=None,
                   **config_overrides):
    """(MoeConfig, params) from a local HF Mixtral directory."""
    hf_cfg, sd = _open(path)
    _validate_hf_mixtral(hf_cfg)
    if config is None:
        config = config_from_hf_mixtral(hf_cfg)
    elif "capacity_factor" not in config_overrides:
        # Parity holds only at capacity E/k (no drops): a preset's
        # production capacity would drop tokens from step 0.
        config = dataclasses.replace(
            config, capacity_factor=(float(hf_cfg.num_local_experts)
                                     / hf_cfg.num_experts_per_tok))
    if config_overrides:
        config = dataclasses.replace(config, **config_overrides)
    params = import_mixtral_state_dict(
        sd, config, tied=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        device=device, dtype=dtype)
    return config, params


# -- Qwen2-MoE (shared expert + gate, qkv biases, raw top-k gates) ---------


def _validate_hf_qwen2_moe(hf_config) -> None:
    """Exact-or-rejected guards for ``Qwen2MoeForCausalLM`` imports."""
    if getattr(hf_config, "model_type", "") != "qwen2_moe":
        raise ValueError(
            f"expected model_type='qwen2_moe', got "
            f"{getattr(hf_config, 'model_type', None)!r}")
    if getattr(hf_config, "decoder_sparse_step", 1) != 1:
        raise ValueError(
            "decoder_sparse_step != 1 (MoE on every layer) is not "
            "representable (native moe_every covers alternation, but "
            "Qwen's dense layers use intermediate_size, a THIRD ffn "
            "width the native config does not carry)")
    if getattr(hf_config, "mlp_only_layers", None):
        raise ValueError("mlp_only_layers is not representable natively")
    if (getattr(hf_config, "use_sliding_window", False)
            and getattr(hf_config, "sliding_window", None)):
        raise ValueError(
            "checkpoint enables sliding_window; the native MoE "
            "attention is full-causal — importing would silently "
            "change logits")
    if getattr(hf_config, "rope_scaling", None):
        raise ValueError("rope_scaling is not implemented natively")
    if getattr(hf_config, "hidden_act", "silu") != "silu":
        raise ValueError(
            f"hidden_act={hf_config.hidden_act!r}; the native experts "
            "are SwiGLU (silu) only")


def config_from_hf_qwen2_moe(hf_config):
    """The port's ``MoeConfig`` of an HF ``Qwen2MoeConfig``: the shared
    expert and its sigmoid gate, q/k/v biases, ``norm_topk_prob`` (Qwen
    defaults to raw softmax gates), capacity E / k."""
    from tensorflow_train_distributed_torch.models.moe import MoeConfig

    _validate_hf_qwen2_moe(hf_config)
    e = hf_config.num_experts
    k = hf_config.num_experts_per_tok
    return MoeConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=hf_config.num_key_value_heads,
        ffn_size=hf_config.moe_intermediate_size,
        num_experts=e,
        top_k=k,
        capacity_factor=float(e) / float(k),
        moe_every=1,
        max_positions=hf_config.max_position_embeddings,
        rope_base=hf_config.rope_theta,
        rms_epsilon=hf_config.rms_norm_eps,
        shared_expert_size=hf_config.shared_expert_intermediate_size,
        shared_expert_gate=True,
        norm_topk_prob=bool(getattr(hf_config, "norm_topk_prob", False)),
        qkv_bias=True,
    )


def import_qwen2_moe_state_dict(state_dict, config, *, tied: bool = False,
                                device="cuda", dtype=None) -> dict:
    """An HF ``Qwen2MoeForCausalLM`` state dict → the port's MoE
    parameters."""
    if not getattr(config, "shared_expert_size", None) or \
            not getattr(config, "shared_expert_gate", False):
        raise ValueError(
            "Qwen2-MoE checkpoints carry a gated shared expert; import "
            "with shared_expert_size set and shared_expert_gate=True "
            "(config_from_hf_qwen2_moe derives both)")
    if not getattr(config, "qkv_bias", False):
        raise ValueError(
            "Qwen2-MoE checkpoints carry q/k/v projection biases; "
            "import with qkv_bias=True (the mapped tree would carry "
            "bias entries a bias-free attention never creates)")
    return _moe_state_dict(
        state_dict, config, _Loader(state_dict, device,
                                    _dtype(config, dtype)),
        tied, "mlp.", "experts.{}.{}.weight",
        ("gate_proj", "up_proj", "down_proj"), shared=True)


def import_qwen2_moe(path, config=None, *, device="cuda", dtype=None,
                     **config_overrides):
    """(MoeConfig, params) from a local HF Qwen2-MoE directory."""
    hf_cfg, sd = _open(path)
    _validate_hf_qwen2_moe(hf_cfg)
    if config is None:
        config = config_from_hf_qwen2_moe(hf_cfg)
    else:
        if "capacity_factor" not in config_overrides:
            # Parity holds only at the no-drop capacity E/k.
            config = dataclasses.replace(
                config, capacity_factor=(float(hf_cfg.num_experts)
                                         / hf_cfg.num_experts_per_tok))
        if "norm_topk_prob" not in config_overrides:
            # The gate convention is the checkpoint's.
            config = dataclasses.replace(
                config, norm_topk_prob=bool(
                    getattr(hf_cfg, "norm_topk_prob", False)))
        if ("rms_epsilon" not in config_overrides
                and getattr(hf_cfg, "rms_norm_eps", None) is not None):
            # The norm epsilon is the checkpoint's too (shape-invisible).
            config = dataclasses.replace(
                config, rms_epsilon=float(hf_cfg.rms_norm_eps))
    if config_overrides:
        config = dataclasses.replace(config, **config_overrides)
    params = import_qwen2_moe_state_dict(
        sd, config, tied=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        device=device, dtype=dtype)
    return config, params


def import_moe(path, config=None, *, device="cuda", dtype=None,
               **config_overrides):
    """Sparse-MoE import, dispatched on the checkpoint's ``model_type``
    (Mixtral or Qwen2-MoE), read from ``config.json`` before any weight:
    the one entry point the launcher, ``sample.py`` and ``serve.py``
    share."""
    mt = getattr(hf_io.read_config(path), "model_type", "")
    if mt == "qwen2_moe":
        return import_qwen2_moe(path, config, device=device, dtype=dtype,
                                **config_overrides)
    if mt != "mixtral":
        raise ValueError(
            f"sparse-MoE import supports mixtral and qwen2_moe, got "
            f"model_type={mt!r}")
    return import_mixtral(path, config, device=device, dtype=dtype,
                          **config_overrides)
