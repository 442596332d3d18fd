"""HuggingFace import and export of the port (``models/hf_io.py``,
``models/import_hf.py``, ``models/export_hf.py``) against transformers and
the JAX package, on the CPU, case by case with the JAX
``tests/test_import_hf.py``.

No network: tiny random HF models are built from a config with
``transformers`` (which only the tests import) and written with
``save_pretrained``; the port reads the directory with its own reader.
Per family (llama, mistral with a window shorter than the sequence,
qwen2 with its biases, gemma, llama3 RoPE scaling, bert, mixtral,
qwen2_moe with raw and renormalized gates):

- the port's import equals ``convert.params_from_flax`` of the JAX
  import of the same model bit for bit (f32);
- the port's logits match transformers' within the JAX tests'
  ``rtol=2e-3, atol=2e-4`` (f32; the gap is the two libraries' f32
  rounding, ~3e-7 here);
- ``config.json`` stripped of every field the class has a default for
  derives the same config, and the same fields, as transformers'
  ``AutoConfig`` and the JAX ``config_from_hf`` read from it;
- single and sharded safetensors and ``pytorch_model.bin`` all load;
- every rejection case of the JAX tests is rejected, with its message.

Exports: a port export loads in ``AutoModelForCausalLM`` with logits
parity; a port export goes through the JAX import, and a JAX export
through the port's, bit for bit; past its shard size an export is written
layer by layer as ``save_pretrained``'s shards and index; a LoRA
checkpoint exports merged.  The JAX constructions are module-scoped.
"""

import copy
import dataclasses
import json
import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from flax import traverse_util

from tensorflow_train_distributed_tpu.models import export_hf as JE
from tensorflow_train_distributed_tpu.models import import_hf as JI
from tensorflow_train_distributed_tpu.models import llama as JL
from tensorflow_train_distributed_tpu.models import moe as JM
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.models import export_hf as TE
from tensorflow_train_distributed_torch.models import generate as TG
from tensorflow_train_distributed_torch.models import hf_io
from tensorflow_train_distributed_torch.models import import_hf as TI
from tensorflow_train_distributed_torch.models import llama as TL
from tensorflow_train_distributed_torch.models import moe as TM
from tensorflow_train_distributed_torch.models import registry

RTOL, ATOL = 2e-3, 2e-4
F32 = dict(device="cpu", dtype=torch.float32)
_C = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=128,
          rope_theta=10_000.0)
_LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
           "high_freq_factor": 4.0, "original_max_position_embeddings": 64}
# name: (config class, its kwargs, model class, seed, sequence length).
FAMILIES = {
    "llama": ("LlamaConfig", dict(_C, rms_norm_eps=1e-5,
                                  attention_bias=False,
                                  tie_word_embeddings=False),
              "LlamaForCausalLM", 0, 16),
    # seq 48 > window 16: parity proves the window semantics.
    "mistral": ("MistralConfig", dict(_C, rms_norm_eps=1e-5,
                                      sliding_window=16,
                                      tie_word_embeddings=False),
                "MistralForCausalLM", 1, 48),
    "qwen2": ("Qwen2Config", dict(_C, rms_norm_eps=1e-5,
                                  use_sliding_window=False,
                                  tie_word_embeddings=False),
              "Qwen2ForCausalLM", 21, 20),
    # MQA, a decoupled head width, tied embeddings.
    "gemma": ("GemmaConfig", dict(_C, num_key_value_heads=1, head_dim=32,
                                  rms_norm_eps=1e-6,
                                  hidden_activation="gelu_pytorch_tanh",
                                  tie_word_embeddings=True),
              "GemmaForCausalLM", 31, 20),
    # Positions past original_max_position_embeddings reach the scaled
    # low-frequency band.
    "llama3": ("LlamaConfig", dict(_C, max_position_embeddings=256,
                                   rms_norm_eps=1e-5, rope_scaling=_LLAMA3,
                                   tie_word_embeddings=False),
               "LlamaForCausalLM", 41, 96),
    "bert": ("BertConfig", dict(vocab_size=200, hidden_size=48,
                                num_hidden_layers=2, num_attention_heads=4,
                                intermediate_size=96,
                                max_position_embeddings=64,
                                type_vocab_size=2, hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0,
                                layer_norm_eps=1e-12),
             "BertForMaskedLM", 0, 12),
    "mixtral": ("MixtralConfig", dict(_C, num_local_experts=4,
                                      num_experts_per_tok=2,
                                      rms_norm_eps=1e-5,
                                      sliding_window=None,
                                      tie_word_embeddings=False),
                "MixtralForCausalLM", 5, 24),
    "qwen2_moe": ("Qwen2MoeConfig", dict(
        _C, moe_intermediate_size=96, shared_expert_intermediate_size=112,
        num_experts=4, num_experts_per_tok=2, rms_norm_eps=1e-5,
        decoder_sparse_step=1, mlp_only_layers=[], norm_topk_prob=False,
        tie_word_embeddings=False), "Qwen2MoeForCausalLM", 7, 24),
    "qwen2_moe_norm": ("Qwen2MoeConfig", dict(
        _C, moe_intermediate_size=96, shared_expert_intermediate_size=112,
        num_experts=4, num_experts_per_tok=2, rms_norm_eps=1e-5,
        decoder_sparse_step=1, mlp_only_layers=[], norm_topk_prob=True,
        tie_word_embeddings=False), "Qwen2MoeForCausalLM", 7, 24),
}
_MOE = ("mixtral", "qwen2_moe", "qwen2_moe_norm")


def _hf_model(name):
    cfg_cls, kw, model_cls, seed, _ = FAMILIES[name]
    cfg = getattr(transformers, cfg_cls)(**copy.deepcopy(kw))
    torch.manual_seed(seed)
    return getattr(transformers, model_cls)(cfg).eval()


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Every family's HF model and its saved directory (safetensors)."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for name in FAMILIES:
        model = _hf_model(name)
        model.save_pretrained(root / name)
        out[name] = (model, str(root / name))
    return out


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(tree), sep="/").items()}


def _port_import(name, path, **kw):
    if name == "bert":
        return TI.import_bert(path, **F32, **kw)
    if name in _MOE:
        return TI.import_moe(path, **F32, remat=False, **kw)
    return TI.import_llama(path, **F32, remat=False, **kw)


def _jax_import(name, model, **kw):
    if name == "bert":
        return JI.import_bert(model, **kw)
    if name in _MOE:
        return JI.import_moe(model, remat=False, dtype=jnp.float32, **kw)
    return JI.import_llama(model, remat=False, dtype=jnp.float32, **kw)


def _model(cfg, params):
    """The port's model of ``cfg`` (f32) holding ``params``, eval mode."""
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = registry.make_task({"config": cfg}, device="meta").model
    model.load_state_dict(params, strict=True, assign=True)
    return model.eval()


def _tokens(name, seed=3):
    vocab = FAMILIES[name][1]["vocab_size"]
    return np.random.default_rng(seed).integers(
        0, vocab, (2, FAMILIES[name][4]))


def _logits(name, cfg, params, tokens, types=None):
    model = _model(cfg, params)
    with torch.no_grad():
        if name == "bert":
            out = model(torch.as_tensor(tokens),
                        token_type_ids=torch.as_tensor(types))
        else:
            out = model(torch.as_tensor(tokens))
    return (out[0] if isinstance(out, tuple) else out).float().numpy()


def _hf_logits(model, tokens, types=None):
    with torch.no_grad():
        kw = {} if types is None else {
            "token_type_ids": torch.as_tensor(types)}
        return model(torch.as_tensor(tokens), **kw).logits.float().numpy()


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _with_config(src: str, dst, **changes) -> str:
    """A copy of the checkpoint directory ``src`` with ``config.json``'s
    fields changed (None deletes one)."""
    shutil.copytree(src, dst)
    path = os.path.join(dst, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    for k, v in changes.items():
        if v is None:
            cfg.pop(k, None)
        else:
            cfg[k] = v
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(dst)


# -- import: the JAX import, HF's logits, the config --------------------------


@pytest.mark.parametrize("name", list(FAMILIES))
def test_import_equals_the_jax_import_bitwise(hf_dirs, name):
    model, path = hf_dirs[name]
    tcfg, tparams = _port_import(name, path)
    jcfg, jparams = _jax_import(name, model)
    _assert_same(tparams, convert.params_from_flax(_flat(jparams), tcfg))
    for f in dataclasses.fields(tcfg):
        if hasattr(jcfg, f.name) and f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("name", list(FAMILIES))
def test_logits_match_transformers(hf_dirs, name):
    model, path = hf_dirs[name]
    cfg, params = _port_import(name, path)
    tokens = _tokens(name)
    types = (np.random.default_rng(4).integers(0, 2, tokens.shape)
             if name == "bert" else None)
    np.testing.assert_allclose(_logits(name, cfg, params, tokens, types),
                               _hf_logits(model, tokens, types), rtol=RTOL,
                               atol=ATOL)


def _jax_config_from_hf(name, hf_cfg):
    if name == "bert":
        return JI.config_from_hf_bert(hf_cfg)
    if name == "mixtral":
        return JI.config_from_hf_mixtral(hf_cfg)
    if name.startswith("qwen2_moe"):
        return JI.config_from_hf_qwen2_moe(hf_cfg)
    return JI.config_from_hf(hf_cfg)


def _port_config_from_hf(name, hf_cfg):
    if name == "bert":
        return TI.config_from_hf_bert(hf_cfg)
    if name == "mixtral":
        return TI.config_from_hf_mixtral(hf_cfg)
    if name.startswith("qwen2_moe"):
        return TI.config_from_hf_qwen2_moe(hf_cfg)
    return TI.config_from_hf(hf_cfg)


@pytest.mark.parametrize("strip", ["defaults", "all_but_shape"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_stripped_config_json_derives_transformers_config(
        hf_dirs, name, strip, tmp_path):
    """Fields absent from ``config.json`` take transformers' class
    defaults (the ones that change logits silently among them): the
    namespace's fields equal ``AutoConfig``'s, and the derived config the
    JAX ``config_from_hf`` of it.  ``defaults`` strips every field the
    class has a default for; ``all_but_shape`` keeps the shapes (sizes,
    layers, heads, experts) and strips the rest."""
    _, path = hf_dirs[name]
    mt = json.loads(open(os.path.join(path, "config.json")).read())[
        "model_type"]
    table = hf_io.CLASS_DEFAULTS[mt]
    keep = set() if strip == "defaults" else {
        k for k in table if k.endswith(("_size", "_layers", "_heads",
                                        "experts", "_tok"))
        or k in ("vocab_size", "max_position_embeddings", "head_dim")}
    # Qwen2's saved layer_types is derived from the layer count.
    d = _with_config(path, tmp_path / "stripped", layer_types=None,
                     **{k: None for k in table if k not in keep})
    ours = hf_io.read_config(d)
    theirs = transformers.AutoConfig.from_pretrained(d)
    for k in table:
        assert getattr(ours, k) == getattr(theirs, k, None), k
    tcfg = _port_config_from_hf(name, ours)
    jcfg = _jax_config_from_hf(name, theirs)
    for f in dataclasses.fields(tcfg):
        if hasattr(jcfg, f.name) and f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.fixture(scope="module")
def llama_formats(hf_dirs, tmp_path_factory):
    model, path = hf_dirs["llama"]
    root = tmp_path_factory.mktemp("formats")
    model.save_pretrained(root / "st_sharded", max_shard_size="100KB")
    model.save_pretrained(root / "bin", safe_serialization=False)
    model.save_pretrained(root / "bin_sharded", safe_serialization=False,
                          max_shard_size="100KB")
    return dict(safetensors=path, **{k: str(root / k) for k in
                                     ("st_sharded", "bin", "bin_sharded")})


@pytest.mark.parametrize("fmt", ["st_sharded", "bin", "bin_sharded"])
def test_every_weight_format_loads_the_same(llama_formats, fmt):
    d = llama_formats[fmt]
    files = os.listdir(d)
    if fmt.endswith("sharded"):
        assert any(f.endswith(".index.json") for f in files), files
    reader = hf_io.CheckpointReader(d)
    assert reader.format == ("bin" if fmt.startswith("bin")
                             else "safetensors")
    _, want = TI.import_llama(llama_formats["safetensors"], **F32)
    _, got = TI.import_llama(d, **F32)
    _assert_same(got, want)


def test_safetensors_reader_reads_bf16_and_f16(tmp_path):
    """The reader's dtypes on a bf16 checkpoint (the layout Llama weights
    ship in) and an f16 one: each tensor read back bit for bit."""
    model = _hf_model("llama")
    for dtype in (torch.bfloat16, torch.float16):
        d = tmp_path / str(dtype)
        model.to(dtype).save_pretrained(d)
        reader = hf_io.CheckpointReader(d)
        sd = model.state_dict()
        for k in reader:
            assert reader[k].dtype == dtype
            assert torch.equal(reader[k], sd[k]), k
        _, params = TI.import_llama(d, device="cpu")        # config dtype
        assert params["lm_head.kernel"].dtype == torch.bfloat16


def test_tied_head_reads_the_embedding(hf_dirs):
    model, path = hf_dirs["llama"]
    sd = {k: v for k, v in model.state_dict().items()
          if k != "lm_head.weight"}
    cfg = TI.config_from_hf(hf_io.read_config(path))
    params = TI.import_llama_state_dict(sd, cfg, **F32)
    assert torch.equal(params["lm_head.kernel"],
                       params["token_embed.embedding"].t())
    # Gemma ties by default: its file carries no head at all.
    _, gemma = hf_dirs["gemma"]
    assert "lm_head.weight" not in hf_io.CheckpointReader(gemma)


def test_binding_window_really_windows(hf_dirs):
    """Beyond the window, the import's logits differ from a no-window
    import of the same weights."""
    _, path = hf_dirs["mistral"]
    cfg, params = TI.import_llama(path, **F32)
    tokens = _tokens("mistral")
    got = _logits("mistral", cfg, params, tokens)
    far = _logits("mistral", dataclasses.replace(cfg, sliding_window=None),
                  params, tokens)
    assert not np.allclose(got[:, 20:], far[:, 20:], atol=1e-3)


def test_router_really_routes(hf_dirs):
    """A capacity that drops tokens changes the outputs: the parity at
    E / k exercised the dispatch."""
    _, path = hf_dirs["mixtral"]
    cfg, params = TI.import_mixtral(path, **F32, remat=False)
    assert cfg.capacity_factor == 2.0
    tokens = _tokens("mixtral")
    tight = _logits("mixtral", dataclasses.replace(cfg, capacity_factor=0.25),
                    params, tokens)
    assert not np.allclose(_logits("mixtral", cfg, params, tokens), tight,
                           atol=1e-4)


@pytest.mark.parametrize("name,new", [("mistral", 40), ("gemma", 6),
                                      ("llama3", 6)])
def test_greedy_decode_equals_transformers_generate(hf_dirs, name, new):
    """``generate()`` on the import reproduces HF's greedy generate token
    for token: the rolling window's ring (mistral), the decoupled head
    width and embedding scale through the cache (gemma), the scaled
    frequencies (llama3)."""
    model, path = hf_dirs[name]
    cfg, params = TI.import_llama(path, **F32)
    prompt = np.random.default_rng(0).integers(2, 256, (1, 24 if name ==
                                                        "mistral" else 3))
    got = TG.generate(dataclasses.replace(cfg, dtype=torch.float32), params,
                      prompt, new, device="cpu")
    with torch.no_grad():
        want = model.generate(torch.as_tensor(prompt), max_new_tokens=new,
                              do_sample=False)
    assert got.tolist() == want.tolist()


def test_overrides_run_before_the_guards(hf_dirs, tmp_path):
    """The guards hold the final config (after the overrides): an
    override that brings the config into agreement imports, one that
    would drop the checkpoint's RoPE scaling cannot."""
    _, path = hf_dirs["llama"]
    cfg = TI.config_from_hf(hf_io.read_config(path))
    bad = dataclasses.replace(cfg, rms_epsilon=1e-6)       # checkpoint 1e-5
    with pytest.raises(ValueError, match="rms_norm_eps"):
        TI.import_llama(path, bad, **F32)
    got, _ = TI.import_llama(path, bad, **F32, rms_epsilon=1e-5)
    assert got.rms_epsilon == 1e-5
    _, path3 = hf_dirs["llama3"]
    good = TI.config_from_hf(hf_io.read_config(path3))
    assert good.rope_scaling == (8.0, 1.0, 4.0, 64)
    with pytest.raises(ValueError, match="rope_scaling"):
        TI.import_llama(path3, good, **F32, rope_scaling=None)
    # A gemma checkpoint under a config missing a Gemma knob, and the
    # override that fixes it.
    _, pathg = hf_dirs["gemma"]
    gcfg = TI.config_from_hf(hf_io.read_config(pathg))
    wrong = dataclasses.replace(gcfg, norm_zero_centered=False)
    with pytest.raises(ValueError, match="model_type='gemma'"):
        TI.import_llama(pathg, wrong, **F32)
    got, _ = TI.import_llama(pathg, wrong, **F32, norm_zero_centered=True)
    assert got.norm_zero_centered


def test_qwen2_moe_config_passed_adopts_the_checkpoint(hf_dirs, tmp_path):
    """With a preset passed, capacity, gate convention and epsilon are the
    checkpoint's; an explicit override wins."""
    _, path = hf_dirs["qwen2_moe_norm"]
    d = _with_config(path, tmp_path / "eps", rms_norm_eps=2e-6)
    preset = TM.MOE_PRESETS["qwen_moe_tiny"]
    assert preset.norm_topk_prob is False
    cfg, _ = TI.import_qwen2_moe(d, preset, **F32)
    assert (cfg.rms_epsilon, cfg.norm_topk_prob) == (2e-6, True)
    cfg, _ = TI.import_qwen2_moe(d, preset, **F32, rms_epsilon=3e-6)
    assert cfg.rms_epsilon == 3e-6


# -- every rejection of the JAX importer --------------------------------------


def _ns(**fields):
    return hf_io.config_namespace(fields)


_LLAMA_NS = dict(model_type="llama", hidden_size=64, num_attention_heads=4)


@pytest.mark.parametrize("fields,match", [
    (dict(model_type="bert"), "Llama-family"),
    (dict(model_type="gemma2"), "gemma2"),
    (dict(_LLAMA_NS, rope_scaling={"rope_type": "yarn", "factor": 4.0}),
     "yarn"),
    (dict(_LLAMA_NS, attention_bias=True), "biases"),
    (dict(_LLAMA_NS, hidden_act="gelu"), "hidden_act"),
    (dict(_LLAMA_NS, model_type="qwen2", use_sliding_window=True),
     "use_sliding_window"),
    (dict(_LLAMA_NS, head_dim=32), "explicit head_dim"),
    (dict(_LLAMA_NS, model_type="gemma", hidden_activation="gelu"),
     "hidden_activation"),
])
def test_llama_family_guards(fields, match):
    with pytest.raises(ValueError, match=match):
        TI.config_from_hf(_ns(**fields))
    if fields["model_type"] in ("llama", "qwen2", "gemma", "bert"):
        with pytest.raises(ValueError, match=match):
            JI.config_from_hf(transformers.AutoConfig.for_model(**fields))


@pytest.mark.parametrize("change,match", [
    (dict(vocab_size=512), "embed"),
    (dict(num_layers=1), "2 decoder layers"),
    (dict(num_layers=3), "2 decoder layers"),
    (dict(qkv_bias=True), "no q/k/v projection biases"),
    (dict(fused_qkv=True), "fused_qkv"),
])
def test_state_dict_guards(hf_dirs, change, match):
    _, path = hf_dirs["llama"]
    cfg = dataclasses.replace(TI.config_from_hf(hf_io.read_config(path)),
                              **change)
    with pytest.raises(ValueError, match=match):
        TI.import_llama_state_dict(hf_io.CheckpointReader(path), cfg, **F32)


@pytest.mark.parametrize("knob", [dict(embed_scale=True),
                                  dict(norm_zero_centered=True),
                                  dict(mlp_activation="gelu")])
def test_gemma_knobs_on_a_llama_checkpoint_rejected(hf_dirs, knob):
    _, path = hf_dirs["llama"]
    cfg = dataclasses.replace(TI.config_from_hf(hf_io.read_config(path)),
                              **knob)
    with pytest.raises(ValueError, match="embed_scale"):
        TI.import_llama(path, cfg, **F32)


def test_biased_checkpoint_needs_the_qkv_bias_config(hf_dirs):
    _, path = hf_dirs["qwen2"]
    cfg = dataclasses.replace(TI.config_from_hf(hf_io.read_config(path)),
                              qkv_bias=False)
    with pytest.raises(ValueError, match="qkv_bias"):
        TI.import_llama_state_dict(hf_io.CheckpointReader(path), cfg, **F32)


def test_sliding_window_zero_imports_as_full_attention(hf_dirs, tmp_path):
    _, path = hf_dirs["mistral"]
    d = _with_config(path, tmp_path / "w0", sliding_window=0)
    cfg, _ = TI.import_llama(d, **F32)
    assert cfg.sliding_window is None
    assert JI.config_from_hf(transformers.AutoConfig.from_pretrained(
        d)).sliding_window is None


@pytest.mark.parametrize("case", ["layers_1", "layers_3", "plain_config",
                                  "model_type", "position", "act"])
def test_bert_guards(hf_dirs, case, tmp_path):
    from tensorflow_train_distributed_torch.models.bert import BertConfig

    _, path = hf_dirs["bert"]
    sd = hf_io.CheckpointReader(path)
    base = TI.config_from_hf_bert(hf_io.read_config(path))
    if case.startswith("layers"):
        cfg = dataclasses.replace(base, num_layers=int(case[-1]))
        with pytest.raises(ValueError, match="encoder layers"):
            TI.import_bert_state_dict(sd, cfg, **F32)
    elif case == "plain_config":
        with pytest.raises(ValueError, match="config_from_hf_bert"):
            TI.import_bert_state_dict(sd, BertConfig(), **F32)
    else:
        change = {"model_type": dict(model_type="llama"),
                  "position": dict(position_embedding_type="relative_key"),
                  "act": dict(hidden_act="relu")}[case]
        fields = dict(vars(hf_io.read_config(path)), **change)
        match = {"model_type": "model_type 'bert'", "position": "absolute",
                 "act": "hidden_act"}[case]
        with pytest.raises(ValueError, match=match):
            TI.config_from_hf_bert(_ns(**fields))


def test_bert_untied_decoder_rejected(hf_dirs):
    _, path = hf_dirs["bert"]
    sd = dict(hf_io.CheckpointReader(path))
    sd["cls.predictions.decoder.weight"] = torch.zeros(200, 48)
    cfg = TI.config_from_hf_bert(hf_io.read_config(path))
    with pytest.raises(ValueError, match="not tied"):
        TI.import_bert_state_dict(sd, cfg, tied=False, **F32)


@pytest.mark.parametrize("fields,match", [
    (dict(sliding_window=64), "sliding_window"),
    (dict(rope_scaling={"rope_type": "linear", "factor": 2.0}),
     "rope_scaling"),
    (dict(model_type="llama"), "expected model_type='mixtral'"),
])
def test_mixtral_guards(hf_dirs, fields, match):
    _, path = hf_dirs["mixtral"]
    ns = _ns(**dict(vars(hf_io.read_config(path)), **fields))
    with pytest.raises(ValueError, match=match):
        TI.config_from_hf_mixtral(ns)


@pytest.mark.parametrize("fields,match", [
    (dict(decoder_sparse_step=2), "decoder_sparse_step"),
    (dict(mlp_only_layers=[0]), "mlp_only_layers"),
    (dict(use_sliding_window=True, sliding_window=64), "sliding_window"),
    (dict(rope_scaling={"rope_type": "linear", "factor": 2.0}),
     "rope_scaling"),
    (dict(hidden_act="gelu"), "SwiGLU"),
    (dict(model_type="mixtral"), "expected model_type='qwen2_moe'"),
])
def test_qwen2_moe_guards(hf_dirs, fields, match):
    _, path = hf_dirs["qwen2_moe"]
    ns = _ns(**dict(vars(hf_io.read_config(path)), **fields))
    with pytest.raises(ValueError, match=match):
        TI.config_from_hf_qwen2_moe(ns)


@pytest.mark.parametrize("case,match", [
    ("mixtral_shared", "no shared expert"),
    ("qwen_unshared", "gated shared expert"),
    ("qwen_biasfree", "q/k/v projection biases"),
    ("dispatch", "sparse-MoE import supports"),
    ("experts", "experts per layer"),
])
def test_moe_state_dict_guards(hf_dirs, case, match):
    if case == "dispatch":
        with pytest.raises(ValueError, match=match):
            TI.import_moe(hf_dirs["llama"][1], **F32)
        return
    name = "mixtral" if case.startswith(("mixtral", "experts")) \
        else "qwen2_moe"
    _, path = hf_dirs[name]
    sd = hf_io.CheckpointReader(path)
    ns = hf_io.read_config(path)
    if name == "mixtral":
        cfg = TI.config_from_hf_mixtral(ns)
        cfg = dataclasses.replace(cfg, **(
            dict(shared_expert_size=32) if case == "mixtral_shared"
            else dict(num_experts=3)))
        fn = TI.import_mixtral_state_dict
    else:
        cfg = dataclasses.replace(TI.config_from_hf_qwen2_moe(ns), **(
            dict(shared_expert_size=None) if case == "qwen_unshared"
            else dict(qkv_bias=False)))
        fn = TI.import_qwen2_moe_state_dict
    with pytest.raises(ValueError, match=match):
        fn(sd, cfg, **F32)


def test_missing_directory_and_weights_fail_clearly(tmp_path, hf_dirs):
    with pytest.raises(FileNotFoundError, match="no HuggingFace checkpoint"):
        TI.import_llama(str(tmp_path / "nowhere"), **F32)
    d = tmp_path / "config_only"
    d.mkdir()
    shutil.copy(os.path.join(hf_dirs["llama"][1], "config.json"), d)
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        TI.import_llama(str(d), **F32)


# -- export -------------------------------------------------------------------

_EXPORTS = {
    # preset: (port config, JAX config, HF class)
    "llama": ("llama_tiny", {}, "LlamaForCausalLM"),
    "llama_scan": ("llama_tiny_scan", {}, "LlamaForCausalLM"),
    "mistral": ("llama_tiny", dict(sliding_window=16), "MistralForCausalLM"),
    "qwen2": ("llama_tiny", dict(qkv_bias=True), "Qwen2ForCausalLM"),
    "llama3": ("llama_tiny", dict(rope_scaling=(8.0, 1.0, 4.0, 64),
                                  max_positions=256), "LlamaForCausalLM"),
    "mixtral": ("moe_tiny", dict(capacity_factor=2.0), "MixtralForCausalLM"),
    "qwen2_moe": ("qwen_moe_tiny", {}, "Qwen2MoeForCausalLM"),
}


def _export_configs(name):
    preset, extra, _ = _EXPORTS[name]
    moe = preset.endswith("moe_tiny") or preset == "moe_tiny"
    tp = (TM.MOE_PRESETS if moe else TL.LLAMA_PRESETS)[preset]
    jp = (JM.MOE_PRESETS if moe else JL.LLAMA_PRESETS)[preset]
    return (dataclasses.replace(tp, dtype=torch.float32, remat=False,
                                **extra),
            dataclasses.replace(jp, dtype=jnp.float32, remat=False,
                                **extra), moe)


def _port_export(cfg, params, out, moe):
    if not moe:
        return TE.export_llama(cfg, params, out)
    if cfg.shared_expert_size:
        return TE.export_qwen2_moe(cfg, params, out)
    return TE.export_mixtral(cfg, params, out)


@pytest.mark.parametrize("name", list(_EXPORTS))
def test_port_export_loads_in_transformers(name, tmp_path):
    cfg, _, moe = _export_configs(name)
    params = convert.init_params(cfg, torch.Generator().manual_seed(2),
                                 device="cpu", dtype=torch.float32)
    out = _port_export(cfg, params, tmp_path / "hf", moe)
    hf = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    assert type(hf).__name__ == _EXPORTS[name][2]
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48))
    np.testing.assert_allclose(_logits(name, cfg, params, tokens),
                               _hf_logits(hf, tokens), rtol=RTOL, atol=ATOL)
    # The port's own import of it is the identity on the weights.
    back_cfg, back = (TI.import_moe if moe else TI.import_llama)(
        str(out), **F32)
    _assert_same(back, params)
    for f in ("sliding_window", "rope_scaling", "qkv_bias", "num_kv_heads",
              "norm_topk_prob"):
        assert getattr(back_cfg, f, None) == getattr(cfg, f, None), f


@pytest.mark.parametrize("name", ["llama", "mixtral", "qwen2_moe"])
def test_sharded_export_writes_layer_by_layer(name, tmp_path, monkeypatch):
    """Past ``hf_io.MAX_SHARD_BYTES`` (5 GB; here one layer's bytes) the
    export is ``save_pretrained``'s sharded layout, whole layers to a
    shard, and loads in transformers, the port and the JAX package as the
    single file does."""
    cfg, _, moe = _export_configs(name)
    params = convert.init_params(cfg, torch.Generator().manual_seed(4),
                                 device="cpu", dtype=torch.float32)
    single = _port_export(cfg, params, tmp_path / "single", moe)
    want = hf_io.CheckpointReader(single)
    layer = sum(want[k].numel() * 4 for k in want
                if k.startswith("model.layers.0."))
    monkeypatch.setattr(hf_io, "MAX_SHARD_BYTES", layer)
    out = _port_export(cfg, params, tmp_path / "hf", moe)
    index = json.loads((out / "pytorch_model.bin.index.json").read_text())
    shards = sorted(f for f in os.listdir(out) if f.endswith(".bin"))
    # The embedding, each layer, then the final norm and the head.
    assert len(shards) == cfg.num_layers + 2, shards
    assert shards[0] == f"pytorch_model-00001-of-{len(shards):05d}.bin"
    assert set(index["weight_map"].values()) == set(shards)
    assert index["weight_map"]["model.layers.1.input_layernorm.weight"] == (
        shards[2])
    assert index["metadata"]["total_size"] == sum(
        want[k].numel() * 4 for k in want)
    got = hf_io.CheckpointReader(out)
    assert got.format == "bin" and set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    hf = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    np.testing.assert_allclose(_logits(name, cfg, params, tokens),
                               _hf_logits(hf, tokens), rtol=RTOL, atol=ATOL)
    _, jparams = (JI.import_moe if moe else JI.import_llama)(
        str(out), remat=False, dtype=jnp.float32)
    _assert_same(convert.params_from_flax(_flat(jparams), cfg), params)
    # A single-file export over it leaves no shard behind.
    monkeypatch.undo()
    _port_export(cfg, params, out, moe)
    assert sorted(os.listdir(out)) == ["config.json", "pytorch_model.bin"]


def test_registry_export_reads_the_checkpoint_mapped(tmp_path):
    """``restore_params`` views the step's file mapped copy-on-write (a
    write to a restored tensor stays in memory), and the registry export
    of the checkpoint equals the export of the same weights in memory."""
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    cfg = registry.get_config("llama_tiny_sft")
    params = convert.init_params(cfg, torch.Generator().manual_seed(5),
                                 device="cpu", dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, {"params": params, "opt_state": {
        k: torch.full_like(v, 7.0) for k, v in params.items()}})
    got = mgr.restore_params()
    assert set(got) == set(params)
    got["final_norm.scale"].add_(1.0)
    assert torch.equal(mgr.restore_params()["final_norm.scale"],
                       params["final_norm.scale"])
    out = TE.export_hf_from_registry("llama_tiny_sft", tmp_path / "ck",
                                     tmp_path / "hf")
    want = TE.export_llama_state_dict(params, cfg)
    sd = hf_io.CheckpointReader(out)
    assert set(sd) == set(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k


@pytest.mark.parametrize("name", list(_EXPORTS))
def test_export_round_trips_with_the_jax_package(name, tmp_path):
    """A port export through the JAX import, and a JAX export through the
    port's import, bit for bit."""
    tcfg, jcfg, moe = _export_configs(name)
    params = convert.init_params(tcfg, torch.Generator().manual_seed(3),
                                 device="cpu", dtype=torch.float32)
    out = _port_export(tcfg, params, tmp_path / "port", moe)
    jimport = JI.import_moe if moe else JI.import_llama
    _, jparams = jimport(str(out), remat=False, dtype=jnp.float32)
    _assert_same(convert.params_from_flax(_flat(jparams), tcfg), params)

    toks = np.zeros((1, 8), np.int32)
    model = (JM.MoeLmModel if moe else JL.LlamaModel)(jcfg)
    jinit = fnn.unbox(model.init(jax.random.key(0), toks)["params"])
    if moe:
        jout = (JE.export_qwen2_moe if jcfg.shared_expert_size
                else JE.export_mixtral)(jcfg, jinit, tmp_path / "jax")
    else:
        jout = JE.export_llama(jcfg, jinit, tmp_path / "jax")
    _, got = (TI.import_moe if moe else TI.import_llama)(str(jout), **F32)
    _assert_same(got, convert.params_from_flax(_flat(jinit), tcfg))


@pytest.mark.parametrize("change,match", [
    (dict(attention_sinks=4, sliding_window=16), "attention_sinks"),
    (dict(embed_scale=True), "Gemma-convention"),
    (dict(head_dim=32), "Gemma-convention"),
    (dict(qkv_bias=True, sliding_window=16), "qkv_bias \\+ sliding_window"),
])
def test_llama_export_guards(change, match):
    cfg = dataclasses.replace(TL.LLAMA_PRESETS["llama_tiny"], **change)
    with pytest.raises(ValueError, match=match):
        TE.hf_config_dict(cfg)
    jcfg = dataclasses.replace(JL.LLAMA_PRESETS["llama_tiny"], **change)
    with pytest.raises(ValueError, match=match):
        JE.hf_config_dict(jcfg)


@pytest.mark.parametrize("preset,change,match", [
    ("moe_tiny", dict(moe_every=2), "moe_every"),
    ("qwen_moe_tiny", {}, "no shared expert"),
    ("moe_tiny", dict(qkv_bias=True), "bias-free"),
    ("moe_tiny", dict(norm_topk_prob=False), "renormalizes"),
])
def test_mixtral_export_guards(preset, change, match):
    cfg = dataclasses.replace(TM.MOE_PRESETS[preset], **change)
    with pytest.raises(ValueError, match=match):
        TE.export_mixtral_state_dict({}, cfg)


@pytest.mark.parametrize("change,match", [
    (dict(moe_every=2), "moe_every"),
    (dict(shared_expert_gate=False), "full Qwen convention"),
])
def test_qwen2_moe_export_guards(change, match):
    cfg = dataclasses.replace(TM.MOE_PRESETS["qwen_moe_tiny"], **change)
    with pytest.raises(ValueError, match=match):
        TE.export_qwen2_moe_state_dict({}, cfg)


def test_non_decoder_config_rejected(tmp_path):
    with pytest.raises(SystemExit, match="Llama- or MoE-family"):
        TE.export_hf_from_registry("mnist", None, tmp_path / "x")
    with pytest.raises(SystemExit, match="Llama- or MoE-family"):
        JE.export_hf_from_registry("mnist", None, tmp_path / "y",
                                   platform="")


def test_fresh_init_export_loads(tmp_path):
    out = TE.export_hf_from_registry("moe_tiny_lm", None, tmp_path / "x")
    hf = transformers.AutoModelForCausalLM.from_pretrained(out)
    assert type(hf).__name__ == "MixtralForCausalLM"
    assert hf_io.checkpoint_bytes(out) > 0
