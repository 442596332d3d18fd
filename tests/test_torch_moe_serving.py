"""MoE decode and serving against the JAX package on the CPU (f32, the
same weights through ``convert``).

- Decode logits (the prompt's fresh call, then single-token calls on the
  shared-index cache) equal JAX's decode within 1e-5, on moe_tiny (dense
  dispatch), moe_tiny with the dropless gmm dispatch (JAX's megablox in
  interpret mode), moe_tiny_shared and qwen_moe_tiny.
- ``generate()`` greedy tokens equal JAX's on the same four.
- The engine mirrors JAX ``tests/test_serving.py``: an MoE engine's
  tokens equal ``generate()``'s and the JAX engine's; dense dispatch
  refuses ``prefill_chunk`` and ``preload_prefix`` with JAX's text and
  exports nothing; gmm buckets, chunks and preloads and still gives
  ``generate()``'s tokens; a gmm lane exported by either package installs
  in the other (MoE caches' wire paths are ``layer_{i}/attention/...``).
- ``serve.py`` and ``sample.py`` with ``--dispatch`` and ``--quant`` print
  the JAX CLIs' lines on the same weights, and refuse what they refuse
  in their words; speculation refuses an MoE target as JAX's does.
"""

import dataclasses
import importlib.util
import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.models import generate as jgen
from tensorflow_train_distributed_tpu.models import moe as JM
from tensorflow_train_distributed_tpu.serving import (
    ServingEngine as JaxEngine,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch import sample as tsample
from tensorflow_train_distributed_torch import serve as tserve
from tensorflow_train_distributed_torch.models import generate as tgen
from tensorflow_train_distributed_torch.models import moe as TM
from tensorflow_train_distributed_torch.serving import (
    ServingEngine as TorchEngine,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (preset, dispatch)
CONFIGS = {"moe_tiny": ("moe_tiny", "dense"),
           "moe_tiny_gmm": ("moe_tiny", "gmm"),
           "moe_tiny_shared": ("moe_tiny_shared", "dense"),
           "qwen_moe_tiny": ("qwen_moe_tiny", "dense")}
LOGIT_TOL = 1e-5    # f32 forwards that agree to rounding
SYNC = dict(overlap=False, prefill_budget=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these many small ops (the suite runs in
    parallel workers); the results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(name, **kw):
    preset, dispatch = CONFIGS[name]
    return (dataclasses.replace(JM.MOE_PRESETS[preset], dispatch=dispatch,
                                **kw),
            dataclasses.replace(TM.MOE_PRESETS[preset], dispatch=dispatch,
                                **kw))


def _flat(cfg, seed=0) -> dict:
    params = JM.MoeLmModel(cfg).init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


def _tree(flat):
    return jax.tree.map(jnp.asarray,
                        traverse_util.unflatten_dict(flat, sep="/"))


@pytest.fixture(scope="module")
def weights():
    """{name: flat JAX params} (the gmm case shares moe_tiny's)."""
    out = {}
    for name in CONFIGS:
        out[name] = _flat(_configs(name)[0])
    return out


def _prompt(b, s, seed=0):
    return np.random.default_rng(seed).integers(1, 250, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_logits_match_jax(weights, name):
    jcfg, tcfg = _configs(name)
    flat = weights[name]
    prompt, steps = _prompt(2, 7, 1), _prompt(2, 3, 2)
    jmodel = jgen._decode_model(jcfg, cache_len=16)
    logits, state = jmodel.apply({"params": _tree(flat)},
                                 jnp.asarray(prompt), mutable=["cache"])
    want = [np.asarray(logits)]
    for j in range(steps.shape[1]):
        logits, state = jmodel.apply(
            {"params": _tree(flat), "cache": state["cache"]},
            jnp.asarray(steps[:, j:j + 1]), mutable=["cache"])
        want.append(np.asarray(logits))
    model = tgen._decode_model(tcfg, convert.params_from_flax(flat, tcfg),
                               device="cpu")
    cache = model.init_cache(2, 16, shared=True)
    with torch.no_grad():
        got = [model(torch.as_tensor(prompt).long(), cache).numpy()]
        for j in range(steps.shape[1]):
            got.append(model(torch.as_tensor(steps[:, j:j + 1]).long(),
                             cache).numpy())
    assert cache.index == 10
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_tokens_equal_jax(weights, name):
    jcfg, tcfg = _configs(name)
    flat = weights[name]
    prompt = _prompt(2, 9, 3)
    want = np.asarray(jgen.generate(jcfg, _tree(flat), jnp.asarray(prompt),
                                    12))
    got = tgen.generate(tcfg, convert.params_from_flax(flat, tcfg), prompt,
                        12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _generate(tcfg, params, prompt, m):
    return tgen.generate(tcfg, params, [prompt], m, device="cpu")[0].tolist()


def _serve(eng, reqs):
    ids = [eng.submit(p, m) for p, m in reqs]
    out = eng.run()
    return [list(out[i]) for i in ids]


@pytest.mark.parametrize("name", ["moe_tiny", "qwen_moe_tiny"])
def test_moe_family_matches_generate(weights, name):
    """JAX ``test_moe_family_matches_generate``: one engine serves the MoE
    decoders, token for token ``generate()``'s under contention and
    refill, and the JAX engine's."""
    jcfg, tcfg = _configs(name)
    flat = weights[name]
    rng = np.random.default_rng(5)
    reqs = [([int(t) for t in rng.integers(1, 256, n)], m)
            for n, m in [(4, 6), (6, 5), (3, 8)]]
    kw = dict(slots=2, cache_len=32, chunk=3, prompt_buckets=(8,))
    params = convert.params_from_flax(flat, tcfg)
    teng = TorchEngine(tcfg, params, device="cpu", **kw)
    assert teng._exact_prefill
    got = _serve(teng, reqs)
    assert got == [_generate(tcfg, params, p, m) for p, m in reqs]
    assert got == _serve(JaxEngine(jcfg, _tree(flat), **SYNC, **kw), reqs)
    assert teng.kv_stats["prefix_hits"] == 0


def test_chunked_prefill_rejected_for_moe(weights):
    jcfg, tcfg = _configs("moe_tiny")
    flat = weights["moe_tiny"]
    with pytest.raises(ValueError, match="prefill_chunk") as je:
        JaxEngine(jcfg, _tree(flat), prefill_chunk=4)
    with pytest.raises(ValueError) as te:
        TorchEngine(tcfg, convert.params_from_flax(flat, tcfg),
                    prefill_chunk=4, device="cpu")
    assert str(te.value) == str(je.value)


def test_dense_moe_refuses_preload_and_export(weights):
    """Dense dispatch prefills at the exact length: ``preload_prefix``
    raises JAX's error, and no prefix or lane KV is exported or
    installed; prompts past every bucket still serve."""
    jcfg, tcfg = _configs("moe_tiny")
    flat = weights["moe_tiny"]
    kw = dict(slots=2, cache_len=48, chunk=2, prompt_buckets=(8,),
              kv_block_size=4)
    jeng = JaxEngine(jcfg, _tree(flat), **SYNC, **kw)
    params = convert.params_from_flax(flat, tcfg)
    teng = TorchEngine(tcfg, params, device="cpu", **kw)
    errs = []
    for eng in (jeng, teng):
        with pytest.raises(ValueError) as e:
            eng.preload_prefix([1, 2, 3, 4, 5])
        errs.append(str(e.value))
        assert eng.export_prefix_kv(list(range(1, 20))) is None
    assert errs[0] == errs[1]
    prompt = [int(t) for t in _prompt(1, 13, 4)[0]]     # past bucket 8
    rid = teng.submit(prompt, 10)
    for _ in range(2):
        teng.serve_step()
    meta, blob = teng.export_lane(rid)
    assert meta["kind"] == "lane" and meta["kv"] is None and blob == b""
    assert teng.install_prefix_kv({"tokens": prompt[:12], "n": 12},
                                  b"") == 0
    assert teng.run()[rid] == _generate(tcfg, params, prompt, 10)


def test_moe_gmm_bucketed_and_chunked_prefill_match_generate(weights):
    """JAX's test of the same name: dropless routing lets pad tokens ride
    along without touching real ones, so bucketed and chunked prefill
    give ``generate()``'s exact-length tokens."""
    _, tcfg = _configs("moe_tiny_gmm")
    params = convert.params_from_flax(weights["moe_tiny_gmm"], tcfg)
    rng = np.random.default_rng(7)
    reqs = [([int(t) for t in rng.integers(1, 256, n)], m)
            for n, m in [(3, 5), (6, 4), (5, 6)]]
    refs = [_generate(tcfg, params, p, m) for p, m in reqs]
    for kw in (dict(prompt_buckets=(8,)), dict(prefill_chunk=4)):
        eng = TorchEngine(tcfg, params, slots=2, cache_len=32, chunk=3,
                          device="cpu", **kw)
        assert not eng._exact_prefill
        assert _serve(eng, reqs) == refs


def test_moe_gmm_prefix_caching_matches_generate(weights):
    """JAX's test of the same name: a preloaded system prompt under the
    gmm dispatch, its blocks hit in the radix."""
    _, tcfg = _configs("moe_tiny_gmm")
    params = convert.params_from_flax(weights["moe_tiny_gmm"], tcfg)
    rng = np.random.default_rng(10)
    system = [int(t) for t in rng.integers(1, 256, 9)]
    reqs = [(system + [int(t) for t in rng.integers(1, 256, d)], m)
            for d, m in [(2, 4), (3, 3)]]
    eng = TorchEngine(tcfg, params, slots=2, cache_len=32, chunk=3,
                      prompt_buckets=(8,), kv_block_size=4, device="cpu")
    eng.preload_prefix(system)
    assert _serve(eng, reqs) == [_generate(tcfg, params, p, m)
                                 for p, m in reqs]
    assert eng.kv_stats["prefix_hit_tokens"] == 16


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_gmm_lane_migrates_between_packages(weights, direction):
    """A gmm lane exported mid-stream by one package installs in the
    other; re-admitted with ``resume_from`` it ends with the uninterrupted
    tokens, its rows hit by the radix.  The manifests name the unrolled
    MoE layers' paths."""
    jcfg, tcfg = _configs("moe_tiny_gmm")
    flat = weights["moe_tiny_gmm"]
    kw = dict(slots=2, cache_len=48, chunk=2, prompt_buckets=(8, 16),
              kv_block_size=4)

    def pair():
        return (JaxEngine(jcfg, _tree(flat), **SYNC, **kw),
                TorchEngine(tcfg, convert.params_from_flax(flat, tcfg),
                            device="cpu", **kw))

    (jsrc, tsrc), (jdst, tdst) = pair(), pair()
    src, dst = (jsrc, tdst) if direction == "jax_to_port" else (tsrc, jdst)
    prompt = [int(t) for t in _prompt(1, 11, 9)[0]]
    rid = src.submit(prompt, 16)
    full = src.run()[rid]
    rid = src.submit(prompt, 16)
    for _ in range(3):
        src.serve_step()
    meta, blob = src.export_lane(rid)
    paths = {tuple(leaf["path"]) for leaf in meta["kv"]["leaves"]}
    assert ("layer_1", "attention", "value_cache") in paths
    assert src.cancel(rid)
    warm = dst.install_lane(meta, blob)
    assert warm == meta["kv"]["n"] >= 12
    done = len(meta["tokens"]) - len(prompt)
    rid = dst.submit(meta["tokens"], meta["remaining"], seed=meta["seed"],
                     resume_from=done)
    assert list(dst.run()[rid]) == list(full)
    assert dst.kv_stats["prefix_hit_tokens"] == warm


# -- the CLIs -----------------------------------------------------------------


def _jax_cli(name):
    """``tools/<name>.py`` loaded by path (``serve`` imports its sibling
    ``sample`` as a top-level module)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_cli", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def moe_npz(tmp_path_factory, weights):
    """moe_tiny's weights as the port's ``--params-npz`` (the JAX CLIs
    read the same tree through a patched checkpoint restore)."""
    path = tmp_path_factory.mktemp("moe") / "params.npz"
    np.savez(path, **weights["moe_tiny"])
    return str(path)


FLAGS = {"dense": ["--dispatch", "dense"], "gmm": ["--dispatch", "gmm"],
         "int8": ["--quant", "int8"],
         "int8_dense": ["--quant", "int8", "--dispatch", "dense"]}


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_serve_cli_prints_the_jax_cli_lines(weights, moe_npz, case, capsys,
                                            monkeypatch, tmp_path):
    jcli = _jax_cli("serve")
    monkeypatch.setattr(sys.modules["sample"], "_restore_params",
                        lambda d: _tree(weights["moe_tiny"]))
    common = ["--config", "moe_tiny_lm", "--prompt", "1,2,3,4",
              "--prompt", "9,8,7,6,5,4,3", "--prompt", "5,5", "--max-new",
              "6", "--slots", "2", "--chunk", "2", "--cache-len", "32",
              "--kv-block-size", "4", *FLAGS[case]]
    assert jcli.main(common + ["--checkpoint-dir", str(tmp_path),
                               "--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert tserve.main(common + ["--params-npz", moe_npz,
                                 "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want and len(want.splitlines()) == 3
    if case == "gmm":
        assert tserve.main(common + ["--params-npz", moe_npz, "--device",
                                     "cpu", "--prefix", "9,8,7,6"]) == 0
        assert capsys.readouterr().out == want


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_sample_cli_prints_the_jax_cli_lines(weights, moe_npz, case, capsys,
                                             monkeypatch, tmp_path):
    jcli = _jax_cli("sample")
    monkeypatch.setattr(jcli, "_restore_params",
                        lambda d: _tree(weights["moe_tiny"]))
    common = ["--config", "moe_tiny_lm", "--prompt", "1,2,3,4",
              "--prompt", "9,8,7,6", "--max-new", "8", *FLAGS[case]]
    assert jcli.main(common + ["--checkpoint-dir", str(tmp_path),
                               "--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert tsample.main(common + ["--params-npz", moe_npz,
                                  "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and len(want.splitlines()) == 2


def test_cli_refusals_carry_jaxs_messages(weights, moe_npz, tmp_path,
                                          monkeypatch):
    """``--kv-int8`` and ``--lora-*`` on MoE, ``--dispatch`` on a Llama
    config, an MoE target with a draft: the JAX CLIs' words."""
    jserve, jsample = _jax_cli("serve"), _jax_cli("sample")
    monkeypatch.setattr(sys.modules["sample"], "_restore_params",
                        lambda d: _tree(weights["moe_tiny"]))
    monkeypatch.setattr(jsample, "_restore_params",
                        lambda d: _tree(weights["moe_tiny"]))
    base = ["--config", "moe_tiny_lm", "--prompt", "1,2"]
    jsrc = ["--checkpoint-dir", str(tmp_path), "--platform", "cpu"]
    tsrc = ["--params-npz", moe_npz, "--device", "cpu"]
    draft = ["--speculative-draft-config", "llama_tiny_sft",
             "--speculative-draft-checkpoint", str(tmp_path)]
    cases = [(jserve, tserve, base + ["--kv-int8"]),
             (jsample, tsample, base + ["--lora-rank", "4"]),
             (jsample, tsample, base + draft),
             (jsample, tsample, base + ["--quant", "int8"] + draft),
             (jsample, tsample, ["--config", "llama_tiny_sft", "--prompt",
                                 "1", "--dispatch", "gmm"])]
    for jmod, tmod, flags in cases:
        with pytest.raises(SystemExit) as je:
            jmod.main(flags + jsrc)
        with pytest.raises(SystemExit) as te:
            tmod.main(flags + tsrc)
        assert str(te.value) == str(je.value), flags


def test_speculation_refuses_an_moe_target_with_jaxs_message(weights):
    """``generate_speculative`` and the speculative engine keep refusing
    an MoE target, as JAX's ``_reject_config`` does."""
    from tensorflow_train_distributed_tpu.models import speculative as jspec
    from tensorflow_train_distributed_torch.models import speculative as tspec

    jcfg, tcfg = _configs("moe_tiny")
    flat = weights["moe_tiny"]
    params = convert.params_from_flax(flat, tcfg)
    prompt = _prompt(1, 5)
    with pytest.raises(ValueError) as je:
        jspec.generate_speculative(jcfg, _tree(flat), jcfg, _tree(flat),
                                   jnp.asarray(prompt), 4, k=2)
    with pytest.raises(ValueError) as te:
        tspec.generate_speculative(tcfg, params, tcfg, params, prompt, 4,
                                   k=2, device="cpu")
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="Llama family only"):
        TorchEngine(tcfg, params, draft_config=tcfg, draft_params=params,
                    speculative_k=2, device="cpu")
