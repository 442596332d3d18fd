"""The port's linear (non-paged) serving engine against the JAX package's
linear engine on the CPU, mirroring JAX ``tests/test_serving_paged.py``'s
linear cases.

Both packages get the same JAX-initialised weights (``convert``).  In
every case the port's linear engine (``paged=False``) gives greedy tokens
bitwise equal to the JAX linear engine's and to the port's paged
engine's: refills through two slots, speculative rounds (a self draft and
a disagreeing one), a mid-stream cancel of a decoding lane and of a staged
prefill, a long prompt staged between decode chunks, an int8 KV cache,
and MoE on the dense and the dropless gmm dispatch.  Around them: the
``TTD_NO_PAGED_KV`` kill switch, the LRU-bounded manual prefix cache,
seeded sampling linear against paged, the refusals of what needs the
pool (JAX's returns), no paged kernel on the linear path, and the
flight recorder's engine events against the JAX engine's.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.models import moe as JM
from tensorflow_train_distributed_tpu.models.llama import (
    LLAMA_PRESETS as JAX_PRESETS,
    LlamaModel as JaxLlama,
)
from tensorflow_train_distributed_tpu.runtime import events as jevents
from tensorflow_train_distributed_tpu.serving import (
    ServingEngine as JaxEngine,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.models import generate as tgen
from tensorflow_train_distributed_torch.models import moe as TM
from tensorflow_train_distributed_torch.models.llama import (
    LLAMA_PRESETS as TORCH_PRESETS,
)
from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.runtime import events as tevents
from tensorflow_train_distributed_torch.serving import (
    ServingEngine as TorchEngine,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these many small ops (the suite runs in
    parallel workers); the results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(model, seed=0) -> dict:
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


def _tree(flat):
    return jax.tree.map(jnp.asarray,
                        traverse_util.unflatten_dict(flat, sep="/"))


def _llama(name, seed=0, **kw):
    jcfg = dataclasses.replace(JAX_PRESETS[name], **kw)
    tcfg = dataclasses.replace(TORCH_PRESETS[name], **kw)
    return jcfg, tcfg, _flat(JaxLlama(jcfg), seed)


def _moe(dispatch):
    jcfg = dataclasses.replace(JM.MOE_PRESETS["moe_tiny"], dispatch=dispatch)
    tcfg = dataclasses.replace(TM.MOE_PRESETS["moe_tiny"], dispatch=dispatch)
    return jcfg, tcfg, _flat(JM.MoeLmModel(jcfg))


def _reqs(seed, spec):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(1, 200, n)], m) for n, m in spec]


def _run_all(eng, reqs, seeds=None):
    seeds = seeds or [None] * len(reqs)
    ids = [eng.submit(p, m, seed=s) for (p, m), s in zip(reqs, seeds)]
    out = eng.run()
    return [list(out[i]) for i in ids]


def _cancel(eng, reqs, seeds=None):
    """JAX ``test_paged_matches_linear_mid_stream_cancel``: cancel a
    staged prefill and a decoding lane; the survivors' tokens."""
    short, long_prompt = reqs[:3], reqs[3]
    a = eng.submit(*short[0])
    b = eng.submit(*short[1])
    eng.serve_step()
    c = eng.submit(*long_prompt)           # stages behind the decode
    d = eng.submit(*short[2])
    eng.serve_step()
    assert eng.cancel(c)                   # mid-staged-prefill
    eng.serve_step()
    assert eng.cancel(a)                   # mid-decode
    out = {}
    while eng.pending():
        out.update(eng.serve_step())
    return [list(out[b]), list(out[d])]


def _interleave(eng, reqs, seeds=None):
    """JAX ``test_paged_matches_linear_staged_interleave``: a long prompt
    admitted mid-stream in several installments."""
    ids = [eng.submit(p, m, seed=7 + i) for i, (p, m) in enumerate(reqs[:2])]
    eng.serve_step()
    ids.append(eng.submit(*reqs[2], seed=99))
    out = {}
    while eng.pending():
        out.update(eng.serve_step())
    return [list(out[i]) for i in ids]


BASE = dict(slots=2, cache_len=64, chunk=4, prompt_buckets=(8, 16),
            kv_block_size=4)
REFILLS = [(5, 6), (3, 9), (7, 4), (4, 12), (6, 1), (2, 0)]
# name -> (models, requests, scenario, engine kwargs, draft models)
CASES = {
    "refills": ("llama", (1, REFILLS), _run_all, BASE, None),
    "speculative_self": (
        "llama", (2, [(5, 8), (7, 6), (3, 9)]), _run_all,
        dict(BASE, cache_len=48, chunk=3, prompt_buckets=(8,),
             speculative_k=3), "self"),
    "speculative_disagreeing": (
        "llama", (2, [(5, 8), (7, 6), (3, 9)]), _run_all,
        dict(BASE, cache_len=48, chunk=3, prompt_buckets=(8,),
             speculative_k=3), "scan"),
    "cancel": ("llama", (3, [(5, 10), (5, 10), (5, 6), (24, 8)]), _cancel,
               dict(BASE, chunk=3, prompt_buckets=(8,), prefill_chunk=8),
               None),
    "interleave": ("llama", (4, [(6, 14), (6, 14), (30, 6)]), _interleave,
                   dict(BASE, slots=3, chunk=3, prompt_buckets=(8,),
                        prefill_chunk=8), None),
    "int8": ("llama_int8", (11, [(5, 6), (3, 9), (7, 4), (4, 8), (6, 1)]),
             _run_all, BASE, None),
    "moe_dense": ("moe_dense", (5, [(4, 6), (6, 5), (3, 8)]), _run_all,
                  dict(BASE, cache_len=32, chunk=3, prompt_buckets=(8,)),
                  None),
    "moe_gmm": ("moe_gmm", (5, [(4, 4), (6, 3)]), _run_all,
                dict(BASE, cache_len=32, chunk=3, prompt_buckets=(8,)),
                None),
}


@pytest.fixture(scope="module")
def models():
    """{name: (jax config, port config, flat JAX params)}."""
    return {"llama": _llama("llama_tiny"),
            "llama_int8": _llama("llama_tiny", kv_cache_int8=True),
            "scan": _llama("llama_tiny_scan", seed=9),
            "moe_dense": _moe("dense"), "moe_gmm": _moe("gmm")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_linear_tokens_equal_jax_linear_and_port_paged(models, case):
    family, (seed, spec), scenario, kw, draft = CASES[case]
    jcfg, tcfg, flat = models[family]
    reqs = _reqs(seed, spec)
    jkw, tkw = dict(kw), dict(kw)
    if draft is not None:
        djcfg, dtcfg, dflat = (models[family] if draft == "self"
                               else models[draft])
        jkw.update(draft_config=djcfg, draft_params=_tree(dflat))
        tkw.update(draft_config=dtcfg,
                   draft_params=convert.params_from_flax(dflat, dtcfg))
    jeng = JaxEngine(jcfg, _tree(flat), paged=False, **jkw)
    want = scenario(jeng, reqs)
    params = convert.params_from_flax(flat, tcfg)
    lin = TorchEngine(tcfg, params, paged=False, device="cpu", **tkw)
    got = scenario(lin, reqs)
    paged = TorchEngine(tcfg, params, device="cpu", **tkw)
    assert not lin.paged and paged.paged
    assert got == want
    assert scenario(paged, reqs) == got
    if draft is not None:
        assert lin.spec_stats["rounds"] >= 1
        assert lin.spec_stats == jeng.spec_stats


def test_kill_switch_restores_linear_engine(models, monkeypatch):
    """``TTD_NO_PAGED_KV=1`` at construction wins over ``paged=True``:
    no pool, no radix, generate()'s tokens."""
    _, tcfg, flat = models["llama"]
    params = convert.params_from_flax(flat, tcfg)
    monkeypatch.setenv("TTD_NO_PAGED_KV", "1")
    eng = TorchEngine(tcfg, params, paged=True, slots=2, cache_len=32,
                      chunk=2, prompt_buckets=(8,), device="cpu")
    assert not eng.paged and eng._kv_pool is None and eng._radix is None
    assert eng.kv_blocks_total() == eng.kv_blocks_in_use() == 0
    assert eng.kv_pool_bytes() == eng.kv_bytes_in_use() == 0
    rid = eng.submit([1, 2, 3], 4)
    want = tgen.generate(tcfg, params, [[1, 2, 3]], 4, device="cpu")
    assert eng.run()[rid] == want[0].tolist()


def test_linear_prefix_cache_is_lru_bounded(models):
    """JAX's test of the same name: preloads past
    ``prefix_cache_limit`` evict the least recently matched."""
    _, tcfg, flat = models["llama"]
    eng = TorchEngine(tcfg, convert.params_from_flax(flat, tcfg), slots=1,
                      cache_len=32, chunk=2, prompt_buckets=(8,),
                      paged=False, prefix_cache_limit=2, device="cpu")
    eng.preload_prefix([1, 1])
    eng.preload_prefix([2, 2])
    eng._match_prefix([1, 1, 9], touch=True)   # refresh [1, 1]
    eng.preload_prefix([3, 3])                 # evicts [2, 2]
    assert len(eng._prefix_caches) == 2
    assert eng._match_prefix([2, 2, 9])[0] == 0
    assert eng._match_prefix([1, 1, 9])[0] == 2
    assert eng._match_prefix([3, 3, 9])[0] == 2


def test_linear_preload_prefix_matches_jax_linear(models):
    """A preloaded system prompt on the linear engine: requests that
    extend it prefill only their suffix (a suffix past the largest
    bucket is accepted because of it), with the JAX linear engine's
    tokens and the port's paged engine's."""
    jcfg, tcfg, flat = models["llama"]
    rng = np.random.default_rng(8)
    pre = [int(t) for t in rng.integers(1, 200, 14)]
    reqs = [(pre + [int(t) for t in rng.integers(1, 200, n)], m)
            for n, m in [(3, 6), (8, 5), (1, 7)]]
    kw = dict(slots=2, cache_len=48, chunk=3, prompt_buckets=(8,))
    outs = []
    for eng in (JaxEngine(jcfg, _tree(flat), paged=False, **kw),
                TorchEngine(tcfg, convert.params_from_flax(flat, tcfg),
                            paged=False, device="cpu", **kw),
                TorchEngine(tcfg, convert.params_from_flax(flat, tcfg),
                            device="cpu", **kw)):
        eng.preload_prefix(pre)
        outs.append(_run_all(eng, reqs))
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("sampling", [dict(temperature=0.9, top_k=16),
                                      dict(temperature=0.7, top_p=0.9)])
def test_sampled_linear_equals_sampled_paged(models, sampling):
    """Seeded sampling through refills: the linear engine's tokens are
    the paged engine's (the streams depend on the request alone)."""
    _, tcfg, flat = models["llama"]
    params = convert.params_from_flax(flat, tcfg)
    reqs = _reqs(1, REFILLS)
    seeds = [11, 22, 33, 44, 55, 66]
    got = [_run_all(TorchEngine(tcfg, params, paged=paged, device="cpu",
                                **BASE, **sampling), reqs, seeds)
           for paged in (False, True)]
    assert got[0] == got[1]


def test_linear_refuses_what_needs_the_pool_as_jax_does(models):
    """The JAX linear engine's answers: no prefix KV to export or
    install, a lane exported without KV, zero blocks and pool bytes."""
    jcfg, tcfg, flat = models["llama"]
    kw = dict(slots=2, cache_len=48, chunk=2, prompt_buckets=(8, 16),
              kv_block_size=4)
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, 200, 13)]
    for eng in (JaxEngine(jcfg, _tree(flat), paged=False, **kw),
                TorchEngine(tcfg, convert.params_from_flax(flat, tcfg),
                            paged=False, device="cpu", **kw)):
        assert eng.export_prefix_kv(prompt) is None
        assert eng.install_prefix_kv({"tokens": prompt[:12], "n": 12},
                                     b"\x00") == 0
        rid = eng.submit(prompt, 10)
        eng.serve_step()
        eng.serve_step()
        meta, blob = eng.export_lane(rid)
        assert (meta["kind"], meta["kv"], blob) == ("lane", None, b"")
        assert eng.install_lane(meta, blob) == 0
        assert (eng.kv_blocks_total(), eng.kv_blocks_in_use(),
                eng.kv_bytes_in_use(), eng.kv_pool_bytes()) == (0, 0, 0, 0)


def test_linear_path_runs_no_paged_kernel(models, monkeypatch):
    """Decode attends through the masked einsum: neither the paged
    attention nor the paged KV gather is called, a repeated prefix and a
    speculative draft included; RMSNorm runs."""
    _, tcfg, flat = models["llama"]
    params = convert.params_from_flax(flat, tcfg)
    called = {"rms_norm": 0}

    def refuse(*a, **k):
        raise AssertionError("a paged kernel ran on the linear engine")

    rms = K.rms_norm

    def counting(*a, **k):
        called["rms_norm"] += 1
        return rms(*a, **k)

    monkeypatch.setattr(K, "paged_attention", refuse)
    monkeypatch.setattr(K, "paged_kv_gather", refuse)
    monkeypatch.setattr(K, "rms_norm", counting)
    pre = list(range(1, 13))
    eng = TorchEngine(tcfg, params, paged=False, device="cpu",
                      draft_config=tcfg, draft_params=params,
                      speculative_k=2, **BASE)
    eng.preload_prefix(pre)
    assert len(_run_all(eng, [(pre + [20], 5), (pre + [21, 22], 6)])) == 2
    assert called["rms_norm"] > 0


def _names(events, prefix=("engine/", "slot/", "prefill/", "decode/")):
    """{name: count} of the engine's events (a recorder's events are
    (name, phase, start, duration, thread, attrs))."""
    out = {}
    for name, *_ in events:
        if name.startswith(prefix):
            out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_engine_records_the_jax_engines_events(models, paged):
    """The flight recorder holds the JAX engine's span and instant names
    for the same workload, and as many per-request events (queued,
    inserted, retired) and decode dispatches."""
    jcfg, tcfg, flat = models["llama"]
    reqs = _reqs(1, REFILLS[:4])
    kw = dict(BASE, overlap=False, prefill_budget=0)
    got = {}
    for name, rec, make in (
            ("jax", jevents.get_recorder(),
             lambda: JaxEngine(jcfg, _tree(flat), paged=paged, **kw)),
            ("port", tevents.get_recorder(),
             lambda: TorchEngine(tcfg, convert.params_from_flax(flat, tcfg),
                                 paged=paged, device="cpu", **kw))):
        eng = make()
        rec.clear()
        _run_all(eng, reqs)
        got[name] = _names(rec.events())
    assert set(got["port"]) == set(got["jax"])
    for key in ("engine/queued", "slot/insert", "slot/retire",
                "decode/dispatch", "decode/wait", "decode/harvest"):
        assert got["port"][key] == got["jax"][key], key
