"""The port's ServingEngine against the JAX ServingEngine on the CPU.

Both engines get the same JAX-initialised weights (converted with
``convert.params_from_flax``) and the same requests.  The JAX engine runs
in its synchronous atomic-admission mode (``overlap=False,
prefill_budget=0``), the port's only mode; its other modes give the same
tokens bit for bit.  Greedy tokens must be EQUAL, and the engines' block
economics (radix hits, evictions, refused admissions) identical.  Each
workload mixes more requests than slots (refills), two requests sharing a
block-aligned prefix (a radix hit) and, on the fp run, a pool small
enough to refuse admission.  Sampling is checked by distribution (torch
cannot reproduce threefry bits) and by placement invariance.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
import flax.linen as fnn
from scipy import stats

from tensorflow_train_distributed_tpu.models import generate as jgen
from tensorflow_train_distributed_tpu.models.llama import (
    LLAMA_PRESETS as JAX_PRESETS,
    LlamaModel as JaxLlama,
)
from tensorflow_train_distributed_tpu.serving import (
    ServingEngine as JaxEngine,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.models import generate as tgen
from tensorflow_train_distributed_torch.models.llama import (
    LLAMA_PRESETS as TORCH_PRESETS,
)
from tensorflow_train_distributed_torch.serving import (
    ServingEngine as TorchEngine,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(slots=2, cache_len=64, chunk=2, prompt_buckets=(8, 16),
              kv_block_size=4)


def _flat_params(name, seed=0):
    params = JaxLlama(JAX_PRESETS[name]).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


def _requests(seed=0):
    """Five requests over two slots; #0 and #2 share an 8-token (two
    block) prefix, #4 resolves at prefill (max_new 1)."""
    rng = np.random.default_rng(seed)
    pre = [int(t) for t in rng.integers(1, 250, 8)]
    rand = lambda n: [int(t) for t in rng.integers(1, 250, n)]  # noqa: E731
    return [(pre + rand(1), 6), (rand(5), 5), (pre + rand(2), 4),
            (rand(12), 7), (rand(3), 1)]


def _run(engine, reqs):
    ids = [engine.submit(p, m) for p, m in reqs]
    out = engine.run()
    return [out[i] for i in ids]


def _pair(name, *, kv_int8=False, **kw):
    """(jax_tokens, torch_tokens, jax_engine, torch_engine)."""
    flat = _flat_params(name)
    jcfg, tcfg = JAX_PRESETS[name], TORCH_PRESETS[name]
    if kv_int8:
        jcfg = dataclasses.replace(jcfg, kv_cache_int8=True)
        tcfg = dataclasses.replace(tcfg, kv_cache_int8=True)
    reqs = _requests()
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray,
                                        traverse_util.unflatten_dict(
                                            flat, sep="/")),
                     overlap=False, prefill_budget=0, **ENGINE, **kw)
    teng = TorchEngine(tcfg, convert.params_from_flax(flat, tcfg),
                       device="cpu", **ENGINE, **kw)
    return _run(jeng, reqs), _run(teng, reqs), jeng, teng


@pytest.fixture(scope="module")
def tiny_pressure():
    # 8 blocks of 4 rows: two lanes fit, the fourth request must wait.
    return _pair("llama_tiny", kv_pool_blocks=8)


@pytest.fixture(scope="module")
def tiny_scan():
    return _pair("llama_tiny_scan")


@pytest.fixture(scope="module")
def tiny_int8():
    return _pair("llama_tiny", kv_int8=True)


@pytest.fixture(scope="module")
def tiny_chunked_eos(tiny_pressure):
    """Prefill in 4-token pieces (one program at any prompt length), and
    an EOS id: request #1's third generated token, so it stops early."""
    eos = tiny_pressure[1][1][len(_requests()[1][0]) + 2]
    return _pair("llama_tiny", prefill_chunk=4, eos_id=eos) + (eos,)


CASES = ["tiny_pressure", "tiny_scan", "tiny_int8", "tiny_chunked_eos"]


@pytest.mark.parametrize("case", CASES)
def test_greedy_tokens_equal_jax_engine(case, request):
    jtoks, ttoks, *_ = request.getfixturevalue(case)
    assert ttoks == jtoks
    budgets = [len(p) + m for p, m in _requests()]
    if case == "tiny_chunked_eos":
        eos = request.getfixturevalue(case)[-1]
        assert ttoks[1][-1] == eos and len(ttoks[1]) < budgets[1]
    else:
        assert [len(t) for t in ttoks] == budgets


@pytest.mark.parametrize("case", CASES)
def test_block_economics_equal_jax_engine(case, request):
    _, _, jeng, teng, *_ = request.getfixturevalue(case)
    assert teng.kv_stats == jeng.kv_stats
    assert teng.kv_stats["prefix_hits"] >= 1
    assert teng.kv_blocks_in_use() == jeng.kv_blocks_in_use()
    teng._radix.check_invariants()


def test_pool_pressure_refuses_then_admits(tiny_pressure):
    _, ttoks, _, teng = tiny_pressure
    assert teng.kv_stats["alloc_refusals"] >= 1
    assert len(ttoks) == len(_requests())     # every request still served


@pytest.mark.parametrize("name", ["llama_tiny", "llama_tiny_scan"])
def test_first_token_prefill_logits_match_jax(name):
    """The engine's prefill program (batch-1 linear cache, one call over
    the prompt) against the JAX prefill model: f32 logits within 1e-5."""
    flat = _flat_params(name, seed=3)
    jcfg, tcfg = JAX_PRESETS[name], TORCH_PRESETS[name]
    prompt = np.random.default_rng(1).integers(1, 250, (1, 11))
    jmodel = jgen._decode_model(jcfg, 64, slot_decode=True)
    jlogits, _ = jmodel.apply(
        {"params": traverse_util.unflatten_dict(flat, sep="/")},
        jnp.asarray(prompt, jnp.int32), mutable=["cache"])
    tmodel = tgen._decode_model(tcfg, convert.params_from_flax(flat, tcfg),
                                device="cpu")
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(prompt),
                         tmodel.init_cache(1, 64))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.8), (0.9, 20, 0.6)])
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    logits = 3.0 * np.random.default_rng(4).standard_normal(
        (3, 64)).astype(np.float32)
    want = np.asarray(jgen.filter_logits(
        jnp.asarray(logits), temperature=temperature, top_k=top_k,
        top_p=top_p))
    got = tgen.filter_logits(torch.from_numpy(logits),
                             temperature=temperature, top_k=top_k,
                             top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = ~np.isinf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_sampling_draws_follow_filtered_softmax():
    """Chi-square of 4000 draws (one per (seed, count) stream) against
    softmax(filter_logits(...)) computed by the JAX package."""
    flat = _flat_params("llama_tiny")
    cfg = TORCH_PRESETS["llama_tiny"]
    eng = TorchEngine(cfg, convert.params_from_flax(flat, cfg),
                      device="cpu", temperature=0.8, top_k=6, **ENGINE)
    logits = np.random.default_rng(5).standard_normal(
        (1, cfg.vocab_size)).astype(np.float32)
    n = 4000
    draws = eng._pick(torch.from_numpy(np.repeat(logits, n, 0)),
                      list(range(n)), [3] * n).numpy()
    probs = np.asarray(jax.nn.softmax(jgen.filter_logits(
        jnp.asarray(logits[0]), temperature=0.8, top_k=6)))
    support = np.flatnonzero(probs > 0)
    assert set(np.unique(draws)) <= set(support)
    observed = np.array([(draws == s).sum() for s in support])
    chi2, p = stats.chisquare(observed, n * probs[support])
    assert p > 1e-3, (chi2, p, observed)


def test_sampled_tokens_independent_of_slot_placement():
    flat = _flat_params("llama_tiny")
    cfg = TORCH_PRESETS["llama_tiny"]
    params = convert.params_from_flax(flat, cfg)
    reqs = _requests(seed=2)

    def serve(order, slots):
        eng = TorchEngine(cfg, params, device="cpu", temperature=1.0,
                          top_p=0.9, **dict(ENGINE, slots=slots))
        ids = {i: eng.submit(reqs[i][0], reqs[i][1], seed=100 + i)
               for i in order}
        out = eng.run()
        return [out[ids[i]] for i in range(len(reqs))]

    a = serve(range(len(reqs)), 2)
    assert a == serve(reversed(range(len(reqs))), 3)
    assert a == serve(range(len(reqs)), 1)


def test_serve_cli_from_params_npz(tmp_path):
    flat = _flat_params("llama_tiny")
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    out = tmp_path / "out.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch.serve",
         "--config", "llama_tiny_sft", "--params-npz", str(npz),
         "--prompt", "1,2,3", "--prompt", "4,5,6,7,8", "--max-new", "5",
         "--slots", "2", "--chunk", "2", "--cache-len", "64",
         "--kv-block-size", "4", "--device", "cpu", "--output", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    cfg = TORCH_PRESETS["llama_tiny"]
    eng = TorchEngine(cfg, convert.params_from_flax(flat, cfg),
                      device="cpu", slots=2, chunk=2, cache_len=64,
                      kv_block_size=4)
    want = _run(eng, [([1, 2, 3], 5), ([4, 5, 6, 7, 8], 5)])
    assert [rec["tokens"] for rec in lines] == want
