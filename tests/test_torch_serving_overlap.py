"""The port's pipelined serving engine on the CPU: the one-chunk overlap
and staged interleaved prefill (counterpart of the JAX package's
``tests/test_serving_overlap.py``, without its cancel and gateway cases,
which wait with lane control).

The contract: pipelining changes when the host learns about tokens and
when prefill pieces run, never the tokens.  Overlap and interleave on
against off are bit for bit equal for greedy, seeded sampling and
speculative serving, through refills, an EOS in the middle of a chunk, a
long admission mid-stream, radix hits on refills and small prefill
budgets; the counters show that both engaged; each kill switch
(``overlap=False`` / ``TTD_NO_OVERLAP=1``, ``prefill_budget=0`` /
``TTD_NO_INTERLEAVE=1``) restores the synchronous path, the environment
winning over the constructor.  Greedy tokens also equal the JAX engine's
(one module-scoped JAX engine, synchronous with atomic admission, serves
every reference: greedy output does not depend on the engine's shape).
``serve.py``'s new flags end the file: its speculative serving on
checkpoints of the port's launcher gives the tokens of plain greedy
serving.
"""

import json
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.models.llama import (
    LLAMA_PRESETS as JAX_PRESETS,
    LlamaModel as JaxLlama,
)
from tensorflow_train_distributed_tpu.serving import (
    ServingEngine as JaxEngine,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch import serve as tserve
from tensorflow_train_distributed_torch.models.llama import (
    LLAMA_PRESETS as TORCH_PRESETS,
)
from tensorflow_train_distributed_torch.serving import ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = TORCH_PRESETS["llama_tiny"]
DCFG = TORCH_PRESETS["llama_tiny_scan"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these many small ops: under the suite's
    parallel workers a thread pool a worker oversubscribes the cores and
    slows each op tens of times; the results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    """These tests turn the paths on and off themselves; an ambient kill
    switch would turn the on legs off."""
    for switch in ("TTD_NO_OVERLAP", "TTD_NO_INTERLEAVE",
                   "TTD_NO_ADAPTIVE_SPEC"):
        monkeypatch.delenv(switch, raising=False)


def _flat(name, key):
    params = JaxLlama(JAX_PRESETS[name]).init(
        key, jnp.zeros((1, 8), jnp.int32))["params"]
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


@pytest.fixture(scope="module")
def flats():
    return (_flat("llama_tiny", jax.random.PRNGKey(0)),
            _flat("llama_tiny_scan", jax.random.PRNGKey(99)))


@pytest.fixture(scope="module")
def params(flats):
    return convert.params_from_flax(flats[0], CFG)


@pytest.fixture(scope="module")
def draft(flats):
    return dict(draft_config=DCFG,
                draft_params=convert.params_from_flax(flats[1], DCFG))


@pytest.fixture(scope="module")
def ref(flats):
    """Greedy tokens of the JAX engine (synchronous, atomic admission)
    for a list of (prompt, max_new)."""
    eng = JaxEngine(JAX_PRESETS["llama_tiny"], jax.tree.map(
        jnp.asarray, traverse_util.unflatten_dict(flats[0], sep="/")),
        overlap=False, prefill_budget=0, slots=2, cache_len=64, chunk=4,
        prompt_buckets=(8, 16), kv_block_size=4)

    def run(reqs):
        ids = [eng.submit(p, m) for p, m in reqs]
        out = eng.run()
        return [list(out[i]) for i in ids]

    return run


def _serve(params, reqs, **kw):
    eng = ServingEngine(CFG, params, device="cpu", **kw)
    ids = [eng.submit(p, m) for p, m in reqs]
    out = eng.run()
    return [out[i] for i in ids], eng


def _rand(rng, n):
    return [int(t) for t in rng.integers(1, 200, n)]


# -- the kill switches ----------------------------------------------------------


def test_overlap_engages_and_its_kill_switches_restore_sync(params, ref,
                                                            monkeypatch):
    reqs = [([1, 2, 3], 6), ([4, 5], 5)]
    kw = dict(slots=2, cache_len=16, chunk=2, prompt_buckets=(8,))
    base, eng = _serve(params, reqs, **kw)
    assert eng.overlap and eng.overlap_stats["chunks"] >= 3
    assert eng.overlap_stats["overlapped_harvests"] > 0
    assert eng.overlap_ratio() > 0.0
    assert base == ref(reqs)
    off, eng_off = _serve(params, reqs, overlap=False, **kw)
    assert not eng_off.overlap and eng_off.overlap_ratio() == 0.0
    assert eng_off.overlap_stats["overlapped_harvests"] == 0
    assert off == base
    monkeypatch.setenv("TTD_NO_OVERLAP", "1")
    env_off, eng_env = _serve(params, reqs, overlap=True, **kw)
    assert not eng_env.overlap
    assert eng_env.overlap_stats["overlapped_harvests"] == 0
    assert env_off == base


def _instrument(eng):
    """The engine's dispatch order: 'p' per target prefill piece, 'd' per
    decode chunk (instance attributes shadow the methods)."""
    events = []
    orig_p, orig_d = eng._prefill_piece, eng._decode_chunk

    def p(*a):
        events.append("p")
        return orig_p(*a)

    def d(*a):
        events.append("d")
        return orig_d(*a)

    eng._prefill_piece, eng._decode_chunk = p, d
    return events


def _mid_stream(params, active, long_req, tail_req=None, **kw):
    """Active lanes decode; after two steps a long prompt (several budget
    installments, and a trailing short one) arrives; all run to the end.
    Returns (outputs in submission order, engine, events since the
    arrival)."""
    eng = ServingEngine(CFG, params, device="cpu", **kw)
    events = _instrument(eng)
    out = {}
    ids = [eng.submit(p, m) for p, m in active]
    out.update(eng.serve_step())
    out.update(eng.serve_step())
    mark = len(events)
    ids += [eng.submit(*r) for r in (long_req, tail_req) if r is not None]
    while eng.pending():
        out.update(eng.serve_step())
    return [out[i] for i in ids], eng, events[mark:]


def test_interleave_engages_and_its_kill_switches_restore_atomic(
        params, ref, monkeypatch):
    """A 12-token admission in 4-token pieces: decode chunks for the
    active lane are dispatched between its pieces; ``prefill_budget=0``
    and TTD_NO_INTERLEAVE=1 run them back to back; outputs equal."""
    rng = np.random.default_rng(17)
    active, long_prompt = _rand(rng, 3), _rand(rng, 12)
    kw = dict(slots=2, cache_len=64, chunk=2, prefill_chunk=4)
    on, eng, tail = _mid_stream(params, [(active, 16)], (long_prompt, 4),
                                **kw)
    assert eng.interleave
    assert eng.prefill_stats["staged_requests"] >= 1
    assert eng.prefill_stats["installments"] >= 3
    pieces = [i for i, e in enumerate(tail) if e == "p"]
    assert len(pieces) == 3
    assert tail[pieces[0] + 1:pieces[-1]].count("d") >= 2, tail
    assert on == ref([(active, 16), (long_prompt, 4)])
    for switch in ("arg", "env"):
        if switch == "env":
            monkeypatch.setenv("TTD_NO_INTERLEAVE", "1")
        off, eng0, tail0 = _mid_stream(
            params, [(active, 16)], (long_prompt, 4),
            prefill_budget=0 if switch == "arg" else None, **kw)
        assert not eng0.interleave
        assert eng0.prefill_stats["staged_requests"] == 0
        pieces0 = [i for i, e in enumerate(tail0) if e == "p"]
        assert tail0[pieces0[0]:pieces0[-1] + 1] == ["p", "p", "p"], tail0
        assert off == on


def test_prefill_budget_groups_installments(params, ref):
    """Budget 8 over 4-token pieces: two pieces a step, then the third a
    step later, exactly one decode chunk between them."""
    rng = np.random.default_rng(29)
    active, long_prompt = _rand(rng, 3), _rand(rng, 12)
    out, _, tail = _mid_stream(params, [(active, 12)], (long_prompt, 4),
                               slots=2, cache_len=64, chunk=2,
                               prefill_chunk=4, prefill_budget=8)
    pieces = [i for i, e in enumerate(tail) if e == "p"]
    assert len(pieces) == 3
    assert tail[pieces[0]:pieces[0] + 2] == ["p", "p"]
    assert tail[pieces[1] + 1:pieces[2]].count("d") == 1, tail
    assert out == ref([(active, 12), (long_prompt, 4)])


# -- the parity matrix ------------------------------------------------------------

MODES = {"sync_atomic": dict(overlap=False, prefill_budget=0),
         "overlap_atomic": dict(prefill_budget=0),
         "sync_staged": dict(overlap=False, prefill_budget=3),
         "pipelined": {}}
SAMPLING = {"greedy": {}, "sampled": dict(temperature=0.8, top_k=20)}


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_modes_equal_with_refills(params, ref, sampling):
    """Six mixed-length requests through two slots (every slot refills;
    one resolves at prefill, one is a no-op, two share a block-aligned
    prefix): every mode gives the synchronous atomic tokens."""
    rng = np.random.default_rng(0)
    pre = _rand(rng, 8)
    reqs = [(pre + _rand(rng, 2), 6), (_rand(rng, 3), 9), (_rand(rng, 7), 4),
            (pre + _rand(rng, 5), 12), (_rand(rng, 6), 1), (_rand(rng, 2), 0)]
    kw = dict(slots=2, cache_len=64, chunk=4, prompt_buckets=(8, 16),
              kv_block_size=4, **SAMPLING[sampling])
    outs = {m: _serve(params, reqs, **kw, **MODES[m]) for m in MODES}
    base = outs["sync_atomic"][0]
    for mode, (toks, eng) in outs.items():
        assert toks == base, mode
        assert eng.kv_stats["prefix_hits"] >= 1
    assert outs["pipelined"][1].overlap_stats["overlapped_harvests"] > 0
    assert outs["pipelined"][1].prefill_stats["installments"] > 0
    if sampling == "greedy":
        assert base == ref(reqs)


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_modes_equal_speculative(params, draft, ref, sampling):
    """Speculative rounds pipeline too (the device advances each slot's
    counter by its own ``emitted``), and the draft's prefill stages with
    the target's: tokens and emitted counts equal in every mode."""
    rng = np.random.default_rng(21)
    reqs = [(_rand(rng, n), m) for n, m in [(5, 9), (3, 7), (6, 11), (4, 5)]]
    kw = dict(slots=2, cache_len=48, chunk=3, prompt_buckets=(8,),
              speculative_k=3, **draft, **SAMPLING[sampling])
    outs = {m: _serve(params, reqs, **kw, **MODES[m]) for m in MODES}
    base, eng0 = outs["sync_atomic"]
    for mode, (toks, eng) in outs.items():
        assert toks == base, mode
        assert eng.spec_stats["emitted"] == eng0.spec_stats["emitted"], mode
    assert outs["pipelined"][1].overlap_stats["overlapped_harvests"] > 0
    if sampling == "greedy":
        assert base == ref(reqs)


def test_stop_token_mid_chunk_is_trimmed(params, ref):
    """EOS in the middle of a chunk: the successor is already in flight
    when the host sees it, and the trim cuts the overshoot."""
    rng = np.random.default_rng(2)
    prompt, other = _rand(rng, 5), _rand(rng, 4)
    full = ref([(prompt, 12)])[0]
    eos = full[5 + 3]                     # the fourth token: mid-chunk
    cut = full[5:].index(eos) + 1
    outs = {}
    for mode in ("pipelined", "sync_atomic"):
        eng = ServingEngine(CFG, params, slots=2, cache_len=64, chunk=4,
                            prompt_buckets=(8,), eos_id=eos, device="cpu",
                            **MODES[mode])
        rid = eng.submit(prompt, 12)
        eng.submit(other, 10)
        outs[mode] = eng.run()[rid]
        if mode == "pipelined":
            assert eng.overlap_stats["overlapped_harvests"] > 0
    assert outs["pipelined"] == outs["sync_atomic"] == full[:5 + cut]


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_long_admission_mid_stream(params, ref, sampling):
    """A prompt of three installments (and a short one behind it)
    admitted while a lane decodes: interleaved equals atomic."""
    rng = np.random.default_rng(23)
    active = [(_rand(rng, 4), 14)]
    long_req, tail_req = (_rand(rng, 12), 6), (_rand(rng, 3), 5)
    kw = dict(slots=2, cache_len=64, chunk=3, prefill_chunk=4,
              **SAMPLING[sampling])
    on, eng, _ = _mid_stream(params, active, long_req, tail_req, **kw)
    off, eng_off, _ = _mid_stream(params, active, long_req, tail_req,
                                  prefill_budget=0, **kw)
    assert on == off
    assert eng.prefill_stats["staged_requests"] >= 2
    assert eng_off.prefill_stats["staged_requests"] == 0
    if sampling == "greedy":
        assert on == ref(active + [long_req, tail_req])


def test_long_admission_mid_stream_speculative(params, draft, ref):
    rng = np.random.default_rng(27)
    active = [(_rand(rng, 4), 9)]
    long_req, tail_req = (_rand(rng, 12), 6), (_rand(rng, 3), 5)
    kw = dict(slots=2, cache_len=64, chunk=3, prefill_chunk=4,
              speculative_k=3, **draft)
    on, eng, _ = _mid_stream(params, active, long_req, tail_req, **kw)
    off, eng_off, _ = _mid_stream(params, active, long_req, tail_req,
                                  overlap=False, prefill_budget=0, **kw)
    assert on == off
    assert eng.spec_stats["emitted"] == eng_off.spec_stats["emitted"]
    assert eng.prefill_stats["staged_requests"] >= 2
    assert on == ref(active + [long_req, tail_req])


def test_online_submission_and_radix_hit_mid_stream(params, ref):
    """serve_step() online under the pipeline: requests submitted while
    chunks are in flight, one extending a finished request's prompt by
    whole blocks (a radix hit on a refill), give the reference tokens."""
    rng = np.random.default_rng(11)
    shared = _rand(rng, 8)
    reqs = [(shared + _rand(rng, 1), 9), (_rand(rng, 3), 7),
            (shared + _rand(rng, 3), 5)]
    eng = ServingEngine(CFG, params, slots=2, cache_len=32, chunk=3,
                        prompt_buckets=(8, 16), kv_block_size=4,
                        device="cpu")
    out = {}
    ids = [eng.submit(*reqs[0])]
    out.update(eng.serve_step())
    ids.append(eng.submit(*reqs[1]))
    out.update(eng.serve_step())
    ids.append(eng.submit(*reqs[2]))
    while eng.pending():
        out.update(eng.serve_step())
    assert [out[i] for i in ids] == ref(reqs)
    assert eng.kv_stats["prefix_hits"] >= 1
    assert eng.overlap_stats["overlapped_harvests"] > 0
    eng._radix.check_invariants()


@pytest.mark.parametrize("mode", ["pipelined", "sync_atomic"])
def test_idle_stale_lane_writes_only_scratch_in_both_pools(params, ref,
                                                           mode):
    """A lane that stops at EOS long before its budget leaves most of its
    claimed blocks unwritten; they go back to the pool and a request
    admitted into another slot takes them, while the stopped lane stays
    idle and keeps decoding garbage at positions inside them.  Its table
    must point at the scratch block in the target's pool and the draft's
    before that garbage is dispatched: the new request's tokens stay the
    reference's, and the self draft keeps accepting every token (a
    corrupted draft pool would not)."""
    rng = np.random.default_rng(5)
    reqs = [(_rand(rng, 5), 3), (_rand(rng, 5), 20), (_rand(rng, 3), 20)]
    late = (_rand(rng, 6), 20)
    full = ref(reqs + [late])
    eos = full[1][5 + 1]                      # #1's second token
    want = [t[:n + t[n:].index(eos) + 1] if eos in t[n:] else t
            for t, n in zip(full, [len(p) for p, _ in reqs + [late]])]
    assert len(want[1]) == 5 + 2
    eng = ServingEngine(CFG, params, slots=3, cache_len=32, chunk=2,
                        prompt_buckets=(8,), kv_block_size=4, eos_id=eos,
                        device="cpu", draft_config=CFG, draft_params=params,
                        speculative_k=2, **MODES[mode])
    ids = [eng.submit(p, m) for p, m in reqs]
    out = {}
    while len(out) < 2:
        out.update(eng.serve_step())
    assert set(out) == set(ids[:2])           # #0 and #1 stopped
    ids.append(eng.submit(*late))             # takes slot 0; slot 1 idles
    while eng.pending():
        out.update(eng.serve_step())
    assert [out[i] for i in ids] == want
    s = eng.spec_stats
    assert s["drafted_accepted"] == s["drafted"] > 0


# -- serve.py ------------------------------------------------------------------


def _train(tmp, name, steps):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch",
         "--config", "llama_tiny_sft", "--steps", str(steps), "--device",
         "cpu", "--checkpoint-dir", str(tmp / name), "--checkpoint-every",
         str(steps)], cwd=tmp, env=env, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return str(tmp / name)


def test_serve_cli_speculative_gives_plain_greedy_tokens(tmp_path, capsys):
    target, draft = _train(tmp_path, "t", 4), _train(tmp_path, "d", 2)
    base = ["--config", "llama_tiny_sft", "--checkpoint-dir", target,
            "--device", "cpu", "--max-new", "8", "--slots", "2", "--chunk",
            "3", "--cache-len", "64", "--kv-block-size", "4",
            "--prompt", "1,2,3", "--prompt", "4,5,6,7,8,9"]
    spec = ["--speculative-draft-config", "llama_tiny_sft",
            "--speculative-draft-checkpoint", draft, "--speculative-k", "3"]

    def serve(*flags):
        assert tserve.main(base + list(flags)) == 0
        out, err = capsys.readouterr()
        summary = json.loads(err.split("serve summary: ")[1].splitlines()[0])
        return [json.loads(x)["tokens"] for x in out.splitlines()], summary

    plain, _ = serve("--no-overlap", "--no-interleave")
    got, summary = serve(*spec)
    assert got == plain
    assert summary["spec_stats"]["rounds"] >= 1
    assert 0.0 <= summary["acceptance"] <= 1.0
    assert summary["overlap_ratio"] > 0.0
    assert summary["prefill_stats"]["staged_requests"] == 2
    assert serve(*spec, "--spec-depth", "adaptive:0,2,3",
                 "--prefill-budget", "4")[0] == plain
    int8_plain, _ = serve("--kv-int8")
    assert serve(*spec, "--kv-int8", "--no-overlap")[0] == int8_plain
    for flags, match in (
            (["--speculative-draft-checkpoint", draft], "needs"),
            (["--speculative-draft-config", "llama_tiny_sft"], "required"),
            (["--spec-depth", "adaptive"], "needs"),
            (spec + ["--spec-depth", "sometimes"], "spec-depth"),
            (spec + ["--speculative-k", "0"], "speculative_k"),
            (["--speculative-draft-config", "bert_tiny_mlm",
              "--speculative-draft-checkpoint", draft], "llama-family")):
        with pytest.raises(SystemExit, match=match):
            tserve.main(base + flags)
