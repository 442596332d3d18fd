"""Lane control of the port's paged serving engine against the JAX
engine on the CPU (f32, ``llama_tiny``; the JAX engines synchronous with
atomic admission unless a case says otherwise).

- ``cancel`` of a queued request, a staged partial prefill and a
  decoding lane at the same ``serve_step`` counts in both packages, on
  the plain, the pipelined and the speculative engine: the same return
  values, the survivors' greedy tokens, ``kv_stats`` and blocks in use
  equal to the JAX engine's, and after the last step only radix-held
  blocks in use.
- ``submit(..., resume_from=g)``: a resumed seeded stream reproduces the
  uninterrupted one bit for bit; the validation messages are JAX's.
- ``preload_prefix``: the same tokens and radix hit counts as JAX's, the
  LRU bound, the sub-block tail served from the stored pair, and the
  refusals.
- KV export and install: an export read twice is equal; the port's
  manifest equals JAX's for the same lane (paths, dtypes, shapes,
  order), f32 and int8; a lane exported by either package installs in
  the other and resumes to the uninterrupted greedy tokens; the port's
  own round trip keeps greedy and seeded tokens bit for bit; torn,
  trailing and mismatched manifests raise JAX's errors.
- ``serve.py --prefix``.
"""

import dataclasses
import json

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
from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.serving import (
    ServingEngine as TorchEngine,
)

ENGINE = dict(slots=2, cache_len=64, chunk=2, prompt_buckets=(8, 16),
              kv_block_size=4)
SYNC = dict(overlap=False, prefill_budget=0)
STAGED = dict(overlap=False, prefill_chunk=4)


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
    for switch in ("TTD_NO_OVERLAP", "TTD_NO_INTERLEAVE",
                   "TTD_NO_ADAPTIVE_SPEC"):
        monkeypatch.delenv(switch, raising=False)


def _flat(name, key):
    params = JaxLlama(JAX_PRESETS[name]).init(
        key, jnp.zeros((1, 8), jnp.int32))["params"]
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


@pytest.fixture(scope="module")
def weights():
    return _flat("llama_tiny", jax.random.PRNGKey(0))


def _jax_tree(flat):
    return jax.tree.map(jnp.asarray, traverse_util.unflatten_dict(flat,
                                                                  sep="/"))


def _pair(weights, kv_int8=False, draft=False, **kw):
    """(JAX engine, port engine) on the same weights and settings."""
    jcfg, tcfg = JAX_PRESETS["llama_tiny"], TORCH_PRESETS["llama_tiny"]
    if kv_int8:
        jcfg = dataclasses.replace(jcfg, kv_cache_int8=True)
        tcfg = dataclasses.replace(tcfg, kv_cache_int8=True)
    tparams = convert.params_from_flax(weights, tcfg)
    jkw, tkw = dict(ENGINE, **kw), dict(ENGINE, **kw)
    if draft:
        jkw.update(draft_config=jcfg, draft_params=_jax_tree(weights),
                   speculative_k=3)
        tkw.update(draft_config=tcfg, draft_params=tparams, speculative_k=3)
    return (JaxEngine(jcfg, _jax_tree(weights), **jkw),
            TorchEngine(tcfg, tparams, device="cpu", **tkw))


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    pre = [int(t) for t in rng.integers(1, 250, 8)]
    rand = lambda n: [int(t) for t in rng.integers(1, 250, n)]  # noqa: E731
    return pre, rand


def _script(eng, ops):
    """Run ``ops`` on ``eng``: ("submit", prompt, max_new[, kwargs]),
    ("step",), ("cancel", submission index), ("preload", tokens).
    Returns (outputs by submission index, cancel results, kv_stats,
    blocks in use after each step)."""
    rids, outs, cancels, blocks = [], {}, [], []
    for op in ops:
        if op[0] == "submit":
            rids.append(eng.submit(op[1], op[2], **(op[3] if len(op) > 3
                                                    else {})))
        elif op[0] == "step":
            outs.update(eng.serve_step())
            blocks.append(eng.kv_blocks_in_use())
        elif op[0] == "cancel":
            cancels.append(eng.cancel(rids[op[1]]))
        else:
            eng.preload_prefix(op[1])
    while eng.pending():
        outs.update(eng.serve_step())
    by_index = {i: list(outs[r]) for i, r in enumerate(rids) if r in outs}
    return by_index, cancels, dict(eng.kv_stats), blocks


def _cancel_ops():
    """Two lanes: #0 and #1 decode, #2 and #3 queue behind them; cancel
    #3 (queued) and #1 (decoding) mid-stream, then #4, staged behind a
    decoding lane, after its first piece; #2 and #5 extend #0's prefix
    (radix hits) and a finished id cancels to False."""
    pre, rand = _prompts(1)
    return [("submit", pre + rand(2), 10), ("submit", rand(6), 12),
            ("submit", pre + rand(3), 5), ("submit", rand(5), 6),
            ("step",), ("cancel", 3), ("step",), ("cancel", 1), ("step",),
            ("step",), ("submit", rand(14), 4), ("step",), ("cancel", 4),
            ("cancel", 4), ("submit", pre + rand(1), 3), ("step",),
            ("cancel", 0), ("step",)]


@pytest.mark.parametrize("mode", ["sync", "staged", "pipelined", "spec"])
def test_cancel_matches_jax_at_the_same_steps(weights, mode):
    kw = {"sync": SYNC, "staged": STAGED, "pipelined": dict(prefill_chunk=4),
          "spec": SYNC}[mode]
    jeng, teng = _pair(weights, draft=mode == "spec", **kw)
    want = _script(jeng, _cancel_ops())
    got = _script(teng, _cancel_ops())
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[1][:2] == [True, True] and got[1][3] is False
    cancelled = {i for i, ok in zip((3, 1, 4), got[1]) if ok}
    assert {2, 5} <= set(got[0]) and not cancelled & set(got[0])
    assert got[2]["prefix_hit_tokens"] >= 8
    assert teng.kv_blocks_in_use() == teng._radix.cached_blocks()
    teng._radix.check_invariants()
    if mode == "pipelined":
        assert teng.overlap_stats["overlapped_harvests"] > 0
    if mode == "spec":
        assert teng.spec_stats == jeng.spec_stats


def test_cancel_in_flight_lane_emits_nothing_and_flushes(weights):
    """A lane cancelled between a chunk's dispatch and its harvest (the
    pipelined speculative engine): its in-flight tokens are trimmed, its
    table row points at scratch from the next dispatch on (one table for
    both pools), and the other lanes' tokens are the synchronous
    engine's."""
    _, teng = _pair(weights, draft=True)
    _, ref = _pair(weights, **SYNC)
    _, rand = _prompts(2)
    pa, pb, pc = rand(5), rand(7), rand(4)
    a, b = teng.submit(pa, 20), teng.submit(pb, 20)
    teng.serve_step()
    teng.serve_step()
    assert teng._inflight is not None
    slot = [s.request_id if s else None
            for s in teng._slot_states].index(b)
    assert teng.cancel(b) and not teng.cancel(b)
    assert set(teng.snapshot()) == {a} and slot in teng._stale_slots
    assert teng.active_slots() == 1 and teng.queue_depth() == 0
    teng.serve_step()
    assert not teng._cache.block_table[slot].any()
    c = teng.submit(pc, 6)
    out = teng.run()
    assert b not in out and teng.progress() == {}
    ra, rc = ref.submit(pa, 20), ref.submit(pc, 6)
    want = ref.run()
    assert out[a] == want[ra] and out[c] == want[rc]
    assert teng.kv_blocks_in_use() == teng._radix.cached_blocks()


def test_gauges(weights):
    jeng, teng = _pair(weights, kv_int8=True, draft=True, **STAGED)
    for eng in (jeng, teng):
        assert eng.kv_blocks_total() == 2 * 16
        eng.submit(list(range(1, 10)), 6)
        eng.submit(list(range(3, 20)), 6)
        eng.submit(list(range(5, 9)), 6)
        eng.serve_step()
    assert teng.kv_pool_bytes() == jeng.kv_pool_bytes()
    assert teng.kv_bytes_in_use() == jeng.kv_bytes_in_use() > 0
    for name in ("active_slots", "staged_rids", "queue_depth", "progress",
                 "snapshot", "kv_blocks_in_use"):
        assert getattr(teng, name)() == getattr(jeng, name)(), name


# -- resume-from-token --------------------------------------------------------


@pytest.mark.parametrize("g", [1, 4, 9])
def test_resume_continues_the_seeded_stream_bit_for_bit(weights, g):
    _, teng = _pair(weights, temperature=0.9, top_k=40)
    _, rand = _prompts(3)
    prompt = rand(6)
    rid = teng.submit(prompt, 12, seed=77)
    full = teng.run()[rid]
    rid = teng.submit(full[:6 + g], 12 - g, seed=77, resume_from=g)
    assert teng.run()[rid] == full
    # Without resume_from the continuation draws other tokens.
    rid = teng.submit(full[:6 + g], 12 - g, seed=77)
    assert teng.run()[rid] != full


def test_resume_greedy_and_validation_match_jax(weights):
    jeng, teng = _pair(weights, **SYNC)
    _, rand = _prompts(4)
    prompt = rand(14)
    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        rid = eng.submit(prompt, 8)
        full = eng.run()[rid]
        # A resumed prompt past the largest bucket (16) is admitted.
        rid = eng.submit(full[:17], 5, resume_from=3)
        out[name] = (full, eng.run()[rid])
    assert out["port"] == out["jax"]
    assert out["port"][1] == out["port"][0]
    for args in (([1, 2, 3], 4, None, 3), ([1, 2, 3], 4, None, -1),
                 (list(range(1, 21)), 4, None, 0)):
        errs = []
        for eng in (jeng, teng):
            with pytest.raises(ValueError) as e:
                eng.validate_request(*args)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


# -- preload_prefix -----------------------------------------------------------


def test_preload_tokens_and_radix_hits_match_jax(weights):
    jeng, teng = _pair(weights, **SYNC)
    pre, rand = _prompts(5)
    prefix = pre + rand(2)                    # 10: two blocks and a tail
    reqs = [(prefix + rand(3), 6), (prefix + rand(10), 4), (rand(5), 5),
            (prefix + rand(1), 7)]
    ops = [("preload", prefix)] + [("submit", p, m) for p, m in reqs] + [
        ("step",)]
    want, _, jstats, jblocks = _script(jeng, ops)
    got, _, tstats, tblocks = _script(teng, ops)
    assert got == want and tstats == jstats and tblocks == jblocks
    assert tstats["prefix_hits"] == 3 and tstats["prefix_hit_tokens"] == 24
    assert teng._radix.stats == jeng._radix.stats
    # The same tokens as without the preload (chunked: the longest
    # prompt passes the largest bucket).
    _, plain = _pair(weights, prefill_chunk=4, **SYNC)
    assert _script(plain, ops[1:])[0] == got


def test_preload_sub_block_tail_and_lru(weights):
    """A 3-token prefix (under one block) has no shareable blocks: its
    stored pair serves the requests; the LRU keeps ``prefix_cache_limit``
    prefixes and validation follows it."""
    jeng, teng = _pair(weights, prefix_cache_limit=2, **SYNC)
    _, rand = _prompts(6)
    short = rand(3)
    for eng in (jeng, teng):
        eng.preload_prefix(short)
        assert eng.kv_blocks_in_use() == 0
    ops = [("submit", short + rand(14), 5), ("step",)]
    want, got = _script(jeng, ops), _script(teng, ops)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[2]["prefix_hits"] == 0
    longs = [rand(4) for _ in range(3)]
    for eng in (jeng, teng):
        for p in longs:
            eng.preload_prefix(p)
        assert list(eng._prefix_caches) == [tuple(p) for p in longs[1:]]
    # The suffix bound counts from the longest declared prefix, and
    # validation leaves the LRU order as it was.
    errs = []
    for eng in (jeng, teng):
        eng.validate_request(longs[1] + rand(16), 4)
        assert list(eng._prefix_caches) == [tuple(p) for p in longs[1:]]
        eng.validate_request(longs[2] + rand(16), 4)
        with pytest.raises(ValueError) as e:
            eng.validate_request(longs[0] + rand(16), 4)
        errs.append(str(e.value))
        with pytest.raises(ValueError, match="empty prefix"):
            eng.preload_prefix([])
        with pytest.raises(ValueError, match="cache room"):
            eng.preload_prefix(list(range(1, 65)))
    assert errs[0] == errs[1]


def test_preloaded_prefix_under_speculation_and_staging(weights):
    _, rand = _prompts(7)
    prefix = rand(9)
    reqs = [("submit", prefix + rand(4), 6), ("submit", prefix + rand(7), 5)]
    want = _script(_pair(weights, **SYNC)[1], reqs + [("step",)])[0]
    for kw in (dict(draft=True, **SYNC), dict(draft=True, **STAGED)):
        jeng, teng = _pair(weights, **kw)
        ops = [("preload", prefix)] + reqs + [("step",)]
        got, jgot = _script(teng, ops), _script(jeng, ops)
        assert got[0] == want == jgot[0]
        assert got[2] == jgot[2] and got[2]["prefix_hit_tokens"] == 16


# -- KV export and install ----------------------------------------------------


def _leaves(meta, blob):
    """The manifest's arrays, decoded from the blob."""
    out, off = [], 0
    for leaf in meta.get("kv", meta)["leaves"]:
        dt = np.dtype(leaf["dtype"])
        n = int(np.prod(leaf["shape"]))
        out.append(np.frombuffer(blob, dt, n, off).reshape(leaf["shape"]))
        off += n * dt.itemsize
    return out


def _decoding(eng, prompt, max_new, steps, **kw):
    rid = eng.submit(prompt, max_new, **kw)
    for _ in range(steps):
        eng.serve_step()
    return rid


@pytest.mark.parametrize("kv_int8", [False, True])
def test_export_lane_manifest_equals_jax_and_reads_twice(weights, kv_int8):
    jeng, teng = _pair(weights, kv_int8=kv_int8, **SYNC)
    _, rand = _prompts(8)
    prompt = rand(10)
    metas = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        rid = _decoding(eng, prompt, 20, 2)
        meta, blob = eng.export_lane(rid)
        again = eng.export_lane(rid)
        assert again[0] == meta and again[1] == blob
        metas[name] = (meta, blob)
    (jm, jb), (tm, tb) = metas["jax"], metas["port"]
    assert tm == jm                    # kind, tokens, counters, manifest
    assert tm["kv"]["n"] == 12 and len(tb) == len(jb)
    for (a, b), leaf in zip(zip(_leaves(tm, tb), _leaves(jm, jb)),
                            tm["kv"]["leaves"]):
        # The rows come from f32 forwards that agree to rounding; an int8
        # row may land one step over a rounding edge.
        tol = 1.0 if a.dtype == np.int8 else 1e-5
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), rtol=1e-5, atol=tol)
    for eng in (jeng, teng):
        assert eng.export_lane(12345) is None
        q = eng.submit([1, 2, 3], 4, seed=9)
        s = eng.submit([4, 5, 6], 4, resume_from=1)
        assert eng.export_lane(q)[0] == {
            "kind": "queued", "prompt": [1, 2, 3], "max_new": 4, "seed": 9,
            "resume_from": 0, "kv": None}
        assert eng.export_lane(s)[0]["resume_from"] == 1
        eng.run()


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_lane_migrates_between_packages(weights, kv_int8, direction):
    """Export mid-stream from one package, install in the other, re-admit
    with ``resume_from``: the uninterrupted greedy tokens, the installed
    rows hit by the radix."""
    _, rand = _prompts(9)
    prompt = rand(11)
    jsrc, tsrc = _pair(weights, kv_int8=kv_int8, **SYNC)
    jdst, tdst = _pair(weights, kv_int8=kv_int8, **SYNC)
    src, dst = (jsrc, tdst) if direction == "jax_to_port" else (tsrc, jdst)
    rid = src.submit(prompt, 16)
    full = src.run()[rid]
    rid = _decoding(src, prompt, 16, 3)
    meta, blob = src.export_lane(rid)
    assert src.cancel(rid)
    warm = dst.install_lane(meta, blob)
    assert warm == meta["kv"]["n"] >= 12
    done = len(meta["tokens"]) - len(prompt)
    rid = dst.submit(meta["tokens"], meta["remaining"], seed=meta["seed"],
                     resume_from=done)
    assert list(dst.run()[rid]) == list(full)
    assert dst.kv_stats["prefix_hit_tokens"] == warm


@pytest.mark.parametrize("sampled", [False, True])
def test_port_lane_round_trip_bit_for_bit(weights, sampled):
    kw = dict(temperature=0.8, top_p=0.95) if sampled else {}
    _, src = _pair(weights, **kw)
    _, dst = _pair(weights, **kw)
    _, rand = _prompts(10)
    prompt = rand(9)
    rid = src.submit(prompt, 18, seed=5)
    full = src.run()[rid]
    rid = _decoding(src, prompt, 18, 4, seed=5)
    meta, blob = src.export_lane(rid)          # harvests the chunk in flight
    assert meta["tokens"] == full[:len(meta["tokens"])]
    assert meta["count"] == len(meta["tokens"]) - len(prompt)
    assert dst.install_lane(meta, blob) == meta["kv"]["n"]
    rid = dst.submit(meta["tokens"], meta["remaining"], seed=meta["seed"],
                     resume_from=meta["count"])
    assert dst.run()[rid] == full


def test_export_prefix_kv_and_install_match_jax(weights):
    jeng, teng = _pair(weights, draft=True, **SYNC)
    _, rand = _prompts(11)
    prompt = rand(14)
    jm, jb = jeng.export_prefix_kv(prompt)
    tm, tb = teng.export_prefix_kv(prompt)
    assert tm == jm and tm["n"] == 12 and tm["draft"]
    assert [leaf["draft"] for leaf in tm["leaves"]] == [False] * 4 + [True] * 4
    for a, b in zip(_leaves(tm, tb), _leaves(jm, jb)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert teng.export_prefix_kv(rand(4)) is None
    jdst, tdst = _pair(weights, draft=True, **SYNC)
    assert tdst.install_prefix_kv(jm, jb) == 12
    assert tdst.install_prefix_kv(jm, jb) == 12        # already warm
    assert jdst.install_prefix_kv(tm, tb) == 12
    ops = [("submit", prompt, 6), ("step",)]
    assert _script(tdst, ops)[0] == _script(jdst, ops)[0]
    assert tdst.kv_stats == jdst.kv_stats
    _, plain = _pair(weights, **SYNC)
    assert _script(tdst, ops)[0] == _script(plain, ops)[0]


def test_installed_rows_are_the_blob_bit_for_bit(weights):
    """The pool rows an install writes, gathered back by the paged KV
    gather, are the blob's bytes (int8 rows and scales verbatim)."""
    for kv_int8 in (False, True):
        _, src = _pair(weights, kv_int8=kv_int8, **SYNC)
        _, dst = _pair(weights, kv_int8=kv_int8, **SYNC)
        _, rand = _prompts(12)
        rid = _decoding(src, rand(10), 20, 2)
        meta, blob = src.export_lane(rid)
        dst.install_lane(meta, blob)
        n = meta["kv"]["n"]
        matched, shared = dst._radix.match(meta["kv"]["tokens"],
                                           allow_full=True, record=False)
        table = np.zeros((dst._kv_nblk_lane,), np.int32)
        table[:len(shared)] = shared
        K.reset_launch_counts()
        leaves, back = dst._serialize_rows(torch.from_numpy(table), n)
        assert matched == n and back == blob
        assert leaves == meta["kv"]["leaves"]


def test_torn_trailing_and_mismatched_manifests_raise_jaxs_errors(weights):
    src = _pair(weights, **SYNC)[0]
    jeng, teng = _pair(weights, **SYNC)
    _, rand = _prompts(13)
    meta, blob = src.export_prefix_kv(rand(13))
    bad_shape = json.loads(json.dumps(meta))
    bad_shape["leaves"][0]["shape"][1] = 8
    bad_dtype = json.loads(json.dumps(meta))
    bad_dtype["leaves"][1]["dtype"] = "|i1"
    cases = [(dict(meta, n=6), blob), (dict(meta, n=8), blob),
             (dict(meta, n=64, tokens=list(range(64))), blob),
             (meta, blob[:-4]), (meta, blob + b"\0" * 4),
             (bad_shape, blob[:len(blob) - 512]), (bad_dtype, blob)]
    for m, b in cases:
        errs = []
        for eng in (jeng, teng):
            with pytest.raises(ValueError) as e:
                eng.install_prefix_kv(m, b)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    assert teng.install_prefix_kv(dict(meta, draft=True), blob) == 0
    assert teng.install_lane({"kind": "queued", "kv": None}, b"") == 0
    assert teng.kv_blocks_in_use() == 0


# -- serve.py --prefix --------------------------------------------------------


def test_serve_cli_prefix(tmp_path, weights, capsys):
    np.savez(tmp_path / "p.npz", **weights)
    pre, rand = _prompts(14)
    prefix = pre + rand(2)
    base = ["--config", "llama_tiny_sft", "--params-npz",
            str(tmp_path / "p.npz"), "--device", "cpu", "--max-new", "6",
            "--slots", "2", "--cache-len", "64", "--kv-block-size", "4"]
    for r in (rand(3), rand(5)):
        base += ["--prompt", ",".join(map(str, prefix + r))]

    def serve(*flags):
        assert tserve.main(base + list(flags)) == 0
        out, err = capsys.readouterr()
        summary = json.loads(err.split("serve summary: ")[1].splitlines()[0])
        return [json.loads(x)["tokens"] for x in out.splitlines()], summary

    plain, s0 = serve()
    got, s1 = serve("--prefix", ",".join(map(str, prefix)))
    assert got == plain
    assert s1["kv_stats"]["prefix_hit_tokens"] == 16
    assert s1["prefill_tokens"] < s0["prefill_tokens"]
    for flag, match in (("1,x", "--prefix must be"), ("1,999", "outside")):
        with pytest.raises(SystemExit, match=match):
            tserve.main(base + ["--prefix", flag])


def test_bf16_manifest_reads_numpys_void_dtype(weights):
    """A bf16 leaf goes on the wire as numpy's ``<V2`` (JAX writes
    ``np.dtype(bfloat16).str``).  The port installs a bf16 export of the
    JAX engine and reads back its bytes; the JAX engine refuses its own
    (its leaf check compares the void dtype with bfloat16: ROADMAP
    Queue 3)."""
    jcfg = dataclasses.replace(JAX_PRESETS["llama_tiny"], dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TORCH_PRESETS["llama_tiny"],
                               dtype=torch.bfloat16)
    kw = dict(ENGINE, **SYNC)
    jsrc, jdst = (JaxEngine(jcfg, _jax_tree(weights), **kw)
                  for _ in range(2))
    teng = TorchEngine(tcfg, convert.params_from_flax(weights, tcfg),
                       device="cpu", **kw)
    _, rand = _prompts(15)
    meta, blob = jsrc.export_prefix_kv(rand(13))
    assert {leaf["dtype"] for leaf in meta["leaves"]} == {"<V2"}
    with pytest.raises(ValueError, match="V2"):
        jdst.install_prefix_kv(meta, blob)
    assert teng.install_prefix_kv(meta, blob) == 12
    table = np.zeros((teng._kv_nblk_lane,), np.int32)
    table[:3] = teng._radix.match(meta["tokens"], allow_full=True,
                                  record=False)[1]
    leaves, back = teng._serialize_rows(torch.from_numpy(table), 12)
    assert leaves == meta["leaves"] and back == blob
