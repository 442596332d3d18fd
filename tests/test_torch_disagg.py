"""Disaggregated prefill/decode over the port's dial-in fleet.

JAX ``tests/test_disagg.py``'s cases over the port's engine (llama_tiny
workers on the CPU, one torch thread each, dialing a ``NetPool`` as in
``tests/test_torch_netpool.py``): a prefill and a decode worker serve a
mixed workload with the tokens of one co-located engine (greedy, seeded,
speculative), the KV_HANDOFF blob is the pool's rows bit for bit
(installed and re-exported, the same bytes, f32 and int8 pools),
``TTD_NO_DISAGG=1`` collapses the roles, and ``chaos_check --serving
--disagg`` passes both legs.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflow_train_distributed_torch import chaos_check
from tensorflow_train_distributed_torch.runtime import events
from tensorflow_train_distributed_torch.server.netpool import NetPool
from tensorflow_train_distributed_torch.server.replicas import (
    Replica,
    disagg_killed,
)
from tensorflow_train_distributed_torch.server.worker import (
    StubWorkerEngine,
    _factory_llama,
)
from test_torch_netpool import REPO_ROOT, SERVE_WORKER, WORKER_ENV, _reap

#: One spec for every engine below: workers and the in-process reference
#: build the same engine (llama_tiny, the port's seeded weights).
SPEC = {"preset": "llama_tiny", "init_seed": 0, "device": "cpu",
        "slots": 2, "cache_len": 64, "chunk": 4,
        "prompt_buckets": [8, 16, 32]}

#: Mixed workload: the long prompts span more than one KV block (16
#: tokens), so their placement hands KV from prefill to decode; the short
#: ones take the no-handoff path in the same run.
REQS = [(list(range(3, 27)), 10), ([5, 9, 2], 6),
        (list(range(40, 58)), 8), ([7, 11], 5)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llama_fleet(roles, spec):
    pool = NetPool(host="127.0.0.1", port=0, scale_min=len(roles),
                   max_workers=len(roles) + 1,
                   monitor_poll_s=0.02).start()
    procs = [subprocess.Popen(
        [sys.executable, *SERVE_WORKER,
         "--dial", f"127.0.0.1:{pool.port}", "--factory", "llama",
         "--json", json.dumps(spec), "--replica-id", str(i),
         "--role", role],
        cwd=REPO_ROOT, env=WORKER_ENV, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
        for i, role in enumerate(roles)]
    return pool, procs


def _reference(spec, reqs, *, seeds=None):
    eng = _factory_llama(dict(spec, warm=False))
    rids = [eng.submit(p, m, seed=seeds[i] if seeds else None)
            for i, (p, m) in enumerate(reqs)]
    out = eng.run()
    return [out[r] for r in rids]


def _disagg_parity(spec, *, seeds=None):
    """One prefill and one decode worker over TCP serve the mixed
    workload with the tokens of one co-located engine, with at least one
    real KV handoff between distinct replicas."""
    refs = _reference(spec, REQS, seeds=seeds)
    rec = events.get_recorder()
    cursor, _ = rec.events_after(0)
    pool, procs = _llama_fleet(["prefill", "decode"], spec)
    try:
        assert pool.wait_ready(120), "llama workers never came up"
        assert pool.workers_by_role() == {"prefill": 1, "decode": 1}
        hs = [pool.submit(p, m, seed=seeds[i] if seeds else None)
              for i, (p, m) in enumerate(REQS)]
        outs = [h.result(timeout=120) for h in hs]
        assert outs == refs, "disaggregated output diverged"
        _, evs = rec.events_after(cursor)
        handoffs = [e for e in evs if e[0] == "request/kv_handoff"]
        assert handoffs, "no prefill->decode handoff happened"
        for e in handoffs:
            attrs = e[5]
            assert attrs["prefill_replica"] != attrs["decode_replica"]
            assert attrs["bytes"] > 0 and attrs["tokens"] >= 16
    finally:
        pool.join(timeout=60)
        _reap(procs)


@pytest.mark.parametrize("kind", ["greedy", "seeded", "speculative"])
def test_disagg_prefill_decode_parity(kind):
    """Disaggregation is a placement lever, never a correctness knob:
    greedy, seeded sampling (the per-request streams survive rows
    prefilled in another process) and a self-draft (target and draft
    rows ship in one KV_HANDOFF) all equal the co-located engine."""
    if kind == "greedy":
        _disagg_parity(SPEC)
    elif kind == "seeded":
        _disagg_parity(dict(SPEC, temperature=0.8, top_k=40),
                       seeds=[1000 + i for i in range(len(REQS))])
    else:
        _disagg_parity(dict(SPEC, draft_preset="llama_tiny",
                            speculative_k=3))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_handoff_rows_bitwise_equal_pool_rows(kv_int8):
    """The KV_HANDOFF blob is the pool's rows verbatim: installing it and
    re-exporting from the receiving pool gives the same bytes, the
    manifest accounts for every byte (an int8 pool ships its f32
    scales), and the installed prefix decodes as the exporter does."""
    import dataclasses

    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS,
    )
    from tensorflow_train_distributed_torch.serving import ServingEngine

    cfg = dataclasses.replace(LLAMA_PRESETS["llama_tiny"],
                              kv_cache_int8=kv_int8)
    params = convert.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = {k: v for k, v in SPEC.items()
          if k not in ("preset", "init_seed")}
    kw["prompt_buckets"] = tuple(kw["prompt_buckets"])
    eng_a = ServingEngine(cfg, params, **kw)
    eng_b = ServingEngine(cfg, params, **kw)
    tokens = list(range(3, 27))         # 24 tokens -> one 16-row block
    out = eng_a.export_prefix_kv(tokens)
    assert out is not None, "export refused on a paged engine"
    meta, blob = out
    assert meta["n"] == 16
    assert meta["tokens"] == tokens[:16]
    sizes = [int(np.prod(leaf["shape"]))
             * np.dtype(leaf["dtype"]).itemsize
             for leaf in meta["leaves"]]
    assert sum(sizes) == len(blob)
    dtypes = {np.dtype(leaf["dtype"]) for leaf in meta["leaves"]}
    assert (np.dtype(np.int8) in dtypes) == kv_int8
    if kv_int8:
        assert np.dtype(np.float32) in dtypes
    assert eng_b.install_prefix_kv(dict(meta), blob) == 16
    meta2, blob2 = eng_b.export_prefix_kv(tokens)
    assert meta2["leaves"] == meta["leaves"]
    assert blob2 == blob
    ra = eng_a.submit(tokens, 8)
    rb = eng_b.submit(tokens, 8)
    assert eng_a.run()[ra] == eng_b.run()[rb]
    assert eng_b.kv_prefix_hit_tokens() == 16


def test_kill_switch_collapses_role_split(monkeypatch):
    """TTD_NO_DISAGG=1 collapses the role split (every worker routes as
    'both', no handoff is tried) without touching the transport."""
    eng = StubWorkerEngine(slots=1)
    eng.role = "prefill"
    rep = Replica(0, eng, max_queue=4, default_timeout_s=None,
                  retry_after_s=1.0)
    monkeypatch.setenv("TTD_NO_DISAGG", "1")
    assert disagg_killed()
    assert rep.role() == "both"
    assert rep.decode_capable()
    monkeypatch.setenv("TTD_NO_DISAGG", "0")
    assert not disagg_killed()
    assert rep.role() == "prefill"
    assert not rep.decode_capable()


@pytest.mark.parametrize("sampling", [False, True],
                         ids=["greedy", "seeded-sampling"])
def test_chaos_check_serving_disagg_smoke(sampling):
    """``chaos_check --serving --disagg``: one prefill and two decode
    workers under mixed load; the prefill worker is SIGKILLed after the
    first handoff and a decode worker takes a real killpid mid-stream;
    the survivors complete everything token-equal to a co-located run."""
    verdict = chaos_check.run_serving_chaos_disagg(
        sampling=sampling, n_requests=5 if not sampling else 6,
        device="cpu")
    assert verdict["ok"], verdict
    assert verdict["checks"]["streams_match_reference"]
    assert verdict["checks"]["handoff_happened"]
    assert verdict["checks"]["prefill_worker_dead"]
    assert verdict["checks"]["decode_worker_dead"]
