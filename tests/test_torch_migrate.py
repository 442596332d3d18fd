"""The port's live mid-stream migration: export/install round trips, pool
rebalancing, drain-time evacuation, and the chaos gate.

The cases of JAX ``tests/test_migrate.py`` over the port's modules:
``ReplicaPool.migrate`` over the deterministic ``StubEngine`` (parity is a
closed form, so a duplicated or dropped token is loud), the
``TTD_NO_MIGRATION`` kill switch, the export-failure fallback (an
interrupted migration completes through resume-from-token failover),
defragmentation, drain-time ``lanes_remaining``, and the flight recorder's
join of both lives of a migrated request.  Over the port's engine
(llama_tiny on the CPU): a lane exported mid-generation installs on a
fresh engine and resumes to the uninterrupted tokens; a lane migrated
between two worker PROCESSES (MIGRATE frames over the procpool's
sockets) gives the unmigrated tokens without a re-prefill, as does the
drain of one worker (its lane evacuated to the other); and
``chaos_check --serving --migrate`` passes its greedy, sampled and
speculative runs.
"""

import functools
import threading
import time

import numpy as np
import pytest
import torch

from tensorflow_train_distributed_torch import chaos_check
from tensorflow_train_distributed_torch.runtime import events, faults
from tensorflow_train_distributed_torch.server import ServingGateway
from tensorflow_train_distributed_torch.server.replicas import (
    ReplicaPool,
    migration_killed,
)
from tensorflow_train_distributed_torch.server.worker import llama_params
from tensorflow_train_distributed_torch.serving import (
    ServingEngine as TorchEngine,
)
from test_torch_gateway import StubEngine, _get, _parse_prom


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.disarm()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub_pool(n=2, *, slots=2, step_delay=0.01, **kw):
    kw.setdefault("watchdog_timeout_s", 2.0)
    return ReplicaPool([StubEngine(slots=slots, step_delay=step_delay)
                        for _ in range(n)], **kw).start()


def _wait_placed(pool, h, timeout=5.0):
    """Block until the request holds a replica; returns the replica."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        preq = pool._requests.get(h.id)
        if preq is not None and preq.replica is not None:
            return preq.replica
        time.sleep(0.005)
    raise AssertionError(f"request {h.id} never placed")


# ── the tentpole: move a live stream, bitwise ──────────────────────────


def test_migrate_moves_live_stream_bitwise():
    """One streaming request migrates mid-generation: the client's
    token stream equals the closed form, the source driver remembers
    the request as terminal ``migrated``, and the pool's own answer
    stays ``ok``."""
    pool = _stub_pool(2, step_delay=0.02)
    try:
        prompt, max_new = [5], 40
        h = pool.submit(prompt, max_new, stream=True)
        it = h.iter_tokens()
        got = list(next(it))
        preq = pool._requests[h.id]
        src = preq.replica
        assert src is not None
        assert pool.migrate(h.id)
        for chunk in it:
            got.extend(chunk)
        assert prompt + got == StubEngine.expected(prompt, max_new)
        assert preq.migrations == 1
        assert src.driver.request_status(h.id) == "migrated"
        assert pool.request_status(h.id) == "ok"
    finally:
        assert pool.join(timeout=10)


def test_migrate_twice_targeted_round_trip():
    """Two targeted hops (away and BACK to the original replica) — the
    stream survives both and stays token-equal; bogus targets are
    refused without touching the request."""
    pool = _stub_pool(3, step_delay=0.02)
    try:
        prompt, max_new = [9, 9], 50
        h = pool.submit(prompt, max_new, stream=True)
        it = h.iter_tokens()
        got = list(next(it))
        preq = pool._requests[h.id]
        src = preq.replica.idx
        other = next(r.idx for r in pool.replicas if r.idx != src)
        assert not pool.migrate(h.id, target=99)      # unknown replica
        assert not pool.migrate(12345)                # unknown request
        assert pool.migrate(h.id, target=other)
        assert _wait_placed(pool, h).idx == other
        got.extend(next(it))                          # decoding there
        assert pool.migrate(h.id, target=src)
        assert _wait_placed(pool, h).idx == src
        for chunk in it:
            got.extend(chunk)
        assert prompt + got == StubEngine.expected(prompt, max_new)
        assert preq.migrations == 2
    finally:
        assert pool.join(timeout=10)


def test_migrate_queued_request_moves_parameters_only():
    """An accepted-but-unplaced request migrates as pure parameters
    (kind="queued"): no KV, no token history — it simply prefills on
    the target like a fresh admission."""
    pool = _stub_pool(2, slots=1, step_delay=0.05)
    try:
        # Fill both single-slot replicas, then queue one more.
        busy = [pool.submit([i + 1], 30, stream=True) for i in range(2)]
        its = [h.iter_tokens() for h in busy]
        firsts = [list(next(it)) for it in its]
        h = pool.submit([77], 4)
        # Whether queued or placed by now, the move must commit and
        # the closed form must hold.
        pool.migrate(h.id)
        assert h.result(timeout=20) == StubEngine.expected([77], 4)
        for b, it, got in zip(busy, its, firsts):
            for chunk in it:
                got.extend(chunk)
            assert b.prompt + got == StubEngine.expected(b.prompt, 30)
    finally:
        assert pool.join(timeout=10)


# ── kill switch: TTD_NO_MIGRATION=1 restores pre-PR behavior ───────────


def test_no_migration_kill_switch(monkeypatch):
    """``TTD_NO_MIGRATION=1``: ``migrate()`` refuses, ``_evacuate``
    is a no-op, no ``request/migrate`` event is ever emitted, and the
    stream finishes exactly where it started — the pre-migration
    drain/failover behavior byte-for-byte."""
    monkeypatch.setenv("TTD_NO_MIGRATION", "1")
    assert migration_killed()
    rec = events.get_recorder()
    cursor, _ = rec.events_after(0)
    pool = _stub_pool(2, step_delay=0.02)
    try:
        prompt, max_new = [3], 30
        h = pool.submit(prompt, max_new, stream=True)
        it = h.iter_tokens()
        got = list(next(it))
        preq = pool._requests[h.id]
        src = preq.replica
        assert not pool.migrate(h.id)
        assert pool._evacuate(src) == 0
        assert pool.defragment() == 0
        for chunk in it:
            got.extend(chunk)
        assert prompt + got == StubEngine.expected(prompt, max_new)
        assert preq.migrations == 0
        assert src.driver.request_status(h.id) == "ok"
        assert pool.join(timeout=10)
    finally:
        monkeypatch.setenv("TTD_NO_MIGRATION", "0")
    _, evs = rec.events_after(cursor)
    assert not [e for e in evs
                if e[0] in ("request/migrate", "replica/evacuate")]
    assert not migration_killed()


# ── interrupted migration: the resume-from-token fallback ──────────────


def test_export_refusal_keeps_stream_in_place():
    """An export that never commits (source driver raises) leaves the
    request running where it was — ``migrate()`` returns False and
    the stream completes untouched."""
    pool = _stub_pool(2, step_delay=0.02)
    try:
        prompt, max_new = [4], 30
        h = pool.submit(prompt, max_new, stream=True)
        it = h.iter_tokens()
        got = list(next(it))
        preq = pool._requests[h.id]
        src = preq.replica

        def refuse(request_id, timeout_s=None):
            raise RuntimeError("export refused")

        src.driver.export_lane = refuse
        assert not pool.migrate(h.id)
        for chunk in it:
            got.extend(chunk)
        assert prompt + got == StubEngine.expected(prompt, max_new)
        assert preq.migrations == 0
        assert preq.replica is src
    finally:
        assert pool.join(timeout=10)


def test_lost_export_reply_completes_via_failover():
    """The nasty half-committed shape: the source exports AND retires
    the lane but the reply is lost (timeout).  ``migrate()`` returns
    False, yet the request must still COMPLETE token-equal via the
    normal resume-from-token failover — no token duplicated or
    dropped."""
    pool = _stub_pool(2, step_delay=0.02)
    rec = events.get_recorder()
    cursor, _ = rec.events_after(0)
    try:
        prompt, max_new = [6], 40
        h = pool.submit(prompt, max_new, stream=True)
        it = h.iter_tokens()
        got = list(next(it))
        preq = pool._requests[h.id]
        src = preq.replica
        committed = src.driver.export_lane

        def lost_reply(request_id, timeout_s=None):
            committed(request_id, timeout_s)     # lane leaves the src
            raise TimeoutError("reply lost")     # ...but nobody hears

        src.driver.export_lane = lost_reply
        assert not pool.migrate(h.id)
        for chunk in it:
            got.extend(chunk)
        assert prompt + got == StubEngine.expected(prompt, max_new)
        assert pool.request_status(h.id) == "ok"
        assert preq.migrations == 0
    finally:
        assert pool.join(timeout=10)
    _, evs = rec.events_after(cursor)
    assert [e for e in evs if e[0] == "request/failover"
            and e[5].get("request_id") == h.id]


# ── drain-time evacuation and fleet packing ────────────────────────────


def test_drain_reports_lanes_remaining_and_evacuates():
    """A draining replica's /healthz row carries ``lanes_remaining``;
    evacuation moves the lane off and the stream completes elsewhere,
    token-equal."""
    pool = _stub_pool(2, step_delay=0.05)
    try:
        prompt, max_new = [8], 40
        h = pool.submit(prompt, max_new, stream=True)
        it = h.iter_tokens()
        got = list(next(it))
        src = pool._requests[h.id].replica
        src.driver.drain()
        row = next(s for s in pool.replica_states()
                   if s["replica"] == src.idx)
        assert row["state"] == "draining"
        assert row["lanes_remaining"] == 1
        assert pool._evacuate(src) == 1
        row = next(s for s in pool.replica_states()
                   if s["replica"] == src.idx)
        assert row.get("lanes_remaining", 0) == 0
        for chunk in it:
            got.extend(chunk)
        assert prompt + got == StubEngine.expected(prompt, max_new)
        assert pool._requests.get(h.id) is None or (
            pool._requests[h.id].replica is not src)
    finally:
        assert pool.join(timeout=10)


def test_join_evacuates_before_draining():
    """``join()`` prefers migration: live lanes move to the next
    replica instead of blocking the drain, and every stream still
    matches the closed form."""
    rec = events.get_recorder()
    cursor, _ = rec.events_after(0)
    pool = _stub_pool(2, step_delay=0.05)
    hs = [pool.submit([10 + i], 40, stream=True) for i in range(4)]
    its = [h.iter_tokens() for h in hs]
    got = [list(next(it)) for it in its]   # all placed and decoding

    def consume(i):
        for chunk in its[i]:
            got[i].extend(chunk)

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(hs))]
    for t in threads:
        t.start()
    assert pool.join(timeout=30)
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    for i, h in enumerate(hs):
        want = StubEngine.expected(h.prompt, 40)
        assert got[i] == want[len(h.prompt):]
    _, evs = rec.events_after(cursor)
    assert [e for e in evs if e[0] == "replica/evacuate"]
    assert [e for e in evs if e[0] == "request/migrate"]


def test_defragment_packs_long_tail():
    """Defragmentation moves the least-occupied replica's lanes into
    the rest of the fleet's spare slots so scale-down can reclaim the
    worker — streams keep their closed-form output."""
    pool = _stub_pool(2, slots=4, step_delay=0.05)
    try:
        hs = [pool.submit([20 + i], 40, stream=True) for i in range(3)]
        its = [h.iter_tokens() for h in hs]
        firsts = [list(next(it)) for it in its]
        occupied = [r for r in pool.replicas
                    if r.driver.active_slots() > 0]
        assert len(occupied) == 2        # load-balanced 2/1 split
        moved = pool.defragment()
        assert moved >= 1
        for h, it, got in zip(hs, its, firsts):
            for chunk in it:
                got.extend(chunk)
            assert h.prompt + got == StubEngine.expected(h.prompt, 40)
    finally:
        assert pool.join(timeout=10)


# ── observability: metrics and the flight recorder ─────────────────────


def test_migration_metrics_and_timeline():
    """A migration increments ``ttd_gateway_migrations_total`` and
    observes ``ttd_gateway_migration_seconds``, and the flight
    recorder's request timeline shows BOTH lives joined by the
    ``request/migrate`` hop."""
    gw = ServingGateway([StubEngine(slots=2, step_delay=0.02)
                         for _ in range(2)],
                        host="127.0.0.1", port=0).start()
    rec = events.get_recorder()
    try:
        h = gw.pool.submit([7], 40, stream=True)
        it = h.iter_tokens()
        got = list(next(it))
        assert gw.pool.migrate(h.id)
        for chunk in it:
            got.extend(chunk)
        assert [7] + got == StubEngine.expected([7], 40)
        prom = _parse_prom(_get(gw.port, "/metrics")[1])
        assert prom.get("ttd_gateway_migrations_total") == 1.0
        assert prom.get("ttd_gateway_migration_seconds_count") == 1.0
        # Stub lanes ship no KV rows; the counter exists and is 0.
        assert prom.get("ttd_gateway_migrated_kv_bytes_total") == 0.0
        names = [e[0] for e in rec.request_timeline(h.id)]
        assert "request/migrate" in names
        assert "request/pool_admitted" in names
    finally:
        gw.drain(timeout=10)


# ── the port's engine: lane round trips ─────────────────────────────────


_KW = dict(slots=2, cache_len=64, chunk=4, prompt_buckets=(8, 16, 32))


def _llama():
    cfg, params = llama_params("llama_tiny", 0, "cpu")
    return cfg, params, functools.partial(TorchEngine, device="cpu")


def test_engine_lane_roundtrip_bitwise():
    """The byte recipe end-to-end WITHOUT a pool: a llama lane
    exported mid-generation (full KV blocks in the KV_HANDOFF row
    format) installs on a fresh engine whose resumed decode produces
    the EXACT token stream of an uninterrupted run.  Export is
    read-only and deterministic — two snapshots are bit-identical."""
    cfg, params, ServingEngine = _llama()
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(1, 200, 21)]
    max_new = 24

    ref_eng = ServingEngine(cfg, params, **_KW)
    rid = ref_eng.submit(list(prompt), max_new, seed=7)
    ref = ref_eng.run()[rid]

    src = ServingEngine(cfg, params, **_KW)
    rid = src.submit(list(prompt), max_new, seed=7)
    out = None
    for _ in range(200):
        src.serve_step()
        out = src.export_lane(rid)
        assert out is not None, "request finished before export"
        meta, blob = out
        if (meta["kind"] == "lane"
                and len(meta["tokens"]) >= len(prompt) + 10):
            break
    assert meta["kind"] == "lane"
    kv = meta["kv"]
    assert kv is not None and blob, "lane exported without KV rows"
    assert kv["n"] > 0 and kv["n"] % src.kv_block_size == 0
    meta2, blob2 = src.export_lane(rid)      # read-only + deterministic
    assert meta2 == meta and blob2 == blob

    dst = ServingEngine(cfg, params, **_KW)
    warm = dst.install_lane(meta, blob)
    assert warm == kv["n"]
    gen = len(meta["tokens"]) - len(prompt)
    rid2 = dst.submit(list(meta["tokens"]), meta["remaining"], seed=7,
                      resume_from=gen)
    assert dst.run()[rid2] == ref


def _worker_pool(n=2, **spec):
    from tensorflow_train_distributed_torch.server.procpool import (
        ProcPool,
        WorkerSpec,
    )

    spec = dict(preset="llama_tiny", init_seed=0, device="cpu",
                **{k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in _KW.items()}, **spec)
    return ProcPool(WorkerSpec(factory="llama", factory_json=spec,
                               env={"OMP_NUM_THREADS": "1"}),
                    replicas=n, watchdog_timeout_s=30.0,
                    monitor_poll_s=0.02, spawn_cooldown_s=0.05,
                    restart_backoff_s=0.05).start()


@pytest.mark.parametrize("sampling", [False, True],
                         ids=["greedy", "seeded-sampling"])
def test_lane_migrated_between_torch_workers_gives_unmigrated_tokens(
        sampling):
    """A live lane moves between two worker processes over MIGRATE
    frames (its KV blocks and decode state, no re-prefill: the target's
    radix takes the shipped rows); the stream equals an uninterrupted
    engine's, and nobody died for it."""
    cfg, params, ServingEngine = _llama()
    kw = dict(_KW, temperature=0.8, top_k=40) if sampling else dict(_KW)
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(1, 200, 21)]
    ref_eng = ServingEngine(cfg, params, **kw)
    rid = ref_eng.submit(list(prompt), 30, seed=7 if sampling else None)
    ref = ref_eng.run()[rid]
    extra = dict(temperature=0.8, top_k=40) if sampling else {}
    pool = _worker_pool(2, **extra)
    try:
        assert pool.wait_ready(120)
        rec = events.get_recorder()
        cursor, _ = rec.events_after(0)
        h = pool.submit(list(prompt), 30, seed=7 if sampling else None,
                        stream=True)
        it = h.iter_tokens()
        toks = list(next(it))
        preq = pool._requests[h.id]
        src = preq.replica
        assert pool.migrate(h.id)
        for chunk in it:
            toks.extend(chunk)
        assert prompt + toks == ref
        assert preq.migrations == 1 and preq.replica is not src
        _, evs = rec.events_after(cursor)
        hops = [e for e in evs if e[0] == "request/migrate"]
        assert hops and hops[0][5].get("bytes", 0) > 0
        assert pool.alive_count() == 2
    finally:
        pool.join(timeout=60)


def test_worker_drain_migrates_live_lanes():
    """The pool's staged drain (``join``, what a SIGTERM runs) evacuates
    the first worker's live lane to the other before it drains it: the
    lane's KV and state move over MIGRATE frames and the stream finishes
    with the uninterrupted tokens.  (Evacuation precedes the DRAIN frame:
    a worker told to drain may close its socket once its last lane is
    gone, before an export's reply is out.)"""
    cfg, params, ServingEngine = _llama()
    prompt, max_new = [3, 9, 2, 7, 1, 4, 6, 8, 5, 11, 13, 17, 19, 23,
                       29, 31, 37], 28
    ref_eng = ServingEngine(cfg, params, **_KW)
    rid = ref_eng.submit(list(prompt), max_new)
    want = ref_eng.run()[rid]
    pool = _worker_pool(2)
    joined = []
    try:
        assert pool.wait_ready(120)
        h = pool.submit(list(prompt), max_new, stream=True)
        it = h.iter_tokens()
        got = list(next(it))                 # placed and streaming
        preq = pool._requests[h.id]
        src = preq.replica
        assert src.idx == 0                  # drained first
        t = threading.Thread(target=lambda: joined.append(
            pool.join(timeout=60)))
        t.start()
        for chunk in it:
            got.extend(chunk)
        t.join(timeout=90)
        assert not t.is_alive() and joined == [True]
        assert prompt + got == want
        assert preq.migrations == 1 and preq.replica is not src
    finally:
        if not joined:
            pool.join(timeout=60)


# ── the chaos gate (chaos_check --serving --migrate) ────────────────────


@pytest.mark.parametrize("leg", ["greedy", "sampled", "speculative"])
def test_chaos_check_serving_migrate_smoke(leg):
    """Every active stream on a 3-replica gateway migrates twice
    mid-generation under load, a source replica vanishes armed
    mid-migration, and every token stream equals an uninterrupted
    single-engine run, with KV bytes shipped and a replica (never the
    fleet) dead."""
    verdict = chaos_check.run_serving_chaos_migrate(
        sampling=leg == "sampled", speculative=leg == "speculative",
        n_requests=5, device="cpu")
    assert verdict["ok"], verdict
    assert verdict["checks"]["streams_match_reference"]
    assert verdict["checks"]["every_stream_migrated_twice"]
    assert verdict["checks"]["kv_bytes_moved"]
    assert verdict["checks"]["replica_died"]
