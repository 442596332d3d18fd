"""The port's out-of-process serving replicas (``server.procpool``,
``server.worker``): the frame protocol, the subprocess pool, real-SIGKILL
fault isolation, elastic scaling.

The cases of JAX ``tests/test_procpool.py`` over the port's modules:
``server.proto``'s hardening (truncated frames, oversized length
prefixes, garbage payloads, version mismatches) and the ``ProcPool`` over
the deterministic stub worker engine (real subprocesses, closed-form
outputs): a worker killed with ``os.kill(pid, SIGKILL)`` mid-stream
re-admits its request on a survivor token-equal to an uninterrupted run,
the corpse is classified "killed by signal 9", the scaler respawns it
under the restart budget, and deliberately corrupt workers fail one
replica, never the pool.  The port's engine rides ``chaos_check --serving
--procs`` (both legs, llama_tiny workers on the CPU), workers built by
the production factory (``serve.worker_engine_factory``) lose one to a
SIGKILL and finish every stream token for token, and ``serve_http
--replica-procs`` serves, scrapes and drains on SIGTERM as a process.
Workers run one torch thread (``OMP_NUM_THREADS=1``).
"""

import dataclasses
import io
import json
import os
import signal
import struct
import time

import pytest

from tensorflow_train_distributed_torch import chaos_check
from tensorflow_train_distributed_torch.server import proto
from tensorflow_train_distributed_torch.server.procpool import (
    ProcPool,
    WorkerSpec,
    proc_replicas_killed,
)
from tensorflow_train_distributed_torch.server.replicas import NoReplicas
from tensorflow_train_distributed_torch.server.worker import (
    StubWorkerEngine,
)
from test_torch_gateway import _get, _parse_prom, _post


# ── the frame protocol (pure functions) ────────────────────────────────


def test_frame_roundtrip_every_type():
    buf = io.BytesIO()
    bodies = {}
    for ftype in proto.FRAME_NAMES:
        bodies[ftype] = {"t": ftype, "payload": [1, 2, 3],
                         "text": "μtf-8 – ok"}
        if ftype in proto.BINARY_FRAMES:
            # Binary types have exactly one legal writer; a JSON body
            # would be mis-parsed as a binary layout on the far side.
            with pytest.raises(proto.ProtocolError, match="binary"):
                proto.write_frame(buf, ftype, bodies[ftype])
            blob = bytes(range(256)) * 3
            buf.write(proto.encode_binary_frame(
                ftype, bodies[ftype], blob))
            bodies[ftype] = dict(bodies[ftype],
                                 **{proto.BLOB_KEY: blob})
        else:
            proto.write_frame(buf, ftype, bodies[ftype])
    buf.seek(0)
    for ftype in proto.FRAME_NAMES:
        got = proto.read_frame(buf)
        assert got == (ftype, bodies[ftype])
    assert proto.read_frame(buf) is None      # clean EOF on a boundary


def test_oversized_length_prefix_refused_without_reading_body():
    """The bounded-read contract: a corrupt/hostile length prefix
    fails on the PREFIX ALONE — the reader never attempts the body."""

    class HeaderOnly:
        def __init__(self, header):
            self._header = header

        def read(self, n):
            if self._header:
                out, self._header = self._header, b""
                return out
            raise AssertionError("read past the refused prefix")

    fp = HeaderOnly(struct.pack("!I", proto.MAX_FRAME_BYTES + 1))
    with pytest.raises(proto.ProtocolError, match="oversized"):
        proto.read_frame(fp)
    # An explicitly tightened bound refuses smaller frames too.
    frame = proto.encode_frame(proto.STATS, {"x": "y" * 64})
    with pytest.raises(proto.ProtocolError, match="oversized"):
        proto.read_frame(io.BytesIO(frame), max_frame=16)


def test_truncated_frame_is_midframe_death():
    # Header claims 4096 payload bytes; the stream dies after 10.
    fp = io.BytesIO(struct.pack("!I", 4096) + b"\x07" + b"x" * 9)
    with pytest.raises(proto.ProtocolError, match="mid-frame"):
        proto.read_frame(fp)
    # ... and inside the header itself.
    with pytest.raises(proto.ProtocolError, match="mid-frame"):
        proto.read_frame(io.BytesIO(b"\x00\x00"))


def test_garbage_and_malformed_bodies():
    payload = b"\x03\xff\xfe not json"
    fp = io.BytesIO(struct.pack("!I", len(payload)) + payload)
    with pytest.raises(proto.ProtocolError, match="not JSON"):
        proto.read_frame(fp)
    frame = proto._HEADER.pack(6) + bytes([proto.CHUNK]) + b"[1,2]"
    with pytest.raises(proto.ProtocolError, match="JSON object"):
        proto.read_frame(io.BytesIO(frame))
    with pytest.raises(proto.ProtocolError, match="empty frame"):
        proto.read_frame(io.BytesIO(struct.pack("!I", 0)))


def test_outgoing_frames_honor_the_bound_too():
    with pytest.raises(proto.ProtocolError, match="exceeds"):
        proto.encode_frame(proto.STATS, {"blob": "x" * 1024},
                           max_frame=128)


def test_hello_handshake_versioning():
    body = {"proto": proto.PROTO_VERSION, "pid": 1}
    assert proto.check_hello(proto.HELLO, body) is body
    with pytest.raises(proto.ProtocolError, match="version mismatch"):
        proto.check_hello(proto.HELLO, {"proto": 999})
    with pytest.raises(proto.ProtocolError, match="expected HELLO"):
        proto.check_hello(proto.STATS, {})


# ── the subprocess pool over stub workers ──────────────────────────────


def _stub_pool(n=2, *, step_delay=0.0, slots=2, **kw):
    kw.setdefault("watchdog_timeout_s", 10.0)
    kw.setdefault("monitor_poll_s", 0.02)
    kw.setdefault("restart_backoff_s", 0.05)
    kw.setdefault("scale_poll_s", 0.05)
    kw.setdefault("spawn_cooldown_s", 0.05)
    spec = WorkerSpec(factory="stub",
                      factory_json={"slots": slots,
                                    "step_delay": step_delay})
    return ProcPool(spec, replicas=n, **kw).start()


def test_procpool_serves_parity_and_drains_clean():
    pool = _stub_pool(2)
    try:
        assert pool.wait_ready(30)
        hs = [pool.submit([10 * (i + 1)], 3 + i % 4) for i in range(8)]
        for i, h in enumerate(hs):
            expect = StubWorkerEngine.expected([10 * (i + 1)],
                                               3 + i % 4)
            assert h.result(timeout=30) == expect
            assert pool.request_status(h.id) == "ok"
        states = pool.replica_states()
        assert all(s["state"] == "alive" and s["pid"] for s in states)
    finally:
        assert pool.join(timeout=30)


def test_real_sigkill_midstream_failover_token_equal_and_respawn():
    """THE headline: a worker killed with a real os.kill(pid, SIGKILL)
    mid-stream — the gateway process survives, the request re-admits
    on a survivor via resume-from-token and the full stream equals an
    uninterrupted run, the corpse is classified 'killed by signal 9',
    and the elastic pool respawns it (restart accounting moves)."""
    pool = _stub_pool(2, step_delay=0.05)
    try:
        assert pool.wait_ready(30)
        h = pool.submit([5, 6, 7], 30, stream=True)
        it = h.iter_tokens()
        toks = list(next(it))              # placed and streaming
        victim = pool._requests[h.id].replica
        os.kill(victim.driver.pid, signal.SIGKILL)
        for chunk in it:
            toks.extend(chunk)
        assert [5, 6, 7] + toks == StubWorkerEngine.expected(
            [5, 6, 7], 30)
        dead = [s for s in pool.replica_states()
                if s["state"] == "dead"]
        assert len(dead) == 1
        assert "signal 9" in dead[0]["reason"]
        assert dead[0]["failure_class"] == "killed"
        assert dead[0]["replica"] == victim.idx
        # Respawn under the restart budget: capacity returns on its
        # own, and the restart counter moves.
        deadline = time.monotonic() + 20
        while (pool.alive_count() < 2
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert pool.alive_count() >= 2
        assert pool.restarts_total() >= 1
        # The respawned worker actually serves.
        h2 = pool.submit([42], 4)
        assert h2.result(timeout=30) == StubWorkerEngine.expected(
            [42], 4)
    finally:
        pool.join(timeout=30)


def test_elastic_scaler_spawns_under_pressure_and_drains_at_idle():
    """The elasticity pin: queue pressure grows the fleet toward
    scale_max; sustained idle drains it back toward scale_min, one
    staged worker at a time, and fully-drained workers are pruned."""
    pool = _stub_pool(1, step_delay=0.05, slots=1, scale_min=1,
                      scale_max=3, scale_up_queue=1,
                      idle_grace_s=0.3)
    try:
        assert pool.wait_ready(30)
        hs = [pool.submit([i + 1], 12) for i in range(8)]
        deadline = time.monotonic() + 30
        grew = 0
        while time.monotonic() < deadline:
            grew = max(grew, sum(1 for r in pool.replicas
                                 if r.accepting()))
            if grew >= 2 and all(h.done() for h in hs):
                break
            time.sleep(0.02)
        assert grew >= 2, "scaler never spawned under queue pressure"
        for i, h in enumerate(hs):
            assert h.result(timeout=30) == StubWorkerEngine.expected(
                [i + 1], 12)
        # Sustained idle: drain back to scale_min and prune the
        # drained workers from the published snapshot.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            accepting = [r for r in pool.replicas if r.accepting()]
            if (len(accepting) == 1
                    and len(pool.replicas) == len(accepting)):
                break
            time.sleep(0.05)
        accepting = [r for r in pool.replicas if r.accepting()]
        assert len(accepting) == 1, "scaler never drained back at idle"
        assert len(pool.replicas) == 1, "drained workers not pruned"
        # Still serving after the shrink.
        h = pool.submit([9], 3)
        assert h.result(timeout=30) == StubWorkerEngine.expected(
            [9], 3)
    finally:
        pool.join(timeout=30)


def test_sigkill_mid_drain_classified_dead_not_drained():
    """A worker murdered WHILE draining (SIGKILL/OOM before its BYE)
    is a death, not an orderly scale-down: it must classify 'dead'
    with the kill reason — never be pruned as 'drained'."""
    pool = _stub_pool(2, step_delay=0.05)
    try:
        assert pool.wait_ready(30)
        h = pool.submit([1, 2], 40, stream=True)
        it = h.iter_tokens()
        next(it)                            # placed and streaming
        victim = pool._requests[h.id].replica
        victim.driver.drain()               # orderly drain begins...
        os.kill(victim.driver.pid, signal.SIGKILL)   # ...kill lands
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            # state() flips "dead" the moment the corpse's wait
            # status is visible; the KILL REASON is written by the
            # monitor's classification one tick later — wait for
            # both, or a loaded host reads the gap as a failure.
            if victim.state() == "dead" and victim.dead_reason:
                break
            assert victim.state() != "drained", (
                "mid-drain kill misread as an orderly drain")
            time.sleep(0.02)
        assert victim.state() == "dead"
        assert "signal 9" in (victim.dead_reason or "")
        # The stream still completes on the survivor, token-equal
        # (the handle sees the whole spliced stream).
        for _chunk in it:
            pass
        assert h.result(timeout=30) == StubWorkerEngine.expected(
            [1, 2], 40)
    finally:
        pool.join(timeout=30)


def test_oversized_submit_is_client_error_not_dead_replica():
    """A request whose SUBMIT frame exceeds the frame bound is the
    CLIENT's error (RequestError -> 400), not a dead-pipe event that
    excludes healthy replicas."""
    spec = WorkerSpec(factory="stub", factory_json={"slots": 2},
                      max_frame_bytes=65536)
    pool = ProcPool(spec, replicas=2, watchdog_timeout_s=10.0,
                    monitor_poll_s=0.02).start()
    try:
        assert pool.wait_ready(30)
        from tensorflow_train_distributed_torch.server.driver import (
            RequestError,
        )

        h = pool.submit(list(range(1, 20_001)), 2)
        with pytest.raises(RequestError, match="exceeds"):
            h.result(timeout=30)
        # Nobody was blamed: both replicas still alive and serving.
        assert pool.alive_count() == 2
        h2 = pool.submit([3], 4)
        assert h2.result(timeout=30) == StubWorkerEngine.expected(
            [3], 4)
    finally:
        pool.join(timeout=30)


def test_restart_budget_exhaustion_is_terminal():
    """With the respawn budget spent, a dead fleet stops resurrecting:
    placement fails NoReplicas instead of waiting forever."""
    pool = _stub_pool(1, max_restarts=0)
    try:
        assert pool.wait_ready(30)
        os.kill(pool.replicas[0].driver.pid, signal.SIGKILL)
        deadline = time.monotonic() + 10
        while pool.alive_count() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pool.alive_count() == 0
        time.sleep(0.3)                   # a few scaler passes: no
        assert pool.restarts_total() == 0  # budget means no respawn
        with pytest.raises(NoReplicas):
            pool.submit([1], 3)
    finally:
        pool.join(timeout=30)


def test_kill_switch_refuses_proc_pool(monkeypatch):
    monkeypatch.setenv("TTD_NO_PROC_REPLICAS", "1")
    assert proc_replicas_killed()
    with pytest.raises(RuntimeError, match="TTD_NO_PROC_REPLICAS"):
        ProcPool(WorkerSpec(), replicas=2)
    monkeypatch.setenv("TTD_NO_PROC_REPLICAS", "0")
    assert not proc_replicas_killed()


# ── protocol hardening: corrupt workers fail ONE replica, never the
# pool ─────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("mode", ["badversion", "oversize", "truncate",
                                  "garbage", "midframe", "midmigrate",
                                  "migrateversion"])
def test_corrupt_worker_fails_one_replica_never_the_pool(mode):
    """Every protocol failure mode — stale hello version, oversized
    length prefix, truncated frame, non-JSON payload, death mid-frame,
    death mid-MIGRATE, and a MIGRATE manifest from a future version —
    fails exactly the speaking replica, classified in its /healthz
    state, while the healthy replica keeps serving."""

    class MixedPool(ProcPool):
        def _make_replica(self, idx, spec):
            if idx == 0:
                spec = dataclasses.replace(spec, test_corrupt=mode)
            return super()._make_replica(idx, spec)

    spec = WorkerSpec(factory="stub", factory_json={"slots": 2})
    pool = MixedPool(spec, replicas=2, watchdog_timeout_s=10.0,
                     monitor_poll_s=0.02, restart_backoff_s=0.05,
                     # No respawn: the test pins the corpse's
                     # classification, not the recovery.
                     max_restarts=0).start()
    try:
        # The healthy replica hellos and serves regardless of what
        # replica 0 is speaking.
        assert pool.replicas[1].driver.wait_ready(30)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            dead = [s for s in pool.replica_states()
                    if s["state"] == "dead"]
            if dead:
                break
            time.sleep(0.02)
        assert len(dead) == 1, f"{mode}: corrupt replica not declared"
        assert dead[0]["replica"] == 0
        assert dead[0]["failure_class"] == "protocol", dead[0]
        assert "ProtocolError" in dead[0]["reason"]
        # Never the pool: the healthy replica still serves.
        assert pool.alive_count() == 1
        h = pool.submit([7], 4)
        assert h.result(timeout=30) == StubWorkerEngine.expected(
            [7], 4)
    finally:
        pool.join(timeout=30)


# ── the gateway over a subprocess pool ─────────────────────────────────


def _proc_gateway(n=2, **kw):
    from tensorflow_train_distributed_torch.server import ServingGateway

    kw.setdefault("watchdog_timeout_s", 10.0)
    kw.setdefault("monitor_poll_s", 0.02)
    kw.setdefault("restart_backoff_s", 0.05)
    kw.setdefault("scale_poll_s", 0.05)
    spec = WorkerSpec(factory="stub", factory_json={"slots": 2})
    # UNSTARTED: the gateway owns the pool's lifecycle (start/drain),
    # exactly like the launchers.
    pool = ProcPool(spec, replicas=n, **kw)
    return ServingGateway(pool, host="127.0.0.1", port=0).start(), pool


def test_gateway_over_procpool_http_healthz_metrics():
    """The HTTP surface is pool-blind: /v1/generate serves, /healthz
    carries per-worker pid/rss, /metrics renders the restart counter
    and the per-worker rss gauge (labeled series)."""
    gw, pool = _proc_gateway(n=2)
    try:
        assert pool.wait_ready(30)
        st, obj, _ = _post(gw.port, {"prompt": [1, 2, 3],
                                     "max_new": 5})
        assert st == 200
        assert obj["tokens"] == StubWorkerEngine.expected([1, 2, 3], 5)
        st, body, _ = _get(gw.port, "/healthz")
        assert st == 200
        health = json.loads(body)
        assert health["status"] == "ok"
        assert all(r["pid"] for r in health["replicas"])
        # rss arrives with the first stats frame (0.2s heartbeat).
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            _, text, _ = _get(gw.port, "/metrics")
            prom = _parse_prom(text)
            if prom.get('ttd_gateway_replica_rss_bytes'
                        '{replica="0"}', 0) > 0:
                break
            time.sleep(0.1)
        assert prom['ttd_gateway_replica_rss_bytes{replica="0"}'] > 0
        assert prom['ttd_gateway_replica_rss_bytes{replica="1"}'] > 0
        assert prom["ttd_gateway_replica_restarts_total"] == 0
        assert prom["ttd_gateway_slots_total"] == 4   # live aggregate
        # A real SIGKILL moves the restart counter through the full
        # metrics pipeline (scaler -> GatewayMetrics -> scrape).
        os.kill(pool.replicas[0].driver.pid, signal.SIGKILL)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            _, text, _ = _get(gw.port, "/metrics")
            prom = _parse_prom(text)
            if prom["ttd_gateway_replica_restarts_total"] >= 1:
                break
            time.sleep(0.05)
        assert prom["ttd_gateway_replica_restarts_total"] >= 1
        st, body, _ = _get(gw.port, "/healthz")
        health = json.loads(body)
        assert health["status"] in ("ok", "degraded")
        dead = [r for r in health["replicas"]
                if r["state"] == "dead"]
        assert dead and dead[0]["failure_class"] == "killed"
    finally:
        gw.drain(timeout=30)


def test_worker_events_relayed_into_request_timeline():
    """A request served by a subprocess worker still shows its
    worker-side lifecycle in the parent's /v1/requests/<id> — the
    stats frames relay the request-scoped flight-recorder slice
    across the process boundary."""
    gw, pool = _proc_gateway(n=2)
    try:
        assert pool.wait_ready(30)
        st, obj, _ = _post(gw.port, {"prompt": [4, 5], "max_new": 4})
        assert st == 200
        rid = obj["id"]
        # Worker events ride the next stats heartbeat (0.2s).
        deadline = time.monotonic() + 10
        names = []
        while time.monotonic() < deadline:
            st, body, _ = _get(gw.port, f"/v1/requests/{rid}")
            assert st == 200
            names = [e["name"] for e in json.loads(body)["timeline"]]
            if "request/commit" in names:
                break
            time.sleep(0.1)
        # Parent-side pool admission AND worker-side driver lifecycle
        # in one joined timeline.
        assert "request/pool_admitted" in names
        assert "request/admitted" in names, names
        assert "request/commit" in names, names
    finally:
        gw.drain(timeout=30)


# ── the port's engine: chaos gate, production factory, the CLI ───────


@pytest.mark.parametrize("sampling", [False, True],
                         ids=["greedy", "seeded-sampling"])
def test_chaos_check_serving_procs_smoke(sampling):
    """``chaos_check --serving --procs``: two llama_tiny workers, a real
    SIGKILL (the killpid fault in worker 0's own environment) mid-stream
    under load; streams equal an uninterrupted in-process run, the corpse
    is classified, the fleet respawned."""
    verdict = chaos_check.run_serving_chaos_procs(
        sampling=sampling, n_requests=4 if not sampling else 6,
        device="cpu")
    assert verdict["ok"], verdict
    assert verdict["checks"]["streams_match_reference"]
    assert verdict["checks"]["killed_by_signal_9"]
    assert verdict["checks"]["worker_respawned"]


_CLI = ["--config", "llama_tiny_sft", "--device", "cpu", "--slots", "2",
        "--cache-len", "64", "--chunk", "4", "--kv-block-size", "4"]


def test_production_factory_workers_sigkill_token_for_token():
    """Workers built by ``serve.worker_engine_factory`` from serve_http's
    parsed flags (random weights from --seed: every worker draws the
    same); one is SIGKILLed mid-stream and every stream finishes on the
    survivor with the tokens of one uninterrupted engine built the same
    way."""
    from tensorflow_train_distributed_torch import serve_http
    from tensorflow_train_distributed_torch.serve import (
        worker_engine_factory,
    )

    spec = dict(vars(serve_http.build_parser().parse_args(_CLI)))
    ref = worker_engine_factory(spec)
    reqs = [([7, 3, 9, 1][: 2 + i % 3] + [i + 1], 24) for i in range(4)]
    ids = [ref.submit(p, m) for p, m in reqs]
    out = ref.run()
    want = [out[i] for i in ids]
    pool = ProcPool(
        WorkerSpec(factory="tensorflow_train_distributed_torch.serve:"
                           "worker_engine_factory",
                   factory_json=spec, env={"OMP_NUM_THREADS": "1"}),
        replicas=2, watchdog_timeout_s=30.0, monitor_poll_s=0.02,
        restart_backoff_s=0.05, spawn_cooldown_s=0.05).start()
    try:
        assert pool.wait_ready(120)
        hs = [pool.submit(p, m, stream=True) for p, m in reqs]
        it = hs[0].iter_tokens()
        got0 = list(next(it))               # placed and streaming
        victim = pool._requests[hs[0].id].replica
        os.kill(victim.driver.pid, signal.SIGKILL)
        for chunk in it:
            got0.extend(chunk)
        assert reqs[0][0] + got0 == want[0]
        assert [h.result(timeout=120) for h in hs[1:]] == want[1:]
        dead = [s for s in pool.replica_states() if s["state"] == "dead"]
        assert len(dead) == 1 and dead[0]["failure_class"] == "killed"
    finally:
        pool.join(timeout=60)


def test_serve_http_replica_procs_cli_serves_and_drains(tmp_path):
    """``python -m ...serve_http --replica-procs --replicas 2`` as a
    process (its workers given ``--max-frame``): it advertises its port
    once both workers are ready, answers a request and /metrics, and
    SIGTERM drains it to exit 0 with the final metrics logged."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo)
    log = open(tmp_path / "stderr.log", "w+")      # the workers' too
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflow_train_distributed_torch."
         "serve_http", *_CLI, "--replica-procs", "--replicas", "2",
         "--host", "127.0.0.1", "--port", "0", "--drain-timeout", "30",
         "--max-frame", str(8 << 20)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=log, text=True)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("gateway listening on"):
                port = int(line.split()[3].rsplit(":", 1)[1])
                break
        assert port, (tmp_path / "stderr.log").read_text()
        status, obj, _ = _post(port, {"prompt": [1, 2, 3], "max_new": 5})
        assert status == 200 and obj["tokens"][:3] == [1, 2, 3]
        assert len(obj["tokens"]) == 8
        s = _parse_prom(_get(port, "/metrics")[1])
        assert s['ttd_gateway_requests_total{status="ok"}'] == 1
        assert s["ttd_gateway_replicas_alive"] == 2
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
        err = (tmp_path / "stderr.log").read_text()
        assert proc.returncode == 0, err
        assert "final metrics" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
        log.close()
