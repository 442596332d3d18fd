"""The port's multi-replica serving (``server.replicas``): pool routing,
health and watchdog, deterministic failover, retry with backoff, staged
drain, chaos parity.

The cases of JAX ``tests/test_replicas.py`` over the port's modules: the
``ReplicaPool`` and the HTTP gateway over it drive the deterministic
``StubEngine`` (death, vanish and hang faults injected through
``runtime.faults``'s ``serve:dispatch`` site), and the port's engine
(llama_tiny, ``server.worker.llama_params``) pins the contract: with one
of two replicas killed mid-decode, every accepted request completes on the
survivor with the tokens of an uninterrupted single-replica run (greedy
and seeded sampling), and ``TTD_NO_FAILOVER=1`` restores the single-engine
gateway.  ``chaos_check --serving`` runs in process (both legs).
"""

import json
import threading
import time

import functools

import pytest
import torch

from tensorflow_train_distributed_torch import chaos_check
from tensorflow_train_distributed_torch.runtime import events, faults
from tensorflow_train_distributed_torch.server import (
    AdmissionFull,
    DeadlineExceeded,
    ServingGateway,
)
from tensorflow_train_distributed_torch.server.replicas import ReplicaPool
from tensorflow_train_distributed_torch.server.worker import llama_params
from tensorflow_train_distributed_torch.serving import (
    ServingEngine as TorchEngine,
)
from test_torch_gateway import StubEngine, _get, _parse_prom, _post

#: The port's engine on the CPU (the tests' device).
ServingEngine = functools.partial(TorchEngine, device="cpu")


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


# ── fault-plan grammar ─────────────────────────────────────────────────


def test_serve_dispatch_fault_plan_parses_and_rejects():
    plan = faults.parse_plan(
        "serve:dispatch:5:kill9:replica=1;"
        "serve:dispatch:3:hang:hang_s=0.5;serve:dispatch:2:raise")
    assert [e.site for e in plan.entries] == ["serve:dispatch"] * 3
    assert plan.entries[0].params["replica"] == 1
    with pytest.raises(ValueError, match="unknown serve action"):
        faults.parse_plan("serve:dispatch:5:sigterm")
    with pytest.raises(ValueError, match="not an integer"):
        faults.parse_plan("serve:dispatch:x:raise")


# ── pool basics ────────────────────────────────────────────────────────


def test_pool_serves_concurrent_requests_exactly():
    pool = _stub_pool(2)
    try:
        hs = [pool.submit([10 * (i + 1)], 3 + i % 4) for i in range(8)]
        for i, h in enumerate(hs):
            expect = StubEngine.expected([10 * (i + 1)], 3 + i % 4)
            assert h.result(timeout=10) == expect
            assert pool.request_status(h.id) == "ok"
        assert pool.alive_count() == 2
    finally:
        assert pool.join(timeout=10)


def test_pool_affinity_routes_shared_prefix_to_one_replica():
    """Two requests sharing a first KV block (16 stub tokens) land on
    the same replica — the warm-prefix routing policy."""
    pool = _stub_pool(2, step_delay=0.02)
    try:
        shared = list(range(1, 17))            # one full default block
        h1 = pool.submit(shared + [99], 30)
        deadline = time.monotonic() + 5
        while pool.active_slots() == 0:        # placed and decoding
            assert time.monotonic() < deadline
            time.sleep(0.005)
        first_rep = next(r for r in pool.replicas
                         if r.driver.active_slots()
                         + r.driver.waiting() > 0)
        h2 = pool.submit(shared + [77], 2)
        assert h2.result(timeout=10) == StubEngine.expected(
            shared + [77], 2)
        assert first_rep.affinity(tuple(shared)) == 1
        # The follow-up was routed to the replica that saw the prefix
        # even though the other one was idle.
        assert h1.result(timeout=20) == StubEngine.expected(
            shared + [99], 30)
        states = pool.replica_states()
        others = [s for s in states if s["replica"] != first_rep.idx]
        assert all(s["queue_depth"] == 0 and s["slots_in_use"] == 0
                   for s in others)
    finally:
        assert pool.join(timeout=10)


# ── failover: the three death modes ────────────────────────────────────


class DiesAfter(StubEngine):
    """Stub whose serve_step raises after ``n`` steps (driver-death
    with error propagation — the 'device exploded' mode)."""

    def __init__(self, n, slots=2, step_delay=0.01):
        super().__init__(slots=slots, step_delay=step_delay)
        self.n = n
        self.steps = 0

    def serve_step(self):
        self.steps += 1
        if self.steps > self.n:
            raise RuntimeError("replica exploded")
        return super().serve_step()


def test_failover_on_driver_death_completes_exactly():
    pool = ReplicaPool(
        [DiesAfter(3), StubEngine(slots=2, step_delay=0.01)],
        max_queue=16, watchdog_timeout_s=2.0).start()
    try:
        hs = [pool.submit([7 + i], 40) for i in range(4)]
        for i, h in enumerate(hs):
            assert h.result(timeout=30) == StubEngine.expected(
                [7 + i], 40), i
        states = pool.replica_states()
        assert sum(s["state"] == "dead" for s in states) == 1
        assert pool.alive_count() == 1
    finally:
        pool.join(timeout=10)


def test_failover_on_kill9_vanish_and_timeline_shows_hop():
    """kill9 = abrupt vanish: no error propagates, only the liveness
    monitor notices; every request still completes exactly, and the
    flight recorder shows both lives plus the failover hop."""
    faults.arm("serve:dispatch:3:kill9:replica=0")
    pool = _stub_pool(2)
    try:
        hs = [pool.submit([3 + i], 30) for i in range(4)]
        for i, h in enumerate(hs):
            assert h.result(timeout=30) == StubEngine.expected(
                [3 + i], 30), i
        dead = [r for r in pool.replicas if r.dead]
        assert len(dead) == 1 and dead[0].idx == 0
        assert dead[0].driver.vanished()
        assert dead[0].driver.failure() is None    # no corpse: SIGKILL
        # At least one request hopped; its timeline shows admission on
        # replica 0, the failover instant, re-admission on replica 1.
        hopped = None
        for h in hs:
            names = [e[0] for e in
                     events.get_recorder().request_timeline(h.id)]
            if "request/failover" in names:
                hopped = h
                tl = events.get_recorder().request_timeline(h.id)
                break
        assert hopped is not None, "no request failed over?"
        reps_of_admits = [
            (e[5] or {}).get("replica") for e in tl
            if e[0] == "request/admitted"]
        assert reps_of_admits == [0, 1]
        names = [e[0] for e in tl]
        assert names.index("request/pool_admitted") < names.index(
            "request/failover") < names.index("request/pool_retire")
    finally:
        faults.disarm()
        pool.join(timeout=10)


def test_failover_on_hung_dispatch_watchdog():
    """A wedged decode dispatch (hang fault) trips the watchdog: the
    replica is declared dead while its thread still exists, and its
    requests resume on the survivor."""
    faults.arm("serve:dispatch:3:hang:replica=0:hang_s=20")
    pool = _stub_pool(2, watchdog_timeout_s=0.4)
    try:
        hs = [pool.submit([5 + i], 30) for i in range(4)]
        t0 = time.monotonic()
        for i, h in enumerate(hs):
            assert h.result(timeout=30) == StubEngine.expected(
                [5 + i], 30), i
        # Detection is watchdog-bounded, nowhere near hang_s.
        assert time.monotonic() - t0 < 10
        dead = [r for r in pool.replicas if r.dead]
        assert len(dead) == 1 and dead[0].idx == 0
        assert "watchdog" in dead[0].dead_reason
    finally:
        faults.disarm()
        pool.join(timeout=10)


def test_dead_replica_driver_is_fenced_after_wake():
    """A hung dispatch that WAKES after the watchdog declared its
    replica dead must not dispatch again: the pool poisons the driver
    at declaration, so the woken loop exits instead of working its
    stale backlog — a zombie driving the device (or consuming a
    later-armed chaos-fault budget, the flake this regression pins)
    corrupts whoever took over."""
    faults.arm("serve:dispatch:2:hang:replica=0:hang_s=1.5")
    pool = _stub_pool(2, watchdog_timeout_s=0.3)
    try:
        hs = [pool.submit([3 + i], 20) for i in range(4)]
        for i, h in enumerate(hs):
            assert h.result(timeout=30) == StubEngine.expected(
                [3 + i], 20), i
        dead = [r for r in pool.replicas if r.dead]
        assert len(dead) == 1 and dead[0].idx == 0
        drv = dead[0].driver
        # The wedged thread wakes from the hang and must EXIT —
        # unfenced it would decode its whole failed-over backlog and
        # then wait on the condition forever (this join times out).
        drv._thread.join(timeout=10)
        assert not drv._thread.is_alive()
        # ...without completing more than the step it was wedged in
        # (unfenced, the backlog adds dozens of completed steps).
        assert drv.steps_completed() <= 3, drv.steps_completed()
    finally:
        faults.disarm()
        pool.join(timeout=10)


def test_unscoped_serve_fault_fires_on_every_replica():
    """A serve:dispatch entry WITHOUT replica= kills every driver —
    each has its own fire budget (N drivers must not race one shared
    budget and leave N-1 replicas unscathed)."""
    faults.arm("serve:dispatch:2:raise")
    pool = _stub_pool(2, slots=1, step_delay=0.01)
    try:
        hs = [pool.submit([4 + i], 20) for i in range(4)]
        for h in hs:
            with pytest.raises(RuntimeError):
                h.result(timeout=20)
        deadline = time.monotonic() + 5
        while not all(r.dead for r in pool.replicas):
            assert time.monotonic() < deadline, pool.replica_states()
            time.sleep(0.01)
        assert pool.alive_count() == 0
    finally:
        faults.disarm()
        pool.join(timeout=10)


def test_no_replicas_left_fails_cleanly():
    """Both replicas dying mid-flight resolves (not hangs) every
    request with an error, and later submissions raise NoReplicas."""
    from tensorflow_train_distributed_torch.server.replicas import (
        NoReplicas,
    )

    pool = ReplicaPool([DiesAfter(2), DiesAfter(2)], max_queue=16,
                       watchdog_timeout_s=2.0).start()
    try:
        hs = [pool.submit([9 + i], 50, timeout_s=60.0)
              for i in range(3)]
        t0 = time.monotonic()
        for h in hs:
            with pytest.raises(RuntimeError):
                h.result(timeout=20)
        assert time.monotonic() - t0 < 15      # fail-fast, not deadline
        deadline = time.monotonic() + 5
        while pool.alive():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        with pytest.raises(NoReplicas):
            pool.submit([1], 1)
        assert pool.failure() is not None
    finally:
        pool.join(timeout=10)


# ── retry with backoff (transient admission refusals) ──────────────────


def _gw_metrics_for(pool):
    from tensorflow_train_distributed_torch.server.metrics import (
        GatewayMetrics,
    )

    m = GatewayMetrics(queue_depth_fn=pool.waiting,
                       slots_in_use_fn=pool.active_slots,
                       slots_total=4,
                       replicas_alive_fn=pool.alive_count)
    pool.set_metrics(m)
    return m


def _fill_replica(rep, prompt, max_new, n=2, timeout=5.0):
    """Saturate one replica directly through its driver: n requests,
    waiting out the admission races (the driver loop moves work into
    the engine asynchronously)."""
    handles = []
    deadline = time.monotonic() + timeout
    while len(handles) < n:
        try:
            handles.append(rep.driver.submit(list(prompt), max_new))
        except AdmissionFull:
            assert time.monotonic() < deadline, "replica never drained"
            time.sleep(0.005)
    return handles


def test_placement_retries_with_backoff_instead_of_failing_fast():
    """Every replica's own queue full at submit time: the request is
    NOT shed — placement retries with backoff and completes once a
    queue drains; the retries counter counts the waits."""
    pool = ReplicaPool(
        [StubEngine(slots=1, step_delay=0.01) for _ in range(2)],
        max_queue=64, replica_max_queue=1, backoff_base_s=0.02,
        watchdog_timeout_s=5.0).start()
    m = _gw_metrics_for(pool)
    try:
        # Saturate both replicas through their own drivers: 1 decoding
        # + 1 queued each (replica_max_queue=1).
        direct = [h for i, rep in enumerate(pool.replicas)
                  for h in _fill_replica(rep, [1 + i], 30)]
        h = pool.submit([40], 2, timeout_s=30.0)
        assert h.result(timeout=30) == StubEngine.expected([40], 2)
        assert m.retries.value() >= 1
        assert m.requests.value(label_value="shed") == 0
        for d in direct:
            assert d.result(timeout=30)
    finally:
        pool.join(timeout=10)


def test_placement_gives_up_at_deadline_with_expired_status():
    """Queues that never drain: the retry loop gives up exactly at the
    request's deadline with DeadlineExceeded (status 'expired'), not a
    fail-fast refusal and not an infinite spin."""
    pool = ReplicaPool(
        [StubEngine(slots=1, step_delay=0.05) for _ in range(2)],
        max_queue=64, replica_max_queue=1, backoff_base_s=0.02,
        watchdog_timeout_s=5.0).start()
    m = _gw_metrics_for(pool)
    try:
        direct = [h for i, rep in enumerate(pool.replicas)
                  for h in _fill_replica(rep, [1 + i], 500)]
        h = pool.submit([40], 2, timeout_s=0.4)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            h.result(timeout=10)
        assert 0.2 < time.monotonic() - t0 < 5
        assert pool.request_status(h.id) == "expired"
        assert m.retries.value() >= 2           # backed off repeatedly
        assert m.requests.value(label_value="expired") == 1
        for d in direct:                # free the stub slots for drain
            d.deadline = time.monotonic()
    finally:
        pool.join(timeout=20)


def test_pool_level_shed_still_answers_admission_full():
    """The pool-wide bound still sheds: 2 decoding + 2 queued fills
    max_queue=2 worth of WAITING work, and the next submission gets
    AdmissionFull with the configured Retry-After."""
    pool = ReplicaPool(
        [StubEngine(slots=1, step_delay=0.05) for _ in range(2)],
        max_queue=2, retry_after_s=3.0, watchdog_timeout_s=5.0).start()
    try:
        hs = [pool.submit([5 + i], 100) for i in range(2)]
        deadline = time.monotonic() + 5
        while pool.active_slots() < 2:    # both decoding, waiting == 0
            assert time.monotonic() < deadline
            time.sleep(0.005)
        hs += [pool.submit([7 + i], 100) for i in range(2)]
        while pool.waiting() < 2:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        with pytest.raises(AdmissionFull) as ei:
            pool.submit([9], 1)
        assert ei.value.retry_after_s == 3.0
        for h in hs:
            pool.abandon(h)
    finally:
        pool.join(timeout=20)


# ── staged drain ───────────────────────────────────────────────────────


def test_pool_drain_is_staged_and_finishes_inflight():
    """join() drains replicas one at a time: in-flight work on BOTH
    replicas completes, new submissions are refused, and the pool
    reports fully drained."""
    from tensorflow_train_distributed_torch.server.driver import Draining

    pool = _stub_pool(2, slots=1, step_delay=0.02)
    try:
        hs = [pool.submit([6 + i], 40) for i in range(2)]
        deadline = time.monotonic() + 5
        while pool.active_slots() < 2:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        drainer = threading.Thread(target=pool.join, args=(20,))
        drainer.start()
        deadline = time.monotonic() + 5
        while not pool.is_draining():
            assert time.monotonic() < deadline
            time.sleep(0.005)
        with pytest.raises(Draining):
            pool.submit([1], 1)
        for i, h in enumerate(hs):
            assert h.result(timeout=20) == StubEngine.expected(
                [6 + i], 40)
        drainer.join(timeout=20)
        assert not drainer.is_alive()
    finally:
        pool.join(timeout=10)


# ── gateway over the pool (HTTP) ───────────────────────────────────────


def _make_pool_gateway(engines=None, **kw):
    engines = engines or [StubEngine(slots=2, step_delay=0.01)
                          for _ in range(2)]
    kw.setdefault("watchdog_timeout_s", 2.0)
    return ServingGateway(engines, host="127.0.0.1", port=0,
                          **kw).start()


def test_gateway_pool_healthz_metrics_and_failover():
    faults.arm("serve:dispatch:4:kill9:replica=0")
    gw = _make_pool_gateway()
    try:
        status, body, _ = _get(gw.port, "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert health["replicas_alive"] == 2
        assert [r["replica"] for r in health["replicas"]] == [0, 1]

        results = [None] * 5

        def client(i):
            results[i] = _post(gw.port, {"prompt": [11 * (i + 1)],
                                         "max_new": 25})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, (status, obj, _) in enumerate(results):
            assert status == 200, (i, status, obj)
            assert obj["tokens"] == StubEngine.expected(
                [11 * (i + 1)], 25)
        # Degraded — NOT 503: one replica still serves.
        status, body, _ = _get(gw.port, "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "degraded"
        assert health["replicas_alive"] == 1
        dead = [r for r in health["replicas"] if r["state"] == "dead"]
        assert len(dead) == 1 and dead[0]["replica"] == 0
        s = _parse_prom(_get(gw.port, "/metrics")[1])
        assert s["ttd_gateway_replicas_alive"] == 1
        assert s["ttd_gateway_failovers_total"] >= 1
        assert s['ttd_gateway_requests_total{status="ok"}'] == 5
        # No token duplicated or dropped across the hop.
        assert s["ttd_gateway_tokens_generated_total"] == 5 * 25
    finally:
        faults.disarm()
        gw.drain(timeout=15)


def test_gateway_overload_sheds_with_retry_after_and_expires_visibly():
    """Overload coverage: all replicas saturated → the pool-full shed
    carries Retry-After; a deadline-bound admitted request expires
    with 504 and an 'expired' terminal status in its timeline; and
    NOTHING is silently dropped — every submission is accounted
    ok|shed|expired."""
    gw = _make_pool_gateway(
        [StubEngine(slots=1, step_delay=0.05) for _ in range(2)],
        max_queue=4, retry_after_s=2.0)
    try:
        outcomes = []
        lock = threading.Lock()

        def client(i, max_new, timeout_s=None):
            body = {"prompt": [5 + i], "max_new": max_new}
            if timeout_s is not None:
                body["timeout_s"] = timeout_s
            status, obj, headers = _post(gw.port, body)
            with lock:
                outcomes.append((status, obj, headers))

        # Two long requests take both single-slot replicas...
        long_t = [threading.Thread(target=client, args=(i, 50))
                  for i in range(2)]
        for t in long_t:
            t.start()
        deadline = time.monotonic() + 5
        while gw.driver.active_slots() < 2:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        # ...two more fill each replica's queue share
        # (replica_max_queue = max_queue/2 = 2 → 1 decoding + 2
        # queued... fill both replica queues and the pool bound).
        fill_t = [threading.Thread(target=client, args=(2 + i, 2))
                  for i in range(2)]
        for t in fill_t:
            t.start()
        deadline = time.monotonic() + 5
        while gw.driver.waiting() < 2:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        # A deadline-bound request and one more filler bring waiting to
        # the pool bound (4)...
        t_exp = threading.Thread(target=client, args=(4, 100, 1.0))
        t_exp.start()
        extra_t = threading.Thread(target=client, args=(5, 2))
        extra_t.start()
        deadline = time.monotonic() + 5
        while gw.driver.waiting() < 4:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        # ...so the NEXT submission is shed, with Retry-After.
        status, obj, headers = _post(gw.port, {"prompt": [99],
                                               "max_new": 1})
        assert status == 429
        assert int(headers["Retry-After"]) == 2
        assert "error" in obj
        for t in long_t + fill_t + [t_exp, extra_t]:
            t.join()
        statuses = sorted(s for s, _, _ in outcomes)
        assert statuses == [200, 200, 200, 200, 200, 504], statuses
        s = _parse_prom(_get(gw.port, "/metrics")[1])
        assert s['ttd_gateway_requests_total{status="ok"}'] == 5
        assert s['ttd_gateway_requests_total{status="shed"}'] == 1
        assert s['ttd_gateway_requests_total{status="expired"}'] == 1
        # The expired request's timeline records the terminal status.
        expired_ids = [
            rid for rid in range(6)
            if gw.driver.request_status(rid) == "expired"]
        assert len(expired_ids) == 1
        status, body, _ = _get(gw.port,
                               f"/v1/requests/{expired_ids[0]}")
        assert status == 200
        assert json.loads(body)["status"] == "expired"
    finally:
        gw.drain(timeout=20)


def test_gateway_all_replicas_dead_answers_503_with_retry_after():
    gw = _make_pool_gateway([DiesAfter(1, slots=1), DiesAfter(1, slots=1)])
    try:
        _post(gw.port, {"prompt": [1], "max_new": 10})  # detonate both
        deadline = time.monotonic() + 10
        while gw.pool.alive_count() > 0:
            _post(gw.port, {"prompt": [1], "max_new": 2})
            assert time.monotonic() < deadline
            time.sleep(0.02)
        status, obj, headers = _post(gw.port, {"prompt": [2],
                                               "max_new": 1})
        assert status == 503
        assert "Retry-After" in headers
        status, body, _ = _get(gw.port, "/healthz")
        assert status == 503
        assert json.loads(body)["status"] == "no_replicas"
        s = _parse_prom(_get(gw.port, "/metrics")[1])
        assert s["ttd_gateway_replicas_alive"] == 0
    finally:
        gw._httpd.shutdown()
        gw._httpd.server_close()


def test_gateway_sigterm_drain_staged_n2():
    """The single-engine SIGTERM drain contract extended to N=2:
    /healthz flips to draining (503), new submissions refused, both
    replicas' in-flight requests finish."""
    gw = _make_pool_gateway(
        [StubEngine(slots=1, step_delay=0.02) for _ in range(2)])
    try:
        inflight = {}

        def client(name, prompt):
            inflight[name] = _post(gw.port, {"prompt": prompt,
                                             "max_new": 50})

        threads = [threading.Thread(target=client, args=(f"r{i}", [2 + i]))
                   for i in range(2)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5
        while gw.driver.active_slots() < 2:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        drainer = threading.Thread(target=gw.drain, args=(20,))
        drainer.start()
        deadline = time.monotonic() + 5
        while not gw.draining:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        status, body, _ = _get(gw.port, "/healthz")
        assert status == 503
        assert json.loads(body)["status"] == "draining"
        status, obj, _ = _post(gw.port, {"prompt": [1], "max_new": 1})
        assert status == 503
        for t in threads:
            t.join()
        drainer.join()
        for i in range(2):
            status, obj, _ = inflight[f"r{i}"]
            assert status == 200
            assert obj["tokens"] == StubEngine.expected([2 + i], 50)
    finally:
        if not gw._stopped.is_set():
            gw.drain(timeout=10)


# ── the port's engine: resume-from-token + chaos failover parity ─────────────


@pytest.fixture(scope="module")
def llama_tiny():
    return llama_params("llama_tiny", 0, "cpu")


def _engine_kw(sampling):
    kw = dict(slots=2, cache_len=64, chunk=4, prompt_buckets=(8, 16, 32))
    if sampling:
        kw.update(temperature=0.8, top_k=40)
    return kw


@pytest.mark.parametrize("sampling", [False, True],
                         ids=["greedy", "seeded-sampling"])
def test_engine_resume_from_token_is_bitwise(llama_tiny, sampling):
    """The failover primitive: re-admitting prompt + g generated
    tokens with resume_from=g continues the EXACT token stream an
    uninterrupted run produces (the rng counter picks up at g)."""
    cfg, params = llama_tiny
    kw = _engine_kw(sampling)
    prompt, max_new, seed = [5, 9, 2, 7], 12, 123
    eng = ServingEngine(cfg, params, **kw)
    rid = eng.submit(prompt, max_new, seed=seed if sampling else None)
    ref = eng.run()[rid]
    for g in (1, 3, 7):
        eng2 = ServingEngine(cfg, params, **kw)
        rid2 = eng2.submit(ref[:len(prompt) + g], max_new - g,
                           seed=seed if sampling else None,
                           resume_from=g)
        assert eng2.run()[rid2] == ref, g


def test_resume_beyond_largest_bucket_is_admitted(llama_tiny):
    """A resumed prompt (original + streamed tokens) may exceed the
    largest prefill bucket the ORIGINAL admission fit in — the resumed
    tail is the request's own output and ``_pieces_for`` chunks any
    span into bucket-sized pieces, so re-admission must not die
    'invalid' mid-failover (and the continuation stays bitwise)."""
    cfg, params = llama_tiny
    kw = dict(slots=2, cache_len=64, chunk=4, prompt_buckets=(8,))
    prompt, max_new = [5, 9, 2, 7], 12
    eng = ServingEngine(cfg, params, **kw)
    rid = eng.submit(prompt, max_new)
    ref = eng.run()[rid]
    g = 7                                  # 4 + 7 = 11 > bucket 8
    eng2 = ServingEngine(cfg, params, **kw)
    with pytest.raises(ValueError, match="bucket"):
        eng2.validate_request(ref[:len(prompt) + g], max_new - g)
    rid2 = eng2.submit(ref[:len(prompt) + g], max_new - g,
                       resume_from=g)
    assert eng2.run()[rid2] == ref


def test_engine_rejects_bad_resume_from(llama_tiny):
    cfg, params = llama_tiny
    eng = ServingEngine(cfg, params, **_engine_kw(False))
    with pytest.raises(ValueError, match="resume_from"):
        eng.validate_request([1, 2, 3], 4, None, 3)
    with pytest.raises(ValueError, match="resume_from"):
        eng.validate_request([1, 2, 3], 4, None, -1)


@pytest.mark.parametrize("sampling", [False, True],
                         ids=["greedy", "seeded-sampling"])
def test_chaos_failover_parity_real_engine(llama_tiny, sampling):
    """THE acceptance contract: a deterministic fault plan kills one
    of two replicas mid-decode under concurrent load; every accepted
    request completes and its full token stream equals the
    uninterrupted single-replica run."""
    import numpy as np

    cfg, params = llama_tiny
    kw = _engine_kw(sampling)
    rng = np.random.default_rng(0)
    reqs = [([int(t) for t in rng.integers(1, 200,
                                           int(rng.integers(2, 8)))],
             int(rng.integers(6, 14)), 1000 + i) for i in range(6)]

    ref_eng = ServingEngine(cfg, params, **kw)
    rids = [ref_eng.submit(p, m, seed=s if sampling else None)
            for p, m, s in reqs]
    ref_out = ref_eng.run()
    refs = [ref_out[r] for r in rids]

    engines = [ServingEngine(cfg, params, **kw) for _ in range(2)]
    for e in engines:       # prewarm: a first dispatch compiles, and
        e.submit([1, 2, 3], 5, seed=0 if sampling else None)
        e.run()             # the watchdog must not mistake XLA for a hang
    faults.arm("serve:dispatch:3:kill9:replica=0")
    gw = ServingGateway(engines, host="127.0.0.1", port=0,
                        max_queue=32, watchdog_timeout_s=10.0).start()
    try:
        results = [None] * len(reqs)

        def client(i):
            p, m, s = reqs[i]
            body = {"prompt": p, "max_new": m}
            if sampling:
                body["seed"] = s
            results[i] = _post(gw.port, body)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for (p, m, s), ref, (status, obj, _) in zip(reqs, refs,
                                                    results):
            assert status == 200, (status, obj)
            assert obj["tokens"] == ref
        assert gw.metrics.failovers.value() >= 1
        assert sum(r["state"] == "dead"
                   for r in gw.pool.replica_states()) == 1
    finally:
        faults.disarm()
        gw.drain(timeout=30)


def test_no_failover_kill_switch_restores_single_engine(llama_tiny,
                                                        monkeypatch):
    """TTD_NO_FAILOVER=1 with a multi-engine list drives only the
    first engine through the plain EngineDriver — outputs and the
    /healthz shape are byte-for-byte the single-engine gateway's."""
    cfg, params = llama_tiny
    kw = _engine_kw(False)

    single = ServingGateway(ServingEngine(cfg, params, **kw),
                            host="127.0.0.1", port=0).start()
    try:
        st, single_obj, _ = _post(single.port, {"prompt": [1, 2, 3],
                                                "max_new": 6})
        assert st == 200
        single_health = json.loads(_get(single.port, "/healthz")[1])
    finally:
        single.drain(timeout=20)

    monkeypatch.setenv("TTD_NO_FAILOVER", "1")
    gw = ServingGateway([ServingEngine(cfg, params, **kw),
                         ServingEngine(cfg, params, **kw)],
                        host="127.0.0.1", port=0).start()
    try:
        assert gw.pool is None
        from tensorflow_train_distributed_torch.server.driver import (
            EngineDriver,
        )

        assert isinstance(gw.driver, EngineDriver)
        st, obj, _ = _post(gw.port, {"prompt": [1, 2, 3],
                                     "max_new": 6})
        assert st == 200
        assert obj["tokens"] == single_obj["tokens"]
        health = json.loads(_get(gw.port, "/healthz")[1])
        assert set(health) == set(single_health)
        assert "replicas" not in health
    finally:
        gw.drain(timeout=20)


# ── serving chaos smoke (chaos_check --serving) ───────────────────────


@pytest.mark.parametrize("sampling", [False, True],
                         ids=["greedy", "seeded-sampling"])
def test_chaos_check_serving_smoke(sampling):
    """The in-process leg of ``chaos_check --serving``, both of the CLI's
    runs."""
    verdict = chaos_check.run_serving_chaos(sampling=sampling,
                                            n_requests=4, device="cpu")
    assert verdict["ok"], verdict
    assert verdict["checks"]["streams_match_reference"]
    assert verdict["checks"]["one_replica_dead"]


def test_chaos_check_cli_serving(capsys):
    """``python -m ...chaos_check --serving --device cpu``: the verdict
    line, exit 0; the training legs are refused."""
    import json as json_

    assert chaos_check.main(["--serving", "--device", "cpu"]) == 0
    verdict = json_.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["ok"] and verdict["mode"] == "serving"
    with pytest.raises(SystemExit):
        chaos_check.main(["--device", "cpu"])
