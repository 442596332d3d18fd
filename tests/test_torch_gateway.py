"""The port's online serving gateway (``server``: driver, HTTP frontend,
metrics), against the JAX package's.

- The cases of JAX ``tests/test_gateway.py`` over the port's modules: the
  real HTTP stack over a deterministic stub engine (scheduling, shedding,
  deadlines, streaming, drain, the scrape format), and the port's engine
  (llama_tiny, weights from ``server.worker.llama_params``) behind it:
  served tokens equal a batch run of the same requests, greedy and with
  seeded sampling.
- Parity with the JAX package: greedy tokens served by two in-process
  replicas built by ``serve.worker_engine_factory`` from an npz of JAX
  llama_tiny parameters equal the JAX batch engine's and the port's batch
  engine's; a port ``GatewayMetrics`` scrape equals a JAX one fed the same
  observations line for line, and the port engine's scrape accessors read
  what the JAX engine's read on the same requests (the samples that differ
  by design are named in the test).
- The engine's thread discipline (``_prefix_lock``, ``_stats_lock``,
  ``@thread_role``) under the port's lock-order sanitizer, and launch counts
  from two threads adding up.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import functools

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
from tensorflow_train_distributed_tpu.server.metrics import (
    GatewayMetrics as JaxMetrics,
)
from tensorflow_train_distributed_tpu.serving import (
    ServingEngine as JaxEngine,
)

from tensorflow_train_distributed_torch.server import (
    AdmissionFull,
    Draining,
    EngineDriver,
    RequestError,
    ServingGateway,
)
from tensorflow_train_distributed_torch.server.metrics import (
    GatewayMetrics,
    Registry,
)
from tensorflow_train_distributed_torch.server.worker import llama_params
from tensorflow_train_distributed_torch.serving import (
    ServingEngine as TorchEngine,
)

#: The port's engine on the CPU (the tests' device).
ServingEngine = functools.partial(TorchEngine, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # Tiny ops under the parallel tier-1 run: a thread pool as wide as the
    # machine per test process oversubscribes the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ── deterministic stub engine ──────────────────────────────────────────


class StubEngine:
    """ServingEngine's driver-facing surface with arithmetic decode:
    each step every active slot appends ``last + 1 (mod 997)``, so
    expected outputs are closed-form and slot contention is real
    (``slots`` bounds concurrency, the queue holds the rest)."""

    def __init__(self, slots=2, step_delay=0.0):
        self.slots = slots
        self.step_delay = step_delay
        self._queue = []
        self._slots = [None] * slots   # [rid, prompt, max_new, tokens]
        self._next = 0

    @staticmethod
    def expected(prompt, max_new):
        out = list(prompt)
        for _ in range(max_new):
            out.append((out[-1] + 1) % 997)
        return out

    def validate_request(self, prompt, max_new, seed=None):
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 0:
            raise ValueError(f"max_new must be >= 0, got {max_new}")
        if seed is not None and not 0 <= seed < 2 ** 32:
            raise ValueError(f"seed {seed} outside uint32")
        return prompt

    def submit(self, prompt, max_new, seed=None):
        self.validate_request(prompt, max_new, seed)
        rid = self._next
        self._next += 1
        self._queue.append((rid, list(prompt), max_new))
        return rid

    def cancel(self, rid):
        for i, (q, _, _) in enumerate(self._queue):
            if q == rid:
                del self._queue[i]
                return True
        for i, s in enumerate(self._slots):
            if s is not None and s[0] == rid:
                self._slots[i] = None
                return True
        return False

    def queue_depth(self):
        return len(self._queue)

    def active_slots(self):
        return sum(s is not None for s in self._slots)

    def pending(self):
        return len(self._queue) + self.active_slots()

    def snapshot(self):
        return {s[0]: list(s[3]) for s in self._slots if s is not None}

    def export_lane(self, rid):
        """Minimal migration surface (mirrors the subprocess
        ``StubWorkerEngine``): parameters + token history, no KV —
        the re-placed request recomputes its arithmetic
        deterministically, the same closed form as failover."""
        for q, prompt, max_new in self._queue:
            if q == rid:
                return {"kind": "queued", "prompt": list(prompt),
                        "max_new": int(max_new), "seed": None,
                        "resume_from": 0, "kv": None}, b""
        for s in self._slots:
            if s is not None and s[0] == rid:
                _, prompt, max_new, tokens = s
                done = len(tokens) - len(prompt)
                return {"kind": "lane", "tokens": list(tokens),
                        "remaining": int(max_new - done),
                        "last_token": int(tokens[-1]), "seed": 0,
                        "count": int(done), "done": False,
                        "kv": None}, b""
        return None

    def install_lane(self, meta, blob):
        return 0                      # nothing to warm: no KV to ship

    def serve_step(self):
        for i in range(self.slots):
            if self._slots[i] is None and self._queue:
                rid, prompt, max_new = self._queue.pop(0)
                self._slots[i] = [rid, prompt, max_new, list(prompt)]
        if self.step_delay:
            time.sleep(self.step_delay)
        done = {}
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            rid, prompt, max_new, tokens = s
            if len(tokens) - len(prompt) < max_new:
                tokens.append((tokens[-1] + 1) % 997)
            if len(tokens) - len(prompt) >= max_new:
                done[rid] = list(tokens)
                self._slots[i] = None
        return done


# ── http plumbing ──────────────────────────────────────────────────────


def _post(port, body, path="/v1/generate"):
    """(status, parsed json or None, headers)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if isinstance(body, dict)
        else body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            obj = json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            obj = None
        return e.code, obj, dict(e.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _parse_prom(text):
    """Prometheus 0.0.4 text → {'name{labels}': float} (format check:
    every non-comment line must split into exactly sample + value)."""
    samples = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        key, val = line.rsplit(" ", 1)
        samples[key] = float(val)
    return samples


def _make_gateway(stub=None, **kw):
    eng = stub if stub is not None else StubEngine()
    return ServingGateway(eng, host="127.0.0.1", port=0, **kw).start()


# ── fast tier: gateway behavior over the stub engine ───────────────────


def test_concurrent_submissions_all_served():
    """More client threads than slots: every request answers 200 with
    exactly the tokens a serial decode would produce."""
    gw = _make_gateway(StubEngine(slots=2))
    try:
        reqs = [([10 * (c + 1), 10 * (c + 1) + 1], 3 + c % 4)
                for c in range(8)]
        results = [None] * len(reqs)

        def client(c):
            prompt, max_new = reqs[c]
            results[c] = _post(gw.port, {"prompt": prompt,
                                         "max_new": max_new})

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for (prompt, max_new), (status, obj, _) in zip(reqs, results):
            assert status == 200
            assert obj["tokens"] == StubEngine.expected(prompt, max_new)
            assert obj["prompt"] == prompt
    finally:
        gw.drain(timeout=10)


def test_full_queue_sheds_429_inflight_completes():
    """slots=1 busy + max_queue=1 occupied → the next request is shed
    with 429 + Retry-After while both admitted requests complete."""
    gw = _make_gateway(StubEngine(slots=1, step_delay=0.02),
                       max_queue=1, retry_after_s=2.0)
    try:
        outcomes = {}

        def client(name, max_new):
            outcomes[name] = _post(gw.port, {"prompt": [5], "max_new":
                                             max_new})

        ta = threading.Thread(target=client, args=("a", 60))
        ta.start()
        deadline = time.monotonic() + 5
        while gw.driver.active_slots() == 0:   # a decoding
            assert time.monotonic() < deadline, "request a never started"
            time.sleep(0.005)
        tb = threading.Thread(target=client, args=("b", 2))
        tb.start()
        while gw.driver.waiting() == 0:        # b admitted, waiting
            assert time.monotonic() < deadline, "request b never queued"
            time.sleep(0.005)
        status, obj, headers = _post(gw.port, {"prompt": [9],
                                               "max_new": 1})
        assert status == 429
        assert "error" in obj
        assert int(headers["Retry-After"]) == 2
        ta.join()
        tb.join()
        assert outcomes["a"][0] == 200
        assert outcomes["a"][1]["tokens"] == StubEngine.expected([5], 60)
        assert outcomes["b"][0] == 200
        assert outcomes["b"][1]["tokens"] == StubEngine.expected([5], 2)
        shed = gw.metrics.requests.value(label_value="shed")
        assert shed == 1
    finally:
        gw.drain(timeout=10)


def test_metrics_scrape_parses_and_counters_move():
    gw = _make_gateway(StubEngine(slots=2))
    try:
        n, gen = 3, 0
        for i in range(n):
            status, obj, _ = _post(gw.port, {"prompt": [7 + i],
                                             "max_new": 2 + i})
            assert status == 200
            gen += 2 + i
        status, text, headers = _get(gw.port, "/metrics")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        s = _parse_prom(text)   # raises if any line is malformed
        assert s['ttd_gateway_requests_total{status="ok"}'] == n
        assert s["ttd_gateway_tokens_generated_total"] == gen
        assert s["ttd_gateway_request_latency_seconds_count"] == n
        assert s["ttd_gateway_ttft_seconds_count"] == n
        # Inter-token observations: one per commit after a request's
        # first — the stub commits one token per step, so max_new - 1
        # observations per request.
        assert s["ttd_gateway_inter_token_seconds_count"] == gen - n
        # The stub engine has no decode lookahead: the overlap gauge
        # must render a truthful constant 0 (a real-engine gateway's
        # value is pinned in tests/test_serving_overlap.py).
        assert s["ttd_engine_overlap_ratio"] == 0
        assert s["ttd_gateway_slots_total"] == 2
        assert s["ttd_gateway_queue_depth"] == 0
        assert s["ttd_gateway_slots_in_use"] == 0
        # Cumulative buckets: the +Inf bucket equals _count.
        assert s['ttd_gateway_request_latency_seconds_bucket{le="+Inf"}'] \
            == n
        # Counters only move forward on a second scrape.
        _post(gw.port, {"prompt": [3], "max_new": 1})
        s2 = _parse_prom(_get(gw.port, "/metrics")[1])
        assert s2['ttd_gateway_requests_total{status="ok"}'] == n + 1
        assert s2["ttd_gateway_tokens_generated_total"] == gen + 1
    finally:
        gw.drain(timeout=10)


def test_deadline_expiry_504_frees_slot():
    """A request whose deadline lands mid-decode answers 504 and its
    slot is reusable — the next request completes normally."""
    gw = _make_gateway(StubEngine(slots=1, step_delay=0.02))
    try:
        status, obj, _ = _post(gw.port, {"prompt": [4], "max_new": 500,
                                         "timeout_s": 0.1})
        assert status == 504
        assert "deadline" in obj["error"]
        status, obj, _ = _post(gw.port, {"prompt": [4], "max_new": 2})
        assert status == 200
        assert obj["tokens"] == StubEngine.expected([4], 2)
        assert gw.metrics.requests.value(label_value="expired") == 1
        assert gw.driver.active_slots() == 0
    finally:
        gw.drain(timeout=10)


def test_streaming_chunks_concatenate_to_full_output():
    gw = _make_gateway(StubEngine(slots=1))
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{gw.port}/v1/generate",
            data=json.dumps({"prompt": [20, 21], "max_new": 5,
                             "stream": True}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(x) for x in r.read().splitlines() if x]
        assert "id" in lines[0]
        assert lines[-1] == {"done": True}
        streamed = [t for chunk in lines[1:-1] for t in chunk["tokens"]]
        assert streamed == StubEngine.expected([20, 21], 5)[2:]
    finally:
        gw.drain(timeout=10)


def test_stream_client_disconnect_frees_slot():
    """Closing a streaming connection mid-generation must abandon the
    request (slot freed at the next sweep), not decode to max_new for
    nobody — the follow-up request proves the slot is reusable fast."""
    import socket

    gw = _make_gateway(StubEngine(slots=1, step_delay=0.02))
    try:
        body = json.dumps({"prompt": [6], "max_new": 10_000,
                           "stream": True}).encode()
        with socket.create_connection(("127.0.0.1", gw.port),
                                      timeout=10) as s:
            s.sendall(b"POST /v1/generate HTTP/1.1\r\n"
                      b"Host: x\r\nContent-Type: application/json\r\n"
                      + f"Content-Length: {len(body)}\r\n\r\n".encode()
                      + body)
            s.recv(4096)       # headers + first chunk: decoding started
        # Connection closed; the handler's next write hits OSError and
        # abandons — a 2-token request then finishes long before the
        # abandoned one's 10k tokens ever could.
        status, obj, _ = _post(gw.port, {"prompt": [8], "max_new": 2})
        assert status == 200
        assert obj["tokens"] == StubEngine.expected([8], 2)
        deadline = time.monotonic() + 5
        while gw.driver.active_slots() or gw.driver.waiting():
            assert time.monotonic() < deadline, "slot never freed"
            time.sleep(0.01)
    finally:
        gw.drain(timeout=10)


def test_driver_failure_answers_500():
    """An engine that kills the driver loop fails pending requests and
    answers later submissions with HTTP 500 — not a dropped socket."""
    class ExplodingEngine(StubEngine):
        def serve_step(self):
            raise RuntimeError("device exploded")

    gw = _make_gateway(ExplodingEngine())
    try:
        status, obj, _ = _post(gw.port, {"prompt": [1], "max_new": 2})
        assert status == 500
        assert "driver failed" in obj["error"]
        status, obj, _ = _post(gw.port, {"prompt": [2], "max_new": 2})
        assert status == 500      # submit() refuses after failure
        assert gw.metrics.requests.value(label_value="error") >= 1
    finally:
        gw._httpd.shutdown()
        gw._httpd.server_close()


def test_unread_body_rejections_close_the_connection():
    """Replies sent WITHOUT consuming the request body (oversize 400,
    404 route) must advertise and perform Connection: close — leftover
    body bytes on a keep-alive socket would be misparsed as the next
    request line."""
    import socket

    from tensorflow_train_distributed_torch.server.gateway import (
        MAX_BODY_BYTES,
    )

    gw = _make_gateway()
    try:
        with socket.create_connection(("127.0.0.1", gw.port),
                                      timeout=10) as s:
            s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                      + f"Content-Length: {MAX_BODY_BYTES + 1}\r\n"
                        "\r\n".encode()
                      + b'{"prompt"')      # body mostly never sent
            data = b""
            while chunk := s.recv(65536):   # to EOF: server closed
                data += chunk
            reply = data.decode()
            assert reply.startswith("HTTP/1.1 400")
            assert "connection: close" in reply.lower()
        # A consumed-body 400 (bad JSON) keeps the connection usable:
        # the next request on the SAME socket answers 200.
        def _req(body):
            return (b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                    + f"Content-Length: {len(body)}\r\n\r\n".encode()
                    + body)

        def _read_response(s):
            # Headers + Content-Length body: one recv may return a
            # partial response (the server flushes headers and body in
            # separate writes), so read to the framed end.
            data = b""
            while b"\r\n\r\n" not in data:
                data += s.recv(65536)
            head, _, body = data.partition(b"\r\n\r\n")
            for line in head.decode().lower().splitlines():
                if line.startswith("content-length:"):
                    n = int(line.split(":", 1)[1])
                    break
            else:
                n = 0
            while len(body) < n:
                body += s.recv(65536)
            return head.decode()

        with socket.create_connection(("127.0.0.1", gw.port),
                                      timeout=10) as s:
            s.sendall(_req(b"not json"))
            assert _read_response(s).startswith("HTTP/1.1 400")
            s.sendall(_req(json.dumps({"prompt": [3],
                                       "max_new": 1}).encode()))
            assert _read_response(s).startswith("HTTP/1.1 200")
    finally:
        gw.drain(timeout=10)


def test_healthz_drains_via_driver_drain_too():
    """/healthz flips to draining even when library code calls
    driver.drain() directly — one flag, driver-owned."""
    gw = _make_gateway()
    try:
        assert _get(gw.port, "/healthz")[0] == 200
        gw.driver.drain()
        status, body, _ = _get(gw.port, "/healthz")
        assert status == 503
        assert json.loads(body)["status"] == "draining"
    finally:
        gw.drain(timeout=10)


def test_bad_payloads_answer_400():
    gw = _make_gateway()
    try:
        for body in (b"not json",
                     b"[1,2]",                          # not an object
                     {"max_new": 4},                    # no prompt
                     {"prompt": []},                    # empty prompt
                     {"prompt": [1, True]},             # bool id
                     {"prompt": [1], "max_new": 1.5},   # float budget
                     {"prompt": [1], "seed": -1},       # engine screen
                     {"prompt": [1], "timeout_s": 0}):  # bad deadline
            status, obj, _ = _post(gw.port, body)
            assert status == 400, body
            assert "error" in obj
        assert gw.metrics.requests.value(label_value="invalid") == 8
        status, _, _ = _post(gw.port, {"prompt": [1], "max_new": 1},
                             path="/v1/nope")
        assert status == 404
    finally:
        gw.drain(timeout=10)


def test_healthz_reports_and_drain_stops_admission():
    gw = _make_gateway(StubEngine(slots=1, step_delay=0.02))
    try:
        status, body, _ = _get(gw.port, "/healthz")
        assert status == 200
        health = json.loads(body)
        assert health["status"] == "ok"
        assert health["slots_total"] == 1

        inflight = {}

        def client():
            inflight["r"] = _post(gw.port, {"prompt": [2],
                                            "max_new": 50})

        t = threading.Thread(target=client)
        t.start()
        deadline = time.monotonic() + 5
        while gw.driver.active_slots() == 0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        drainer = threading.Thread(target=gw.drain, args=(10,))
        drainer.start()
        deadline = time.monotonic() + 5
        while not gw.draining:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        status, body, _ = _get(gw.port, "/healthz")
        assert status == 503
        assert json.loads(body)["status"] == "draining"
        status, obj, _ = _post(gw.port, {"prompt": [1], "max_new": 1})
        assert status == 503          # not admitting while draining
        t.join()
        drainer.join()
        assert inflight["r"][0] == 200    # in-flight finished normally
        assert inflight["r"][1]["tokens"] == StubEngine.expected([2], 50)
    finally:
        if not gw._stopped.is_set():
            gw.drain(timeout=10)


# ── fast tier: driver as a library (no HTTP) ───────────────────────────


def test_driver_futures_resolve_out_of_order():
    drv = EngineDriver(StubEngine(slots=2), max_queue=8).start()
    try:
        short = drv.submit([1], 2)
        long = drv.submit([2], 30)
        assert short.result(timeout=10) == StubEngine.expected([1], 2)
        assert not long.done() or long.result(timeout=10)
        assert long.result(timeout=10) == StubEngine.expected([2], 30)
    finally:
        drv.join(timeout=10)


def test_driver_shed_and_drain_exceptions():
    eng = StubEngine(slots=1, step_delay=0.02)
    drv = EngineDriver(eng, max_queue=1, retry_after_s=3.0).start()
    handle = drv.submit([1], 100)
    deadline = time.monotonic() + 5
    while eng.active_slots() == 0:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    waiting = drv.submit([2], 1)
    with pytest.raises(AdmissionFull) as ei:
        drv.submit([3], 1)
    assert ei.value.retry_after_s == 3.0
    drv.drain()
    with pytest.raises(Draining):
        drv.submit([4], 1)
    assert handle.result(timeout=20) == StubEngine.expected([1], 100)
    assert waiting.result(timeout=20) == StubEngine.expected([2], 1)
    assert drv.join(timeout=10)


def test_driver_rejects_bad_requests_before_admission():
    drv = EngineDriver(StubEngine(), max_queue=2).start()
    try:
        with pytest.raises(RequestError):
            drv.submit([], 4)              # stub validate_request
        with pytest.raises(RequestError):
            drv.submit([1], 4, timeout_s=-1)
        assert drv.waiting() == 0          # nothing leaked into queues
    finally:
        drv.join(timeout=10)


# ── fast tier: metrics module ──────────────────────────────────────────


def test_registry_rejects_duplicates_and_renders_histogram():
    r = Registry()
    c = r.counter("c_total", "help", label="status")
    h = r.histogram("h_seconds", "help", buckets=(0.1, 1.0))
    with pytest.raises(ValueError):
        r.counter("c_total", "again")
    with pytest.raises(ValueError):
        c.inc(-1, label_value="ok")
    c.inc(label_value="ok")
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    s = _parse_prom(r.render())
    assert s['c_total{status="ok"}'] == 1
    assert s['h_seconds_bucket{le="0.1"}'] == 1
    assert s['h_seconds_bucket{le="1"}'] == 2
    assert s['h_seconds_bucket{le="+Inf"}'] == 3
    assert s["h_seconds_count"] == 3
    assert abs(s["h_seconds_sum"] - 5.55) < 1e-9


def test_gateway_metrics_gauges_sample_callables_at_scrape():
    depth = {"v": 0}
    m = GatewayMetrics(queue_depth_fn=lambda: depth["v"],
                       slots_in_use_fn=lambda: 2, slots_total=4)
    s = _parse_prom(m.render())
    assert s["ttd_gateway_queue_depth"] == 0
    depth["v"] = 7
    s = _parse_prom(m.render())
    assert s["ttd_gateway_queue_depth"] == 7
    assert s["ttd_gateway_slots_in_use"] == 2
    assert s["ttd_gateway_slots_total"] == 4


def test_metric_conventions_and_readme_single_source_of_truth():
    """The port's counterpart of JAX's ttd-lint ``prometheus`` check (the
    lint core waits for ROADMAP Queue 1 step 8): every metric the
    registry builds is a literal of ``server/metrics.py``, counters end
    ``_total``, histograms ``_seconds``, and every ``ttd_*`` name appears
    in README's metric list."""
    import os

    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    metrics_py = os.path.join(
        root, "tensorflow_train_distributed_torch", "server", "metrics.py")
    src = open(metrics_py).read()
    readme = open(os.path.join(root, "README.md")).read()
    m = GatewayMetrics(queue_depth_fn=lambda: 0,
                       slots_in_use_fn=lambda: 0, slots_total=1)
    metrics = m.registry._metrics
    assert metrics, "registry is empty?"
    kinds = {line.split()[2]: line.split()[3]
             for line in m.render().splitlines()
             if line.startswith("# TYPE")}
    for metric in metrics:
        name = metric.name
        assert f'"{name}"' in src, f"{name} registered dynamically"
        assert f"`{name}`" in readme, f"{name} missing from README"
        if kinds.get(name) == "counter":
            assert name.endswith("_total"), name
        if kinds.get(name) == "histogram":
            assert name.endswith("_seconds"), name


def test_histogram_bucket_edges_inclusive():
    """``observe(v)`` lands in the first bucket with v <= upper —
    boundary values INCLUSIVE (the bisect fast path must keep the
    linear scan's le semantics exactly)."""
    r = Registry()
    h = r.histogram("edges_seconds", "help", buckets=(0.1, 1.0, 10.0))
    for v in (0.1, 1.0, 10.0, 10.0001, 0.0999):
        h.observe(v)
    s = _parse_prom(r.render())
    assert s['edges_seconds_bucket{le="0.1"}'] == 2     # 0.0999, 0.1
    assert s['edges_seconds_bucket{le="1"}'] == 3       # + 1.0
    assert s['edges_seconds_bucket{le="10"}'] == 4      # + 10.0
    assert s['edges_seconds_bucket{le="+Inf"}'] == 5    # + 10.0001
    assert s["edges_seconds_count"] == 5


def test_scrape_vs_observe_hammer_monotonic_buckets():
    """Handler-thread scrapes racing driver-loop observes: every
    render must be internally consistent — cumulative bucket lines
    non-decreasing within a scrape, +Inf bucket == _count, and counts
    non-decreasing ACROSS scrapes."""
    m = GatewayMetrics(queue_depth_fn=lambda: 0,
                       slots_in_use_fn=lambda: 0, slots_total=4)
    stop = threading.Event()
    errs = []

    def writer(k):
        i = 0
        try:
            while not stop.is_set():
                m.ttft.observe((i % 50) * 0.01)
                m.queue_wait.observe((i % 7) * 0.2)
                m.inter_token.observe((i % 11) * 0.001)
                m.requests.inc(label_value="ok")
                m.tokens.inc(3)
                i += 1
        except BaseException as e:          # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(k,))
               for k in range(4)]
    for t in threads:
        t.start()
    last_counts: dict = {}
    try:
        for _ in range(300):
            text = m.render()
            s = _parse_prom(text)           # every line well-formed
            for hist in ("ttd_gateway_ttft_seconds",
                         "ttd_gateway_queue_wait_seconds",
                         "ttd_gateway_inter_token_seconds"):
                # Cumulative bucket values IN RENDER ORDER (the dict
                # from _parse_prom loses it).
                ordered = [float(ln.rsplit(" ", 1)[1])
                           for ln in text.splitlines()
                           if ln.startswith(hist + "_bucket")]
                assert ordered == sorted(ordered), (hist, ordered)
                assert ordered[-1] == s[hist + "_count"]
                assert s[hist + "_count"] >= last_counts.get(hist, 0)
                last_counts[hist] = s[hist + "_count"]
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errs
    assert last_counts["ttd_gateway_ttft_seconds"] > 0  # writers ran


# ── fast tier: flight-recorder endpoints ───────────────────────────────


def test_debug_trace_endpoint_serves_chrome_json():
    gw = _make_gateway(StubEngine(slots=2))
    try:
        status, obj, _ = _post(gw.port, {"prompt": [4], "max_new": 2})
        assert status == 200
        rid = obj["id"]
        status, body, _ = _get(gw.port, "/debug/trace?last_s=60")
        assert status == 200
        trace = json.loads(body)
        assert isinstance(trace["traceEvents"], list)
        for ev in trace["traceEvents"]:
            assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)
        names = {e["name"] for e in trace["traceEvents"]}
        assert "request/admitted" in names
        admitted = [e for e in trace["traceEvents"]
                    if e["name"] == "request/admitted"
                    and e.get("args", {}).get("request_id") == rid]
        assert admitted
        status, body, _ = _get(gw.port, "/debug/trace?last_s=zero")
        assert status == 400
    finally:
        gw.drain(timeout=10)


def test_request_timeline_endpoint_stub_lifecycle_and_queue_wait():
    """Driver-level lifecycle over the stub engine: /v1/requests/<id>
    shows admission → slot grant → commits → retire with terminal
    status, the queue-wait histogram observes once per served request,
    and an unknown id answers 404."""
    gw = _make_gateway(StubEngine(slots=2))
    try:
        status, obj, _ = _post(gw.port, {"prompt": [4], "max_new": 3})
        assert status == 200
        rid = obj["id"]
        status, body, _ = _get(gw.port, f"/v1/requests/{rid}")
        assert status == 200
        tl = json.loads(body)
        assert tl["id"] == rid and tl["status"] == "ok"
        names = [e["name"] for e in tl["timeline"]]
        for a, b in (("request/admitted", "request/slot_granted"),
                     ("request/slot_granted", "request/commit"),
                     ("request/commit", "request/retire")):
            assert names.index(a) < names.index(b), names
        # t_ms is relative to the first event and non-decreasing.
        ts = [e["t_ms"] for e in tl["timeline"]]
        assert ts[0] == 0 and ts == sorted(ts)
        s = _parse_prom(_get(gw.port, "/metrics")[1])
        assert s["ttd_gateway_queue_wait_seconds_count"] == 1
        status, body, _ = _get(gw.port, "/v1/requests/999999")
        assert status == 404
        assert json.loads(body)["status"] == "unknown"
        status, body, _ = _get(gw.port, "/v1/requests/not-a-number")
        assert status == 400
    finally:
        gw.drain(timeout=10)


def test_request_timeline_endpoint_real_engine_order(llama_tiny):
    """Acceptance: a served request's /v1/requests/<id> timeline shows
    admission → prefill → decode → retire in order (engine events
    joined through the rid recorded at engine submit)."""
    cfg, params = llama_tiny
    eng = ServingEngine(cfg, params, slots=2, cache_len=32, chunk=2,
                        prompt_buckets=(8,))
    gw = ServingGateway(eng, host="127.0.0.1", port=0).start()
    try:
        status, obj, _ = _post(gw.port, {"prompt": [1, 2, 3],
                                         "max_new": 5})
        assert status == 200
        rid = obj["id"]
        status, body, _ = _get(gw.port, f"/v1/requests/{rid}")
        assert status == 200
        tl = json.loads(body)
        assert tl["status"] == "ok"
        names = [e["name"] for e in tl["timeline"]]
        idx = [names.index("request/admitted"),
               min(i for i, n in enumerate(names)
                   if n.startswith("prefill/")),
               min(i for i, n in enumerate(names)
                   if n == "request/commit"),
               names.index("request/retire")]
        assert idx == sorted(idx), names
        retire = [e for e in tl["timeline"]
                  if e["name"] == "request/retire"][-1]
        assert retire["args"]["status"] == "ok"
    finally:
        gw.drain(timeout=30)


# ── the port's engine: parity over concurrent HTTP ─────────────────────


@pytest.fixture(scope="module")
def llama_tiny():
    return llama_params("llama_tiny", 0, "cpu")


def _requests_fixture(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [(list(int(t) for t in rng.integers(1, 200,
                                               int(rng.integers(2, 8)))),
             int(rng.integers(1, 8)), 1000 + i) for i in range(n)]


def _serve_concurrently(gw, reqs, with_seeds):
    results = [None] * len(reqs)

    def client(i):
        prompt, max_new, seed = reqs[i]
        body = {"prompt": prompt, "max_new": max_new}
        if with_seeds:
            body["seed"] = seed
        results[i] = _post(gw.port, body)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


@pytest.mark.parametrize("sampling", [False, True],
                         ids=["greedy", "seeded-sampling"])
def test_gateway_parity_with_batch_engine(llama_tiny, sampling):
    """Tokens served over concurrent HTTP == a batch engine run on the
    same requests.  Sampling passes explicit per-request seeds (request
    ids differ between online arrival order and the batch run, so the
    default rid-keyed streams would not line up — explicit seeds are
    the reproducibility contract)."""
    cfg, params = llama_tiny
    kw = dict(slots=2, cache_len=64, chunk=4, prompt_buckets=(8,))
    if sampling:
        kw.update(temperature=0.8, top_k=40)
    reqs = _requests_fixture()

    ref_eng = ServingEngine(cfg, params, **kw)
    rids = [ref_eng.submit(p, m, seed=s if sampling else None)
            for p, m, s in reqs]
    ref_out = ref_eng.run()
    refs = [ref_out[r] for r in rids]

    gw = ServingGateway(ServingEngine(cfg, params, **kw),
                        host="127.0.0.1", port=0, max_queue=32).start()
    try:
        results = _serve_concurrently(gw, reqs, with_seeds=sampling)
        for (prompt, _, _), ref, (status, obj, _) in zip(reqs, refs,
                                                         results):
            assert status == 200
            assert obj["tokens"] == ref
            assert obj["tokens"][:len(prompt)] == prompt
    finally:
        gw.drain(timeout=30)


def test_gateway_real_engine_smoke(llama_tiny):
    """Fast-tier end-to-end: one real-engine gateway round trip, so a
    broken import or driver/engine contract mismatch is caught within
    minutes (the parity matrix is above)."""
    cfg, params = llama_tiny

    def vocab_screen(prompt, max_new, seed):
        # serve_http.py's make_vocab_validator shape: the library
        # stays tokenizer-agnostic, the launcher hangs the screen here.
        if any(not 0 <= int(t) < cfg.vocab_size for t in prompt):
            raise RequestError(f"token id outside vocab "
                               f"[0, {cfg.vocab_size})")

    eng = ServingEngine(cfg, params, slots=2, cache_len=16, chunk=2,
                        prompt_buckets=(8,))
    gw = ServingGateway(eng, host="127.0.0.1", port=0,
                        validate=vocab_screen).start()
    try:
        status, obj, _ = _post(gw.port, {"prompt": [1, 2, 3],
                                         "max_new": 4})
        assert status == 200
        assert obj["tokens"][:3] == [1, 2, 3]
        assert len(obj["tokens"]) == 7
        assert all(0 <= t < cfg.vocab_size for t in obj["tokens"])
        status, obj, _ = _post(gw.port, {"prompt": [900000],
                                         "max_new": 1})
        assert status == 400      # the validate hook answers before
        assert "vocab" in obj["error"]     # admission, as serve_http's
    finally:
        gw.drain(timeout=30)


# ── driver-death detection ─────────────────────────────────────────────


def test_driver_death_flips_healthz_and_gauge():
    """When the driver loop dies, /healthz must pull the instance out
    of rotation (503 driver_dead) and /metrics must expose
    ttd_gateway_driver_alive 0 — the listener socket alone staying up
    is exactly the zombie state a load balancer cannot see."""
    class ExplodingEngine(StubEngine):
        def serve_step(self):
            raise RuntimeError("device exploded")

    gw = _make_gateway(ExplodingEngine())
    try:
        assert gw.driver.alive()
        status, body, _ = _get(gw.port, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        s = _parse_prom(_get(gw.port, "/metrics")[1])
        assert s["ttd_gateway_driver_alive"] == 1

        # First request detonates the loop; the submitter gets 500.
        status, obj, _ = _post(gw.port, {"prompt": [1], "max_new": 2})
        assert status == 500

        deadline = time.monotonic() + 5
        while gw.driver.alive():
            assert time.monotonic() < deadline, "driver never died"
            time.sleep(0.005)
        assert "device exploded" in repr(gw.driver.failure())
        status, body, _ = _get(gw.port, "/healthz")
        assert status == 503
        assert json.loads(body)["status"] == "driver_dead"
        s = _parse_prom(_get(gw.port, "/metrics")[1])
        assert s["ttd_gateway_driver_alive"] == 0
    finally:
        gw._httpd.shutdown()
        gw._httpd.server_close()


def test_driver_death_fails_pending_handles_fast():
    """Requests already admitted (queued behind a busy slot) when the
    loop dies must resolve with the failure immediately — not hang
    until their deadline."""
    class DiesOnSecondStep(StubEngine):
        def __init__(self):
            super().__init__(slots=1, step_delay=0.02)
            self.steps = 0

        def serve_step(self):
            self.steps += 1
            if self.steps >= 2:
                raise RuntimeError("mid-flight death")
            return super().serve_step()

    drv = EngineDriver(DiesOnSecondStep(), max_queue=8).start()
    # Long deadlines: only fail-fast (not expiry) can finish these soon.
    handles = [drv.submit([1], 50, timeout_s=60.0) for _ in range(3)]
    t0 = time.monotonic()
    for h in handles:
        with pytest.raises(RuntimeError, match="driver failed"):
            h.result(timeout=10)
    assert time.monotonic() - t0 < 5     # nowhere near the 60 s deadline
    with pytest.raises(RuntimeError, match="driver failed"):
        drv.submit([1], 1)
    assert not drv.alive()


def test_driver_alive_false_after_drain():
    gw = _make_gateway(StubEngine())
    assert gw.driver.alive()
    gw.drain(timeout=10)
    assert not gw.driver.alive()
    assert gw.driver.failure() is None   # orderly stop, not a corpse


# ── parity with the JAX package ─────────────────────────────────────────

_JAX_KW = dict(slots=2, cache_len=64, chunk=4, kv_block_size=4)


def _jax_llama_tiny_flat():
    params = JaxLlama(JAX_PRESETS["llama_tiny"]).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


def _jax_engine(flat, **kw):
    params = jax.tree.map(jnp.asarray,
                          traverse_util.unflatten_dict(flat, sep="/"))
    return JaxEngine(JAX_PRESETS["llama_tiny"], params, overlap=False,
                     prefill_budget=0, **_JAX_KW, **kw)


def _batch(eng, reqs):
    ids = [eng.submit(p, m) for p, m, _ in reqs]
    out = eng.run()
    return [out[i] for i in ids]


@pytest.fixture(scope="module")
def jax_tiny(tmp_path_factory):
    """(npz path, flat JAX llama_tiny params, the JAX batch engine's
    tokens on ``_requests_fixture(n=8)``, max_new 6 each)."""
    flat = _jax_llama_tiny_flat()
    npz = str(tmp_path_factory.mktemp("npz") / "params.npz")
    np.savez(npz, **flat)
    reqs = [(p, 6, s) for p, _, s in _requests_fixture(seed=3, n=8)]
    return npz, flat, reqs, _batch(_jax_engine(flat), reqs)


def test_gateway_greedy_parity_with_jax_batch_engine(jax_tiny):
    """Two in-process replicas built by the fleet's production factory
    (``serve.worker_engine_factory``, replaying serve_http's parsed flags
    with ``--params-npz``) serve concurrent HTTP requests; the greedy
    tokens equal the JAX batch engine's on the same weights, and the
    port's batch engine's."""
    from tensorflow_train_distributed_torch import convert, serve_http
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS,
    )
    from tensorflow_train_distributed_torch.serve import (
        worker_engine_factory,
    )

    npz, flat, reqs, jax_tokens = jax_tiny
    args = serve_http.build_parser().parse_args(
        ["--config", "llama_tiny_sft", "--params-npz", npz,
         "--device", "cpu", "--slots", "2", "--cache-len", "64",
         "--chunk", "4", "--kv-block-size", "4", "--replicas", "2"])
    engines = [worker_engine_factory(dict(vars(args))) for _ in range(2)]
    cfg = LLAMA_PRESETS["llama_tiny"]
    port_batch = _batch(ServingEngine(cfg, convert.params_from_flax(
        flat, cfg), **_JAX_KW), reqs)
    gw = ServingGateway(engines, host="127.0.0.1", port=0,
                        max_queue=32).start()
    try:
        results = _serve_concurrently(gw, reqs, with_seeds=False)
    finally:
        gw.drain(timeout=30)
    got = [obj["tokens"] for status, obj, _ in results]
    assert all(status == 200 for status, _, _ in results)
    assert got == jax_tokens
    assert port_batch == jax_tokens
    # Both replicas served (load routing spreads 8 requests over 2 x 2
    # slots).
    assert all(e.stats["decode_steps"] > 0 for e in engines)


#: Samples whose values differ between the packages by design: the
#: process-wide compile counter (the port's eager engine compiles no
#: programs, JAX's counts every jit compile of its process).
_BY_DESIGN = ("ttd_engine_compiles_total ",)


def _feed(metrics_cls):
    """One GatewayMetrics, every callable a constant, a fixed sequence of
    observations."""
    m = metrics_cls(
        queue_depth_fn=lambda: 3, slots_in_use_fn=lambda: 2,
        slots_total=4, driver_alive_fn=lambda: True,
        replicas_alive_fn=lambda: 2, overlap_ratio_fn=lambda: 0.25,
        prefill_stall_fn=lambda: 1.5, kv_blocks_in_use_fn=lambda: 7,
        kv_blocks_total_fn=lambda: 32, kv_prefix_hit_tokens_fn=lambda: 8,
        kv_evictions_fn=lambda: 1, kv_pool_bytes_fn=lambda: 4096,
        replica_rss_fn=lambda: {"0": 123.0, "1": 456.0},
        hbm_bytes_fn=lambda: {"kv_pool": 4096.0},
        workers_by_role_fn=lambda: {"prefill": 1, "decode": 2},
        spec_depth_fn=lambda: 2.0, spec_accepted_fn=lambda: 5,
        spec_drafted_fn=lambda: 9, hbm_autosized_fn=lambda: 0,
        mfu_fn=lambda: {"0/decode": 12.5}, mbu_fn=lambda: {"0/decode": 40.0})
    for i in range(40):
        m.requests.inc(label_value=("ok", "shed", "invalid", "expired",
                                    "error")[i % 5])
        m.tokens.inc(3)
        m.ttft.observe(i * 0.013)
        m.queue_wait.observe(i * 0.07)
        m.inter_token.observe(i * 0.0011)
        m.latency.observe(i * 0.31)
    m.failovers.inc()
    return m.render()


def test_metrics_scrape_equals_jax_line_for_line():
    port, jax_ = _feed(GatewayMetrics), _feed(JaxMetrics)
    pl, jl = port.splitlines(), jax_.splitlines()
    assert len(pl) == len(jl)
    differ = [(a, b) for a, b in zip(pl, jl) if a != b]
    assert all(a.startswith(_BY_DESIGN) and b.startswith(_BY_DESIGN)
               for a, b in differ), differ
    assert "ttd_engine_compiles_total 0" in pl
    assert any(ln.startswith("# HELP ttd_engine_mfu_pct") for ln in pl)


def test_engine_scrape_accessors_read_what_jax_reads(jax_tiny):
    """The accessors the gateway samples, on each package's engine after
    the same requests on the same weights.  By design apart:
    ``overlap_ratio`` and ``prefill_stall_s`` are host-clock readings
    (both bounded here), ``kv_pool_bytes`` is left out (the port keeps
    one block table for all layers, not one a layer)."""
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS,
    )

    _, flat, reqs, _ = jax_tiny
    # A shared 8-token (two-block) prefix makes a radix hit.
    pre = reqs[0][0] + reqs[1][0] + [5, 6, 7]
    reqs = [(pre[:8] + p, m, s) for p, m, s in reqs[:4]]
    cfg = LLAMA_PRESETS["llama_tiny"]
    teng = ServingEngine(cfg, convert.params_from_flax(flat, cfg),
                         overlap=False, prefill_budget=0, **_JAX_KW)
    jeng = _jax_engine(flat)
    assert _batch(teng, reqs) == _batch(jeng, reqs)
    for name in ("kv_blocks_in_use", "kv_blocks_total",
                 "kv_prefix_hit_tokens", "kv_evictions", "spec_depth",
                 "spec_accepted_tokens", "spec_drafted_tokens",
                 "hbm_autosized_bytes"):
        assert getattr(teng, name)() == getattr(jeng, name)(), name
    assert teng.kv_prefix_hit_tokens() > 0
    for eng in (teng, jeng):
        assert 0.0 <= eng.overlap_ratio() <= 1.0
        assert eng.prefill_stall_s() >= 0.0


# ── the engine's thread discipline ──────────────────────────────────────


@pytest.fixture
def port_lockcheck():
    """The port's lock-order sanitizer installed for the test (locks the
    port creates meanwhile are instrumented), the factories it replaced
    restored after."""
    import threading as th

    from tensorflow_train_distributed_torch.runtime.lint import (
        lockcheck,
        registry,
    )

    assert registry._sanitizer_armed(), "conftest arms TTD_LOCKCHECK"
    saved = (th.Lock, th.RLock, th.Condition)
    lockcheck.uninstall()
    assert lockcheck.install()
    lockcheck.reset_graph()
    try:
        yield lockcheck
    finally:
        th.Lock, th.RLock, th.Condition = saved
        lockcheck._INSTALLED = False


def test_engine_lock_discipline_under_lockcheck(port_lockcheck,
                                                llama_tiny):
    """An engine on its driver thread, a scrape thread hammering the
    accessors (as ``/metrics`` does) and a handler thread validating
    requests against the prefix store, all at once: nothing raises, the
    sanitizer sees no lock-order inversion, every counter only rises, and
    a handler-role read of a guarded dict without its lock is refused."""
    from tensorflow_train_distributed_torch.runtime.lint.registry import (
        thread_role,
    )

    cfg, params = llama_tiny
    eng = ServingEngine(cfg, params, slots=2, cache_len=64, chunk=2,
                        prompt_buckets=(8, 16, 32), kv_block_size=4)
    assert isinstance(eng._stats_lock, port_lockcheck._InstrumentedLock)
    prefix = [3, 1, 4, 1, 5, 9, 2, 6]
    eng.preload_prefix(prefix)
    drv = EngineDriver(eng, max_queue=64).start()
    stop = threading.Event()
    errors, readings = [], []

    @thread_role("handler")
    def scrape():
        try:
            while not stop.is_set():
                readings.append((eng.kv_prefix_hit_tokens(),
                                 eng.kv_evictions(),
                                 eng.spec_accepted_tokens(),
                                 eng.spec_drafted_tokens(),
                                 eng.prefill_stall_s()))
                eng.overlap_ratio()
                eng.spec_depth()
                time.sleep(0.001)    # yield the GIL to the driver
        except BaseException as e:       # noqa: BLE001
            errors.append(e)

    @thread_role("handler")
    def validate():
        try:
            while not stop.is_set():
                eng.validate_request(prefix + [7, 7], 4)
                time.sleep(0.001)
        except BaseException as e:       # noqa: BLE001
            errors.append(e)

    @thread_role("handler")
    def unguarded():
        try:
            eng.kv_stats["prefix_hits"]
        except port_lockcheck.GuardViolation as e:
            return e

    threads = [threading.Thread(target=f) for f in (scrape, validate)]
    for t in threads:
        t.start()
    try:
        rng = np.random.default_rng(0)
        handles = [drv.submit(prefix + [int(t) for t in rng.integers(
            1, 200, int(rng.integers(1, 6)))], 6, stream=False)
            for _ in range(8)]
        outs = [h.result(timeout=60) for h in handles]
    finally:
        stop.set()
        for t in threads:
            t.join()
        drv.drain()
        drv.join(30)
    assert not errors, errors
    assert all(len(o) > len(prefix) for o in outs)
    assert len(readings) > 1
    for a, b in zip(readings, readings[1:]):
        assert all(y >= x for x, y in zip(a, b)), (a, b)
    assert readings[-1][0] >= 0 and eng.kv_prefix_hit_tokens() > 0
    box = []
    t = threading.Thread(target=lambda: box.append(unguarded()))
    t.start()
    t.join()
    assert isinstance(box[0], port_lockcheck.GuardViolation)


def test_launch_counts_from_two_threads_add_up():
    """Fleets' driver threads bump the kernels' launch counts at once:
    more threads than cores, the interpreter switching threads every
    microsecond, and no increment is lost."""
    import os
    import sys

    from tensorflow_train_distributed_torch.ops import kernels as K

    names = ("paged_attention", "rms_norm", "paged_kv_gather")
    workers = (os.cpu_count() or 4) + 2
    n = 3000
    before = K.launch_counts()

    def bump(name):
        for _ in range(n):
            K._count(name)

    threads = [threading.Thread(target=bump, args=(names[i % 3],))
               for i in range(workers)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = K.launch_counts()
    for i, name in enumerate(names):
        want = n * len(range(i, workers, 3))
        assert after[name] - before[name] == want, name
    K.reset_launch_counts()
    assert not any(K.launch_counts().values())


def test_compilecheck_runtime_surface_matches_jax(monkeypatch):
    """``runtime/lint/compilecheck.py``'s runtime surface: JAX's names and
    return shapes; an eager engine compiles nothing (0 compiles, no
    program stats, no mfu/mbu series); the peaks read the same
    environment overrides as JAX's, and without them this CPU process
    knows none."""
    from tensorflow_train_distributed_tpu.runtime.lint import (
        compilecheck as jcc,
    )
    from tensorflow_train_distributed_torch.runtime.lint import (
        compilecheck as tcc,
    )

    for name in ("armed", "total_compiles", "program_stats",
                 "peak_flops_per_s", "peak_hbm_bytes_per_s",
                 "mfu_by_program", "mbu_by_program"):
        assert callable(getattr(tcc, name)) and callable(getattr(jcc, name))
    assert tcc.total_compiles() == 0
    assert tcc.program_stats() == {}
    assert tcc.mfu_by_program() == {} and tcc.mbu_by_program() == {}
    monkeypatch.setenv("TTD_PEAK_FLOPS", "9.89e14")
    monkeypatch.setenv("TTD_PEAK_HBM_BYTES", "3.35e12")
    assert tcc.peak_flops_per_s() == jcc.peak_flops_per_s() == 9.89e14
    assert tcc.peak_hbm_bytes_per_s() == jcc.peak_hbm_bytes_per_s() \
        == 3.35e12
    monkeypatch.setenv("TTD_PEAK_FLOPS", "not-a-number")
    assert tcc.peak_flops_per_s() is None is jcc.peak_flops_per_s()
    monkeypatch.delenv("TTD_PEAK_FLOPS")
    monkeypatch.delenv("TTD_PEAK_HBM_BYTES")
    assert tcc.peak_flops_per_s() is None
    assert tcc.peak_hbm_bytes_per_s() is None
    for env, want in (({"TTD_COMPILECHECK": "1"}, True),
                      ({"TTD_COMPILECHECK": "1", "TTD_NO_COMPILECHECK": "1"},
                       False), ({"TTD_COMPILECHECK": "0"}, False)):
        monkeypatch.delenv("TTD_NO_COMPILECHECK", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tcc.armed() is jcc.armed() is want, env
