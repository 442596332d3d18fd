"""Threaded HTTP gateway over the continuous-batching engine.

The online frontend the offline ``serve.py`` is not: a stdlib
``ThreadingHTTPServer`` where every connection's handler thread hands
work to the single engine-owning driver (``server.driver``) and blocks
on its future — requests are accepted WHILE the engine decodes, and
responses carry exactly serve.py's token convention, so the same
request set answers byte-identically online and offline.

Endpoints:
- ``POST /v1/generate`` — body ``{"prompt": [ids], "max_new": N,
  "seed": S?, "stream": bool?, "timeout_s": F?}``; reply ``{"id",
  "prompt", "tokens"}`` (tokens = prompt + generated).  With
  ``stream`` true the reply is chunked NDJSON: ``{"id"}`` first, then
  ``{"tokens": [...]}`` per committed decode chunk, then
  ``{"done": true}`` (or ``{"error", "status"}`` terminally).
- ``GET /healthz`` — ``{"status": "ok"|"draining", ...occupancy}``;
  503 while draining (load balancers stop routing before shutdown).
  Multi-replica gateways report per-replica state
  (``alive|draining|dead``, occupancy, free KV blocks) and answer 503
  only when NO replica can accept work — one dead replica of several
  is ``degraded`` at 200.
- ``GET /metrics`` — Prometheus text (``server.metrics`` names).
- ``GET /debug/trace?last_s=N`` — the flight recorder's recent window
  as Chrome trace-event JSON (``runtime.events``; load in Perfetto or
  ``chrome://tracing``).  Omit ``last_s`` for the whole ring.
- ``GET /v1/requests/<id>`` — one request's recorded timeline
  (admission → prefill → decode commits → retire) plus its terminal
  status — the "what happened to request X" forensics endpoint.

Robustness shell: bounded admission (429 + Retry-After via
``AdmissionFull``), per-request deadlines (504; the driver frees the
slot), 400 on malformed payloads, and graceful drain on SIGTERM —
stop admitting, finish in-flight, flush a final metrics snapshot to the
log, stop the listener.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socketserver
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tensorflow_train_distributed_torch.runtime import events
from tensorflow_train_distributed_torch.runtime.lint import compilecheck
from tensorflow_train_distributed_torch.runtime.lint.registry import thread_role
from tensorflow_train_distributed_torch.server.driver import (
    AdmissionFull,
    DeadlineExceeded,
    Draining,
    EngineDriver,
    RequestError,
)
from tensorflow_train_distributed_torch.server.metrics import GatewayMetrics
from tensorflow_train_distributed_torch.server.replicas import (
    NoReplicas,
    ReplicaPool,
)

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 1 << 20          # requests are token-id lists; 1 MiB
#                                   bounds hostile/bogus payloads


def _failover_killed() -> bool:
    """``TTD_NO_FAILOVER=1`` restores the single-engine gateway
    byte-for-byte (only the FIRST engine of a multi-engine list is
    used) — the same no-redeploy kill-switch contract as
    ``TTD_NO_OVERLAP`` and friends."""
    return os.environ.get("TTD_NO_FAILOVER", "0") not in ("", "0")


def _agg(engines, name, ratio: bool = False):
    """One scrape callable over N engines' per-engine stat (None when
    no engine has it — the stub-engine contract): sums, or the mean
    for ratio-shaped stats."""
    fns = [f for f in (getattr(e, name, None) for e in engines)
           if f is not None]
    if not fns:
        return None
    if len(fns) == 1:
        return fns[0]
    if ratio:
        return lambda: sum(f() for f in fns) / len(fns)
    return lambda: sum(f() for f in fns)


class _GatewayHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # Restarts must not wait out TIME_WAIT on the drained port.
    allow_reuse_address = True


class _Handler(BaseHTTPRequestHandler):
    # Keep-alive + chunked streaming need 1.1 framing.
    protocol_version = "HTTP/1.1"
    server: socketserver.BaseServer   # set by http.server

    @property
    def gateway(self) -> "ServingGateway":
        return self.server.gateway    # type: ignore[attr-defined]

    def log_message(self, fmt, *args):          # noqa: A003
        logger.debug("%s %s", self.address_string(), fmt % args)

    # -- plumbing --------------------------------------------------------

    def _reply_json(self, code: int, obj: dict,
                    headers: Optional[dict] = None) -> None:
        body = (json.dumps(obj) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _chunk(self, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

    # -- routes ----------------------------------------------------------

    @thread_role("handler")
    def do_GET(self):                           # noqa: N802
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            self._healthz()
        elif path == "/metrics":
            body = self.gateway.metrics.render().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/debug/trace":
            self._debug_trace(query)
        elif path.startswith("/v1/requests/"):
            self._request_timeline(path[len("/v1/requests/"):])
        else:
            self._reply_json(404, {"error": f"no route {self.path}"})

    def _healthz(self) -> None:
        gw = self.gateway
        draining = gw.draining
        if gw.pool is not None:
            # Pool health: overall status is 503 ONLY when no replica
            # can accept work (all dead, or an orderly drain) — one
            # dead replica of several degrades capacity, it does not
            # pull the instance out of rotation.
            reps = gw.pool.replica_states()
            alive = gw.pool.alive_count()
            if draining:
                status = "draining"
            elif alive == 0:
                status = "no_replicas"
            elif gw.pool.degraded():
                # The pool owns the capacity verdict: for in-process
                # replicas any death degrades for good; the elastic
                # subprocess pool is whole again once its scaler
                # respawned back to the scale_min floor (corpses stay
                # listed for forensics without pinning the status).
                status = "degraded"
            else:
                status = "ok"
            body = {
                "status": status,
                "replicas_alive": alive,
                "replicas": reps,
                "queue_depth": gw.driver.waiting(),
                "slots_in_use": gw.driver.active_slots(),
                "slots_total": sum(r["slots_total"] for r in reps),
            }
            self._reply_json(
                200 if status in ("ok", "degraded") else 503, body)
            return
        # Driver death outranks everything but an orderly drain
        # (drain stops the loop too — that is not a failure): a
        # dead engine loop means every accepted request 500s, so
        # the health check must pull this instance out of rotation
        # even though the listener socket still answers.
        dead = not draining and not gw.driver.alive()
        status = ("draining" if draining
                  else "driver_dead" if dead else "ok")
        body = {
            "status": status,
            "queue_depth": gw.driver.waiting(),
            "slots_in_use": gw.driver.active_slots(),
            "slots_total": gw.engine.slots,
        }
        # Paged-KV engines: admission is keyed on free blocks, so
        # the block occupancy IS the capacity signal load
        # balancers should watch (absent for linear-cache engines
        # and stubs).
        total_fn = getattr(gw.engine, "kv_blocks_total", None)
        total = total_fn() if total_fn is not None else 0
        if total:
            body["kv_blocks_total"] = total
            body["kv_blocks_in_use"] = gw.engine.kv_blocks_in_use()
        self._reply_json(200 if status == "ok" else 503, body)

    def _debug_trace(self, query: str) -> None:
        """The recent flight-recorder window, Chrome-trace JSON."""
        params = urllib.parse.parse_qs(query)
        last_s = None
        if "last_s" in params:
            try:
                last_s = float(params["last_s"][-1])
                if not last_s > 0:
                    raise ValueError
            except ValueError:
                self._reply_json(400, {
                    "error": "last_s must be a positive number"})
                return
        doc = events.get_recorder().export_chrome_trace(last_s)
        gw = self.gateway
        other = doc["otherData"]
        # Fleet metadata: this trace is already fleet-JOINED (worker
        # rings relay through stats frames and land here offset-
        # corrected, tagged replica= and clock_conf_s=) — attach the
        # per-replica states + clock-sync quality so offline tooling
        # (trace_report --fleet) can annotate lanes without a second
        # endpoint round-trip.
        if gw.pool is not None:
            other["fleet"] = gw.pool.replica_states()
        # Live roofline snapshot (empty unless TTD_COMPILECHECK armed
        # the dispatch wrappers): per-program dispatch/flop/byte rates
        # plus %-of-peak when the device peak is known — the
        # trace_report roofline table's source.
        if gw.pool is not None:
            programs = gw.pool.programs_by_site()
            mfu = gw.pool.mfu_by_program()
            mbu = gw.pool.mbu_by_program()
        else:
            programs = compilecheck.program_stats()
            mfu = compilecheck.mfu_by_program()
            mbu = compilecheck.mbu_by_program()
        if programs:
            for prog, stats in programs.items():
                if prog in mfu:
                    stats["mfu_pct"] = mfu[prog]
                if prog in mbu:
                    stats["mbu_pct"] = mbu[prog]
            other["roofline"] = programs
        spool = events.get_recorder().spool_info()
        if spool is not None:
            other["spool"] = spool
        self._reply_json(200, doc)

    def _request_timeline(self, tail: str) -> None:
        """One request's recorded lifecycle + terminal status."""
        try:
            request_id = int(tail)
        except ValueError:
            self._reply_json(400, {
                "error": f"request id must be an integer, got {tail!r}"})
            return
        timeline = []
        t0 = None
        for name, ph, ts, dur, tid, attrs in (
                events.get_recorder().request_timeline(request_id)):
            t0 = ts if t0 is None else t0
            ev = {"name": name, "t_ms": round((ts - t0) * 1e3, 3)}
            if ph == "X":
                ev["dur_ms"] = round(dur * 1e3, 3)
            if attrs:
                ev["args"] = {k: v for k, v in attrs.items()
                              if k != "request_id"}
            timeline.append(ev)
        status = self.gateway.driver.request_status(request_id)
        if status == "unknown" and not timeline:
            self._reply_json(404, {"id": request_id, "status": status,
                                   "error": "request not in the "
                                            "recorder window"})
            return
        self._reply_json(200, {"id": request_id, "status": status,
                               "timeline": timeline})

    @thread_role("handler")
    def do_POST(self):                          # noqa: N802
        if self.path != "/v1/generate":
            # Body never read: close, or its bytes would be parsed as
            # the keep-alive connection's next request line.
            self.close_connection = True
            self._reply_json(404, {"error": f"no route {self.path}"})
            return
        try:
            req = self._parse_body()
        except RequestError as e:
            self.gateway.metrics.requests.inc(label_value="invalid")
            self._reply_json(400, {"error": str(e)})
            return
        try:
            handle = self.gateway.driver.submit(
                req["prompt"], req["max_new"], seed=req.get("seed"),
                stream=req["stream"], timeout_s=req.get("timeout_s"))
        except RequestError as e:
            # submit() counted nothing yet for payload rejections —
            # they never reach the driver's terminal accounting.
            self.gateway.metrics.requests.inc(label_value="invalid")
            self._reply_json(400, {"error": str(e)})
            return
        except AdmissionFull as e:
            self.gateway.metrics.requests.inc(label_value="shed")
            self._reply_json(
                429, {"error": str(e)},
                headers={"Retry-After":
                         f"{max(1, round(e.retry_after_s))}"})
            return
        except Draining as e:
            self._reply_json(503, {"error": str(e)},
                             headers={"Retry-After": "5"})
            return
        except NoReplicas as e:
            # Every replica is dead: unlike a single driver's terminal
            # 500, this is a service-unavailable condition an operator
            # can clear (restart replicas) — 503 + Retry-After so
            # clients and load balancers back off instead of giving
            # the request up for lost.
            self.gateway.metrics.requests.inc(label_value="shed")
            self._reply_json(503, {"error": str(e)},
                             headers={"Retry-After": "5"})
            return
        except RuntimeError as e:
            # Driver thread died: answer 500 instead of dropping the
            # socket (submit() refuses everything once failed).
            self.gateway.metrics.requests.inc(label_value="error")
            self._reply_json(500, {"error": str(e)})
            return
        if req["stream"]:
            self._stream_response(handle)
        else:
            self._block_response(handle)

    def _parse_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0 or length > MAX_BODY_BYTES:
            # Rejecting WITHOUT reading the body leaves its bytes in
            # the keep-alive buffer to be misparsed as the next request
            # line — close instead of draining an unbounded body.
            self.close_connection = True
        if length <= 0:
            raise RequestError("missing request body")
        if length > MAX_BODY_BYTES:
            raise RequestError(
                f"body of {length} bytes exceeds {MAX_BODY_BYTES}")
        raw = self.rfile.read(length)
        try:
            obj = json.loads(raw)
        except json.JSONDecodeError as e:
            raise RequestError(f"body is not JSON: {e}")
        if not isinstance(obj, dict):
            raise RequestError("body must be a JSON object")

        def _int(v, what):
            # Mirror serve.py's request-file rule: bools and floats
            # must not silently pass for token counts.
            if not isinstance(v, int) or isinstance(v, bool):
                raise RequestError(f"{what} must be an integer")
            return v

        prompt = obj.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            raise RequestError("'prompt' must be a non-empty list of ids")
        prompt = [_int(t, "token ids") for t in prompt]
        max_new = _int(obj.get("max_new",
                               self.gateway.default_max_new), "max_new")
        out = {"prompt": prompt, "max_new": max_new,
               "stream": bool(obj.get("stream", False))}
        if "seed" in obj:
            out["seed"] = _int(obj["seed"], "seed")
        if "timeout_s" in obj:
            t = obj["timeout_s"]
            if not isinstance(t, (int, float)) or isinstance(t, bool) \
                    or not t > 0:
                raise RequestError("timeout_s must be a positive number")
            out["timeout_s"] = float(t)
        return out

    def _block_response(self, handle) -> None:
        try:
            tokens = handle.result()
        except DeadlineExceeded as e:
            self._reply_json(504, {"error": str(e)})
            return
        except Exception as e:          # noqa: BLE001 — driver failure
            self._reply_json(500, {"error": str(e)})
            return
        self._reply_json(200, {"id": handle.id, "prompt": handle.prompt,
                               "tokens": tokens})

    def _stream_response(self, handle) -> None:
        self.close_connection = True
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("Connection", "close")
            self.end_headers()
            self._chunk({"id": handle.id})
            try:
                for tokens in handle.iter_tokens():
                    self._chunk({"tokens": tokens})
                self._chunk({"done": True})
            except DeadlineExceeded as e:
                self._chunk({"error": str(e), "status": 504})
            except Exception as e:      # noqa: BLE001
                self._chunk({"error": str(e), "status": 500})
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            # Client went away mid-stream: stop writing and free the
            # request's slot instead of decoding to max_new for nobody.
            self.gateway.driver.abandon(handle)


class ServingGateway:
    """Engine(s) + driver/pool + HTTP listener, one lifecycle.

    ``engine`` is one engine (the classic single-driver gateway), a
    list of engine replicas, or a PREBUILT ``ReplicaPool`` (the
    out-of-process launchers construct a ``procpool.ProcPool`` of
    subprocess workers and hand it over here UNSTARTED — this
    gateway's ``start()``/``drain()`` own its lifecycle, and the HTTP
    surface never learns the difference): with a pool, admissions
    route through it —
    per-replica health + hung-dispatch watchdog
    (``watchdog_timeout_s``), load/KV-affinity routing, deterministic
    request failover, staged per-replica drain — while the HTTP
    surface stays identical.  ``TTD_NO_FAILOVER=1`` (or a
    single-engine list) restores the single-driver path byte-for-byte,
    driving only the first engine (a prebuilt pool, already
    constructed by its launcher, is used as passed).

    ``validate`` is threaded through to the driver (the CLI's
    ``check_vocab_ids`` hook); ``port=0`` binds an ephemeral port
    (tests), readable from ``.port`` after construction.
    """

    def __init__(self, engine, *, host: str = "127.0.0.1",
                 port: int = 8000, max_queue: int = 64,
                 default_timeout_s: Optional[float] = None,
                 default_max_new: int = 32, validate=None,
                 retry_after_s: float = 1.0,
                 watchdog_timeout_s: Optional[float] = 30.0):
        self.default_max_new = default_max_new
        self.pool: Optional[ReplicaPool] = None
        if isinstance(engine, ReplicaPool):
            # Prebuilt pool (the subprocess-replica launchers): the
            # pool already owns its replicas, validation, and scaling
            # policy — the gateway just fronts it.
            self.engine = None
            self.engines = []
            self.pool = engine
            self.driver = engine
        else:
            engines = (list(engine)
                       if isinstance(engine, (list, tuple))
                       else [engine])
            if not engines:
                raise ValueError("need at least one engine")
            self.engine = engines[0]
            self.engines = engines
            if len(engines) > 1 and not _failover_killed():
                self.pool = ReplicaPool(
                    engines, max_queue=max_queue, validate=validate,
                    default_timeout_s=default_timeout_s,
                    retry_after_s=retry_after_s,
                    watchdog_timeout_s=watchdog_timeout_s)
                self.driver = self.pool
            else:
                self.driver = EngineDriver(
                    engines[0], max_queue=max_queue, validate=validate,
                    default_timeout_s=default_timeout_s,
                    retry_after_s=retry_after_s)
        if self.pool is not None:
            # Engine-level scrape callables come from the pool's own
            # aggregation — LIVE values (dead replicas drop out; an
            # elastic pool's workers spawn and drain, so slot capacity
            # is a function, not a constant) — one wiring for
            # in-process and subprocess pools alike.
            self.metrics = GatewayMetrics(
                queue_depth_fn=self.driver.waiting,
                slots_in_use_fn=self.driver.active_slots,
                slots_total=0,          # unused: the live fn rules
                slots_total_fn=self.pool.slots_total,
                driver_alive_fn=self.driver.alive,
                replicas_alive_fn=self.pool.alive_count,
                overlap_ratio_fn=self.pool.overlap_ratio,
                prefill_stall_fn=self.pool.prefill_stall_s,
                kv_blocks_in_use_fn=self.pool.kv_blocks_in_use,
                kv_blocks_total_fn=self.pool.kv_blocks_total,
                kv_prefix_hit_tokens_fn=self.pool.kv_prefix_hit_tokens,
                kv_evictions_fn=self.pool.kv_evictions,
                kv_pool_bytes_fn=self.pool.kv_pool_bytes,
                replica_rss_fn=self.pool.replica_rss,
                hbm_bytes_fn=self.pool.hbm_by_pool,
                workers_by_role_fn=getattr(self.pool, "workers_by_role",
                                           None),
                spec_depth_fn=self.pool.spec_depth,
                spec_accepted_fn=self.pool.spec_accepted_tokens,
                spec_drafted_fn=self.pool.spec_drafted_tokens,
                hbm_autosized_fn=self.pool.hbm_autosized_bytes,
                mfu_fn=self.pool.mfu_by_program,
                mbu_fn=self.pool.mbu_by_program)
        else:
            one = [self.engine]
            self.metrics = GatewayMetrics(
                queue_depth_fn=self.driver.waiting,
                slots_in_use_fn=self.driver.active_slots,
                slots_total=self.engine.slots,
                driver_alive_fn=self.driver.alive,
                # _agg/getattr: test stubs (and any engine without the
                # decode lookahead / prefill scheduler / paged KV)
                # scrape a truthful constant 0.
                overlap_ratio_fn=_agg(one, "overlap_ratio",
                                      ratio=True),
                prefill_stall_fn=_agg(one, "prefill_stall_s"),
                kv_blocks_in_use_fn=_agg(one, "kv_blocks_in_use"),
                kv_blocks_total_fn=_agg(one, "kv_blocks_total"),
                kv_prefix_hit_tokens_fn=_agg(one,
                                             "kv_prefix_hit_tokens"),
                kv_evictions_fn=_agg(one, "kv_evictions"),
                kv_pool_bytes_fn=_agg(one, "kv_pool_bytes"),
                spec_depth_fn=_agg(one, "spec_depth"),
                spec_accepted_fn=_agg(one, "spec_accepted_tokens"),
                spec_drafted_fn=_agg(one, "spec_drafted_tokens"),
                hbm_autosized_fn=_agg(one, "hbm_autosized_bytes"))
        self.driver.set_metrics(self.metrics)
        self._httpd = _GatewayHTTPServer((host, port), _Handler)
        self._httpd.gateway = self    # type: ignore[attr-defined]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="gateway-http",
            daemon=True)
        self._stopped = threading.Event()

    @property
    def draining(self) -> bool:
        """Single source of truth is the driver's flag, so /healthz
        flips to 503 even when library code calls ``driver.drain()``
        directly instead of ``ServingGateway.drain()``."""
        return self.driver.is_draining()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ServingGateway":
        self.driver.start()
        self._http_thread.start()
        logger.info("gateway listening on %s:%d",
                    self._httpd.server_address[0], self.port)
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: flip /healthz to draining, stop admitting
        (503/429 paths stay answerable), finish in-flight requests,
        flush a final metrics snapshot to the log, stop the listener.
        Returns True when the backlog fully drained."""
        self.driver.drain()
        drained = self.driver.join(timeout)
        logger.info("gateway drained=%s; final metrics:\n%s",
                    drained, self.metrics.render())
        self._httpd.shutdown()
        self._httpd.server_close()
        self._stopped.set()
        return drained

    def install_signal_handlers(self, signals=(signal.SIGTERM,
                                               signal.SIGINT),
                                drain_timeout: Optional[float] = None
                                ) -> None:
        """SIGTERM/SIGINT → drain (from a helper thread: handlers must
        return fast, and drain() waits on in-flight decode — replicas
        drain one at a time under a pool, so capacity degrades
        gradually instead of all at once)."""
        def _on_signal(signum, frame):
            logger.info("signal %d: draining", signum)
            threading.Thread(target=self.drain, args=(drain_timeout,),
                             name="gateway-drain", daemon=True).start()

        for s in signals:
            signal.signal(s, _on_signal)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the gateway is stopped (the CLI's main thread)."""
        return self._stopped.wait(timeout)
