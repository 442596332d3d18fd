"""Subprocess replica worker: a thin frame loop around one engine.

``python -m tensorflow_train_distributed_torch.server.worker --fd N``
runs in a child process the parent gateway spawned with one end of a
``socketpair`` on fd ``N``.  The worker builds its engine (a named
builtin factory, or any importable ``module:function`` — the port's
``serve.py`` exports one that replays the CLI's serialized engine flags,
so parent and child construct IDENTICAL engines), sends the versioned ``HELLO``,
and then simply adapts frames to the same ``EngineDriver`` the
in-process gateway already runs:

- ``SUBMIT`` → ``driver.submit(..., request_id, resume_from)`` — the
  deterministic resume-from-token failover contract crosses the
  process boundary untouched, because the driver and engine under it
  are byte-for-byte the in-process ones;
- a per-request relay thread streams the handle's committed chunks
  back as ``CHUNK`` frames and its terminal as ``RETIRE``;
- a stats thread heartbeats ``STATS`` (occupancy, kv gauges, rss,
  step progress for the parent's hung-dispatch watchdog) and relays
  the request-scoped slice of this process's flight recorder, so
  ``/v1/requests/<id>`` in the parent shows both lives of a
  failed-over request;
- ``DRAIN`` → drain the driver, send ``BYE``, exit 0.

Fault isolation is the point: the worker arms ``TTD_FAULT_PLAN`` from
its OWN environment, so a ``serve:dispatch:N:killpid:replica=K`` plan
delivers a real ``os.kill(getpid(), SIGKILL)`` to exactly one worker —
and an engine OOM, a native crash in a CUDA kernel, or the CUDA driver
taking the process down are all the same event to the parent: EOF on the
frame stream, a waitpid corpse, and a failover on a survivor.

The ``--test-corrupt`` modes exist for the protocol-hardening tests
only: they speak deliberately broken frames (oversized length prefix,
truncated frame, stale version, mid-frame death) so the parent's
bounded reader can be pinned to fail one replica, never the pool.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import resource
import signal
import socket
import struct
import sys
import threading
import time
from typing import Optional

from tensorflow_train_distributed_torch.runtime import events, faults
from tensorflow_train_distributed_torch.runtime.lint import (
    compilecheck,
    memcheck,
)
from tensorflow_train_distributed_torch.runtime.lint.registry import (
    thread_role,
)
from tensorflow_train_distributed_torch.server import proto
from tensorflow_train_distributed_torch.server.driver import (
    _DONE,
    DeadlineExceeded,
    EngineDriver,
    RequestError,
)

logger = logging.getLogger(__name__)

#: Flight-recorder events per STATS frame: the relay ships the newest
#: tail past this and counts the rest as dropped (bounded frames beat
#: a complete-but-unbounded forensic stream).
EVENTS_PER_STATS = 512


def rss_bytes() -> int:
    """Resident set size of THIS process (the per-worker gauge feed):
    /proc on Linux, peak-RSS fallback elsewhere."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        # Fallback is PEAK rss (never decreases): ru_maxrss is
        # kilobytes on Linux, already bytes on macOS.
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024


def engine_info(engine) -> dict:
    """The static engine shape the HELLO advertises — what the
    parent-side facade needs for request screening and routing
    (slots for occupancy, kv geometry for the block-bound check and
    prefix-affinity keys)."""
    pool = getattr(engine, "_kv_pool", None)
    buckets = getattr(engine, "prompt_buckets", None)
    auto = getattr(engine, "hbm_autosized_bytes", None)
    return {
        "slots": int(getattr(engine, "slots", 0)),
        "kv_block_size": int(getattr(engine, "kv_block_size", 16)),
        "cache_len": getattr(engine, "cache_len", None),
        "paged": bool(getattr(engine, "paged", False)),
        "pool_blocks": (int(pool.n_blocks) if pool is not None
                        else None),
        "buckets": (list(buckets) if buckets else None),
        # Per-worker HBM footprint (the engine's byte budget — exact
        # when autosized): the parent's worker-packing arithmetic
        # (ProcPool.worker_pack_cap) derives workers-per-host from it.
        "hbm_budget_bytes": getattr(engine, "hbm_budget_bytes", None),
        "hbm_autosized_bytes": (int(auto()) if callable(auto) else 0),
    }


# ── builtin engine factories ───────────────────────────────────────────
#
# "stub": the deterministic arithmetic engine (each step every active
# slot appends ``(last + 1) % 997``) — closed-form expected outputs,
# no torch import, so protocol/pool tests and the elastic-scaler smoke
# run in milliseconds-per-worker.  "llama": a random-init llama preset
# (deterministic init seed ⇒ every worker and any in-process reference
# build bitwise-identical params) — the chaos and bench harness
# engine.  Anything else: ``module:function`` resolved on the worker's
# PYTHONPATH, called with the parsed ``--json`` payload.


class StubWorkerEngine:
    """The driver-facing stub surface (tests/test_gateway.StubEngine's
    arithmetic, re-stated here so worker subprocesses need no test
    import path)."""

    def __init__(self, slots: int = 2, step_delay: float = 0.0):
        self.slots = int(slots)
        self.step_delay = float(step_delay)
        self._queue: list = []
        self._slots = [None] * self.slots
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
        """Minimal migration surface so stub fleets exercise REAL
        MIGRATE frames: parameters + token history, no KV (the stub
        has none) — the re-placed request recomputes its arithmetic
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


def _factory_stub(spec: dict):
    return StubWorkerEngine(slots=spec.get("slots", 2),
                            step_delay=spec.get("step_delay", 0.0))


#: ServingEngine kwargs the llama builtin forwards verbatim when
#: present in the spec (one list, so the chaos/bench harnesses and the
#: in-process reference engine stay configured identically).
_LLAMA_ENGINE_KWARGS = (
    "slots", "cache_len", "chunk", "temperature", "top_k", "top_p",
    "prefill_chunk", "prefill_budget", "overlap", "paged",
    "kv_block_size", "kv_pool_blocks", "prefix_cache_limit",
    "hbm_budget_bytes", "hbm_headroom", "spec_depths",
)


def llama_params(preset: str, init_seed: int, device):
    """The llama builtin's weights: ``convert.init_params`` of
    ``LLAMA_PRESETS[preset]`` drawn from
    ``torch.Generator(device).manual_seed(init_seed)``.  This is the
    port's seeded draw, not the JAX package's ``PRNGKey(init_seed)``
    draw: a port worker and a JAX worker of one spec serve different
    weights (parity with the JAX fleet goes through
    ``serve.worker_engine_factory`` with ``--params-npz``), while every
    port worker of one spec, and an in-process reference built here,
    serve the same ones."""
    import torch

    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS,
    )

    cfg = LLAMA_PRESETS[preset]
    gen = torch.Generator(device=device).manual_seed(int(init_seed))
    return cfg, convert.init_params(cfg, gen, device=device)


def _factory_llama(spec: dict):
    """A random-init llama preset (``llama_params``) on ``spec["device"]``
    (default the card)."""
    from tensorflow_train_distributed_torch.serving import ServingEngine

    device = spec.get("device", "cuda")
    seed = int(spec.get("init_seed", 0))
    cfg, params = llama_params(spec.get("preset", "llama_tiny"), seed,
                               device)
    kw = {k: spec[k] for k in _LLAMA_ENGINE_KWARGS if k in spec}
    if "prompt_buckets" in spec:
        kw["prompt_buckets"] = tuple(spec["prompt_buckets"])
    if spec.get("draft_preset"):
        # Speculative serving: the draft is its own preset + init seed,
        # built as deterministically as the target, so every worker
        # (and the in-process reference) speculates bitwise-alike.
        dcfg, kw["draft_params"] = llama_params(
            spec["draft_preset"], int(spec.get("draft_init_seed", seed)),
            device)
        kw["draft_config"] = dcfg
        kw["speculative_k"] = int(spec.get("speculative_k", 3))
    eng = ServingEngine(cfg, params, device=device, **kw)
    if spec.get("warm", True):
        # Warm inside the child, before the HELLO: the parent's
        # wait_ready covers the first step's one-time costs and the
        # watchdog never sees them.  Requests are seeded independently — a warm pass changes
        # no later output (the chaos harness relies on exactly that).
        eng.submit([1, 2, 3], 5,
                   seed=0 if kw.get("temperature") else None)
        eng.run()
    return eng


_BUILTIN_FACTORIES = {"stub": _factory_stub, "llama": _factory_llama}


def resolve_factory(name: str):
    """A builtin name, or ``module:function`` importable from the
    worker's PYTHONPATH (the port's ``serve.worker_engine_factory`` is
    the production one)."""
    if name in _BUILTIN_FACTORIES:
        return _BUILTIN_FACTORIES[name]
    mod_name, sep, fn_name = name.partition(":")
    if not sep:
        raise SystemExit(
            f"unknown engine factory {name!r}: want one of "
            f"{sorted(_BUILTIN_FACTORIES)} or 'module:function'")
    import importlib

    try:
        mod = importlib.import_module(mod_name)
        return getattr(mod, fn_name)
    except (ImportError, AttributeError) as e:
        raise SystemExit(f"cannot resolve engine factory {name!r}: {e}")


# ── the worker loop ────────────────────────────────────────────────────


@thread_role("pump")
def _relay(rid: int, handle, sender: proto.FrameSender, handles: dict,
           hlock: threading.Lock) -> None:
    """Stream one request's committed chunks out as frames until its
    terminal — the worker-side half of the pool pump's relay (same
    item classification as ``ReplicaPool._relay``)."""
    q = handle._queue
    try:
        while True:
            item = q.get()
            if item is _DONE:
                sender.send(proto.RETIRE, {"id": rid, "status": "ok"})
                return
            if isinstance(item, DeadlineExceeded):
                sender.send(proto.RETIRE, {"id": rid,
                                           "status": "expired",
                                           "error": str(item)})
                return
            if isinstance(item, RequestError):
                sender.send(proto.RETIRE, {"id": rid,
                                           "status": "invalid",
                                           "error": str(item)})
                return
            if isinstance(item, BaseException):
                sender.send(proto.RETIRE, {"id": rid, "status": "error",
                                           "error": repr(item)})
                return
            body = {"id": rid, "toks": list(item)}
            granted = handle.slot_granted_at
            if granted is not None:
                # Parent-side queue-wait metrics need the grant time,
                # but monotonic clocks do not cross processes: ship
                # the AGE, the parent anchors it to its own clock.
                body["granted_ago"] = round(
                    max(0.0, time.monotonic() - granted), 6)
            if not sender.send(proto.CHUNK, body):
                return                      # parent is gone
    finally:
        with hlock:
            handles.pop(rid, None)


@thread_role("pump")
def _handoff_export(rid: int, tokens: list, driver: EngineDriver,
                    sender: proto.FrameSender) -> None:
    """Answer one PREFILL: run the prompt head's per-piece prefill +
    KV export ON THE DRIVER THREAD (``driver.call`` — the engine stays
    single-threaded) and ship the rows back as a binary KV_HANDOFF.
    Every refusal is a KV_ACK with n=0 — the parent degrades that
    request to a local prefill with identical output, so nothing here
    is fatal."""
    try:
        out = driver.call(
            lambda eng: getattr(eng, "export_prefix_kv",
                                lambda t: None)(tokens),
            timeout_s=300.0)
    except BaseException as e:      # noqa: BLE001 — refusal, not death
        sender.send(proto.KV_ACK, {"id": rid, "n": 0,
                                   "error": repr(e)})
        return
    if out is None:
        sender.send(proto.KV_ACK, {"id": rid, "n": 0,
                                   "error": "nothing exportable"})
        return
    meta, blob = out
    header = dict(meta, id=rid)
    if not sender.send_binary(proto.KV_HANDOFF, header, blob):
        # Oversized frame (or parent gone): nothing was written, the
        # stream stays healthy — tell the parent to prefill locally.
        sender.send(proto.KV_ACK, {"id": rid, "n": 0,
                                   "error": "handoff frame refused"})


@thread_role("pump")
def _handoff_install(rid: int, meta: dict, blob: bytes,
                     driver: EngineDriver,
                     sender: proto.FrameSender) -> None:
    """Install one KV_HANDOFF's rows into this worker's pool (driver
    thread via ``driver.call``); KV_ACK carries the warm-token count
    (0 = refused — the request prefills locally, same output)."""
    try:
        n = driver.call(
            lambda eng: getattr(eng, "install_prefix_kv",
                                lambda m, b: 0)(meta, blob),
            timeout_s=300.0)
    except BaseException as e:      # noqa: BLE001 — refusal, not death
        sender.send(proto.KV_ACK, {"id": rid, "n": 0,
                                   "error": repr(e)})
        return
    sender.send(proto.KV_ACK, {"id": rid, "n": int(n or 0)})


@thread_role("pump")
def _migrate_export(hid: int, rid: int, driver: EngineDriver,
                    sender: proto.FrameSender) -> None:
    """Answer one MIGRATE export request: snapshot-and-retire the live
    lane through ``driver.export_lane`` (atomic on the engine-owning
    thread — no token generates after the snapshot) and ship the
    state back as a binary MIGRATE payload.  Refusals are KV_ACK n=0;
    an export that committed but whose reply frame is refused
    (oversized) is still safe — the retired request's relay sends its
    terminal and the parent completes it via resume-from-token
    failover."""
    try:
        out = driver.export_lane(rid, timeout_s=300.0)
    except BaseException as e:      # noqa: BLE001 — refusal, not death
        sender.send(proto.KV_ACK, {"id": hid, "n": 0,
                                   "error": repr(e)})
        return
    if out is None:
        sender.send(proto.KV_ACK, {"id": hid, "n": 0,
                                   "error": "no such live request"})
        return
    meta, blob = out
    header = dict(meta, id=hid, v=proto.MIGRATE_VERSION)
    if not sender.send_binary(proto.MIGRATE, header, blob):
        sender.send(proto.KV_ACK, {"id": hid, "n": 0,
                                   "error": "migrate frame refused"})


@thread_role("pump")
def _migrate_install(hid: int, meta: dict, blob: bytes,
                     driver: EngineDriver,
                     sender: proto.FrameSender) -> None:
    """Install one migrated lane's KV into this worker's pool (driver
    thread via ``driver.install_lane``); KV_ACK carries the warm-token
    count (0 = refused/nothing shipped — the re-placed request
    prefills locally, same output).  A manifest version this worker
    does not speak is a refusal, not a death: the parent's request
    completes via the failover path."""
    if int(meta.get("v") or 0) != proto.MIGRATE_VERSION:
        sender.send(proto.KV_ACK, {
            "id": hid, "n": 0,
            "error": f"MIGRATE manifest version {meta.get('v')!r} "
                     f"!= {proto.MIGRATE_VERSION}"})
        return
    try:
        n = driver.install_lane(meta, blob, timeout_s=300.0)
    except BaseException as e:      # noqa: BLE001 — refusal, not death
        sender.send(proto.KV_ACK, {"id": hid, "n": 0,
                                   "error": repr(e)})
        return
    sender.send(proto.KV_ACK, {"id": hid, "n": int(n or 0)})


def _jsonable_attrs(attrs: Optional[dict]) -> dict:
    if not attrs:
        return {}
    return {k: v for k, v in attrs.items()
            if isinstance(v, (str, int, float, bool)) or v is None}


@thread_role("watchdog")
def _stats_loop(driver: EngineDriver, engine, sender: proto.FrameSender,
                stop: threading.Event, interval: float) -> None:
    """The heartbeat: gauges + step progress + relayed events, every
    ``interval`` seconds (and once immediately, so the parent's first
    stats arrive right after the hello).  A wedged engine dispatch
    does NOT wedge this thread — the parent keeps seeing a growing
    ``step_elapsed`` and its watchdog acts; a SIGKILL stops the
    heartbeat entirely, which is the point."""
    cursor = 0
    died_sent = False
    while True:
        cursor, died_sent = _send_stats(driver, engine, sender, cursor,
                                        died_sent)
        if sender.gone or stop.wait(interval):
            return


def _engine_gauges(engine) -> dict:
    out = {}
    for name in ("kv_blocks_total", "kv_blocks_in_use",
                 "kv_prefix_hit_tokens", "kv_evictions",
                 "kv_pool_bytes", "kv_bytes_in_use", "overlap_ratio",
                 "prefill_stall_s", "spec_depth",
                 "spec_accepted_tokens", "spec_drafted_tokens",
                 "hbm_autosized_bytes"):
        fn = getattr(engine, name, None)
        if fn is None:
            continue
        try:
            out[name] = float(fn())
        except Exception:       # noqa: BLE001 — a gauge never kills
            continue            # the heartbeat
    return out


def _send_stats(driver: EngineDriver, engine, sender: proto.FrameSender,
                cursor: int, died_sent: bool) -> tuple:
    cursor, evs = events.get_recorder().events_after(cursor)
    batch = []
    for name, ph, t0, dur, _tid, attrs in evs:
        # Only the request-correlated slice crosses the boundary: the
        # parent's /v1/requests/<id> join needs request_id/rid-tagged
        # events; unscoped engine internals stay in the worker's own
        # ring (visible via its stderr/logs if ever needed).
        if not attrs or ("request_id" not in attrs
                         and "rid" not in attrs):
            continue
        batch.append([name, ph, round(t0, 6), round(dur, 6),
                      _jsonable_attrs(attrs)])
    dropped = max(0, len(batch) - EVENTS_PER_STATS)
    if dropped:
        batch = batch[-EVENTS_PER_STATS:]
    step_elapsed = driver.step_elapsed()
    body = {
        "mono": time.monotonic(),
        "queue_depth": driver.waiting(),
        "active_slots": driver.active_slots(),
        "steps": driver.steps_completed(),
        "step_elapsed": round(step_elapsed, 6),
        "in_step": step_elapsed > 0.0,
        "driver_alive": driver.alive(),
        "draining": driver.is_draining(),
        "rss": rss_bytes(),
        "gauges": _engine_gauges(engine),
        # Live bytes per declared memcheck pool in THIS process (empty
        # unless TTD_MEMCHECK=1 armed the worker): the parent renders
        # them as ttd_engine_hbm_bytes{pool="<replica>/<pool>"}, so
        # --replica-procs fleets report memory per worker instead of
        # silently dropping the engine-local view.
        "hbm": memcheck.live_by_pool(),
        "events": batch,
    }
    # Roofline numerators from THIS worker's instrumented programs
    # (empty in the port: an eager engine compiles none): the parent
    # renders them as ttd_engine_mfu_pct{program="<replica>/<site>"}
    # against its own device peaks.
    programs = compilecheck.program_stats()
    if programs:
        body["programs"] = programs
    if dropped:
        body["events_dropped"] = dropped
    sender.send(proto.STATS, body)
    failure = driver.failure()
    if failure is not None and not died_sent:
        # The worker's driver loop died with error propagation: the
        # relays already RETIREd every pending request as "error";
        # DIED gives the parent the corpse its failure() reports.
        sender.send(proto.DIED, {"error": repr(failure)})
        died_sent = True
    return cursor, died_sent


@thread_role("reader", "main")
def run_worker(engine, sock: socket.socket, *,
               replica_id: Optional[int] = None, max_queue: int = 64,
               stats_interval: float = 0.25,
               max_frame: int = proto.MAX_FRAME_BYTES,
               role: str = "both", on_drain=None) -> int:
    """Serve one engine over the frame protocol until drain or EOF.
    Returns the process exit code (0 = clean drain / parent closed).
    ``role`` (``prefill|decode|both``) rides the HELLO: a pool doing
    disaggregated serving routes PREFILL frames to prefill-role
    workers and decode placements to decode-role workers; ``both``
    (the default, and what every pre-role parent assumes) serves
    everything.  ``on_drain`` fires when the gateway's DRAIN lands —
    a dial-in daemon (serve_worker.py) uses it to tell an orderly
    scale-down from a connection drop it should re-dial after."""
    if role not in ("prefill", "decode", "both"):
        raise ValueError(f"role must be prefill|decode|both, "
                         f"got {role!r}")
    rfp = sock.makefile("rb")
    wfp = sock.makefile("wb")
    sender = proto.FrameSender(wfp, max_frame)
    driver = EngineDriver(engine, max_queue=max(1, max_queue),
                          validate=None,
                          replica_id=replica_id).start()
    handles: dict = {}
    hlock = threading.Lock()
    stop = threading.Event()
    sender.send(proto.HELLO, {
        "proto": proto.PROTO_VERSION,
        "pid": os.getpid(),
        "replica": replica_id,
        "role": role,
        "mono": time.monotonic(),
        "engine": engine_info(engine),
    })
    threading.Thread(
        target=_stats_loop, args=(driver, engine, sender, stop,
                                  stats_interval),
        name="worker-stats", daemon=True).start()

    def _drain_and_exit():
        if on_drain is not None:
            on_drain()
        driver.join(None)
        # The driver resolved every handle, but the per-request relay
        # threads still have to DEQUEUE and send the final
        # CHUNK/RETIRE frames — BYE must be the last frame on the
        # stream, so wait for the relays to empty the handle table
        # (bounded: a wedged parent socket flips sender.gone and the
        # relays exit on their next send).
        deadline = time.monotonic() + 30.0
        while not sender.gone and time.monotonic() < deadline:
            with hlock:
                if not handles:
                    break
            time.sleep(0.01)
        sender.send(proto.BYE, {})
        # Final-ring flush: a drained worker's last events (the retires
        # the relays just sent) must reach the spool before exit — the
        # stats loop that would have flushed them is about to stop.
        events.get_recorder().flush_spool()
        stop.set()
        try:
            sock.shutdown(socket.SHUT_RDWR)   # unblocks the read loop
        except OSError:
            pass

    try:
        while True:
            try:
                frame = proto.read_frame(rfp, max_frame)
            except proto.ProtocolError as e:
                logger.error("worker %s: unreadable parent frame: %s",
                             replica_id, e)
                return 1
            except OSError:
                frame = None
            if frame is None:           # parent closed (or drain done)
                return 0
            ftype, body = frame
            if ftype == proto.SUBMIT:
                rid = int(body["id"])
                try:
                    handle = driver.submit(
                        body["prompt"], int(body["max_new"]),
                        seed=body.get("seed"), stream=True,
                        timeout_s=body.get("timeout_s"),
                        request_id=rid,
                        resume_from=int(body.get("resume_from", 0)),
                        # The parent already screened admission
                        # (queue bound, drain refusal) — the worker's
                        # own bound must not second-guess a placement
                        # the pool decided on.
                        requeue=True)
                except RequestError as e:
                    sender.send(proto.RETIRE,
                                {"id": rid, "status": "invalid",
                                 "error": str(e)})
                    continue
                except RuntimeError as e:
                    sender.send(proto.RETIRE,
                                {"id": rid, "status": "error",
                                 "error": str(e)})
                    continue
                with hlock:
                    handles[rid] = handle
                threading.Thread(
                    target=_relay,
                    args=(rid, handle, sender, handles, hlock),
                    name=f"worker-relay-{rid}", daemon=True).start()
            elif ftype == proto.CANCEL:
                with hlock:
                    handle = handles.get(int(body["id"]))
                if handle is not None:
                    driver.abandon(handle)
            elif ftype == proto.PREFILL:
                # Disaggregated serving: prefill this prompt's head and
                # hand the KV back.  A helper thread marshals the work
                # through driver.call — the reader must keep reading
                # (CANCEL/DRAIN still arrive mid-export).
                rid = int(body.get("id", -1))
                threading.Thread(
                    target=_handoff_export,
                    args=(rid, list(body.get("tokens") or ()),
                          driver, sender),
                    name=f"worker-export-{rid}", daemon=True).start()
            elif ftype == proto.KV_HANDOFF:
                # Install a handed-off prefix (decode side).
                blob = body.pop(proto.BLOB_KEY, b"")
                rid = int(body.get("id", -1))
                threading.Thread(
                    target=_handoff_install,
                    args=(rid, body, blob, driver, sender),
                    name=f"worker-install-{rid}", daemon=True).start()
            elif ftype == proto.MIGRATE:
                # Live migration: an export request (op=export, empty
                # blob) snapshots-and-retires one live lane; anything
                # else is a migrated lane's payload to install.  Helper
                # threads marshal through driver.call — the reader
                # keeps reading (CANCEL/DRAIN arrive mid-migration).
                blob = body.pop(proto.BLOB_KEY, b"")
                hid = int(body.get("id", -1))
                if body.get("op") == "export":
                    threading.Thread(
                        target=_migrate_export,
                        args=(hid, int(body.get("rid", -1)),
                              driver, sender),
                        name=f"worker-migrate-out-{hid}",
                        daemon=True).start()
                else:
                    threading.Thread(
                        target=_migrate_install,
                        args=(hid, body, blob, driver, sender),
                        name=f"worker-migrate-in-{hid}",
                        daemon=True).start()
            elif ftype == proto.PING:
                # Clock sync: echo the parent's stamp back with our
                # own monotonic, from the reader thread itself — any
                # queueing would inflate the RTT the parent's min-RTT
                # filter is trying to measure.
                sender.send(proto.PONG, {
                    "id": body.get("id"), "t": body.get("t"),
                    "mono": time.monotonic()})
            elif ftype == proto.DRAIN:
                threading.Thread(target=_drain_and_exit,
                                 name="worker-drain",
                                 daemon=True).start()
            # Unknown frame types are ignored (forward compatibility:
            # version negotiation happened at HELLO; a newer parent's
            # optional frames must not kill an older worker).
    finally:
        stop.set()
        # Release the engine: the driver thread is the only one allowed
        # to touch it, so it must exit before a dial-in daemon reuses
        # the engine on its next connection (and a subprocess worker
        # whose parent vanished finishes its accepted backlog instead
        # of orphaning it mid-decode).
        driver.drain()
        driver.join(30.0)
        # Whatever ended the loop (drain, parent EOF, protocol error),
        # the ring's tail reaches the spool before the process goes.
        events.get_recorder().flush_spool()


# ── deliberately broken workers (protocol-hardening tests) ─────────────


def _run_corrupt(mode: str, sock: socket.socket) -> int:
    """Speak broken frames on purpose so tests can pin that the
    parent's bounded reader fails ONE replica, classified — never the
    pool."""
    wfp = sock.makefile("wb")
    rfp = sock.makefile("rb")
    if mode == "badversion":
        proto.write_frame(wfp, proto.HELLO,
                          {"proto": 999, "pid": os.getpid()})
        rfp.read(1)                      # wait for the parent to react
        return 0
    if mode == "oversize":
        # A length prefix past every bound; the parent must refuse on
        # the prefix alone (bounded read), never wait for the body.
        wfp.write(struct.pack("!I", (1 << 31) - 1) + b"\x00" * 64)
        wfp.flush()
        rfp.read(1)
        return 0
    if mode == "truncate":
        # Claim 4096 payload bytes, deliver 10, close: EOF mid-frame.
        wfp.write(struct.pack("!I", 4096) + b"\x07" + b"x" * 9)
        wfp.flush()
        sock.shutdown(socket.SHUT_RDWR)
        return 0
    if mode == "midframe":
        # A healthy hello, then death in the middle of the next frame
        # (the SIGKILL-while-writing shape).
        proto.write_frame(wfp, proto.HELLO, {
            "proto": proto.PROTO_VERSION, "pid": os.getpid(),
            "replica": None, "mono": time.monotonic(),
            "engine": {"slots": 1}})
        wfp.write(struct.pack("!I", 512) + b"\x07" + b'{"half":')
        wfp.flush()
        os._exit(1)
    if mode == "garbage":
        # A perfectly framed payload that is not JSON.
        payload = b"\x01\xff\xfe not json"
        wfp.write(struct.pack("!I", len(payload)) + payload)
        wfp.flush()
        rfp.read(1)
        return 0
    if mode == "midhandoff":
        # A healthy hello, then death in the MIDDLE of a binary
        # KV_HANDOFF frame — the disaggregated analog of midframe:
        # a prefill worker SIGKILLed while streaming rows.
        proto.write_frame(wfp, proto.HELLO, {
            "proto": proto.PROTO_VERSION, "pid": os.getpid(),
            "replica": None, "role": "prefill",
            "mono": time.monotonic(), "engine": {"slots": 1}})
        frame = proto.encode_binary_frame(
            proto.KV_HANDOFF,
            {"id": 1, "tokens": [1, 2], "n": 2, "leaves": []},
            b"\x00" * 4096)
        wfp.write(frame[:len(frame) // 2])
        wfp.flush()
        os._exit(1)
    if mode == "midmigrate":
        # A healthy hello, then death in the MIDDLE of a binary
        # MIGRATE frame — a source worker SIGKILLed while streaming a
        # lane out.  The parent must classify the torn stream, never
        # install half a manifest.
        proto.write_frame(wfp, proto.HELLO, {
            "proto": proto.PROTO_VERSION, "pid": os.getpid(),
            "replica": None, "mono": time.monotonic(),
            "engine": {"slots": 1}})
        frame = proto.encode_binary_frame(
            proto.MIGRATE,
            {"id": 1, "v": proto.MIGRATE_VERSION, "kind": "lane",
             "tokens": [1, 2, 3], "kv": {"n": 16, "leaves": []}},
            b"\x00" * 4096)
        wfp.write(frame[:len(frame) // 2])
        wfp.flush()
        os._exit(1)
    if mode == "migrateversion":
        # A healthy hello, then an unsolicited MIGRATE payload with a
        # manifest version from the future: the parent must fail THIS
        # replica with a classified protocol error — installing a
        # misread lane would corrupt a live stream.
        proto.write_frame(wfp, proto.HELLO, {
            "proto": proto.PROTO_VERSION, "pid": os.getpid(),
            "replica": None, "mono": time.monotonic(),
            "engine": {"slots": 1}})
        wfp.write(proto.encode_binary_frame(
            proto.MIGRATE,
            {"id": 1, "v": 999, "kind": "lane", "tokens": [1]},
            b"\x00" * 64))
        wfp.flush()
        rfp.read(1)                      # wait for the parent to react
        return 0
    raise SystemExit(f"unknown --test-corrupt mode {mode!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fd", type=int, required=True,
                   help="inherited socketpair fd carrying the frame "
                        "protocol")
    p.add_argument("--replica-id", type=int, default=None)
    p.add_argument("--factory", default="stub",
                   help="engine factory: 'stub', 'llama', or an "
                        "importable module:function")
    p.add_argument("--json", default="{}",
                   help="JSON spec handed to the factory (the "
                        "serialized engine flags)")
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--stats-interval", type=float, default=0.25)
    p.add_argument("--max-frame", type=int,
                   default=proto.MAX_FRAME_BYTES)
    p.add_argument("--role", default="both",
                   choices=("prefill", "decode", "both"),
                   help="disaggregated serving role advertised in the "
                        "HELLO (both = serve everything, the default)")
    p.add_argument("--test-corrupt", default="",
                   help="protocol-hardening test modes: speak broken "
                        "frames on purpose (badversion|oversize|"
                        "truncate|midframe|garbage|midhandoff|"
                        "midmigrate|migrateversion)")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format=f"worker[{args.replica_id}] %(levelname)s %(message)s")
    sock = socket.socket(fileno=args.fd)
    if args.test_corrupt:
        return _run_corrupt(args.test_corrupt, sock)
    # Chaos plans target workers through their OWN environment: the
    # parent scopes a plan to one replica with replica=K, and killpid
    # entries deliver a REAL SIGKILL to exactly this process.
    faults.arm_from_env()
    if os.environ.get("TTD_TRACE_SPOOL", ""):
        # SIGTERM (supervisor scale-down, OS shutdown) would skip the
        # drain path's final flush — get the ring's tail to the spool,
        # then die with the default disposition so the exit code still
        # reads as "terminated" (128+15) to whoever sent the signal.
        def _flush_and_term(signum, frame):
            events.get_recorder().flush_spool()
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
        signal.signal(signal.SIGTERM, _flush_and_term)
    factory = resolve_factory(args.factory)
    try:
        spec = json.loads(args.json)
    except ValueError as e:
        raise SystemExit(f"--json is not valid JSON: {e}")
    engine = factory(spec)
    return run_worker(engine, sock, replica_id=args.replica_id,
                      max_queue=args.max_queue,
                      stats_interval=args.stats_interval,
                      max_frame=args.max_frame, role=args.role)


if __name__ == "__main__":
    sys.exit(main())
