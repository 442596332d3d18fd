"""Out-of-process serving replicas: subprocess workers behind the pool.

``server.replicas.ReplicaPool`` makes the gateway replica-blind behind the
``EngineDriver`` submission surface; this module crosses that seam for
real.  Each replica becomes a **subprocess** (``server.worker``: a thin
frame loop around the same engine + driver the in-process gateway
runs), and the parent side speaks ``server.proto``'s length-prefixed
versioned frames through a ``ProcDriver`` that implements the driver
surface — so routing, KV-prefix affinity, the hung-dispatch watchdog,
and the deterministic resume-from-token failover path in
``server.replicas`` are reused UNCHANGED.  What changes is the blast
radius:

- a worker killed with a real ``os.kill(pid, SIGKILL)`` mid-stream is
  an EOF on the frame stream and a waitpid corpse — the pool fails the
  request over to a survivor from its last committed token, bitwise
  equal to an uninterrupted run (greedy and seeded sampling), and the
  gateway process never feels it;
- a worker OOM, a native crash (a CUDA kernel, the driver), or a protocol
  violation (truncated frame, oversized length prefix, version
  mismatch) fails exactly ONE replica, classified in its /healthz
  state — never the pool;
- the pool is **elastic**: a scaler thread spawns workers under queue
  pressure up to ``scale_max``, drains them back (the staged-drain
  machinery, one at a time) after ``idle_grace_s`` of idle, and
  respawns dead workers under an exponential-backoff restart budget
  (the supervisor idiom) — ``ttd_gateway_replica_restarts_total``
  counts the respawns, ``ttd_gateway_replica_rss_bytes`` gauges each
  worker from its stats frames.

Workers are interchangeable behind one spec (the TF-Replicator
replica-orchestration idiom): every spawn replays the same serialized
engine flags, so parent-side screening and worker-side engines agree
and the fleet can grow, shrink, and die while the gateway stays
replica-blind.  ``TTD_NO_PROC_REPLICAS=1`` is the kill switch: the
launchers fall back to in-process replicas, and constructing this pool
refuses loudly.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

from tensorflow_train_distributed_torch.runtime import events
from tensorflow_train_distributed_torch.runtime.lint.registry import (
    concurrency_guarded,
    locks_held,
    thread_role,
)
from tensorflow_train_distributed_torch.server import proto
from tensorflow_train_distributed_torch.server.driver import (
    _TERMINAL_KEEP,
    AdmissionFull,
    DeadlineExceeded,
    Draining,
    RequestError,
    RequestHandle,
)
from tensorflow_train_distributed_torch.server.replicas import (
    Replica,
    ReplicaPool,
    migration_killed,
)

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def proc_replicas_killed() -> bool:
    """``TTD_NO_PROC_REPLICAS=1`` disables subprocess replicas: the
    launchers fall back to the in-process ``ReplicaPool`` (byte for
    byte its behavior) — the same no-redeploy kill-switch contract as
    ``TTD_NO_FAILOVER`` one layer down."""
    return os.environ.get("TTD_NO_PROC_REPLICAS", "0") not in ("", "0")


def worker_pack_cap(total_hbm_bytes, per_worker_bytes,
                    headroom: float = 0.0) -> Optional[int]:
    """Workers-per-host from the SAME arithmetic the engine's HBM
    autosize uses: how many ``per_worker_bytes`` footprints (each
    worker's HELLO-advertised engine budget — exact when autosized)
    fit in ``total_hbm_bytes`` after ``headroom``.  None when either
    side is unknown (no clamp); never below 1 otherwise (a fleet
    cannot pack to zero — the over-budget single worker is the
    engine ctor's refusal to make, not the scaler's)."""
    if not total_hbm_bytes or not per_worker_bytes:
        return None
    usable = int(int(total_hbm_bytes) * (1.0 - float(headroom)))
    return max(1, usable // int(per_worker_bytes))


def _host_hbm_bytes() -> Optional[int]:
    """The host's total accelerator memory for worker packing:
    ``TTD_HBM_BYTES`` only — the parent process must not initialise
    CUDA (workers own the card), so without the env the cap is unknown
    and the scaler trusts ``scale_max`` as configured."""
    env = os.environ.get("TTD_HBM_BYTES", "")
    if env not in ("", "0"):
        return int(env)
    return None


@dataclasses.dataclass
class WorkerSpec:
    """Everything needed to spawn one interchangeable worker.

    ``factory`` is a ``server.worker`` builtin (``stub``, ``llama``)
    or an importable ``module:function``; ``factory_json`` is its
    spec — for the production launcher, the CLI's serialized engine
    flags, so parent and child construct identical engines.
    ``pythonpath`` entries are prepended to the child's PYTHONPATH
    (the repo root is always added); ``env`` overlays the child's
    environment (chaos plans arm ``TTD_FAULT_PLAN`` here, scoped to
    one replica with ``replica=K``)."""

    factory: str = "stub"
    factory_json: dict = dataclasses.field(default_factory=dict)
    stats_interval_s: float = 0.2
    max_frame_bytes: int = proto.MAX_FRAME_BYTES
    pythonpath: tuple = ()
    env: dict = dataclasses.field(default_factory=dict)
    python_exe: str = ""
    test_corrupt: str = ""        # protocol-hardening tests only


@concurrency_guarded
class RemoteEngine:
    """Parent-side facade of a worker's engine: the static shape from
    the HELLO plus the latest stats-frame gauges — what the pool's
    screening, routing, and /metrics aggregation consume in place of
    an in-process engine object."""

    # HELLO fields are ATOMIC-PUBLISH by the reader thread (written
    # once at handshake, plain-scalar reads everywhere); the gauges
    # dict is replaced wholesale under the lock because scrape threads
    # read several fields per render.
    _GUARDED_BY = {
        "_gauges": ("_lock",),
        "_hbm": ("_lock",),
        "_programs": ("_lock",),
        "_rss": ("_lock",),
        "slots": (None, "reader", "main"),
        "kv_block_size": (None, "reader", "main"),
        "cache_len": (None, "reader", "main"),
        "paged": (None, "reader", "main"),
        "pool_blocks": (None, "reader", "main"),
        "pid": (None, "reader", "main"),
        "role": (None, "reader", "main"),
        "hbm_budget_bytes": (None, "reader", "scaler", "main"),
    }

    def __init__(self):
        self.slots = 0
        self.kv_block_size = 16
        self.cache_len: Optional[int] = None
        self.paged = False
        self.pool_blocks: Optional[int] = None
        self.pid: Optional[int] = None
        # Per-worker HBM footprint from the HELLO (the engine's byte
        # budget; exact when autosized) — the worker-packing clamp's
        # numerator-per-worker.
        self.hbm_budget_bytes: Optional[int] = None
        # Disaggregated-serving role from the HELLO: ``prefill``
        # workers only stage+export KV, ``decode`` workers only take
        # placements, ``both`` (every pre-role worker) serves
        # everything.
        self.role = "both"
        self._lock = threading.Lock()
        self._gauges: dict = {}
        self._hbm: dict = {}
        self._programs: dict = {}
        self._rss = 0

    @thread_role("reader")
    def update_hello(self, body: dict) -> None:
        eng = body.get("engine") or {}
        self.kv_block_size = int(eng.get("kv_block_size") or 16)
        self.cache_len = eng.get("cache_len")
        self.paged = bool(eng.get("paged"))
        self.pool_blocks = eng.get("pool_blocks")
        self.pid = body.get("pid")
        self.hbm_budget_bytes = eng.get("hbm_budget_bytes")
        role = str(body.get("role") or "both")
        self.role = role if role in ("prefill", "decode", "both") \
            else "both"
        # slots LAST: replica_states readers key capacity off it, and
        # the rest of the shape must be visible once it is.
        self.slots = int(eng.get("slots") or 0)

    @thread_role("reader")
    def update_stats(self, body: dict) -> None:
        with self._lock:
            self._gauges = dict(body.get("gauges") or {})
            self._hbm = dict(body.get("hbm") or {})
            self._programs = dict(body.get("programs") or {})
            self._rss = int(body.get("rss") or 0)

    def _g(self, name: str) -> float:
        with self._lock:
            return float(self._gauges.get(name, 0.0))

    def rss_bytes(self) -> int:
        with self._lock:
            return self._rss

    def kv_blocks_total(self) -> float:
        return self._g("kv_blocks_total")

    def kv_blocks_in_use(self) -> float:
        return self._g("kv_blocks_in_use")

    def kv_prefix_hit_tokens(self) -> float:
        return self._g("kv_prefix_hit_tokens")

    def kv_evictions(self) -> float:
        return self._g("kv_evictions")

    def kv_pool_bytes(self) -> float:
        return self._g("kv_pool_bytes")

    def kv_bytes_in_use(self) -> float:
        return self._g("kv_bytes_in_use")

    def hbm_by_pool(self) -> dict:
        """The worker's memcheck ledger from its latest stats frame
        (``{pool: live_bytes}``; empty unless the worker armed
        TTD_MEMCHECK) — the per-worker half of the
        ``ttd_engine_hbm_bytes`` gauge family."""
        with self._lock:
            return dict(self._hbm)

    def program_stats(self) -> dict:
        """The worker's roofline ledger from its latest stats frame
        (``{site: {dispatches, flops_per_s, bytes_per_s, ...}}``;
        empty unless the worker armed TTD_COMPILECHECK) — the
        per-worker half of the ``ttd_engine_mfu_pct`` /
        ``ttd_engine_mbu_pct`` gauge families."""
        with self._lock:
            return dict(self._programs)

    def overlap_ratio(self) -> float:
        return self._g("overlap_ratio")

    def prefill_stall_s(self) -> float:
        return self._g("prefill_stall_s")

    def spec_depth(self) -> float:
        return self._g("spec_depth")

    def spec_accepted_tokens(self) -> float:
        return self._g("spec_accepted_tokens")

    def spec_drafted_tokens(self) -> float:
        return self._g("spec_drafted_tokens")

    def hbm_autosized_bytes(self) -> float:
        return self._g("hbm_autosized_bytes")

    def validate_request(self, prompt, max_new: int,
                         seed: Optional[int] = None,
                         resume_from: int = 0) -> list:
        """The cheap half of the engine's screening, from the
        HELLO-advertised shape (enough for 400s at the gateway edge);
        policy the facade cannot know — prefill-bucket fit against
        preloaded prefixes — stays with the worker's real engine,
        whose rejection comes back as a classified ``invalid``
        retire."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if seed is not None and not 0 <= seed < 2 ** 32:
            raise ValueError(f"seed must be a uint32, got {seed}")
        if resume_from < 0 or resume_from >= len(prompt):
            raise ValueError(
                f"resume_from must be in [0, len(prompt)), got "
                f"{resume_from} for a {len(prompt)}-token prompt")
        if max_new < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got "
                             f"{max_new}")
        if self.cache_len and len(prompt) + max_new > self.cache_len:
            raise ValueError(
                f"prompt {len(prompt)} + {max_new} new exceeds "
                f"cache_len={self.cache_len}")
        if self.paged and self.pool_blocks:
            need = -(-(len(prompt) + max_new) // self.kv_block_size)
            if need > self.pool_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks "
                    f"(block_size={self.kv_block_size}) but the pool "
                    f"has {self.pool_blocks}")
        return prompt


def clock_sync_killed() -> bool:
    """``TTD_NO_CLOCK_SYNC=1`` disables the PING/PONG clock-sync
    estimator: no PINGs are sent and relayed event timestamps keep the
    HELLO's one-way offset guess — byte-for-byte the pre-sync
    behavior (re-read per stats frame, an env flip suffices)."""
    return os.environ.get("TTD_NO_CLOCK_SYNC", "0") not in ("", "0")


class ClockSync:
    """NTP-style monotonic-offset estimator over PING/PONG frames.

    Monotonic clocks do not cross processes, and the HELLO's one-way
    guess (``parent_now - worker_mono``) silently absorbs the FULL
    transport + engine-build latency — microseconds over a socketpair,
    but real milliseconds over TCP dial-in, enough to render negative
    hop latencies in a fleet-joined timeline.  The classic two-stamp
    exchange bounds the error instead: the parent stamps ``t0`` into a
    PING, the worker echoes it back with its own ``mono`` (= t1), and
    at receipt (``t3``) the parent has ``rtt = t3 - t0`` and the
    midpoint estimate ``offset = (t0 + t3)/2 - t1`` whose error is at
    most ``rtt/2`` regardless of clock skew (asymmetric transport
    legs shift it by ``|d_up - d_down|/2``, still inside the bound).

    Pure arithmetic, no I/O, no threads: one instance lives on each
    driver and is touched ONLY by its reader thread (ping on every
    STATS heartbeat, fold on every PONG).  Acceptance is min-RTT — a
    congested sample never replaces a crisper one — with a drift
    window: after ``DRIFT_WINDOW_S`` the next in-bound sample wins
    even at a worse RTT, so slow clock drift between host crystals is
    re-estimated instead of frozen at the best sample ever seen.
    """

    #: Replace the held sample after this long even at a worse RTT
    #: (clocks drift ~ppm: a minute-old perfect sample can be further
    #: from the truth than a fresh mediocre one).
    DRIFT_WINDOW_S = 30.0

    #: Samples slower than this are congestion noise, not clock data.
    MAX_RTT_S = 5.0

    __slots__ = ("offset", "rtt", "samples", "_accepted_at",
                 "_next_id")

    def __init__(self):
        self.offset: Optional[float] = None   # worker mono -> parent
        self.rtt: Optional[float] = None      # of the accepted sample
        self.samples = 0                      # PONGs folded in
        self._accepted_at: Optional[float] = None
        self._next_id = 0

    def ping(self, now: float) -> dict:
        """Mint one PING payload (the parent's send stamp rides it —
        the exchange is stateless, no pending table to leak)."""
        self._next_id += 1
        return {"id": self._next_id, "t": now}

    def pong(self, body: dict, now: float) -> bool:
        """Fold one PONG into the estimate; True iff the held sample
        changed (the caller republishes the driver's offset)."""
        try:
            t0 = float(body["t"])
            t1 = float(body["mono"])
        except (KeyError, TypeError, ValueError):
            return False
        rtt = now - t0
        if rtt < 0.0 or rtt > self.MAX_RTT_S:
            return False        # garbled echo or congestion outlier
        self.samples += 1
        stale = (self._accepted_at is not None
                 and now - self._accepted_at >= self.DRIFT_WINDOW_S)
        if self.rtt is not None and rtt > self.rtt and not stale:
            return False        # min-RTT filter: keep the crisper one
        self.offset = (t0 + now) / 2.0 - t1
        self.rtt = rtt
        self._accepted_at = now
        return True

    def confidence_s(self) -> Optional[float]:
        """Worst-case error bound of the held offset (``rtt/2``), or
        None before the first accepted sample."""
        return self.rtt / 2.0 if self.rtt is not None else None


class _ProcRequest:
    """Parent-side record of one live request on a worker."""

    __slots__ = ("handle", "generated")

    def __init__(self, handle: RequestHandle):
        self.handle = handle
        self.generated: list = []


class _PendingHandoff:
    """Rendezvous for one in-flight KV handoff exchange: the caller
    waits on the event; the reader thread fills ``body`` from the
    worker's KV_HANDOFF/KV_ACK reply.  ``body`` still None after the
    event fires means the worker died — a refusal, never an error."""

    __slots__ = ("event", "body")

    def __init__(self):
        self.event = threading.Event()
        self.body: Optional[dict] = None


@concurrency_guarded
class ProcDriver:
    """The ``EngineDriver`` surface over one subprocess worker.

    The parent half of the frame protocol: ``submit`` frames requests
    out; a reader thread resolves ``CHUNK``/``RETIRE`` into the same
    ``RequestHandle`` futures the in-process driver mints, folds
    ``STATS`` into the facade (and the hung-dispatch watchdog feed),
    and relays the worker's request-scoped flight-recorder events into
    this process's ring.  Worker death — SIGKILL, OOM, native crash —
    is an EOF here; protocol violations fail THIS replica with a
    classified ``ProtocolError`` and a defensive SIGKILL of the
    worker.
    """

    # The request table and terminal map are touched by handler/pump
    # submitters and the reader thread — every access locks.
    # Deliberately NOT declared (single-writer atomic publishes with
    # read-only consumers, the EngineDriver idiom): _failed, _vanished,
    # _drained, _poisoned, _returncode, _stats, _stats_rx,
    # _mono_offset, _sync_rtt_s (reader-thread publishes; _clock's
    # internals are reader-private, never read elsewhere).
    _GUARDED_BY = {
        "_recs": ("_lock",),
        "_terminal": ("_lock",),
        "_draining": ("_lock",),
        "_next_id": ("_lock",),
        "_handoffs": ("_lock",),
        "_next_handoff": ("_lock",),
    }

    def __init__(self, spec: WorkerSpec, engine: RemoteEngine, *,
                 replica_id: Optional[int] = None, max_queue: int = 64,
                 default_timeout_s: Optional[float] = None,
                 retry_after_s: float = 1.0):
        self._spec = spec
        self._engine = engine
        self._replica_id = replica_id
        self._max_queue = max_queue
        self._default_timeout_s = default_timeout_s
        self._retry_after_s = retry_after_s
        self._lock = threading.Lock()
        self._recs: dict = {}               # request id -> _ProcRequest
        self._terminal: OrderedDict = OrderedDict()
        self._next_id = 0
        self._handoffs: dict = {}     # handoff id -> _PendingHandoff
        self._next_handoff = 0
        self._draining = False
        self._drained = False               # worker confirmed BYE
        self._failed: Optional[BaseException] = None
        self._vanished = False
        self._poisoned: Optional[str] = None
        self._returncode: Optional[int] = None
        self._proc: Optional[subprocess.Popen] = None
        self._sock = self._rfp = self._wfp = None
        self._sender: Optional[proto.FrameSender] = None
        self._ready = threading.Event()
        self._mono_offset: Optional[float] = None
        # PING/PONG offset estimator (reader-thread-private state; the
        # accepted offset/rtt are atomic-published into _mono_offset/
        # _sync_rtt_s).  None rtt = still on the HELLO's one-way guess.
        self._clock = ClockSync()
        self._sync_rtt_s: Optional[float] = None
        # Latest stats frame (whole-dict atomic publish) + its arrival
        # time: the watchdog feed.  A wedged engine keeps heartbeating
        # a growing step_elapsed; a SIGKILLed worker stops entirely —
        # both surface through step_elapsed()/alive().
        self._stats = {"queue_depth": 0, "active_slots": 0, "steps": 0,
                       "step_elapsed": 0.0, "in_step": False}
        self._stats_rx = time.monotonic()
        self._reader: Optional[threading.Thread] = None
        # Reader-private relay accounting: how many worker events were
        # folded into the parent ring and the last few of them — the
        # corpse snapshot's "what was it doing when it died".
        self._relay_count = 0
        self._relay_tail: deque = deque(maxlen=128)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ProcDriver":
        spec = self._spec
        parent_sock, child_sock = socket.socketpair()
        child_fd = child_sock.fileno()
        cmd = [spec.python_exe or sys.executable,
               "-m", "tensorflow_train_distributed_torch.server.worker",
               "--fd", str(child_fd),
               "--factory", spec.factory,
               "--json", json.dumps(spec.factory_json),
               "--max-queue", str(self._max_queue),
               "--stats-interval", str(spec.stats_interval_s),
               "--max-frame", str(spec.max_frame_bytes)]
        if self._replica_id is not None:
            cmd += ["--replica-id", str(self._replica_id)]
        if spec.test_corrupt:
            cmd += ["--test-corrupt", spec.test_corrupt]
        env = dict(os.environ)
        env.update(spec.env)
        path = [_REPO_ROOT] + list(spec.pythonpath)
        if env.get("PYTHONPATH"):
            path.append(env["PYTHONPATH"])
        env["PYTHONPATH"] = os.pathsep.join(path)
        self._proc = subprocess.Popen(
            cmd, pass_fds=(child_fd,), env=env,
            stdin=subprocess.DEVNULL)
        child_sock.close()
        self._sock = parent_sock
        self._rfp = parent_sock.makefile("rb")
        self._wfp = parent_sock.makefile("wb")
        self._sender = proto.FrameSender(self._wfp,
                                         spec.max_frame_bytes)
        self._stats_rx = time.monotonic()
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"proc-reader-{self._replica_id}", daemon=True)
        self._reader.start()
        events.instant("replica/worker_spawn",
                       replica=self._replica_id, pid=self._proc.pid)
        return self

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the worker's HELLO landed (engine built)."""
        return self._ready.wait(timeout)

    def ready(self) -> bool:
        """Has the HELLO landed (non-blocking)?"""
        return self._ready.is_set()

    def _send(self, ftype: int, body: dict) -> bool:
        s = self._sender
        return s.send(ftype, body) if s is not None else False

    # -- the frame reader ------------------------------------------------

    @thread_role("reader")
    def _read_loop(self) -> None:
        try:
            frame = proto.read_frame(self._rfp,
                                     self._spec.max_frame_bytes)
            if frame is None:
                self._on_eof()
                return
            body = proto.check_hello(*frame)
            self._mono_offset = time.monotonic() - float(
                body.get("mono") or 0.0)
            self._engine.update_hello(body)
            self._stats_rx = time.monotonic()
            self._ready.set()
            while True:
                frame = proto.read_frame(self._rfp,
                                         self._spec.max_frame_bytes)
                if frame is None:
                    self._on_eof()
                    return
                self._dispatch(*frame)
        except proto.ProtocolError as e:
            self._fail_protocol(e)
        except (OSError, ValueError) as e:
            self._stream_error(e)

    def _stream_error(self, e: BaseException) -> None:
        """A torn frame stream, classified.  A SIGKILLed/OOMed worker
        can tear its socket down with data still in flight: the parent
        reads ECONNRESET instead of a clean EOF.  That is the DEATH's
        symptom, not a protocol violation by the worker — if there is
        a corpse (brief wait: the reset and the exit race by
        microseconds), classify it like the EOF it stands for
        ("killed by signal 9" in /healthz), never "protocol".  The
        TCP driver overrides this (no corpse to consult across
        hosts)."""
        rc = None
        if isinstance(e, OSError) and self._proc is not None:
            try:
                rc = self._proc.wait(timeout=1.0)
            except subprocess.TimeoutExpired:
                rc = None
        if rc is not None:
            self._on_eof()
            return
        self._fail_protocol(proto.ProtocolError(
            f"frame stream error: {type(e).__name__}: {e}"))

    def _dispatch(self, ftype: int, body: dict) -> None:
        if ftype == proto.CHUNK:
            rid = int(body["id"])
            with self._lock:
                rec = self._recs.get(rid)
            if rec is None:
                return                     # late chunk after terminal
            handle = rec.handle
            if (handle.slot_granted_at is None
                    and "granted_ago" in body):
                handle.slot_granted_at = (
                    time.monotonic() - float(body["granted_ago"]))
            rec.generated.extend(int(t) for t in body["toks"])
            handle._push_new(list(handle.prompt) + rec.generated)
        elif ftype == proto.RETIRE:
            self._retire(int(body["id"]), str(body.get("status")),
                         body.get("error"))
        elif ftype == proto.STATS:
            self._on_stats(body)
        elif ftype in (proto.KV_HANDOFF, proto.KV_ACK):
            # Disaggregated serving: a prefill worker's exported rows
            # (binary KV_HANDOFF) or a decode worker's install verdict
            # (KV_ACK) — either resolves the waiting handoff exchange.
            self._resolve_handoff(body)
        elif ftype == proto.MIGRATE:
            # A worker's exported lane (the reply to our MIGRATE
            # export request).  The manifest version is validated
            # HERE, before any waiter sees the body: installing a
            # misread lane would corrupt a live stream, so a mismatch
            # is a classified protocol failure of this ONE replica
            # (the interrupted request completes via resume-from-token
            # failover, never a poisoned install).
            v = int(body.get("v") or 0)
            if v != proto.MIGRATE_VERSION:
                raise proto.ProtocolError(
                    f"MIGRATE manifest version {v} != "
                    f"{proto.MIGRATE_VERSION}")
            self._resolve_handoff(body)
        elif ftype == proto.DIED:
            self._failed = RuntimeError(
                f"worker driver died: {body.get('error')}")
            # The worker's relays RETIRE every pending request before
            # DIED lands; anything still here missed its relay —
            # resolve with the corpse so no caller blocks forever.
            with self._lock:
                leftovers = list(self._recs.items())
                self._recs.clear()
            for rid, rec in leftovers:
                self._set_terminal(rid, "error")
                rec.handle._resolve(None, RuntimeError(
                    f"worker driver died: {body.get('error')}"))
            self._fail_handoffs()
        elif ftype == proto.BYE:
            self._drained = True
        elif ftype == proto.PONG:
            # Clock sync: fold the echo into the min-RTT estimate and
            # republish the offset relayed events are corrected by.
            if self._clock.pong(body, time.monotonic()):
                self._mono_offset = self._clock.offset
                self._sync_rtt_s = self._clock.rtt
        # Unknown frame types are ignored (forward compatibility).

    def _retire(self, rid: int, status: str, error) -> None:
        with self._lock:
            rec = self._recs.pop(rid, None)
        self._set_terminal(rid, status)
        if rec is None:
            return
        handle = rec.handle
        if status == "ok":
            handle._resolve(list(handle.prompt) + rec.generated, None)
        elif status == "expired":
            handle._resolve(None, DeadlineExceeded(
                error or f"request {rid} exceeded its deadline"))
        elif status == "invalid":
            handle._resolve(None, RequestError(
                error or f"request {rid} rejected by the engine"))
        else:
            handle._resolve(None, RuntimeError(
                error or f"request {rid} failed on the worker"))

    def _set_terminal(self, rid: int, status: str) -> None:
        with self._lock:
            self._terminal[rid] = status
            while len(self._terminal) > _TERMINAL_KEEP:
                self._terminal.popitem(last=False)

    def _on_stats(self, body: dict) -> None:
        self._stats = {
            "queue_depth": int(body.get("queue_depth") or 0),
            "active_slots": int(body.get("active_slots") or 0),
            "steps": int(body.get("steps") or 0),
            "step_elapsed": float(body.get("step_elapsed") or 0.0),
            "in_step": bool(body.get("in_step")),
        }
        self._stats_rx = time.monotonic()
        self._engine.update_stats(body)
        if (not body.get("driver_alive", True)
                and not body.get("draining")
                and not self.is_draining()
                and self._failed is None):
            # The worker's driver loop vanished (in-process kill9
            # fault inside the child) without a DIED corpse — surface
            # it so the monitor declares this replica dead.  An
            # ORDERLY drain is exempt: the worker's driver thread
            # legitimately exits once its backlog finishes, and a
            # stats heartbeat racing the BYE must not read as a death
            # (either side's drain flag settles it).
            self._failed = RuntimeError(
                "worker's engine driver vanished (no corpse)")
        # Clock sync rides the heartbeat: one PING per STATS frame, so
        # the sampling cadence is the stats interval and no extra
        # thread exists to manage.  The worker echoes from its own
        # reader thread; the PONG resolves in _dispatch.
        if not clock_sync_killed():
            self._send(proto.PING, self._clock.ping(time.monotonic()))
        offset = self._mono_offset
        if offset is None:
            return
        conf = self._sync_rtt_s
        conf = round(conf / 2.0, 6) if conf is not None else None
        for ev in body.get("events") or ():
            try:
                name, ph, t0, dur, attrs = ev
                attrs = dict(attrs) if isinstance(attrs, dict) else {}
                # Fleet provenance: which worker's ring this event came
                # from, and how trustworthy its corrected timestamp is
                # (the offset's rtt/2 error bound; absent = still on
                # the HELLO's one-way guess, trust accordingly).
                if self._replica_id is not None:
                    attrs.setdefault("replica", self._replica_id)
                if conf is not None:
                    attrs["clock_conf_s"] = conf
                self._relay_event(str(name), str(ph),
                                  float(t0) + offset, float(dur),
                                  attrs or None)
            except (TypeError, ValueError):
                continue          # one malformed event never kills the
                #                   reader — frames were JSON-validated

    def _relay_event(self, name: str, ph: str, t0: float, dur: float,
                     attrs: Optional[dict]) -> None:
        """One worker event into the parent ring, with a reader-private
        tail kept for the corpse snapshot."""
        events.get_recorder().record_at(name, ph, t0, dur, attrs)
        self._relay_count += 1
        self._relay_tail.append([name, ph, round(t0, 6),
                                 round(dur, 6), attrs])

    def clock_info(self) -> dict:
        """The clock-sync state fleet-joined timelines annotate with:
        the live offset, whether it came from PING/PONG sampling, and
        the sample's error bound."""
        d: dict = {"offset_s": self._mono_offset,
                   "synced": self._sync_rtt_s is not None}
        if self._sync_rtt_s is not None:
            d["rtt_s"] = round(self._sync_rtt_s, 6)
            d["conf_s"] = round(self._sync_rtt_s / 2.0, 6)
        return d

    def _corpse_snapshot(self, rc) -> None:
        """When a worker vanishes and the trace spool is armed, write
        what the parent last knew — pid, vanish classification, clock
        offset, relay cursor, and the last relayed events (already
        offset-corrected to THIS process's clock) — next to the spool
        segments ``trace_report --post-mortem`` joins."""
        spool_dir = os.environ.get("TTD_TRACE_SPOOL", "")
        if not spool_dir:
            return
        snap = {
            "corpse": 1,
            "replica": self._replica_id,
            "pid": self._engine.pid or (self._proc.pid if self._proc
                                        else None),
            "returncode": rc,
            "reason": (self.vanish_reason() if self.vanished()
                       else "drained" if self._drained else
                       str(self._failed or "eof")),
            "drained": self._drained,
            "clock": self.clock_info(),
            "events_relayed": self._relay_count,
            "last_events": list(self._relay_tail),
            "wall_s": time.time(),
            "mono_s": time.monotonic(),
        }
        try:
            os.makedirs(spool_dir, exist_ok=True)
            path = os.path.join(
                spool_dir, f"corpse-{self._replica_id}-{snap['pid']}"
                           f"-{os.getpid()}.json")
            with open(path, "w") as f:
                json.dump(snap, f)
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:          # a full disk must not take the
            logger.warning("corpse snapshot failed: %s", e)  # reader

    def _on_eof(self) -> None:
        rc = None
        if self._proc is not None:
            try:
                rc = self._proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                # Stream closed but the process lingers (wedged past
                # its own drain): make the death real.
                self._proc.kill()
                rc = self._proc.wait()
        self._returncode = rc
        if not (self._drained and rc == 0) and self._failed is None:
            # Abrupt end: no BYE, no corpse — SIGKILL semantics.  No
            # handle is resolved (nobody was notified); the pool
            # pump's liveness watch is the only detector, exactly like
            # the in-process kill9 fault.
            self._vanished = True
            logger.warning("worker %s (pid %s) vanished (rc=%s)",
                           self._replica_id, self._engine.pid, rc)
        self._fail_handoffs()
        self._corpse_snapshot(rc)
        events.instant("replica/worker_exit",
                       replica=self._replica_id, returncode=rc,
                       drained=self._drained)

    def _fail_protocol(self, e: proto.ProtocolError) -> None:
        """An unusable frame stream fails THIS replica, classified —
        and the worker is SIGKILLed defensively (its stream can no
        longer be trusted, so it must not keep decoding)."""
        self._failed = e
        logger.error("worker %s protocol failure: %s",
                     self._replica_id, e)
        events.instant("replica/protocol_error",
                       replica=self._replica_id, error=str(e)[:200])
        self._fail_handoffs()
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._returncode = self._proc.wait()

    # -- the EngineDriver surface ----------------------------------------

    @thread_role("handler", "pump", "main")
    def submit(self, prompt, max_new: int, *,
               seed: Optional[int] = None, stream: bool = False,
               timeout_s: Optional[float] = None,
               request_id: Optional[int] = None,
               resume_from: int = 0,
               requeue: bool = False) -> RequestHandle:
        if self._failed is not None:
            raise RuntimeError(
                f"engine driver failed: {self._failed!r}")
        if not self.alive():
            raise RuntimeError(
                f"worker {self._replica_id} is gone")
        try:
            prompt = self._engine.validate_request(prompt, max_new,
                                                   seed, resume_from)
        except ValueError as e:
            raise RequestError(str(e))
        if timeout_s is None:
            timeout_s = self._default_timeout_s
        if timeout_s is not None and timeout_s <= 0:
            raise RequestError(f"timeout_s must be > 0, got {timeout_s}")
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        with self._lock:
            if not requeue:
                if self._draining:
                    raise Draining("worker is draining; not admitting")
                waiting = self._waiting_locked()
                if waiting >= self._max_queue:
                    raise AdmissionFull(waiting, self._retry_after_s)
            if request_id is None:
                request_id = self._next_id
                self._next_id += 1
            handle = RequestHandle(request_id, prompt, max_new, seed,
                                   stream, deadline, resume_from)
            self._recs[request_id] = _ProcRequest(handle)
        try:
            # Pre-encoded so an OVERSIZED request is the CLIENT's
            # error (400), clearly distinct from a genuinely closed
            # pipe — it must not read as a dead replica and burn
            # every healthy candidate in the pool's placement loop.
            frame = proto.encode_frame(proto.SUBMIT, {
                "id": request_id, "prompt": prompt,
                "max_new": max_new, "seed": seed,
                "timeout_s": timeout_s, "resume_from": resume_from},
                self._spec.max_frame_bytes)
        except proto.ProtocolError as e:
            with self._lock:
                self._recs.pop(request_id, None)
            raise RequestError(str(e))
        sender = self._sender
        if sender is None or not sender.send_frame(frame):
            with self._lock:
                self._recs.pop(request_id, None)
            raise RuntimeError(
                f"worker {self._replica_id} pipe closed")
        return handle

    @locks_held("_lock")
    def _waiting_locked(self) -> int:
        return sum(1 for rec in self._recs.values()
                   if rec.handle.slot_granted_at is None)

    def waiting(self) -> int:
        """Requests submitted here that hold no worker lane yet (the
        routing/shed gauge; grant news arrives with the first chunk)."""
        with self._lock:
            return self._waiting_locked()

    def active_slots(self) -> int:
        return self._stats["active_slots"]

    def alive(self) -> bool:
        if self._failed is not None:
            return False
        p = self._proc
        return p is not None and p.poll() is None

    def failure(self) -> Optional[BaseException]:
        return self._failed

    def _corpse_rc(self) -> Optional[int]:
        """The worker's wait status, live: the reader thread's
        ``_on_eof`` records it durably at EOF, but the kernel has it
        the MOMENT the process dies — ``poll()`` here lets the pool
        monitor classify a SIGKILL on its very next tick instead of
        reporting the generic "vanished" until the frame stream
        drains (a real flake under load: the chaos gate read
        /healthz between the death and the reader's EOF and missed
        the "killed by signal 9" classification)."""
        if self._returncode is not None:
            return self._returncode
        p = self._proc
        return p.poll() if p is not None else None

    def vanished(self) -> bool:
        """Abrupt worker death: durable after the reader's EOF, and
        detected LIVE from the wait status so classification never
        lags the corpse.  Only a NONZERO/signal status counts live —
        a clean exit is "vanished" only if the reader's EOF confirms
        the BYE never came (an orderly drain's worker exits 0 moments
        before its BYE frame is processed, and that window must never
        classify a clean scale-down as a death)."""
        if self._vanished:
            return True
        if self._drained or self._failed is not None:
            return False
        rc = self._corpse_rc()
        return rc is not None and rc != 0

    def vanish_reason(self) -> Optional[str]:
        """How the worker went away, from its wait status — the
        monitor folds this into the replica's dead_reason so /healthz
        says "killed by signal 9", not just "vanished"."""
        if not self.vanished():
            return None
        rc = self._corpse_rc()
        pid = self._engine.pid or (self._proc.pid if self._proc
                                   else None)
        if rc is not None and rc < 0:
            return f"worker pid {pid} killed by signal {-rc}"
        return f"worker pid {pid} exited unexpectedly (code {rc})"

    def failure_class(self) -> Optional[str]:
        """Coarse per-replica failure classification for /healthz."""
        if isinstance(self._failed, proto.ProtocolError):
            return "protocol"
        if self._failed is not None:
            return "worker_error"
        if self.vanished():
            rc = self._corpse_rc()
            return "killed" if rc is not None and rc < 0 else "exited"
        return None

    def health_extra(self) -> dict:
        d: dict = {}
        if self._engine.pid is not None:
            d["pid"] = self._engine.pid
        rss = self._engine.rss_bytes()
        if rss:
            d["rss_bytes"] = rss
        cls = self.failure_class()
        if cls is not None:
            d["failure_class"] = cls
        if self._ready.is_set():
            d["clock"] = self.clock_info()
        return d

    def step_elapsed(self) -> float:
        """The watchdog feed, reconstructed from heartbeats: the
        worker's own in-step elapsed plus the heartbeat's age — a
        wedged dispatch keeps reporting a growing elapsed, and a
        worker gone COMPLETELY silent (stats thread dead too) shows
        its silence age once it exceeds a few heartbeat intervals."""
        if not self._ready.is_set():
            return 0.0              # still building the engine
        s = self._stats
        age = max(0.0, time.monotonic() - self._stats_rx)
        if s["in_step"]:
            return s["step_elapsed"] + age
        if age > max(1.0, 5 * self._spec.stats_interval_s):
            return age
        return 0.0

    def steps_completed(self) -> int:
        return self._stats["steps"]

    def replica_id(self) -> Optional[int]:
        return self._replica_id

    def request_status(self, request_id: int) -> str:
        with self._lock:
            status = self._terminal.get(request_id)
            if status is not None:
                return status
            rec = self._recs.get(request_id)
        if rec is None:
            return "unknown"
        return ("queued" if rec.handle.slot_granted_at is None
                else "active")

    def abandon(self, handle: RequestHandle) -> None:
        handle.deadline = time.monotonic()
        self._send(proto.CANCEL, {"id": handle.id})

    # -- disaggregated serving: prefill→decode KV handoff ----------------

    def _new_handoff(self) -> tuple:
        pend = _PendingHandoff()
        with self._lock:
            hid = self._next_handoff
            self._next_handoff += 1
            self._handoffs[hid] = pend
        return hid, pend

    def _drop_handoff(self, hid: int) -> None:
        with self._lock:
            self._handoffs.pop(hid, None)

    def _resolve_handoff(self, body: dict) -> None:
        hid = body.get("id")
        with self._lock:
            pend = (self._handoffs.pop(int(hid), None)
                    if hid is not None else None)
        if pend is None:
            return          # the waiter timed out and gave up already
        pend.body = body
        pend.event.set()

    def _fail_handoffs(self) -> None:
        """Wake every pending handoff waiter with a refusal (body stays
        None) — a dead worker must never leave a pump blocked for the
        full handoff timeout."""
        with self._lock:
            pending = list(self._handoffs.values())
            self._handoffs.clear()
        for pend in pending:
            pend.event.set()

    @thread_role("pump", "handler", "main")
    def prefill_export(self, tokens,
                       timeout_s: float = 60.0) -> Optional[tuple]:
        """Ask THIS (prefill-role) worker to stage ``tokens``' head
        through its per-piece prefill and ship the finished KV rows
        back.  Returns ``(meta, blob)`` — the wire header (block span,
        leaf manifest) and the raw int8-rows+scales payload — or None
        on ANY refusal (nothing exportable, oversized frame, timeout,
        worker death): the caller degrades that request to a local
        prefill with bitwise-identical output, so no path here is
        fatal."""
        if not self.alive():
            return None
        hid, pend = self._new_handoff()
        if not self._send(proto.PREFILL,
                          {"id": hid,
                           "tokens": [int(t) for t in tokens]}):
            self._drop_handoff(hid)
            return None
        if not pend.event.wait(timeout_s):
            self._drop_handoff(hid)
            return None
        body = pend.body
        if body is None:                # worker died mid-export
            return None
        body = dict(body)
        blob = body.pop(proto.BLOB_KEY, None)
        if not blob or not body.get("n"):
            return None                 # KV_ACK refusal (n=0)
        body.pop("id", None)
        return body, blob

    @thread_role("pump", "handler", "main")
    def install_handoff(self, meta: dict, blob: bytes,
                        timeout_s: float = 60.0) -> int:
        """Forward an exported prefix into THIS (decode-role) worker's
        paged pool; returns the warm-token count its radix index now
        answers (0 = refused — the request prefills locally with the
        same output)."""
        if not self.alive():
            return 0
        hid, pend = self._new_handoff()
        s = self._sender
        if s is None or not s.send_binary(proto.KV_HANDOFF,
                                          dict(meta, id=hid), blob):
            self._drop_handoff(hid)
            return 0
        if not pend.event.wait(timeout_s):
            self._drop_handoff(hid)
            return 0
        body = pend.body
        if body is None:                # worker died mid-install
            return 0
        return int(body.get("n") or 0)

    # -- live mid-stream migration ---------------------------------------

    @thread_role("pump", "handler", "main")
    def export_lane(self, request_id: int,
                    timeout_s: float = 60.0) -> Optional[tuple]:
        """Ask THIS worker to export request ``request_id``'s live
        lane (token history, rng counter, KV block rows in the
        KV_HANDOFF byte recipe) and retire it there; returns
        ``(meta, blob)`` or None on refusal/timeout/death.  On success
        the request is terminal ``migrated`` on this replica — the
        pool re-homes the stream; the worker-relayed RETIRE for the
        moved id is absorbed by the ``_recs`` pop here (whichever
        lands first wins, both are the same verdict)."""
        if not self.alive():
            return None
        hid, pend = self._new_handoff()
        s = self._sender
        hdr = {"id": hid, "rid": int(request_id), "op": "export",
               "v": proto.MIGRATE_VERSION}
        # An export REQUEST is a binary MIGRATE with an empty blob —
        # one frame type serves both directions of the exchange.
        if s is None or not s.send_binary(proto.MIGRATE, hdr, b""):
            self._drop_handoff(hid)
            return None
        if not pend.event.wait(timeout_s):
            self._drop_handoff(hid)
            return None
        body = pend.body
        if body is None:                # worker died mid-export
            return None
        body = dict(body)
        blob = body.pop(proto.BLOB_KEY, b"") or b""
        if body.get("error") or "kind" not in body:
            return None                 # KV_ACK refusal
        body.pop("id", None)
        body.pop("v", None)
        with self._lock:
            rec = self._recs.pop(int(request_id), None)
        if rec is not None:
            self._set_terminal(int(request_id), "migrated")
        return body, blob

    @thread_role("pump", "handler", "main")
    def install_lane(self, meta: dict, blob: bytes,
                     timeout_s: float = 60.0) -> int:
        """Forward a migrated lane's KV into THIS worker's paged pool;
        returns the warm-token count (0 = refused — the re-placed
        request prefills locally, the failover path)."""
        if not self.alive():
            return 0
        hid, pend = self._new_handoff()
        s = self._sender
        if s is None or not s.send_binary(
                proto.MIGRATE,
                dict(meta, id=hid, v=proto.MIGRATE_VERSION), blob):
            self._drop_handoff(hid)
            return 0
        if not pend.event.wait(timeout_s):
            self._drop_handoff(hid)
            return 0
        body = pend.body
        if body is None:                # worker died mid-install
            return 0
        return int(body.get("n") or 0)

    def poison(self, reason: str) -> None:
        """Fence a declared-dead worker: for a subprocess the fence is
        the real thing — SIGKILL.  A wedged worker that would
        eventually wake must never stream into a request that already
        failed over."""
        self._poisoned = reason
        p = self._proc
        if p is not None and p.poll() is None:
            logger.warning("SIGKILLing poisoned worker %s (pid %d): %s",
                           self._replica_id, p.pid, reason)
            p.kill()

    def is_draining(self) -> bool:
        with self._lock:
            return self._draining

    def drain(self) -> None:
        with self._lock:
            if self._draining:
                return
            self._draining = True
        self._send(proto.DRAIN, {})

    def join(self, timeout: Optional[float] = None) -> bool:
        self.drain()
        if self._proc is None:
            return True
        try:
            self._proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return False
        if self._reader is not None:
            self._reader.join(timeout=5.0)
        return True


class _SpecReplica(Replica):
    """One subprocess replica: the base Replica with a ProcDriver and
    the parent-side facade in the engine seat."""

    def __init__(self, idx: int, spec: WorkerSpec, *, max_queue: int,
                 default_timeout_s: Optional[float],
                 retry_after_s: float):
        engine = RemoteEngine()
        driver = ProcDriver(spec, engine, replica_id=idx,
                            max_queue=max_queue,
                            default_timeout_s=default_timeout_s,
                            retry_after_s=retry_after_s)
        super().__init__(idx, engine, max_queue=max_queue,
                         default_timeout_s=default_timeout_s,
                         retry_after_s=retry_after_s, driver=driver)


@concurrency_guarded
class ProcPool(ReplicaPool):
    """``ReplicaPool`` over subprocess workers, made elastic.

    Everything request-shaped — admission, routing, failover, the
    watchdog, staged drain — is inherited; this class owns worker
    LIFECYCLE: spawning from one shared ``WorkerSpec``, a scaler
    thread that grows the fleet under queue pressure
    (``scale_up_queue`` waiting requests per accepting replica) up to
    ``scale_max``, drains it back to ``scale_min`` after
    ``idle_grace_s`` of idle (one worker at a time — the staged-drain
    rule), and respawns dead workers with exponential backoff under a
    ``max_restarts`` budget (the supervisor's idiom).  While the
    respawn budget lasts, a request caught with NO live replica waits
    (bounded by its own deadline) instead of failing — capacity is
    coming back.
    """

    # Scaler-thread-owned bookkeeping (single writer, monitor/handler
    # readers see atomic scalars).  Only THIS class's additions are
    # declared: the lock-guarded request/terminal/drain structures —
    # and the atomic-publish `_replicas` snapshot the scaler replaces
    # wholesale — are declared (and checked) on ReplicaPool itself.
    _GUARDED_BY = {
        "_replicas": (None, "scaler", "main"),
        "_idle_since": (None, "scaler"),
        "_respawn_at": (None, "scaler"),
        "_respawn_streak": (None, "scaler"),
        "_restarts": (None, "scaler"),
        "_last_spawn_t": (None, "scaler"),
        "_next_idx": (None, "scaler", "main"),
    }

    def __init__(self, spec: WorkerSpec, *, replicas: int = 2,
                 scale_min: Optional[int] = None,
                 scale_max: Optional[int] = None,
                 max_queue: int = 64, validate=None,
                 default_timeout_s: Optional[float] = None,
                 retry_after_s: float = 1.0,
                 watchdog_timeout_s: Optional[float] = 30.0,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0,
                 replica_max_queue: Optional[int] = None,
                 monitor_poll_s: Optional[float] = None,
                 scale_poll_s: float = 0.25,
                 scale_up_queue: int = 2,
                 idle_grace_s: float = 10.0,
                 spawn_cooldown_s: float = 1.0,
                 max_restarts: int = 8,
                 restart_backoff_s: float = 0.5,
                 restart_backoff_cap_s: float = 10.0):
        if proc_replicas_killed():
            raise RuntimeError(
                "subprocess replicas are disabled "
                "(TTD_NO_PROC_REPLICAS=1); use in-process replicas")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        scale_min = replicas if scale_min is None else int(scale_min)
        scale_max = (max(replicas, scale_min) if scale_max is None
                     else int(scale_max))
        if not 1 <= scale_min <= scale_max:
            raise ValueError(
                f"need 1 <= scale_min ({scale_min}) <= scale_max "
                f"({scale_max})")
        if not scale_min <= replicas <= scale_max:
            raise ValueError(
                f"replicas ({replicas}) must lie in "
                f"[scale_min={scale_min}, scale_max={scale_max}]")
        self._spec = spec
        self._scale_min = scale_min
        self._scale_max = scale_max
        self._scale_poll_s = scale_poll_s
        self._scale_up_queue = max(1, int(scale_up_queue))
        self._idle_grace_s = idle_grace_s
        self._spawn_cooldown_s = spawn_cooldown_s
        self._max_restarts = max_restarts
        self._restart_backoff_s = restart_backoff_s
        self._restart_backoff_cap_s = restart_backoff_cap_s
        self._next_idx = replicas
        self._restarts = 0
        self._respawn_streak = 0
        self._respawn_at = 0.0
        self._idle_since: Optional[float] = None
        self._last_spawn_t = 0.0
        self._budget_logged = False
        super().__init__([spec] * replicas, max_queue=max_queue,
                         validate=validate,
                         default_timeout_s=default_timeout_s,
                         retry_after_s=retry_after_s,
                         watchdog_timeout_s=watchdog_timeout_s,
                         backoff_base_s=backoff_base_s,
                         backoff_cap_s=backoff_cap_s,
                         replica_max_queue=replica_max_queue,
                         monitor_poll_s=monitor_poll_s)
        self._scaler_thread = threading.Thread(
            target=self._scale_loop, name="proc-scaler", daemon=True)

    def _make_replica(self, idx: int, spec) -> Replica:
        return _SpecReplica(idx, spec,
                            max_queue=self._replica_max_queue,
                            default_timeout_s=self._default_timeout_s,
                            retry_after_s=self._retry_after_s)

    def start(self) -> "ProcPool":
        super().start()
        self._scaler_thread.start()
        return self

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the fleet is SERVING-ready: at least
        ``scale_min`` replicas finished their HELLO handshake (engine
        built + warm in the child) and are still usable — launchers
        call this before advertising the port, the warm-up analog.
        Survives a worker that dies BEFORE its HELLO (bad flags, OOM
        mid-compile): the corpse stays visible in the replica list
        but stops being waited on, the scaler's respawns count as
        they come up, and a fleet that cannot reach ``scale_min``
        returns False at the timeout instead of blocking on a corpse
        forever."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            ready = sum(1 for rep in self._replicas
                        if rep.usable() and rep.driver.ready())
            if ready >= self._scale_min:
                return True
            if (deadline is not None
                    and time.monotonic() >= deadline):
                return False
            time.sleep(0.05)

    def restarts_total(self) -> int:
        return self._restarts

    def degraded(self) -> bool:
        """Reduced capacity means fewer USABLE workers than the floor
        the operator asked for — dead corpses kept visible for
        /healthz forensics do not count against a fleet the scaler
        already respawned back to strength."""
        return self.alive_count() < self._scale_min

    # -- elasticity ------------------------------------------------------

    def _restart_budget_left(self) -> bool:
        return self._restarts < self._max_restarts

    def _placement_may_recover(self) -> bool:
        """A dead fleet with respawn budget left recovers on its own:
        pumps wait (bounded by their deadlines) instead of failing."""
        return not self.is_draining() and self._restart_budget_left()

    @thread_role("scaler")
    def _scale_loop(self) -> None:
        while not self._stop.wait(self._scale_poll_s):
            if self.is_draining():
                continue
            try:
                self._scale_once()
            except Exception:       # noqa: BLE001 — scaler must survive
                logger.exception("proc-pool scaler pass failed")

    def _hbm_scale_cap(self) -> int:
        """The worker-packing half of the scale-up bound: workers
        whose HELLO advertised an HBM budget divide into the host's
        ``TTD_HBM_BYTES``; either side unknown → no clamp (a very
        large sentinel, so ``min`` with scale_max is a no-op).  Uses
        the LARGEST advertised budget — workers are interchangeable
        (one shared spec), so any difference is transient handshake
        skew and the conservative read wins."""
        per = max((int(getattr(r.engine, "hbm_budget_bytes", 0) or 0)
                   for r in self._replicas), default=0)
        cap = worker_pack_cap(_host_hbm_bytes(), per)
        return cap if cap is not None else sys.maxsize

    def _scale_once(self) -> None:
        now = time.monotonic()
        reps = self._replicas
        usable = [r for r in reps if r.usable()]
        accepting = [r for r in reps if r.accepting()]
        # 1) Respawn toward scale_min after deaths, under the restart
        # budget, with exponential backoff (a crash-looping engine —
        # bad checkpoint, poisoned config — must not fork-bomb).
        if len(usable) < self._scale_min:
            self._idle_since = None
            if not self._restart_budget_left():
                if not self._budget_logged:
                    self._budget_logged = True
                    events.instant("replica/restart_budget_exhausted",
                                   restarts=self._restarts)
                    logger.error(
                        "worker restart budget exhausted after %d "
                        "respawns; pool stays at %d usable replicas",
                        self._restarts, len(usable))
                return
            if now < self._respawn_at:
                return
            self._restarts += 1
            self._respawn_streak += 1
            backoff = min(
                self._restart_backoff_cap_s,
                self._restart_backoff_s * 2 ** (self._respawn_streak
                                                - 1))
            self._respawn_at = now + backoff
            m = self._metrics
            counter = getattr(m, "replica_restarts", None)
            if counter is not None:
                counter.inc()
            self._spawn("respawn")
            return
        self._respawn_streak = 0
        # 2) Scale up under queue pressure — capped by BOTH the
        # configured scale_max and the HBM worker-packing arithmetic
        # (how many HELLO-advertised per-worker budgets fit the host's
        # accelerator memory; unknown budgets leave scale_max alone).
        if (len(accepting) < min(self._scale_max,
                                 self._hbm_scale_cap())
                and now - self._last_spawn_t >= self._spawn_cooldown_s
                and self.waiting() > self._scale_up_queue
                * max(1, len(accepting))):
            self._idle_since = None
            self._spawn("scale_up")
            return
        # 3) Scale down at sustained idle — ONE draining worker at a
        # time (the staged-drain rule), never below scale_min.  With
        # live migration available the idle test relaxes to a PACK
        # test: the tail worker may still hold lanes as long as the
        # rest of the accepting fleet has spare slots for all of them
        # — `_evacuate` moves the streams, then the (now-empty) victim
        # drains.  Long-tail stragglers stop pinning fleet size.
        packable = False
        if (len(accepting) > self._scale_min and self.waiting() == 0
                and self.active_slots() > 0
                and not migration_killed()):
            tail = accepting[-1]
            lanes = tail.driver.active_slots()
            spare = sum(max(0, r.slots - r.driver.active_slots())
                        for r in accepting if r is not tail)
            packable = lanes <= spare
        if (len(accepting) > self._scale_min
                and self.waiting() == 0
                and (self.active_slots() == 0 or packable)):
            if self._idle_since is None:
                self._idle_since = now
            elif (now - self._idle_since >= self._idle_grace_s
                    and not any(r.state() == "draining" for r in reps)):
                victim = accepting[-1]
                events.instant("replica/scale_down",
                               replica=victim.idx)
                logger.info("idle %.1fs: draining worker %d "
                            "(%d accepting, scale_min %d)",
                            now - self._idle_since, victim.idx,
                            len(accepting), self._scale_min)
                self._evacuate(victim)
                victim.driver.drain()
        else:
            self._idle_since = None
        # 4) Prune fully-drained scale-down workers from the published
        # snapshot (dead replicas stay visible — operators read their
        # classification in /healthz; drained ones left on purpose).
        gone = [r for r in reps if r.state() == "drained"]
        if gone:
            self._replicas = [r for r in reps if r not in gone]

    def _spawn(self, kind: str) -> None:
        idx = self._next_idx
        self._next_idx += 1
        rep = self._make_replica(idx, self._spec)
        rep.driver.start()
        # Publish AFTER start: readers must never see a replica whose
        # driver has no process yet.
        self._replicas = self._replicas + [rep]
        self._last_spawn_t = time.monotonic()
        events.instant("replica/spawn", replica=idx, kind=kind)
        logger.info("spawned worker %d (%s); fleet=%d", idx, kind,
                    len(self._replicas))
