"""Always-on flight recorder: spans/instants in a bounded ring buffer.

The forensic layer the metrics scrape surface is not: ``/metrics``
aggregates (how many, how slow on average) — this module records the
TIMELINE (what happened to request X, why was step N slow), so
incidents on the overlap/interleave schedulers can be reconstructed
after the fact instead of reproduced under a profiler.  It is ON by
default and designed to stay on in production:

- recording is one lock-guarded ``deque.append`` of a small tuple —
  no I/O, no serialization, no allocation beyond the tuple and its
  attrs dict (measured ≤ 2 % serving tok/s against the kill switch;
  ``tools/bench_serving.py --trace-ab`` is the committed A/B);
- the buffer is a bounded ring (``TTD_TRACE_CAPACITY`` events, default
  65536): old events fall off the back, memory is O(capacity) forever;
- ``TTD_NO_TRACE=1`` is the kill switch: ``span()`` degrades to a
  shared no-op context manager and ``instant()`` to one dict lookup —
  an env flip, no redeploy (the ``TTD_NO_OVERLAP`` contract).
- ``TTD_TRACE_SPOOL=<dir>`` (off by default) adds the crash-durable
  layer: a flusher thread mirrors the ring into size-capped rotating
  JSONL segments (``TTD_TRACE_SPOOL_BYTES``, default 64 MiB/process),
  fsync-batched off the hot path, so the last seconds before a SIGKILL
  survive for ``tools/trace_report.py --post-mortem``.

Event model (exported as Chrome trace-event JSON, loadable in Perfetto
or ``chrome://tracing``):

- ``span(name, **attrs)`` — a context manager recording ONE complete
  event (``ph="X"``) at exit with monotonic start + duration.
  Recording at exit means the ring never holds an unbalanced begin.
- ``instant(name, **attrs)`` — a point event (``ph="i"``).
- timestamps are ``time.monotonic()`` (immune to wall-clock steps;
  the export carries a wall-clock anchor for cross-run alignment),
  ``tid`` is the recording thread's ident, ``pid`` the process.

Attrs are the correlation layer: the gateway driver tags request
lifecycle events with the ``request_id`` it minted at admission plus
the engine's ``rid`` once a slot is granted, the engine tags its
prefill/decode/retire events with ``rid``, and
``request_timeline()`` joins the two — the ``/v1/requests/<id>``
endpoint and ``tools/trace_report.py`` are its consumers.  Keep attr
values JSON-scalar (str/int/float/bool): the export serializes them
verbatim.

The JAX package's compile-discipline sanitizer records a
``compile/<site>`` span around every dispatch that compiles a new
signature; eager PyTorch compiles nothing per call, so in this package
``registry.compile_site`` is a declaration only and no such span is
recorded.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from tensorflow_train_distributed_torch.runtime.lint.registry import (
    concurrency_guarded,
    locks_held,
    thread_role,
)

_KILL_ENV = "TTD_NO_TRACE"
_CAPACITY_ENV = "TTD_TRACE_CAPACITY"
DEFAULT_CAPACITY = 65536

# -- crash-durable spool knobs --------------------------------------------
# ``TTD_TRACE_SPOOL=<dir>`` arms a per-process rotating JSONL spool: a
# flusher thread drains the ring through ``events_after`` every
# ``_SPOOL_FLUSH_S`` (write+flush per batch, fsync on the
# ``_SPOOL_FSYNC_S`` clock), so the recording hot path stays a
# deque.append and the disk sees the timeline at most one
# flush interval behind the crash.  Off by default — the ring alone is
# the production default; the spool is the post-mortem opt-in.
_SPOOL_ENV = "TTD_TRACE_SPOOL"
_SPOOL_BYTES_ENV = "TTD_TRACE_SPOOL_BYTES"
DEFAULT_SPOOL_BYTES = 64 << 20
_SPOOL_FLUSH_S = 0.25
#: Segments rotate at cap/4 (floor 1 MiB) and the oldest own segment is
#: unlinked once the per-process total would exceed the cap — disk use
#: is O(cap) forever, like the ring is O(capacity).
_SPOOL_MIN_SEGMENT = 1 << 20
#: Events per ``{"b": [...]}`` spool line: large enough that the batch
#: json.dumps amortizes (one C-level call per ~512 events, not one per
#: event), small enough that a line stays ~100 KiB and segment caps
#: are enforced at line granularity.
_SPOOL_BATCH_EVENTS = 512
#: fsync cadence.  Every batch is write()+flush()ed — that alone
#: survives PROCESS death (the post-mortem case: the kernel still owns
#: the pages when a worker is SIGKILLed); fsync only adds machine-
#: death durability and costs milliseconds on ext4, so it runs on a
#: clock instead of per batch.  Rotation and the final drain/SIGTERM
#: flush always fsync.
_SPOOL_FSYNC_S = 2.0

# Event tuple layout (kept flat — one small allocation per event):
# (name, ph, t0_monotonic_s, dur_s, tid, attrs_dict_or_None)


# The kill check runs per event on serving's per-chunk path, and
# ``os.environ.get`` costs ~1 us (encode + mapping indirection) vs
# ~0.14 us for the raw ``_data`` dict CPython keeps underneath (posix:
# fsencoded-bytes keys, kept in sync by __setitem__/__delitem__ — so
# monkeypatch.setenv flips it live too).  Fall back to the public API
# where the private layout differs.


def make_env_flag_reader(env_name: str):
    """A ``() -> bool`` truthiness reader for one env flag, using the
    ``os.environ._data`` fast path when the layout allows — THE shared
    implementation of every per-event/per-dispatch live kill switch
    (``TTD_NO_TRACE`` here, ``TTD_NO_COMPILECHECK`` in
    runtime.lint.compilecheck), so the subtle layout probe lives
    once."""
    try:
        env_data = os.environ._data
        key = os.fsencode(env_name)
        # Layout probe: the fast path needs bytes keys (posix).  A
        # str-keyed _data (Windows) would make .get() return None
        # forever — silently disabling the kill switch — so check the
        # key type, not just that .get() doesn't raise.
        if not isinstance(next(iter(env_data)), bytes):
            raise TypeError("os.environ._data keys are not bytes")

        def read() -> bool:
            v = env_data.get(key)
            return v is not None and v not in (b"", b"0")
    except (AttributeError, TypeError, StopIteration):  # pragma: no cover
        def read() -> bool:
            return os.environ.get(env_name, "0") not in ("", "0")
    return read


#: ``TTD_NO_TRACE=1`` disables recording process-wide (re-read per
#: event, so a test or an operator shell can flip it live).
trace_killed = make_env_flag_reader(_KILL_ENV)


class _Span:
    """One recording span: appends a single complete event at exit."""

    __slots__ = ("_rec", "_name", "_attrs", "t0")

    def __init__(self, rec: "Recorder", name: str, attrs: Optional[dict]):
        self._rec = rec
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic()
        self._rec._append(self._name, "X", self.t0, t1 - self.t0,
                          self._attrs)
        return False


class _NullSpan:
    """The kill-switch span: no clock reads, no append, one shared
    instance."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()

# Per-thread default attrs (module-level: one store shared by every
# recorder).  A replica's driver thread sets {"replica": k} once and
# every engine/driver event it records carries the id — the
# correlation key multi-replica forensics needs, with zero per-call
# plumbing through the engine.
_TLS = threading.local()


def set_thread_attrs(**attrs) -> None:
    """Replace THIS thread's default event attrs (merged under any
    per-event attrs at record time; call with no kwargs to clear).
    The pool's driver and pump threads tag themselves with
    ``replica=k`` so engine-side events — which know nothing about
    replicas — land on the right timeline."""
    _TLS.attrs = dict(attrs) if attrs else None


def get_thread_attrs() -> Optional[dict]:
    return getattr(_TLS, "attrs", None)


@concurrency_guarded
class Recorder:
    """Lock-cheap bounded ring buffer of trace events.

    Threads append concurrently (driver loop, HTTP handlers, trainer
    host thread); readers snapshot under the same lock.  The lock is
    held for one ``deque.append`` / one ``list()`` copy — never across
    user code.
    """

    # Every thread role appends; every access locks (ttd-lint's
    # concurrency checker + TTD_LOCKCHECK=1 enforce it stays so).
    # The spool state dict is shared by the flusher thread and any
    # thread calling flush_spool()/stop_spool() (worker drain, tests).
    _GUARDED_BY = {"_buf": ("_lock",), "_seq": ("_lock",),
                   "_spool": ("_spool_lock",)}

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.pid = os.getpid()
        self._buf: deque = deque(maxlen=capacity)
        # Total events ever appended — the cursor feed for
        # ``events_after`` (a subprocess worker's event-relay loop
        # ships only what it has not shipped yet; a deque index would
        # shift as the ring drops old events, a running sequence does
        # not).
        self._seq = 0
        self._lock = threading.Lock()
        # Wall-clock anchor: wall time at monotonic ``_anchor_mono`` —
        # lets offline tooling place the monotonic timeline in real
        # time (e.g. against a supervisor journal's ``time.time()``).
        self._anchor_mono = time.monotonic()
        self._anchor_wall = time.time()
        # Crash-durable spool (None until armed).  Auto-arms when
        # ``TTD_TRACE_SPOOL`` names a directory: subprocess workers
        # inherit the env, so one flag spools the whole fleet — each
        # process into its own pid-named segments.
        self._spool: Optional[dict] = None
        self._spool_lock = threading.Lock()
        self._spool_stop = threading.Event()
        if os.environ.get(_SPOOL_ENV, ""):
            try:
                self.start_spool()
            except OSError:
                # An unwritable spool dir must not take the process —
                # the ring (the production surface) still works.
                pass

    @property
    def enabled(self) -> bool:
        return not trace_killed()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def _append(self, name: str, ph: str, t0: float, dur: float,
                attrs: Optional[dict]) -> None:
        base = getattr(_TLS, "attrs", None)
        if base:
            # Per-event attrs win over the thread defaults.
            attrs = {**base, **(attrs or {})}
        ev = (name, ph, t0, dur, threading.get_ident(), attrs or None)
        with self._lock:
            self._buf.append(ev)
            self._seq += 1

    # -- recording api ---------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager timing its block into one complete event
        (``ph="X"``); a no-op singleton under the kill switch.

        Repeated spans of one name within a step are the sub-span
        convention (no nesting needed): the bucketed-overlap trainer
        emits one ``train/grad_comm`` / ``train/optimizer_apply`` span
        PER BUCKET, tagged ``bucket=<i>, buckets=<K>`` in attrs, plus a
        single ``train/step_barrier`` span at the only host-blocking
        point — trace_report groups same-name spans per step and breaks
        them out per bucket when the ``bucket`` attr is present."""
        if trace_killed():
            return _NULL_SPAN
        return _Span(self, name, attrs or None)

    def instant(self, name: str, **attrs) -> None:
        """Record a point event (``ph="i"``)."""
        if trace_killed():
            return
        self._append(name, "i", time.monotonic(), 0.0, attrs or None)

    def record_at(self, name: str, ph: str, t0: float, dur: float = 0.0,
                  attrs: Optional[dict] = None) -> None:
        """Record one event with a CALLER-supplied timestamp — the
        relay path for events that happened in another process (a
        subprocess replica ships its recorder's events in stats frames;
        the parent re-records them mapped into its own monotonic
        domain so ``request_timeline`` joins both lives of a
        failed-over request).  Honors the kill switch like every
        recording entry point."""
        if trace_killed():
            return
        self._append(name, ph if ph in ("X", "i") else "i", t0,
                     dur if ph == "X" else 0.0, dict(attrs or {}) or None)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    # -- query / export --------------------------------------------------

    def events(self, last_s: Optional[float] = None) -> list:
        """Snapshot of the ring (oldest first), optionally only events
        whose END falls inside the trailing ``last_s`` seconds."""
        with self._lock:
            items = list(self._buf)
        if last_s is not None:
            cutoff = time.monotonic() - last_s
            items = [e for e in items if e[2] + e[3] >= cutoff]
        return items

    def events_after(self, cursor: int) -> tuple:
        """``(new_cursor, events)``: every event appended since
        ``cursor`` (a value previously returned here; 0 = everything
        still in the ring).  The cursor is the recorder's running
        append sequence, so it stays exact while the bounded ring
        drops old events — events that fell off the back before being
        read are simply gone (the ring's contract), never re-delivered
        and never double-delivered.  The subprocess worker's stats
        loop is the consumer: each frame ships exactly the new tail."""
        with self._lock:
            seq = self._seq
            fresh = seq - int(cursor)
            if fresh <= 0:
                return seq, []
            n = len(self._buf)
            if fresh >= n:
                items = list(self._buf)
            else:
                # O(tail) copy, not O(capacity): the stats loop and
                # the spool flusher each poll a few times a second,
                # and list(deque) walks the whole ring every poll.
                rev = reversed(self._buf)
                items = [next(rev) for _ in range(fresh)]
                items.reverse()
        return seq, items

    def request_timeline(self, request_id: int) -> list:
        """Every event belonging to gateway request ``request_id``,
        sorted by start time: driver events tagged ``request_id``
        (from the LATEST admission of that id — ids restart per driver,
        forensics wants the most recent life) joined with engine events
        tagged with the ``rid`` each engine-submit recorded, scoped to
        [engine-submit, next engine-submit or retire] so a reused
        engine rid from another session cannot bleed in.  A replica
        pool's request has ONE ``request/pool_admitted`` anchor (which
        outranks the per-life ``request/admitted`` events — failover
        re-admits the same id on a survivor, and the timeline must
        show both lives plus the hop) and possibly several
        engine-submit segments, each additionally keyed on its
        ``replica`` attr so two replicas' identical engine rids never
        cross-join."""
        evs = self.events()
        admit_t = pool_t = solo_t = None
        for e in evs:               # latest admission wins, per kind
            a = e[5]
            if a is None or a.get("request_id") != request_id:
                continue
            if e[0] == "request/pool_admitted":
                pool_t = e[2]
            elif e[0] == "request/admitted":
                admit_t = e[2]
                # A per-life admission on a pool replica carries the
                # replica id; a STANDALONE driver's does not.  Only
                # the latter may outrank a pool anchor — a newer
                # single-driver request reusing the id (driver ids
                # restart per driver) must not join a stale pool
                # life's events, and vice versa a failover's per-life
                # re-admissions must never displace their own pool
                # anchor.
                if a.get("replica") is None:
                    solo_t = e[2]
        if pool_t is not None and (solo_t is None or pool_t > solo_t):
            admit_t = pool_t
        out = []
        segs: list = []           # [rid, replica, grant_t, hi] per life
        retire_t = None
        for e in evs:
            a = e[5]
            if (a is None or a.get("request_id") != request_id
                    or (admit_t is not None and e[2] < admit_t)):
                continue
            out.append(e)
            if e[0] == "request/engine_submit" and "rid" in a:
                if segs:        # previous life ends where this begins
                    segs[-1][3] = min(segs[-1][3], e[2])
                segs.append([a["rid"], a.get("replica"), e[2],
                             float("inf")])
            if e[0] == "request/retire":
                retire_t = e[2]
        if segs and retire_t is not None and retire_t >= segs[-1][2]:
            # hi is exact: the EngineDriver's retire follows every engine
            # event of the request (the harvest trim guard keeps a
            # retired rid from ever being tagged again).
            segs[-1][3] = min(segs[-1][3], retire_t)
        for rid, replica, grant_t, hi in segs:
            # lo is padded: the engine's own queued instant fires just
            # BEFORE the EngineDriver records the engine-submit join anchor.
            lo = grant_t - 1e-3
            for e in evs:
                a = e[5]
                if (a is not None and "request_id" not in a
                        and a.get("rid") == rid and lo <= e[2] <= hi
                        and (replica is None
                             or a.get("replica") in (None, replica))):
                    out.append(e)
        out.sort(key=lambda e: e[2])
        return out

    def export_chrome_trace(self, last_s: Optional[float] = None) -> dict:
        """Chrome trace-event JSON (the ``traceEvents`` array form):
        every event carries ``name``/``ph``/``ts``/``pid``/``tid``
        (ts/dur in microseconds), spans are complete events (``X``) so
        the trace is balanced by construction — load the dict's JSON in
        Perfetto or ``chrome://tracing`` as-is."""
        trace_events = []
        for name, ph, t0, dur, tid, attrs in self.events(last_s):
            ev = {
                "name": name,
                "cat": name.split("/", 1)[0],
                "ph": ph,
                "ts": round(t0 * 1e6, 3),
                "pid": self.pid,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            elif ph == "i":
                ev["s"] = "t"          # thread-scoped instant
            if attrs:
                ev["args"] = dict(attrs)
            trace_events.append(ev)
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {
                "pid": self.pid,
                "capacity": self.capacity,
                "clock": "monotonic_us",
                "wall_anchor_s": self._anchor_wall,
                "mono_anchor_us": round(self._anchor_mono * 1e6, 3),
                "killed": trace_killed(),
            },
        }

    def save(self, path: str, last_s: Optional[float] = None) -> None:
        with open(path, "w") as f:
            json.dump(self.export_chrome_trace(last_s), f)

    # -- crash-durable spool ---------------------------------------------
    #
    # The ring answers "what happened" only while the process is alive
    # to be asked.  The spool is the same timeline made to survive the
    # asker: ``spool-<pid>-<n>.jsonl`` segments, each opened with a
    # header line carrying the pid and the wall/monotonic anchor pair
    # (so offline tooling can place a dead process's monotonic
    # timestamps in real time), then one compact ``{"b": [...]}``
    # batch line per flush — event arrays in ring-tuple order.  A
    # flusher thread drains ``events_after`` every flush interval
    # (write+flush per batch, fsync on a clock — see
    # ``_SPOOL_FSYNC_S``); if the ring laps the flusher, an honest
    # ``{"dropped": n}`` line marks the gap.
    # ``tools/trace_report.py --post-mortem`` is the consumer.

    def start_spool(self, directory: Optional[str] = None) -> Optional[str]:
        """Arm the crash-durable spool into ``directory`` (default: the
        ``TTD_TRACE_SPOOL`` env var; no-op returning None when unset).
        Idempotent — a second call returns the armed directory."""
        directory = directory or os.environ.get(_SPOOL_ENV, "")
        if not directory:
            return None
        with self._spool_lock:
            if self._spool is not None:
                return self._spool["dir"]
            os.makedirs(directory, exist_ok=True)
            raw = os.environ.get(_SPOOL_BYTES_ENV, "")
            cap = int(raw) if raw else DEFAULT_SPOOL_BYTES
            self._spool = {
                "dir": directory,
                "cap": max(cap, 2 * _SPOOL_MIN_SEGMENT),
                "seg_cap": max(cap // 4, _SPOOL_MIN_SEGMENT),
                "cursor": 0,      # events_after sequence already spooled
                "seg": 0,
                "fh": None,
                "path": "",
                "written": 0,     # bytes in the open segment
                "segments": [],   # [(path, bytes)] closed, oldest first
                "dropped": 0,
                "last_fsync": time.monotonic(),
            }
            self._spool_open_segment()
        self._spool_stop.clear()
        t = threading.Thread(target=self._spool_loop, name="trace-spool",
                             daemon=True)
        t.start()
        return directory

    @locks_held("_spool_lock")
    def _spool_open_segment(self) -> None:
        """Rotate to a fresh segment, then unlink our own oldest closed
        segments until the per-process total fits the byte cap."""
        st = self._spool
        fh = st["fh"]
        if fh is not None:
            try:
                fh.flush()
                os.fsync(fh.fileno())
                st["last_fsync"] = time.monotonic()
                fh.close()
            except OSError:
                pass
            st["segments"].append((st["path"], st["written"]))
        st["seg"] += 1
        path = os.path.join(
            st["dir"], f"spool-{self.pid}-{st['seg']:04d}.jsonl")
        fh = open(path, "wb")
        header = json.dumps({
            "spool": 1,
            "pid": self.pid,
            "segment": st["seg"],
            "capacity": self.capacity,
            "wall_anchor_s": self._anchor_wall,
            "mono_anchor_s": self._anchor_mono,
            "open_wall_s": time.time(),
            "open_mono_s": time.monotonic(),
        }, separators=(",", ":")).encode() + b"\n"
        fh.write(header)
        st["fh"], st["path"], st["written"] = fh, path, len(header)
        total = st["written"] + sum(b for _, b in st["segments"])
        while st["segments"] and total > st["cap"]:
            old_path, old_bytes = st["segments"].pop(0)
            try:
                os.unlink(old_path)
            except OSError:
                pass
            total -= old_bytes

    @locks_held("_spool_lock")
    def _spool_flush_once(self, force_fsync: bool = False) -> int:
        """Drain the ring's new tail to disk (write+flush per batch,
        fsync on the ``_SPOOL_FSYNC_S`` clock or when forced); returns
        the number of events written.  An OSError (full disk, revoked
        dir) disables the spool but must never take the process — the
        ring keeps working."""
        st = self._spool
        if st is None or st["fh"] is None:
            return 0
        cursor, evs = self.events_after(st["cursor"])
        fresh = cursor - st["cursor"]
        st["cursor"] = cursor
        if fresh <= 0:
            return 0
        chunks = []
        if fresh > len(evs):
            st["dropped"] += fresh - len(evs)
            chunks.append(json.dumps(
                {"dropped": fresh - len(evs),
                 "mono_s": round(time.monotonic(), 6)},
                separators=(",", ":")).encode() + b"\n")
        # One dumps call per ``{"b": [[...], ...]}`` batch line,
        # straight from the ring tuples: per-event dumps costs ~7 µs
        # an event and the flusher shares a core (and a GIL) with the
        # serving threads it is observing — on a small host that read
        # as tok/s overhead in the --trace-fleet-ab bench.  Batches
        # are sliced so one line stays line-sized and the segment cap
        # is enforced between slices, not after a megabyte write.  A
        # torn tail line loses at most one slice of one flush window
        # (~0.25 s) — the window an unflushed ring loses anyway.
        for lo in range(0, len(evs), _SPOOL_BATCH_EVENTS):
            chunks.append(json.dumps(
                {"b": evs[lo:lo + _SPOOL_BATCH_EVENTS]},
                separators=(",", ":"), default=str).encode() + b"\n")
        try:
            for data in chunks:
                if st["written"] >= st["seg_cap"]:
                    self._spool_open_segment()
                st["fh"].write(data)
                st["written"] += len(data)
            st["fh"].flush()
            now = time.monotonic()
            if force_fsync or now - st["last_fsync"] >= _SPOOL_FSYNC_S:
                os.fsync(st["fh"].fileno())
                st["last_fsync"] = now
        except OSError:
            try:
                st["fh"].close()
            except OSError:
                pass
            st["fh"] = None
        return len(evs)

    @thread_role("watchdog")
    def _spool_loop(self) -> None:
        while not self._spool_stop.wait(_SPOOL_FLUSH_S):
            with self._spool_lock:
                if self._spool is None or self._spool["fh"] is None:
                    return
                self._spool_flush_once()

    def flush_spool(self) -> int:
        """Synchronously drain the ring to the spool and fsync — the
        worker's final-flush hook on drain/SIGTERM, and the test seam.
        Returns events written (0 when the spool is not armed)."""
        with self._spool_lock:
            return self._spool_flush_once(force_fsync=True)

    def stop_spool(self) -> None:
        """Final flush, close the open segment, disarm."""
        self._spool_stop.set()
        with self._spool_lock:
            self._spool_flush_once(force_fsync=True)
            st = self._spool
            if st is not None and st["fh"] is not None:
                try:
                    st["fh"].flush()
                    os.fsync(st["fh"].fileno())
                    st["fh"].close()
                except OSError:
                    pass
                st["fh"] = None
            self._spool = None

    def spool_info(self) -> Optional[dict]:
        """Armed-spool status for health surfaces (None when off)."""
        with self._spool_lock:
            st = self._spool
            if st is None:
                return None
            return {
                "dir": st["dir"],
                "segment": st["seg"],
                "written_bytes": st["written"],
                "segments": len(st["segments"]) + 1,
                "dropped": st["dropped"],
                "active": st["fh"] is not None,
            }


# -- process-global recorder ---------------------------------------------

_cap = os.environ.get(_CAPACITY_ENV, "")
_RECORDER = Recorder(int(_cap) if _cap else DEFAULT_CAPACITY)
del _cap


def get_recorder() -> Recorder:
    return _RECORDER


def span(name: str, **attrs):
    """``with events.span("decode/harvest", rid=3): ...`` on the
    process-global recorder."""
    return _RECORDER.span(name, **attrs)


def instant(name: str, **attrs) -> None:
    _RECORDER.instant(name, **attrs)


class _DeviceSpan:
    """``span`` whose block ends when ``device`` has run the work queued
    in it (``torch.cuda.synchronize``) while recording is on: the span
    meters device time, as a JAX span that blocks on its result does."""

    __slots__ = ("_span", "_device")

    def __init__(self, span_cm, device):
        self._span = span_cm
        self._device = device

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if exc[0] is None and self._device.type == "cuda":
            import torch

            torch.cuda.synchronize(self._device)
        return self._span.__exit__(*exc)


def device_span(name: str, device, **attrs):
    """``span(name, **attrs)`` that, on a CUDA ``device`` (a
    ``torch.device``), waits for the block's queued device work before it
    ends.  Under the kill switch it records nothing and waits for
    nothing."""
    if trace_killed():
        return _NULL_SPAN
    return _DeviceSpan(_RECORDER.span(name, **attrs), device)
