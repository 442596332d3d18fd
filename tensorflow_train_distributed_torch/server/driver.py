"""Engine driver: the thread-safe submission bridge over ServingEngine.

The engine is a single-threaded object (a host loop launching eager
PyTorch and the port's CUDA kernels); the gateway is many handler
threads.  This
module is the ONE place they meet: a background driver thread owns
every mutating engine call, handler threads hand it work through a
bounded admission deque and get a ``RequestHandle`` (a future) back.
Between decode chunks — ``ServingEngine.serve_step()`` hands control
back exactly for this — the driver refills the engine's queue from
admissions, resolves finished requests, streams newly committed tokens,
and enforces per-request deadlines (``engine.cancel`` frees the slot —
including a slot still STAGED mid-prefill under the engine's
interleaved prefill scheduler: the deadline sweep below covers
requests that have produced no tokens yet, and a cancelled staged
prefill frees its lane immediately).
With the engine's async decode pipelining (the default), ``serve_step``
returns WITH A CHUNK STILL IN FLIGHT, so every one of those host passes
— harvest/stream/deadline after the step, admission refill before the
next — runs inside the overlap window while the device computes; the
loop body needs no special casing, only this ordering.  No device code
runs anywhere else, so the bridge composes with every engine
configuration (sampling, int8, speculative, TP meshes) untouched.

Load shedding happens at ``submit()``: requests waiting for a lane
(admitted here + queued inside the engine) are capped at ``max_queue``;
beyond it ``AdmissionFull`` tells the frontend to answer 429 with a
Retry-After.  With the engine's paged KV cache (the default), a lane
grant is keyed on FREE BLOCKS, not free slots: the engine refuses a
claim the pool cannot back and the request stays queued — so the
waiting() gauge (and therefore the 429 threshold) reflects memory
pressure, not just slot occupancy, and a request that could NEVER fit
(more blocks than the whole pool) is rejected at ``submit()`` as a
RequestError by the engine's validator.  Draining flips one flag: new
submissions get ``Draining`` (503) while in-flight work finishes
normally.
"""

from __future__ import annotations

import inspect
import logging
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

from tensorflow_train_distributed_torch.runtime import events, faults
from tensorflow_train_distributed_torch.runtime.lint.registry import (
    concurrency_guarded,
    locks_held,
    thread_role,
)

logger = logging.getLogger(__name__)

_DONE = object()          # stream sentinel: request finished cleanly

# Terminal statuses remembered per request id for /v1/requests/<id>
# forensics (bounded: oldest evicted).
_TERMINAL_KEEP = 4096


class RequestError(ValueError):
    """Bad request payload (HTTP 400)."""


class AdmissionFull(RuntimeError):
    """Admission queue at capacity — shed (HTTP 429)."""

    def __init__(self, waiting: int, retry_after_s: float):
        super().__init__(f"admission queue full ({waiting} waiting); "
                         f"retry after {retry_after_s:g}s")
        self.retry_after_s = retry_after_s


class Draining(RuntimeError):
    """Gateway is draining — not admitting (HTTP 503)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before completion (HTTP 504)."""


class _PendingCall:
    """One queued ``EngineDriver.call``: a closure to run on the driver
    thread plus the future its caller blocks on."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def _run(self, engine) -> None:
        try:
            self._result = self._fn(engine)
        except BaseException as e:      # noqa: BLE001 — relay to caller
            self._error = e
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()


class RequestHandle:
    """Caller's future for one submitted request.

    ``result()`` blocks for the full token list (prompt + generated,
    the serve.py convention).  With ``stream=True``, ``iter_tokens()``
    yields lists of GENERATED tokens as the driver commits them
    (chunk-granular) and raises the terminal error, if any, at the end
    — exactly one of the two accessors should be used per request.
    """

    def __init__(self, req_id: int, prompt: list, max_new: int,
                 seed: Optional[int], stream: bool,
                 deadline: Optional[float], resume_from: int = 0):
        self.id = req_id
        self.prompt = prompt
        self.max_new = max_new
        self.seed = seed
        self.stream = stream
        self.deadline = deadline
        self.resume_from = resume_from   # failover re-admission offset
        self.t_submit = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.last_commit_at: Optional[float] = None  # inter-token feed
        self.slot_granted_at: Optional[float] = None  # queue_wait feed
        self._streamed = len(prompt)    # tokens already pushed/known
        self._queue: Optional[queue.Queue] = (
            queue.Queue() if stream else None)
        self._done = threading.Event()
        self._tokens: Optional[list] = None
        self._error: Optional[BaseException] = None

    # -- driver side -----------------------------------------------------

    def _push_new(self, tokens: list) -> int:
        """Stream tokens beyond what was already pushed; returns how
        many were new (the driver's token-counter feed)."""
        new = tokens[self._streamed:]
        if new and self._queue is not None:
            self._queue.put(list(new))
        self._streamed = len(tokens)
        return len(new)

    def _resolve(self, tokens: Optional[list],
                 error: Optional[BaseException]) -> None:
        self._tokens, self._error = tokens, error
        if self._queue is not None:
            self._queue.put(error if error is not None else _DONE)
        self._done.set()

    # -- caller side -----------------------------------------------------

    def result(self, timeout: Optional[float] = None) -> list:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} still running")
        if self._error is not None:
            raise self._error
        return list(self._tokens)

    def iter_tokens(self):
        """Yield lists of generated tokens until the request finishes."""
        if self._queue is None:
            raise RuntimeError("request was not submitted with stream=True")
        while True:
            item = self._queue.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def done(self) -> bool:
        return self._done.is_set()


@concurrency_guarded
class EngineDriver:
    """Background thread owning a ``ServingEngine``; concurrent-safe
    ``submit()`` for everyone else.

    ``validate``: optional callable ``(prompt, max_new, seed) -> None``
    raising ``RequestError`` — the CLI hangs vocab screening
    (``check_vocab_ids``) here so the library stays tokenizer-agnostic.
    ``metrics``: a ``GatewayMetrics`` (optional — the driver works bare
    for library use/tests).
    """

    # Every cross-thread structure is ``_cv``-guarded for ALL access —
    # including the driver loop's own: the loop MUTATES these while
    # handler threads iterate them under the lock, and a lock-free
    # owner write would race the locked readers (the `_inflight` del
    # vs ``request_status`` iteration bug ttd-lint's concurrency
    # checker now catches statically and TTD_LOCKCHECK=1 at runtime).
    # Deliberately NOT declared (single-field atomic publishes with
    # read-only consumers): _step_t0, _steps_done, _dispatch_n,
    # _vanished.
    _GUARDED_BY = {
        "_admit": ("_cv",),
        "_inflight": ("_cv",),
        "_terminal": ("_cv",),
        "_draining": ("_cv",),
        "_failed": ("_cv",),
        "_poisoned": ("_cv",),
        "_calls": ("_cv",),
    }

    def __init__(self, engine, *, max_queue: int = 64,
                 validate: Optional[Callable] = None,
                 metrics=None, default_timeout_s: Optional[float] = None,
                 retry_after_s: float = 1.0,
                 replica_id: Optional[int] = None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._engine = engine
        self._validate = validate
        self._metrics = metrics
        self._max_queue = max_queue
        self._default_timeout_s = default_timeout_s
        self._retry_after_s = retry_after_s
        self._cv = threading.Condition()
        self._admit: deque = deque()       # RequestHandles not yet in engine
        self._inflight: dict = {}          # engine rid -> RequestHandle
        self._calls: deque = deque()       # _PendingCalls for the loop
        self._terminal: OrderedDict = OrderedDict()  # id -> final status
        self._next_id = 0
        self._draining = False
        self._failed: Optional[BaseException] = None
        # Fencing: a watchdog-declared-dead replica's loop thread may
        # still EXIST (wedged in a hung dispatch) — when it eventually
        # wakes it must not dispatch again (its requests failed over
        # long ago; a zombie driving the device — or consuming armed
        # chaos-fault budgets — corrupts whoever took over).  The pool
        # poisons the driver at declaration; the loop exits at its
        # next iteration instead of dispatching.
        self._poisoned: Optional[str] = None
        # Replica identity (None standalone): tagged onto this driver's
        # flight-recorder events (the loop thread via thread attrs,
        # caller-thread instants via _ev_attrs) and handed to the
        # serve:dispatch fault site, so chaos plans can target one
        # replica of a pool.
        self._replica_id = replica_id
        self._ev_attrs = ({} if replica_id is None
                          else {"replica": replica_id})
        # Hung-dispatch watchdog feed: monotonic start of the
        # serve_step in progress (None between steps).  Plain attribute
        # writes — atomic, read-only consumers.
        self._step_t0: Optional[float] = None
        self._dispatch_n = 0               # serve_step ordinal (faults)
        self._steps_done = 0               # completed serve_steps
        self._vanished = False             # kill9 fault: died unnotified
        # Does the engine speak resume-from-token admission?  Detected
        # once by signature: engines without it (test stubs, external
        # implementations) still serve failed-over requests — the
        # resumed tokens ride in the prompt either way — they just
        # cannot offset a sampling rng stream (greedy/deterministic
        # decode is unaffected).
        try:
            self._engine_resumes = (
                "resume_from" in inspect.signature(
                    engine.validate_request).parameters
                and "resume_from" in inspect.signature(
                    engine.submit).parameters)
        except (TypeError, ValueError):     # builtins / odd callables
            self._engine_resumes = False
        self._thread = threading.Thread(
            target=self._loop,
            name=("engine-driver" if replica_id is None
                  else f"engine-driver-{replica_id}"),
            daemon=True)

    # -- public api ------------------------------------------------------

    def start(self) -> "EngineDriver":
        self._thread.start()
        return self

    def set_metrics(self, metrics) -> None:
        """Late wiring: the gateway builds GatewayMetrics from THIS
        driver's occupancy callables, so the driver exists first."""
        self._metrics = metrics

    def waiting(self) -> int:
        """Requests admitted but not yet in a lane (the shed gauge):
        driver-side admissions plus the engine's own queue.  A request
        staged mid-prefill holds a lane already — it counts toward
        ``active_slots()``, not here.  (``_cv`` is a re-entrant
        Condition: ``submit()`` calls this while holding it.)"""
        with self._cv:
            return len(self._admit) + self._engine.queue_depth()

    def alive(self) -> bool:
        """Is the driver loop able to make progress?  False once the
        loop died (``failure()`` has the corpse) or after a drain
        finished — the signal /healthz and the ``driver_alive`` gauge
        expose so load balancers stop routing to a zombie gateway
        whose listener still accepts sockets."""
        with self._cv:
            failed = self._failed is not None
        return not failed and self._thread.is_alive()

    def failure(self) -> Optional[BaseException]:
        """The exception that killed the driver loop, if any."""
        with self._cv:
            return self._failed

    def vanished(self) -> bool:
        """True when the loop exited ABRUPTLY without notifying anyone
        (the in-process kill9 fault): no corpse in ``failure()``, no
        handles resolved — detectable only by liveness, exactly like a
        SIGKILLed subprocess replica."""
        return self._vanished

    def step_elapsed(self) -> float:
        """Seconds the serve_step in progress has been running (0.0
        between steps) — the hung-dispatch watchdog's feed: a healthy
        chunk completes in milliseconds-to-seconds, so an elapsed time
        past the watchdog deadline means the dispatch is wedged on the
        device (or a hang fault) and the replica must be declared dead
        even though its thread is technically alive."""
        t0 = self._step_t0
        return 0.0 if t0 is None else max(0.0, time.monotonic() - t0)

    def steps_completed(self) -> int:
        """Completed serve_steps — the watchdog's arming condition: a
        driver's FIRST dispatch pays one-time costs (the kernels' first
        load, cuBLAS handles), so the hung-dispatch deadline only
        applies once at least one step has completed.  (A dispatch that truly hangs before any completes
        still surfaces: requests there never commit, callers time out,
        and operators see step_elapsed() growing.)"""
        return self._steps_done

    def replica_id(self) -> Optional[int]:
        return self._replica_id

    def active_slots(self) -> int:
        return self._engine.active_slots()

    # "reader": the subprocess worker's frame loop submits parent
    # placements into its local driver (server.worker).
    @thread_role("handler", "pump", "main", "reader")
    def submit(self, prompt, max_new: int, *, seed: Optional[int] = None,
               stream: bool = False,
               timeout_s: Optional[float] = None,
               request_id: Optional[int] = None,
               resume_from: int = 0,
               requeue: bool = False) -> RequestHandle:
        """Admit one request; raises ``RequestError`` (bad payload),
        ``AdmissionFull`` (shed), or ``Draining``.  Safe from any
        thread: only read-only engine calls happen here.

        Pool plumbing (standalone callers never pass these):
        ``request_id`` uses the caller's id instead of minting one (the
        replica pool mints pool-unique ids so a failed-over request
        keeps its identity across replicas); ``resume_from=g`` marks
        the prompt's last ``g`` tokens as the request's own earlier
        output (threaded to the engine's resume-from-token admission);
        ``requeue`` bypasses the draining refusal and the queue bound —
        a failover re-admission was already admitted once, and dropping
        it now would break the no-token-lost contract."""
        if self._validate is not None:
            self._validate(prompt, max_new, seed)
        try:
            # resume_from only reaches engines that speak it (test
            # stubs and older engines keep their 3-arg surface).
            if resume_from and self._engine_resumes:
                prompt = self._engine.validate_request(
                    prompt, max_new, seed, resume_from)
            else:
                prompt = self._engine.validate_request(prompt, max_new,
                                                       seed)
        except ValueError as e:
            raise RequestError(str(e))
        if timeout_s is None:
            timeout_s = self._default_timeout_s
        if timeout_s is not None and timeout_s <= 0:
            raise RequestError(f"timeout_s must be > 0, got {timeout_s}")
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        with self._cv:
            if self._failed is not None:
                raise RuntimeError(
                    f"engine driver failed: {self._failed!r}")
            if not requeue:
                if self._draining:
                    raise Draining("gateway is draining; not admitting")
                if self.waiting() >= self._max_queue:
                    raise AdmissionFull(self.waiting(),
                                        self._retry_after_s)
            if request_id is None:
                request_id = self._next_id
                self._next_id += 1
            handle = RequestHandle(request_id, prompt, max_new, seed,
                                   stream, deadline, resume_from)
            # The request_id minted above tags every later lifecycle
            # event — the flight-recorder key /v1/requests/<id>
            # resolves.  Recorded BEFORE the notify releases the driver
            # thread: request_timeline anchors on this event's
            # timestamp, and an engine_submit recorded earlier than its
            # admission would fall outside the window.
            events.instant("request/admitted", request_id=handle.id,
                           prompt_len=len(prompt), max_new=max_new,
                           stream=stream, resumed=resume_from,
                           **self._ev_attrs)
            self._admit.append(handle)
            self._cv.notify()
        return handle

    # "reader"/"pump": the network worker's frame loop (and its
    # per-frame helper threads) marshal KV export/install through here.
    @thread_role("handler", "pump", "main", "reader")
    def call(self, fn: Callable, timeout_s: Optional[float] = None):
        """Run ``fn(engine)`` ON THE DRIVER THREAD between decode steps
        and return its result (exceptions re-raise here).  The engine is
        single-threaded by contract — every mutating call must come from
        the loop — and this is the ONE seam other threads get: the
        disaggregated-serving worker uses it to run KV export/install
        (device gathers + pool scatters) without racing ``serve_step``.
        Raises ``TimeoutError`` if the loop doesn't reach the call in
        ``timeout_s`` (e.g. a wedged dispatch) and ``RuntimeError`` once
        the driver has failed or finished draining."""
        pc = _PendingCall(fn)
        with self._cv:
            if self._failed is not None:
                raise RuntimeError(
                    f"engine driver failed: {self._failed!r}")
            if not self._thread.is_alive() and self._thread.ident is not None:
                raise RuntimeError("engine driver loop has exited")
            self._calls.append(pc)
            self._cv.notify()
        if not pc._done.wait(timeout_s):
            raise TimeoutError("engine call still pending")
        if pc._error is not None:
            raise pc._error
        return pc._result

    @locks_held("_cv")
    def _fail_calls_locked(self, reason: str) -> None:
        """Resolve queued calls with an error at loop exit (callers
        must not block forever on a driver that will never run them)."""
        while self._calls:
            self._calls.popleft()._fail(RuntimeError(reason))

    @thread_role("handler", "pump", "main", "reader")
    def export_lane(self, request_id: int,
                    timeout_s: Optional[float] = None):
        """Export a live request's migration state AND retire it here,
        atomically on the engine-owning thread: ``(meta, blob)`` or
        None when the request is unknown, already finished, or the
        engine cannot export.

        The source half of live migration, driver level.  The whole
        snapshot-then-cancel runs as ONE ``call()`` closure between
        decode steps, so not a single token can generate after the
        exported snapshot — the no-token-lost contract's anchor.  On
        success the request leaves this replica as terminal status
        ``migrated`` (its local handle resolves with an error nobody
        should still be reading — the pool re-homed the stream).  An
        admitted-but-not-yet-engine-queued request exports as pure
        parameters (``kind="queued"``) without touching the engine."""
        def _export(engine):
            with self._cv:
                for i, h in enumerate(self._admit):
                    if h.id == request_id:
                        del self._admit[i]
                        meta = {"kind": "queued",
                                "prompt": list(h.prompt),
                                "max_new": int(h.max_new),
                                "seed": h.seed,
                                "resume_from": int(h.resume_from),
                                "kv": None}
                        self._retire_migrated(h)
                        return meta, b""
                rid = next((r for r, h in self._inflight.items()
                            if h.id == request_id), None)
            if rid is None:
                return None
            ex = getattr(engine, "export_lane", None)
            if ex is None:
                return None
            out = ex(rid)
            if out is None:
                return None
            engine.cancel(rid)
            with self._cv:
                handle = self._inflight.pop(rid, None)
            if handle is not None:
                self._retire_migrated(handle)
            return out
        return self.call(_export, timeout_s)

    @thread_role("handler", "pump", "main", "reader")
    def install_lane(self, meta, blob,
                     timeout_s: Optional[float] = None) -> int:
        """Install a migrated lane's KV on this replica's engine (the
        target half); returns the warm-token count (0 = refused or
        nothing shipped — the re-placed request prefills locally).
        Marshalled through ``call()`` like every mutating engine
        touch."""
        return self.call(
            lambda eng: getattr(eng, "install_lane",
                                lambda m, b: 0)(meta, blob),
            timeout_s)

    def _retire_migrated(self, handle: RequestHandle) -> None:
        """Terminal bookkeeping for a request that left this replica
        alive: status ``migrated`` (the /v1/requests answer on the
        source), retire event for the flight recorder, and a resolve
        that unblocks any local reader with a pointer error."""
        self._count("migrated")
        self._set_terminal(handle.id, "migrated")
        events.instant("request/retire", request_id=handle.id,
                       status="migrated", **self._ev_attrs)
        handle._resolve(None, RuntimeError(
            f"request {handle.id} migrated to another replica"))

    def request_status(self, request_id: int) -> str:
        """Lifecycle answer for /v1/requests/<id>: a remembered
        terminal status (``ok|expired|invalid|error|migrated``), else
        ``queued`` (admitted, not yet in the engine), ``active``
        (in the engine), or ``unknown`` (never seen / evicted)."""
        with self._cv:
            status = self._terminal.get(request_id)
            if status is not None:
                return status
            if any(h.id == request_id for h in self._admit):
                return "queued"
            if any(h.id == request_id
                   for h in self._inflight.values()):
                return "active"
        return "unknown"

    def _set_terminal(self, request_id: int, status: str) -> None:
        with self._cv:
            self._terminal[request_id] = status
            while len(self._terminal) > _TERMINAL_KEEP:
                self._terminal.popitem(last=False)

    def abandon(self, handle: RequestHandle) -> None:
        """Give up on a live request (streaming client disconnected):
        collapse its deadline to now, so the driver's next sweep cancels
        it and frees the slot instead of decoding to ``max_new`` for
        nobody.  A plain attribute write — atomic, and the driver only
        ever compares it against the clock — so no lock is needed."""
        handle.deadline = time.monotonic()

    def poison(self, reason: str) -> None:
        """Fence a declared-dead driver: the loop exits at its next
        iteration WITHOUT dispatching again.  The pool's watchdog calls
        this the moment it declares a replica dead — a wedged dispatch
        that later wakes must not touch the device (or consume armed
        chaos-fault budgets) after its requests failed over.  A hang
        in ``serve_step`` is unaffected (the thread sleeps outside the
        lock); the fence lands when the step returns."""
        with self._cv:
            self._poisoned = reason
            self._cv.notify()

    def is_draining(self) -> bool:
        with self._cv:
            return self._draining

    def drain(self) -> None:
        """Stop admitting; in-flight and already-admitted requests run
        to completion.  Idempotent."""
        with self._cv:
            self._draining = True
            self._cv.notify()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Drain and wait for the driver thread to finish its backlog."""
        self.drain()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- driver loop -----------------------------------------------------

    @thread_role("driver")
    def _loop(self) -> None:
        if self._replica_id is not None:
            # Every event this thread records — driver lifecycle AND
            # engine internals (prefill/decode/kv spans) — carries the
            # replica id without per-call plumbing.
            events.set_thread_attrs(replica=self._replica_id)
        try:
            bind = getattr(self._engine, "bind_thread", None)
            if bind is not None:
                # torch's current device is per thread: the engine pins
                # its card on this, the one thread that launches its work.
                bind()
            while True:
                with self._cv:
                    while not (self._admit or self._inflight
                               or self._calls
                               or self._draining or self._poisoned):
                        self._cv.wait()
                    if self._poisoned:
                        # Fenced (watchdog declared this replica dead):
                        # exit before the next dispatch — kill9
                        # semantics, chosen on purpose: the backlog
                        # already failed over, and resolving anything
                        # here would race the survivors.
                        logger.warning(
                            "engine driver %s fenced after death "
                            "declaration (%s); exiting without "
                            "dispatching", self._replica_id,
                            self._poisoned)
                        self._fail_calls_locked(
                            f"driver fenced: {self._poisoned}")
                        return
                    if (self._draining and not self._admit
                            and not self._inflight and not self._calls):
                        return
                    self._admit_pending()
                    calls = list(self._calls)
                    self._calls.clear()
                # Queued engine calls (KV export/install) run here —
                # on the loop thread, outside the lock, between steps —
                # so they can take as long as a device gather without
                # blocking submitters.
                for pc in calls:
                    pc._run(self._engine)
                with self._cv:
                    if not self._inflight:
                        continue      # everything expired at admission
                self._dispatch_n += 1
                # The watchdog window opens for the whole engine step
                # (dispatch + device wait): _step_t0 is cleared only
                # when serve_step returns, so a wedged chunk shows an
                # ever-growing step_elapsed().  The fault hook sits
                # INSIDE the window — an injected hang must look
                # exactly like a wedged device.
                self._step_t0 = time.monotonic()
                if faults.ARMED:
                    faults.on_serve_dispatch(self._dispatch_n,
                                             replica=self._replica_id)
                done = self._engine.serve_step()
                self._step_t0 = None
                self._steps_done += 1
                self._harvest(done)
        except faults.InjectedKill:
            # kill -9 semantics for an in-process replica: vanish.  No
            # handle resolution, no _failed corpse, no retire events —
            # pending requests learn nothing (their pool pump's
            # liveness watch is the only detector), exactly like a
            # SIGKILLed subprocess.
            self._vanished = True
            logger.warning("engine driver %s vanished (injected kill9)",
                           self._replica_id)
            return
        except BaseException as e:      # noqa: BLE001 — fail loudly
            logger.exception("engine driver loop died")
            with self._cv:
                self._failed = e
                pending = list(self._admit) + list(self._inflight.values())
                self._admit.clear()
                self._inflight.clear()
                self._fail_calls_locked(f"engine driver failed: {e!r}")
            events.instant("driver/died", error=repr(e))
            for handle in pending:
                self._count("error")
                self._set_terminal(handle.id, "error")
                events.instant("request/retire", request_id=handle.id,
                               status="error")
                handle._resolve(None, RuntimeError(
                    f"engine driver failed: {e!r}"))

    @locks_held("_cv")
    def _admit_pending(self) -> None:
        """Move admitted requests into the engine (driver thread only,
        under the lock — the ONE place engine.submit is called)."""
        now = time.monotonic()
        while self._admit:
            handle = self._admit.popleft()
            if handle.deadline is not None and now >= handle.deadline:
                self._expire(handle)
                continue
            try:
                # resume_from is only passed when resuming: test stubs
                # and pre-resume engines keep their 3-arg submit.
                if handle.resume_from and self._engine_resumes:
                    rid = self._engine.submit(
                        handle.prompt, handle.max_new, seed=handle.seed,
                        resume_from=handle.resume_from)
                else:
                    rid = self._engine.submit(handle.prompt,
                                              handle.max_new,
                                              seed=handle.seed)
            except ValueError as e:
                # validate_request screened already; a late preload
                # could still shift the bucket rule — report, don't die.
                self._count("invalid")
                self._set_terminal(handle.id, "invalid")
                events.instant("request/retire", request_id=handle.id,
                               status="invalid")
                handle._resolve(None, RequestError(str(e)))
                continue
            self._inflight[rid] = handle
            # The rid join anchor: every engine-side event for this
            # request (prefill pieces, insert, retire) is tagged with
            # ``rid`` and happens after this instant.
            events.instant("request/engine_submit",
                           request_id=handle.id, rid=rid)

    def _harvest(self, done: dict) -> None:
        """Resolve finished requests, stream fresh tokens, sweep
        deadlines (driver thread only).  A request whose prefill is
        still staged inside the engine appears in neither ``done`` nor
        the snapshot — it falls through to the deadline check below,
        so an expired prefilling request is cancelled (lane freed,
        partial cache discarded) exactly like a decoding one.

        The whole pass holds ``_cv``: the dels below used to run
        lock-free ("driver thread only") while ``request_status``
        iterated ``_inflight.values()`` under the lock from handler
        threads — a dict resized mid-iteration raises in the READER
        (the engine's `_prefix_caches` bug class, one layer up).  Everything in here is host bookkeeping — the hold is
        microseconds and no device work runs under it."""
        now = time.monotonic()
        snapshot = self._engine.snapshot()
        # Lanes reserved for staged prefills count as granted — the
        # slot is held even though the decode snapshot cannot show it
        # yet (engines without the staged scheduler, e.g. test stubs,
        # simply have none).
        staged = getattr(self._engine, "staged_rids", tuple)()
        with self._cv:
            for rid, handle in list(self._inflight.items()):
                tokens = done.get(rid)
                finished = tokens is not None
                if not finished:
                    tokens = snapshot.get(rid)
                if handle.slot_granted_at is None and (
                        tokens is not None or rid in staged):
                    # First time the request holds a lane (decoding,
                    # done, or staged mid-prefill): the queue-depth
                    # gauge's latency companion, chunk-granular like
                    # every harvest signal.
                    handle.slot_granted_at = now
                    wait = now - handle.t_submit
                    if self._metrics is not None:
                        self._metrics.queue_wait.observe(wait)
                    events.instant("request/slot_granted",
                                   request_id=handle.id, rid=rid,
                                   wait_ms=round(wait * 1e3, 3))
                if tokens is not None and len(tokens) > len(handle.prompt):
                    if handle.first_token_at is None:
                        handle.first_token_at = now
                        if self._metrics is not None:
                            self._metrics.ttft.observe(
                                now - handle.t_submit)
                    fresh = handle._push_new(tokens)
                    if fresh:
                        events.instant("request/commit",
                                       request_id=handle.id, tokens=fresh)
                        if self._metrics is not None:
                            self._metrics.tokens.inc(fresh)
                            if handle.last_commit_at is not None:
                                # Commit-to-commit gap amortized over
                                # the tokens it delivered: the stream's
                                # per-token pace, chunk-granular.
                                self._metrics.inter_token.observe(
                                    (now - handle.last_commit_at) / fresh)
                        handle.last_commit_at = now
                if finished:
                    del self._inflight[rid]
                    self._count("ok")
                    self._set_terminal(handle.id, "ok")
                    events.instant(
                        "request/retire", request_id=handle.id,
                        status="ok",
                        tokens=len(tokens) - len(handle.prompt),
                        latency_ms=round((now - handle.t_submit) * 1e3,
                                         3))
                    if self._metrics is not None:
                        self._metrics.latency.observe(
                            now - handle.t_submit)
                    handle._resolve(tokens, None)
                elif (handle.deadline is not None
                        and now >= handle.deadline):
                    self._engine.cancel(rid)
                    del self._inflight[rid]
                    self._expire(handle)

    def _expire(self, handle: RequestHandle) -> None:
        self._count("expired")
        self._set_terminal(handle.id, "expired")
        events.instant("request/retire", request_id=handle.id,
                       status="expired")
        handle._resolve(None, DeadlineExceeded(
            f"request {handle.id} exceeded its deadline"))

    def _count(self, status: str) -> None:
        if self._metrics is not None:
            self._metrics.requests.inc(label_value=status)
