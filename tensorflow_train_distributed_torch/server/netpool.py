"""Multi-host serving: TCP worker daemons dial into the gateway's pool.

``server.procpool`` put every replica in a subprocess behind the frame
protocol — but still on the gateway's host, behind a ``socketpair``.
This module crosses the MACHINE boundary with the protocol unchanged:
the gateway opens one listening TCP socket (``NetPool``), and
standalone worker daemons (``serve_worker.py``) dial in, send the
versioned ``HELLO`` (now carrying their disaggregated-serving
``role``), and become replicas.  The parent half of the frame loop is
``ProcDriver`` almost verbatim — ``NetDriver`` overrides only what was
process-shaped:

- **no spawn**: a replica exists because a worker dialed in; the
  acceptor thread wraps each accepted connection in a driver and
  publishes it to the pool (the scaler's atomic-snapshot idiom);
- **no corpse**: worker death is an EOF (or ECONNRESET) on the TCP
  stream — classified ``disconnected``, never consulted via waitpid;
  a clean drain still ends with ``BYE`` before the close, so orderly
  scale-down and abrupt death stay distinguishable;
- **poison closes the socket**: we cannot SIGKILL across hosts, but a
  closed socket guarantees a wedged worker that wakes later is never
  read again (its next write dies with EPIPE);
- **respawn is a re-dial**: the supervisor's restart-budget semantics
  survive the inversion of control — while the budget lasts, a fleet
  below ``scale_min`` keeps placement waiting (``NoReplicas`` becomes
  a bounded wait) and each replacement dial-in counts a restart; a
  crash-looping worker exhausts the budget and further re-dials are
  refused at accept.

Everything request-shaped — routing (now role-aware), KV-prefix
affinity, the hung-dispatch watchdog, resume-from-token failover, the
prefill→decode KV handoff — is inherited from ``ReplicaPool`` and
``ProcDriver`` untouched, so the gateway stays replica-blind while the
fleet spans machines.  ``TTD_NO_DISAGG=1`` collapses the role split
and handoff (``server.replicas.disagg_killed``); the transport itself
has no kill switch — it IS the deployment.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Optional

from tensorflow_train_distributed_torch.runtime import events
from tensorflow_train_distributed_torch.runtime.lint.registry import (
    concurrency_guarded,
    thread_role,
)
from tensorflow_train_distributed_torch.server import proto
from tensorflow_train_distributed_torch.server.procpool import (
    ProcDriver,
    RemoteEngine,
    WorkerSpec,
)
from tensorflow_train_distributed_torch.server.replicas import (
    Replica,
    ReplicaPool,
)

logger = logging.getLogger(__name__)


@concurrency_guarded
class NetDriver(ProcDriver):
    """The ``EngineDriver`` surface over one dialed-in TCP worker.

    The frame machinery (reader loop, dispatch, submit, stats fold,
    handoff rendezvous, drain) is ProcDriver's — it only ever touches
    the socket pair and the sender, which this class points at the
    accepted connection.  Liveness is connection-shaped: alive until
    the stream fails or closes, vanished when it closed without the
    worker's ``BYE``.
    """

    # _closed is the connection's terminal flag: set by the reader at
    # EOF and by poison()/join() on the declaring thread — like the
    # base class's _vanished/_drained publishes, it only ever goes
    # False→True and every reader tolerates either order.

    def __init__(self, spec: WorkerSpec, engine: RemoteEngine,
                 sock: socket.socket, addr, *,
                 replica_id: Optional[int] = None, max_queue: int = 64,
                 default_timeout_s: Optional[float] = None,
                 retry_after_s: float = 1.0):
        super().__init__(spec, engine, replica_id=replica_id,
                         max_queue=max_queue,
                         default_timeout_s=default_timeout_s,
                         retry_after_s=retry_after_s)
        self._conn = sock
        self._addr = (f"{addr[0]}:{addr[1]}"
                      if isinstance(addr, tuple) else str(addr))
        self._closed = False

    def start(self) -> "NetDriver":
        sock = self._conn
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass                    # AF_UNIX test sockets have no TCP
        self._sock = sock
        self._rfp = sock.makefile("rb")
        self._wfp = sock.makefile("wb")
        self._sender = proto.FrameSender(self._wfp,
                                         self._spec.max_frame_bytes)
        self._stats_rx = time.monotonic()
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"net-reader-{self._replica_id}", daemon=True)
        self._reader.start()
        events.instant("replica/worker_dialin",
                       replica=self._replica_id, addr=self._addr)
        return self

    @property
    def addr(self) -> str:
        return self._addr

    # -- connection-shaped liveness (the proc overrides) -----------------

    def alive(self) -> bool:
        return self._failed is None and not self._closed

    def _corpse_rc(self) -> Optional[int]:
        return None                 # no corpse across a TCP boundary

    def _stream_error(self, e: BaseException) -> None:
        """A remote worker SIGKILLed/OOMed mid-write tears the TCP
        stream down as ECONNRESET — the death's symptom, exactly what
        EOF stands for, and there is no corpse to consult across
        hosts.  Anything else (an undecodable frame) stays a protocol
        failure on THIS replica."""
        if isinstance(e, OSError):
            self._on_eof()
            return
        self._fail_protocol(proto.ProtocolError(
            f"frame stream error: {type(e).__name__}: {e}"))

    def _on_eof(self) -> None:
        self._closed = True
        if not self._drained and self._failed is None:
            # No BYE before the close: SIGKILL semantics.  Nothing is
            # resolved here — the pool pump's liveness watch fails the
            # in-flight streams over, same as the subprocess EOF.
            self._vanished = True
            logger.warning("net worker %s (%s) disconnected without "
                           "BYE", self._replica_id, self._addr)
        self._fail_handoffs()
        self._corpse_snapshot(None)
        events.instant("replica/worker_eof", replica=self._replica_id,
                       addr=self._addr, drained=self._drained)

    def vanished(self) -> bool:
        return self._vanished

    def vanish_reason(self) -> Optional[str]:
        if not self.vanished():
            return None
        return f"worker at {self._addr} disconnected (no BYE)"

    def failure_class(self) -> Optional[str]:
        if isinstance(self._failed, proto.ProtocolError):
            return "protocol"
        if self._failed is not None:
            return "worker_error"
        if self.vanished():
            return "disconnected"
        return None

    def health_extra(self) -> dict:
        d = super().health_extra()
        d["addr"] = self._addr
        d["transport"] = "tcp"
        return d

    def poison(self, reason: str) -> None:
        """Fence a declared-dead remote worker: no cross-host SIGKILL
        exists, but closing the socket guarantees nothing it streams
        is ever read again — a wedged dispatch that wakes later must
        not commit into a request that already failed over."""
        self._poisoned = reason
        logger.warning("closing poisoned net worker %s (%s): %s",
                       self._replica_id, self._addr, reason)
        self._close_conn()

    def _close_conn(self) -> None:
        self._closed = True
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def join(self, timeout: Optional[float] = None) -> bool:
        """Drain and wait for the worker's BYE + close (the reader's
        exit): the worker finishes its backlog, says BYE, and closes;
        a worker that never does is abandoned at the timeout."""
        self.drain()
        r = self._reader
        if r is not None:
            r.join(timeout)
            if r.is_alive():
                return False
        self._close_conn()
        return True


class _NetReplica(Replica):
    """One dialed-in worker: the base Replica with a NetDriver and the
    parent-side facade in the engine seat."""

    def __init__(self, idx: int, spec: WorkerSpec,
                 sock: socket.socket, addr, *, max_queue: int,
                 default_timeout_s: Optional[float],
                 retry_after_s: float):
        engine = RemoteEngine()
        driver = NetDriver(spec, engine, sock, addr, replica_id=idx,
                           max_queue=max_queue,
                           default_timeout_s=default_timeout_s,
                           retry_after_s=retry_after_s)
        super().__init__(idx, engine, max_queue=max_queue,
                         default_timeout_s=default_timeout_s,
                         retry_after_s=retry_after_s, driver=driver)


@concurrency_guarded
class NetPool(ReplicaPool):
    """``ReplicaPool`` over TCP dial-in workers.

    The pool starts EMPTY and grows as workers dial in; ``wait_ready``
    blocks until ``scale_min`` of them finished their HELLO (engine
    built + warm on the worker's host).  Worker lifecycle is inverted
    relative to the subprocess pool — the pool cannot spawn what it
    does not own — so the supervisor idiom becomes: dead replicas stay
    listed for forensics, placement WAITS while the re-dial budget
    lasts (``_placement_may_recover``), and each dial-in that replaces
    dead capacity counts against ``max_restarts``; once the budget is
    spent, further re-dials are refused at accept (a crash-looping
    remote worker must not flap the fleet forever).  Dial-ins beyond
    ``max_workers`` usable replicas are refused outright.
    """

    # Acceptor-thread-owned bookkeeping (single writer; monitor and
    # handler threads read atomic scalars).  The lock-guarded request
    # structures are declared on ReplicaPool itself.
    _GUARDED_BY = {
        "_replicas": (None, "acceptor", "main"),
        "_next_idx": (None, "acceptor"),
        "_accepted": (None, "acceptor"),
        "_restarts": (None, "acceptor"),
    }

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0,
                 scale_min: int = 1, max_workers: int = 16,
                 max_frame_bytes: int = proto.MAX_FRAME_BYTES,
                 stats_interval_s: float = 0.2,
                 max_queue: int = 64, validate=None,
                 default_timeout_s: Optional[float] = None,
                 retry_after_s: float = 1.0,
                 watchdog_timeout_s: Optional[float] = 30.0,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0,
                 replica_max_queue: Optional[int] = None,
                 monitor_poll_s: Optional[float] = None,
                 max_restarts: int = 8):
        if not 1 <= scale_min <= max_workers:
            raise ValueError(
                f"need 1 <= scale_min ({scale_min}) <= max_workers "
                f"({max_workers})")
        # The spec carries only the frame-protocol knobs here (frame
        # bound, heartbeat cadence for the watchdog feed): engine
        # construction happens on the worker's host, from ITS flags.
        self._spec = WorkerSpec(max_frame_bytes=max_frame_bytes,
                                stats_interval_s=stats_interval_s)
        self._host = host
        self._cfg_port = int(port)
        self._scale_min = scale_min
        self._max_workers = max_workers
        self._max_restarts = max_restarts
        self._restarts = 0
        self._accepted = 0
        self._next_idx = 0
        self._budget_logged = False
        self._listener: Optional[socket.socket] = None
        self._port: Optional[int] = None
        self._allow_empty = True        # replicas dial in after start
        super().__init__([], max_queue=max_queue, validate=validate,
                         default_timeout_s=default_timeout_s,
                         retry_after_s=retry_after_s,
                         watchdog_timeout_s=watchdog_timeout_s,
                         backoff_base_s=backoff_base_s,
                         backoff_cap_s=backoff_cap_s,
                         replica_max_queue=replica_max_queue,
                         monitor_poll_s=monitor_poll_s)
        self._acceptor_thread = threading.Thread(
            target=self._accept_loop, name="net-acceptor", daemon=True)

    def _make_replica(self, idx: int, engine) -> Replica:
        raise NotImplementedError(
            "NetPool replicas dial in; nothing to make")

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "NetPool":
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self._host, self._cfg_port))
        lsock.listen(16)
        self._listener = lsock
        self._port = lsock.getsockname()[1]
        super().start()
        self._acceptor_thread.start()
        logger.info("net pool listening on %s:%d (scale_min=%d, "
                    "max_workers=%d)", self._host, self._port,
                    self._scale_min, self._max_workers)
        return self

    @property
    def port(self) -> int:
        """The bound listener port (live after ``start()``; with
        ``port=0`` the OS picked it — tests and launchers advertise
        this to workers)."""
        if self._port is None:
            raise RuntimeError("NetPool not started")
        return self._port

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until ``scale_min`` dialed-in workers finished their
        HELLO and are still usable — the launcher gate before
        advertising the HTTP port."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            ready = sum(1 for rep in self._replicas
                        if rep.usable() and rep.driver.ready())
            if ready >= self._scale_min:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def restarts_total(self) -> int:
        return self._restarts

    def degraded(self) -> bool:
        """Reduced capacity means fewer usable workers than the
        ``scale_min`` floor — corpses kept for /healthz forensics do
        not count against a fleet re-dialed back to strength."""
        return self.alive_count() < self._scale_min

    def _restart_budget_left(self) -> bool:
        return self._restarts < self._max_restarts

    def _placement_may_recover(self) -> bool:
        """A thin fleet recovers when a worker re-dials: placement
        waits (bounded by each request's own deadline) while the
        listener is up and the re-dial budget lasts."""
        return (not self.is_draining() and self._listener is not None
                and self._restart_budget_left())

    # -- the acceptor ----------------------------------------------------

    @thread_role("acceptor")
    def _accept_loop(self) -> None:
        lsock = self._listener      # join() nulls the attribute; the
        while True:                 # socket object itself stays valid
            try:                    # (accept raises once it closes)
                conn, addr = lsock.accept()
            except OSError:
                return              # listener closed: shutting down
            if self._stop.is_set():
                conn.close()
                return
            if self.is_draining():
                conn.close()        # no new capacity mid-drain
                continue
            try:
                self._admit(conn, addr)
            except Exception:   # noqa: BLE001 — acceptor must survive
                logger.exception("failed to admit dial-in from %s",
                                 addr)
                conn.close()

    def _admit(self, conn: socket.socket, addr) -> None:
        usable = self.alive_count()
        if usable >= self._max_workers:
            logger.warning("refusing dial-in from %s: fleet full "
                           "(%d usable)", addr, usable)
            conn.close()
            return
        # A dial-in that REPLACES dead capacity (the fleet already
        # reached scale_min once, and is now below it) is a respawn in
        # supervisor terms: counted, budgeted.  Initial fleet formation
        # and scale-out beyond the floor are free.
        respawn = (self._accepted >= self._scale_min
                   and usable < self._scale_min)
        if respawn and not self._restart_budget_left():
            if not self._budget_logged:
                self._budget_logged = True
                events.instant("replica/restart_budget_exhausted",
                               restarts=self._restarts)
                logger.error(
                    "re-dial budget exhausted after %d replacement "
                    "dial-ins; refusing new workers", self._restarts)
            conn.close()
            return
        if respawn:
            self._restarts += 1
            counter = getattr(self._metrics, "replica_restarts", None)
            if counter is not None:
                counter.inc()
        self._accepted += 1
        idx = self._next_idx
        self._next_idx += 1
        rep = _NetReplica(idx, self._spec, conn, addr,
                          max_queue=self._replica_max_queue,
                          default_timeout_s=self._default_timeout_s,
                          retry_after_s=self._retry_after_s)
        rep.driver.start()
        # Publish AFTER start: readers must never see a replica whose
        # driver has no reader thread yet (the scaler's rule).
        self._replicas = self._replicas + [rep]
        events.instant("replica/dialin", replica=idx,
                       addr=rep.driver.addr, respawn=respawn)
        logger.info("worker dialed in from %s -> replica %d "
                    "(fleet=%d%s)", rep.driver.addr, idx,
                    len(self._replicas),
                    ", respawn" if respawn else "")

    # -- drain -----------------------------------------------------------

    def join(self, timeout: Optional[float] = None) -> bool:
        drained = super().join(timeout)
        lsock, self._listener = self._listener, None
        if lsock is not None:
            try:
                lsock.close()       # unblocks the acceptor's accept()
            except OSError:
                pass
        if self._acceptor_thread.is_alive():
            self._acceptor_thread.join(timeout=5.0)
        return drained
