"""Replica pool: N engine drivers behind one admission layer.

The gateway's single point of failure was its one ``EngineDriver`` — a
dead or hung driver turned every in-flight and queued request into a
loss.  This module fronts N engine replicas (in-process driver threads;
the seam deliberately admits subprocess replicas later — every
replica interaction goes through the ``EngineDriver`` surface, which an
IPC proxy can implement) with:

- **routing**: admissions go to the alive replica with the warmest
  KV affinity (a request whose prompt shares its leading KV block with
  one recently routed to a replica prefers that replica — its radix
  prefix cache holds the warm blocks), ties broken by load (waiting +
  active lanes), then index;
- **health**: per-replica ``driver.alive()`` plus a hung-dispatch
  watchdog — a decode chunk that exceeds ``watchdog_timeout_s``
  declares the replica dead even though its thread still exists (the
  wedged-device failure mode liveness alone cannot see).  A first
  dispatch pays one-time costs (the kernels' first load, cuBLAS
  handles): size the watchdog above them, or warm every replica up
  before taking traffic (the launchers' and chaos harness's idiom);
- **deterministic failover**: a request whose replica dies is
  re-admitted on a survivor with its ORIGINAL seed, its original
  prompt plus every token already committed, and
  ``resume_from=<committed count>`` — the engine's resume-from-token
  admission continues the request's rng stream at its original
  position, so greedy and seeded-sampling outputs equal an
  uninterrupted single-replica run, with no token duplicated or
  dropped (the stream simply continues);
- **bounded retry with backoff**: a placement refused for transient
  pool pressure (every replica's admission queue full) retries with
  exponential backoff and gives up at the request's own deadline
  instead of failing fast;
- **graceful drain**: replicas drain ONE AT A TIME, so capacity
  degrades gradually instead of all at once — and with ≥2 usable
  replicas a draining replica's live lanes are EVACUATED first;
- **live migration**: ``migrate(request_id, target=None)`` moves an
  ACTIVE stream between healthy replicas mid-generation — the lane's
  KV blocks, token history, rng position, and staged-prefill cursor
  cross via ``export_lane``/``install_lane`` and the stream resumes
  bitwise-identical, no re-prefill (``TTD_NO_MIGRATION=1`` disables);
  ``defragment()`` packs long-tail lanes onto fewer replicas.

Each pool request runs a small pump thread that places the request,
relays committed chunks from the replica's stream to the caller's
handle, and re-places on a survivor when the replica dies — the
caller-facing ``RequestHandle`` surface (``result()`` /
``iter_tokens()``) is exactly the single-driver one, so the gateway's
HTTP frontend is replica-blind.

Chaos: ``runtime.faults`` serve-side entries
(``serve:dispatch:N:raise|hang|kill9[:replica=K]``) kill exactly the
failure modes above — error-propagating death, hung dispatch, and
abrupt vanish — deterministically, per replica.
"""

from __future__ import annotations

import logging
import os
import queue as queue_mod
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from tensorflow_train_distributed_torch.runtime import events
from tensorflow_train_distributed_torch.runtime.lint.registry import (
    concurrency_guarded,
    thread_role,
)
from tensorflow_train_distributed_torch.server.driver import (
    _DONE,
    _TERMINAL_KEEP,
    AdmissionFull,
    DeadlineExceeded,
    Draining,
    EngineDriver,
    RequestError,
    RequestHandle,
)

logger = logging.getLogger(__name__)


class NoReplicas(RuntimeError):
    """No live replica can accept work (HTTP 503 + Retry-After: the
    condition may clear — operators restart replicas — unlike a single
    driver's terminal death)."""


def disagg_killed() -> bool:
    """``TTD_NO_DISAGG=1`` disables disaggregated serving's role split
    and prefill→decode KV handoff: every worker is routed as
    ``role=both`` and requests prefill locally on whatever replica
    decodes them (the pre-disagg behavior, bitwise-identical outputs —
    handoff only ever changes WHERE prefill runs).  The TCP transport
    itself stays up: killing routing must not take a cross-host fleet
    offline.  Same no-redeploy contract as ``TTD_NO_PROC_REPLICAS``."""
    return os.environ.get("TTD_NO_DISAGG", "0") not in ("", "0")


def migration_killed() -> bool:
    """``TTD_NO_MIGRATION=1`` disables live mid-stream migration:
    ``ReplicaPool.migrate`` refuses, drain-time evacuation and the
    elastic scaler's pack-drain revert to the pre-migration behavior
    byte-for-byte (drains wait for accepted work to finish; deaths
    fail over via resume-from-token re-prefill), and ``defragment``
    is a no-op.  The ``MIGRATE`` protocol frames stay registered —
    killing the feature must never change what the transport can
    parse.  Same no-redeploy contract as ``TTD_NO_DISAGG``."""
    return os.environ.get("TTD_NO_MIGRATION", "0") not in ("", "0")


# Pump liveness poll while waiting on the next chunk: only paid when
# the stream is IDLE (a ready chunk returns immediately), so it bounds
# failover detection latency, not token latency.
_POLL_S = 0.05

# Recent first-block routing keys remembered per replica (the affinity
# table's LRU bound).
_AFFINITY_KEEP = 512


@concurrency_guarded
class Replica:
    """One engine + its driver + the pool-level health state."""

    # The affinity LRU is read by handler threads (routing scans) while
    # pump threads note placements — every touch locks.  The health
    # pair is ATOMIC-PUBLISH: written exactly once, by the watchdog
    # monitor alone (``mark_dead``), read lock-free everywhere —
    # single-field reads are safe, and the write ORDER (reason first,
    # flag second) guarantees a reader that saw ``dead`` also sees why.
    _GUARDED_BY = {
        "_affinity": ("_aff_lock",),
        "dead": (None, "watchdog"),
        "dead_reason": (None, "watchdog"),
    }

    def __init__(self, idx: int, engine, *, max_queue: int,
                 default_timeout_s: Optional[float],
                 retry_after_s: float, driver=None):
        self.idx = idx
        self.engine = engine
        # ``driver`` injection is the subprocess seam: a ProcDriver
        # (server.procpool) implements the same surface over the frame
        # protocol, and everything else in this module — routing,
        # health, failover, drain — consumes it unchanged.
        if driver is None:
            # validate=None: the pool screens once at its own admission.
            driver = EngineDriver(
                engine, max_queue=max_queue, validate=None,
                default_timeout_s=default_timeout_s,
                retry_after_s=retry_after_s, replica_id=idx)
        self.driver = driver
        self.dead = False
        self.dead_reason: Optional[str] = None
        self._affinity: OrderedDict = OrderedDict()   # block key -> None
        self._aff_lock = threading.Lock()

    @property
    def slots(self) -> int:
        """Live read: a subprocess replica's facade learns its slot
        count at the HELLO handshake, after construction."""
        return getattr(self.engine, "slots", 0)

    def state(self) -> str:
        if self.dead:
            return "dead"
        if self.driver.is_draining():
            # "drained": an orderly drain that already finished (the
            # elastic pool's scale-down end state) — distinct from a
            # drain in progress, which still finishes accepted work,
            # and from a worker that VANISHED mid-drain (SIGKILL/OOM
            # before its BYE): that one is a death the monitor is
            # about to classify, and the scaler must never prune it
            # as a clean scale-down.
            if self.driver.alive():
                return "draining"
            return "dead" if self.driver.vanished() else "drained"
        return "alive"

    def accepting(self) -> bool:
        """Routable for NEW admissions (drain/death excluded)."""
        return (not self.dead and self.driver.alive()
                and not self.driver.is_draining())

    def usable(self) -> bool:
        """Usable for failover/drain-time re-admission: a DRAINING
        replica still finishes accepted work, and a failed-over request
        was accepted once — only death disqualifies."""
        return not self.dead and self.driver.alive()

    def role(self) -> str:
        """Disaggregated-serving role (``prefill|decode|both``) from
        the worker's HELLO; in-process engines have none and serve
        everything.  Under ``TTD_NO_DISAGG=1`` every replica reads as
        ``both`` — the kill switch collapses routing, not health."""
        if disagg_killed():
            return "both"
        role = getattr(self.engine, "role", None) or "both"
        return role if role in ("prefill", "decode", "both") else "both"

    def decode_capable(self) -> bool:
        """May this replica take a decode placement?  Dedicated
        prefill workers only stage and export KV — they are never
        placement candidates."""
        return self.role() != "prefill"

    def load(self) -> int:
        return self.driver.waiting() + self.driver.active_slots()

    @thread_role("watchdog")
    def mark_dead(self, reason: str) -> None:
        """Publish the death verdict (monitor thread only).  The
        REASON is written before the flag: readers everywhere check
        ``dead`` first and then format ``dead_reason`` into errors and
        health bodies lock-free, so the old flag-first order could
        publish a death with a ``None`` explanation mid-read."""
        self.dead_reason = reason
        self.dead = True

    def note_affinity(self, key) -> None:
        if key is None:
            return
        with self._aff_lock:
            self._affinity[key] = None
            self._affinity.move_to_end(key)
            while len(self._affinity) > _AFFINITY_KEEP:
                self._affinity.popitem(last=False)

    def affinity(self, key) -> int:
        if key is None:
            return 0
        with self._aff_lock:
            return 1 if key in self._affinity else 0


class _PoolRequest:
    """Pool-side record of one live request (the pump's state)."""

    __slots__ = ("handle", "generated", "replica", "inner", "excluded",
                 "failovers", "affinity_key", "thread",
                 "queue_wait_seen", "preferred", "avoid",
                 "migrate_to", "migrate_done", "migrate_ok",
                 "migrations")

    def __init__(self, handle: RequestHandle, affinity_key):
        self.handle = handle
        self.generated: list = []      # committed tokens relayed so far
        self.replica: Optional[Replica] = None
        self.inner: Optional[RequestHandle] = None
        self.excluded: set = set()     # replica idxs that died under it
        self.failovers = 0
        self.affinity_key = affinity_key
        self.thread: Optional[threading.Thread] = None
        self.queue_wait_seen = False
        # Migration steering — SOFT, unlike ``excluded``: ``preferred``
        # sorts first at the next placement (the migration target,
        # where the KV just landed) and ``avoid`` is pruned only while
        # alternatives remain (the evacuating source stays a legal
        # last resort — it is alive, unlike a death-excluded replica).
        self.preferred: Optional[int] = None
        self.avoid: Optional[int] = None
        # Migration rendezvous: ``migrate()`` publishes a target
        # (Replica | "auto") and waits on the event; the pump's relay
        # loop — the single consumer of the inner stream — performs
        # the move inline and signals back.
        self.migrate_to = None
        self.migrate_done: Optional[threading.Event] = None
        self.migrate_ok = False
        self.migrations = 0


@concurrency_guarded
class ReplicaPool:
    """N replicas behind the ``EngineDriver`` submission surface.

    The gateway talks to this exactly as it talks to a single driver
    (``submit``/``waiting``/``active_slots``/``alive``/``drain``/
    ``join``/``request_status``/``abandon``), so the HTTP layer is
    replica-blind; everything replica-aware (routing, health, failover,
    per-replica drain) lives here.
    """

    # Touched by handler threads (submit/status), pump threads
    # (_finish), and the drain path — every access locks (``_lock`` is
    # re-entrant, so submit's nested waiting()/alive() reads are fine).
    # ``_replicas`` is ATOMIC-PUBLISH: the list object is immutable
    # once published (the elastic proc pool's scaler REPLACES it with
    # a new list on spawn/prune, never mutates it in place), so every
    # reader iterates a consistent snapshot lock-free.
    _GUARDED_BY = {
        "_requests": ("_lock",),
        "_terminal": ("_lock",),
        "_draining": ("_lock",),
        "_next_id": ("_lock",),
        "_replicas": (None, "scaler", "main"),
    }

    def __init__(self, engines, *, max_queue: int = 64,
                 validate: Optional[Callable] = None,
                 default_timeout_s: Optional[float] = None,
                 retry_after_s: float = 1.0,
                 watchdog_timeout_s: Optional[float] = 30.0,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0,
                 replica_max_queue: Optional[int] = None,
                 monitor_poll_s: Optional[float] = None):
        engines = list(engines)
        # The network pool starts EMPTY (its replicas dial in) and
        # opts out of this floor; every other pool needs a replica up
        # front.
        if len(engines) < 1 and not getattr(self, "_allow_empty",
                                            False):
            raise ValueError("ReplicaPool needs at least one engine")
        if watchdog_timeout_s is not None and watchdog_timeout_s <= 0:
            raise ValueError(
                f"watchdog_timeout_s must be > 0 (None disables), got "
                f"{watchdog_timeout_s}")
        self._validate = validate
        self._max_queue = max_queue
        self._default_timeout_s = default_timeout_s
        self._retry_after_s = retry_after_s
        self._watchdog_s = watchdog_timeout_s
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        # Per-replica admission bound: the pool-wide ``max_queue`` is
        # the SHED bound (429); each replica's driver holds its share,
        # so a skewed placement (affinity pinning, uneven drain) hits a
        # TRANSIENT per-replica refusal the pump absorbs with backoff
        # instead of a client-visible shed.
        if replica_max_queue is None:
            replica_max_queue = max(
                1, -(-max_queue // max(1, len(engines))))
        self._replica_max_queue = replica_max_queue
        self._replicas = [self._make_replica(i, e)
                          for i, e in enumerate(engines)]
        self._metrics = None
        # RLock: submit() holds it across its waiting()/alive() checks
        # (which take it again) so admission decisions are atomic.
        self._lock = threading.RLock()
        self._requests: dict = {}          # pool id -> _PoolRequest
        self._terminal: OrderedDict = OrderedDict()
        self._next_id = 0
        self._draining = False
        self._stop = threading.Event()
        if monitor_poll_s is None:
            monitor_poll_s = (min(0.05, watchdog_timeout_s / 4)
                              if watchdog_timeout_s else 0.05)
        self._monitor_poll_s = monitor_poll_s
        self._monitor_thread = threading.Thread(
            target=self._monitor, name="replica-monitor", daemon=True)

    # -- lifecycle ---------------------------------------------------------

    def _make_replica(self, idx: int, engine) -> Replica:
        """Build one replica — the subclass seam: the subprocess pool
        builds a ProcDriver-backed replica from a worker SPEC here
        instead of an in-process engine."""
        return Replica(idx, engine, max_queue=self._replica_max_queue,
                       default_timeout_s=self._default_timeout_s,
                       retry_after_s=self._retry_after_s)

    def _placement_may_recover(self) -> bool:
        """May capacity come back without operator action?  The base
        pool's replicas never resurrect — an empty candidate set is
        terminal (``NoReplicas``).  The elastic subprocess pool
        overrides this while its respawn budget lasts, so a request
        caught between a death and the respawn WAITS (bounded by its
        own deadline) instead of failing."""
        return False

    def start(self) -> "ReplicaPool":
        for rep in self._replicas:
            rep.driver.start()
        self._monitor_thread.start()
        return self

    def set_metrics(self, metrics) -> None:
        self._metrics = metrics

    @property
    def replicas(self) -> list:
        return self._replicas

    # -- health / occupancy ------------------------------------------------

    def alive(self) -> bool:
        """True while at least one replica can make progress."""
        return any(rep.usable() for rep in self._replicas)

    def alive_count(self) -> int:
        return sum(rep.usable() for rep in self._replicas)

    def degraded(self) -> bool:
        """Is serving capacity reduced?  For the base pool any dead
        replica is capacity gone for good (replicas never resurrect).
        The elastic subprocess pool overrides this: a respawned fleet
        back at strength is NOT degraded even though its corpses stay
        listed for forensics — /healthz keys the load-balancer signal
        here, not on corpse counting."""
        return self.alive_count() < len(self._replicas)

    def failure(self) -> Optional[BaseException]:
        """Total-loss summary once EVERY replica is dead, else None
        (one dead replica is a degraded pool, not a failed one)."""
        if self.alive():
            return None
        reasons = [f"replica {rep.idx}: {rep.dead_reason or 'dead'}"
                   for rep in self._replicas]
        return RuntimeError("all replicas dead (" + "; ".join(reasons)
                            + ")")

    def waiting(self) -> int:
        """Requests admitted by the pool but not yet decoding anywhere:
        un-placed pump requests plus the live replicas' own queues."""
        with self._lock:
            unplaced = sum(1 for preq in self._requests.values()
                           if preq.inner is None)
        return unplaced + sum(rep.driver.waiting()
                              for rep in self._replicas if rep.usable())

    def active_slots(self) -> int:
        return sum(rep.driver.active_slots()
                   for rep in self._replicas if rep.usable())

    def is_draining(self) -> bool:
        with self._lock:
            return self._draining

    def replica_states(self) -> list:
        """Per-replica health the /healthz endpoint reports."""
        out = []
        for rep in self._replicas:
            d = {"replica": rep.idx, "state": rep.state(),
                 "queue_depth": rep.driver.waiting(),
                 "slots_in_use": rep.driver.active_slots(),
                 "slots_total": rep.slots}
            role = rep.role()
            if role != "both":
                d["role"] = role
            if d["state"] == "draining":
                # The evacuation progress gauge: live pool requests
                # still homed on this draining replica.  Operators
                # watch it count down to 0 as lanes migrate off.
                with self._lock:
                    d["lanes_remaining"] = sum(
                        1 for preq in self._requests.values()
                        if preq.replica is rep)
            if rep.dead_reason:
                d["reason"] = rep.dead_reason
            total_fn = getattr(rep.engine, "kv_blocks_total", None)
            total = total_fn() if total_fn is not None else 0
            if total:
                d["kv_blocks_total"] = total
                d["kv_blocks_free"] = (total
                                       - rep.engine.kv_blocks_in_use())
                # Bytes next to blocks: the same capacity signal in
                # the unit budgets reason in (per replica — under
                # --replica-procs each worker reports its own pool
                # from its stats frames instead of dropping it).
                # kv_pool_bytes is the constant capacity,
                # kv_bytes_in_use the referenced-blocks occupancy.
                for name in ("kv_pool_bytes", "kv_bytes_in_use"):
                    fn = getattr(rep.engine, name, None)
                    v = fn() if fn is not None else 0
                    if v:
                        d[name] = v
            hbm_fn = getattr(rep.engine, "hbm_by_pool", None)
            if hbm_fn is not None:
                hbm = hbm_fn()
                if hbm:
                    d["hbm_bytes"] = hbm
            # Driver-specific extras: a subprocess replica's ProcDriver
            # reports pid/rss/protocol state here, so /healthz
            # classifies worker-level failures per replica.
            extra = getattr(rep.driver, "health_extra", None)
            if extra is not None:
                d.update(extra())
            out.append(d)
        return out

    # -- engine-stat aggregation (the gateway's /metrics feed) -------------

    def slots_total(self) -> int:
        """Current slot capacity across usable replicas — a LIVE value
        under the elastic subprocess pool (workers spawn and drain)."""
        return sum(rep.slots for rep in self._replicas if rep.usable())

    def workers_by_role(self) -> dict:
        """Usable replicas per disaggregated-serving role (``{role:
        count}``) — the ``ttd_gateway_workers_alive{role=...}`` feed.
        Under ``TTD_NO_DISAGG=1`` everything truthfully reads
        ``both``."""
        out: dict = {}
        for rep in self._replicas:
            if rep.usable():
                r = rep.role()
                out[r] = out.get(r, 0) + 1
        return out

    def _engine_stat(self, name: str, ratio: bool = False) -> float:
        vals = []
        for rep in self._replicas:
            if not rep.usable():
                continue
            fn = getattr(rep.engine, name, None)
            if fn is None:
                continue
            vals.append(float(fn()))
        if not vals:
            return 0.0
        return sum(vals) / len(vals) if ratio else sum(vals)

    def overlap_ratio(self) -> float:
        return self._engine_stat("overlap_ratio", ratio=True)

    def prefill_stall_s(self) -> float:
        return self._engine_stat("prefill_stall_s")

    def kv_blocks_in_use(self) -> float:
        return self._engine_stat("kv_blocks_in_use")

    def kv_blocks_total(self) -> float:
        return self._engine_stat("kv_blocks_total")

    def kv_prefix_hit_tokens(self) -> float:
        return self._engine_stat("kv_prefix_hit_tokens")

    def kv_evictions(self) -> float:
        return self._engine_stat("kv_evictions")

    def kv_pool_bytes(self) -> float:
        return self._engine_stat("kv_pool_bytes")

    def spec_depth(self) -> float:
        """Fleet draft depth (MEAN over usable replicas — they share
        one spec, so a non-integer read means the controllers have
        diverged on their own traffic, itself worth seeing)."""
        return self._engine_stat("spec_depth", ratio=True)

    def spec_accepted_tokens(self) -> float:
        return self._engine_stat("spec_accepted_tokens")

    def spec_drafted_tokens(self) -> float:
        return self._engine_stat("spec_drafted_tokens")

    def hbm_autosized_bytes(self) -> float:
        return self._engine_stat("hbm_autosized_bytes")

    def hbm_by_pool(self) -> dict:
        """Live bytes per declared memcheck pool, for the labeled
        ``ttd_engine_hbm_bytes{pool=...}`` gauge.  Subprocess replicas
        report their own ledgers through stats frames — rendered as
        ``<replica>/<pool>`` so fleet memory is visible PER WORKER;
        in-process replicas all live in this process, whose global
        ledger is the truth (summing per engine would double-count
        nothing, but the process view already covers every engine)."""
        out: dict = {}
        remote = False
        for rep in self._replicas:
            fn = getattr(rep.engine, "hbm_by_pool", None)
            if fn is None or not rep.usable():
                continue
            remote = True
            for pool, v in fn().items():
                out[f"{rep.idx}/{pool}"] = float(v)
        if not remote:
            from tensorflow_train_distributed_torch.runtime.lint import (
                memcheck,
            )

            out = memcheck.live_by_pool()
        return out

    def programs_by_site(self) -> dict:
        """Fleet roofline numerators: each worker's relayed program
        stats keyed ``<replica>/<site>`` (subprocess/TCP facades), or
        this process's own compilecheck ledger for in-process replicas
        — same shape as ``hbm_by_pool``, consumed by
        ``mfu_by_program``/``mbu_by_program`` below."""
        out: dict = {}
        remote = False
        for rep in self._replicas:
            fn = getattr(rep.engine, "program_stats", None)
            if fn is None or not rep.usable():
                continue
            remote = True
            for site, stats in fn().items():
                out[f"{rep.idx}/{site}"] = dict(stats)
        if not remote:
            from tensorflow_train_distributed_torch.runtime.lint import (
                compilecheck,
            )

            out = compilecheck.program_stats()
        return out

    def mfu_by_program(self) -> dict:
        """Fleet ``ttd_engine_mfu_pct`` source: every replica's
        achieved flop rate against THIS host's device peak (homogeneous
        fleets; heterogeneous ones pin TTD_PEAK_FLOPS).  Empty when the
        peak is unknown — no made-up percentages."""
        from tensorflow_train_distributed_torch.runtime.lint import (
            compilecheck,
        )

        peak = compilecheck.peak_flops_per_s()
        if not peak:
            return {}
        return {prog: round(100.0 * float(s.get("flops_per_s", 0.0))
                            / peak, 3)
                for prog, s in self.programs_by_site().items()
                if s.get("dispatches")}

    def mbu_by_program(self) -> dict:
        """Fleet ``ttd_engine_mbu_pct`` source (see mfu_by_program)."""
        from tensorflow_train_distributed_torch.runtime.lint import (
            compilecheck,
        )

        peak = compilecheck.peak_hbm_bytes_per_s()
        if not peak:
            return {}
        return {prog: round(100.0 * float(s.get("bytes_per_s", 0.0))
                            / peak, 3)
                for prog, s in self.programs_by_site().items()
                if s.get("dispatches")}

    def replica_rss(self) -> dict:
        """Per-replica resident-set bytes (``{replica: bytes}``) for
        engines that report it — subprocess facades do (from the stats
        frames); in-process replicas share the gateway's own rss and
        truthfully report nothing."""
        out = {}
        for rep in self._replicas:
            fn = getattr(rep.engine, "rss_bytes", None)
            if fn is None:
                continue
            v = fn()
            if v:
                out[str(rep.idx)] = float(v)
        return out

    # -- admission ---------------------------------------------------------

    def _affinity_key(self, prompt):
        """First-KV-block token key: requests sharing it share their
        leading physical blocks on whichever replica holds them."""
        reps = self._replicas
        bs = (getattr(reps[0].engine, "kv_block_size", 16) if reps
              else 16)
        return tuple(prompt[:bs]) if len(prompt) >= bs else None

    @thread_role("handler", "main")
    def submit(self, prompt, max_new: int, *, seed: Optional[int] = None,
               stream: bool = False,
               timeout_s: Optional[float] = None) -> RequestHandle:
        """Admit one request to the pool; raises ``RequestError``,
        ``AdmissionFull``, ``Draining``, or ``NoReplicas``.  The
        returned handle is the single-driver one — ``result()`` /
        ``iter_tokens()`` hide placement, retries, and failover."""
        if self._validate is not None:
            self._validate(prompt, max_new, seed)
        try:
            # The screening engine: any replica's validator agrees
            # (identically-configured engines); a subprocess pool's
            # facade answers from the HELLO-advertised shape.  An
            # EMPTY network pool (first worker still dialing in) can
            # only coerce — the worker's real engine screens at
            # placement, coming back as a classified invalid retire.
            reps = self._replicas
            if reps:
                prompt = reps[0].engine.validate_request(
                    prompt, max_new, seed)
            else:
                prompt = [int(t) for t in prompt]
                if not prompt:
                    raise ValueError("empty prompt")
        except ValueError as e:
            raise RequestError(str(e))
        if timeout_s is None:
            timeout_s = self._default_timeout_s
        if timeout_s is not None and timeout_s <= 0:
            raise RequestError(f"timeout_s must be > 0, got {timeout_s}")
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        with self._lock:
            if self._draining:
                raise Draining("gateway is draining; not admitting")
            if not self.alive() and not self._placement_may_recover():
                raise NoReplicas(
                    "no live replica can accept work: "
                    + "; ".join(f"replica {r.idx} {r.state()}"
                                f" ({r.dead_reason})" if r.dead_reason
                                else f"replica {r.idx} {r.state()}"
                                for r in self._replicas))
            if self.waiting() >= self._max_queue:
                raise AdmissionFull(self.waiting(), self._retry_after_s)
            pool_id = self._next_id
            self._next_id += 1
            if seed is None:
                # Pin the effective seed NOW: an engine defaults a None
                # seed to its own internal rid, which (a) collides
                # across replicas — two engines both mint rid 0, so two
                # concurrent seedless sampled requests draw the SAME
                # default stream, breaking the distinct-per-request
                # contract — and (b) changes across a failover
                # re-admission, splicing an unrelated stream onto the
                # committed prefix.  The pool-unique id restores both;
                # greedy decode ignores it entirely.
                seed = pool_id % 2 ** 32
            handle = RequestHandle(pool_id, prompt, max_new, seed,
                                   stream, deadline)
            preq = _PoolRequest(handle, self._affinity_key(prompt))
            self._requests[pool_id] = preq
            # The pool-level admission anchor request_timeline keys on:
            # failover re-admits the SAME id on a survivor, and the
            # timeline must show every life plus the hop.
            events.instant("request/pool_admitted", request_id=pool_id,
                           prompt_len=len(prompt), max_new=max_new,
                           stream=stream)
        preq.thread = threading.Thread(
            target=self._pump, args=(preq,),
            name=f"pool-req-{pool_id}", daemon=True)
        preq.thread.start()
        return handle

    # -- placement ---------------------------------------------------------

    def _candidates(self, preq: _PoolRequest,
                    allow_draining: bool) -> list:
        """Routable DECODE-capable replicas, best first: warm KV
        affinity, then load, then index.  The affinity table is the
        gateway-side mirror of each worker's radix prefix index —
        placements AND finished handoffs feed it — so a warm prefix on
        ANY decode worker wins placement fleet-wide.  Dedicated
        prefill workers never take placements; a replica this request
        already died on is never a candidate (replicas do not
        resurrect)."""
        reps = [rep for rep in self._replicas
                if rep.idx not in preq.excluded
                and rep.decode_capable()
                and (rep.usable() if allow_draining
                     else rep.accepting())]
        if preq.avoid is not None:
            pruned = [r for r in reps if r.idx != preq.avoid]
            if pruned:
                reps = pruned       # soft: only while alternatives live
        key = preq.affinity_key
        reps.sort(key=lambda r: (r.idx != preq.preferred,
                                 -r.affinity(key), r.load(), r.idx))
        return reps

    def _place(self, preq: _PoolRequest, requeue: bool) -> None:
        """Submit the request (or its resumed remainder) to the best
        replica that will take it; when EVERY candidate refuses for
        transient pool pressure, retry with exponential backoff until
        the request's own deadline.  Raises ``DeadlineExceeded`` /
        ``NoReplicas`` when placement cannot happen."""
        outer = preq.handle
        backoff = self._backoff_base_s
        allow_draining = requeue or self.is_draining()
        while True:
            if (outer.deadline is not None
                    and time.monotonic() >= outer.deadline):
                raise DeadlineExceeded(
                    f"request {outer.id} exceeded its deadline")
            # Re-read the drain flag every pass: a pump looping in the
            # backoff branch when drain BEGINS must widen its candidate
            # set to draining replicas (accepted work runs to
            # completion), not starve into NoReplicas.
            allow_draining = allow_draining or self.is_draining()
            reps = self._candidates(preq, allow_draining)
            if not reps and not self._placement_may_recover():
                raise NoReplicas(
                    f"request {outer.id}: no live replica left "
                    f"(excluded: {sorted(preq.excluded)})")
            gen = len(preq.generated)
            prompt = (outer.prompt + preq.generated if gen
                      else outer.prompt)
            timeout_s = None
            if outer.deadline is not None:
                timeout_s = max(1e-3,
                                outer.deadline - time.monotonic())
            # Empty candidate set with recovery possible (the elastic
            # pool's respawn window): wait out the backoff exactly
            # like an everyone-refused pass — capacity is coming.
            refused = not reps
            for rep in reps:
                self._maybe_handoff(preq, prompt, rep)
                try:
                    inner = rep.driver.submit(
                        prompt, outer.max_new - gen, seed=outer.seed,
                        stream=True, timeout_s=timeout_s,
                        request_id=outer.id, resume_from=gen,
                        requeue=requeue or allow_draining)
                except AdmissionFull:
                    refused = True
                    continue
                except Draining:
                    # Began draining between the candidate scan and
                    # the submit: the next pass re-scans with the
                    # drain-aware rule.
                    allow_draining = True
                    continue
                except RuntimeError:
                    # Driver died between scan and submit; the monitor
                    # will mark it — never a candidate again.
                    preq.excluded.add(rep.idx)
                    continue
                rep.note_affinity(preq.affinity_key)
                preq.replica, preq.inner = rep, inner
                return
            if not refused:
                continue        # candidate set changed under us: rescan
            # EVERY candidate refused (transient pool pressure): the
            # wait is bounded by the request's own deadline, so backoff
            # replaces fail-fast INSIDE the pool — the pool-level bound
            # in submit() still sheds 429 when the whole pool is over
            # capacity.
            if self._metrics is not None:
                self._metrics.retries.inc()
            events.instant("request/place_retry", request_id=outer.id,
                           backoff_s=round(backoff, 4))
            sleep = backoff
            if outer.deadline is not None:
                sleep = min(sleep, max(
                    0.0, outer.deadline - time.monotonic()))
            time.sleep(sleep)
            backoff = min(backoff * 2, self._backoff_cap_s)

    # -- prefill→decode KV handoff (disaggregated serving) -----------------

    def _prefill_workers(self) -> list:
        """Usable DEDICATED prefill replicas whose driver speaks the
        handoff exchange, least loaded first."""
        pres = [rep for rep in self._replicas
                if rep.usable() and rep.role() == "prefill"
                and getattr(rep.driver, "prefill_export", None)
                is not None]
        pres.sort(key=lambda r: (r.load(), r.idx))
        return pres

    def _maybe_handoff(self, preq: _PoolRequest, prompt,
                       rep: Replica) -> None:
        """Stage the prompt's head on a dedicated prefill worker and
        install the exported KV rows on the chosen decode replica
        BEFORE submitting — admission then takes the radix prefix hit,
        which is already pinned bitwise-identical to a local prefill,
        so disaggregation never changes output, only where prefill
        runs.  Every failure path (no prefill worker, export refusal,
        oversized frame, install refusal, a worker dying mid-handoff)
        silently degrades the request to a local prefill; a prefill
        worker that dies mid-export simply loses its staged work and
        the request re-enters here on the next prefill candidate —
        nothing was committed anywhere."""
        if disagg_killed():
            return
        install = getattr(rep.driver, "install_handoff", None)
        if install is None:
            return
        bs = getattr(rep.engine, "kv_block_size", 16) or 16
        if len(prompt) <= bs:
            return          # nothing exportable (the engine keeps at
            #                 least one suffix token for decode anyway)
        if rep.affinity(preq.affinity_key):
            return          # already warm there: placement wins as-is
        t0 = time.monotonic()
        for pre in self._prefill_workers():
            # Spans, not just the terminal instant: a fleet waterfall
            # (JAX's tools/trace_report.py --fleet) reads the export span's
            # end → install span's start gap as the handoff's measured
            # wire+queue hop, in the parent's own clock domain (no
            # offset correction involved, so the hop is positive by
            # construction and comparable across skewed workers).
            with events.span("handoff/export",
                             request_id=preq.handle.id,
                             prefill_replica=pre.idx):
                try:
                    out = pre.driver.prefill_export(prompt)
                except RuntimeError:
                    out = None  # prefill worker died between scan/ask
            if out is None:
                continue    # refusal (or death mid-export): next one
            meta, blob = out
            with events.span("handoff/install",
                             request_id=preq.handle.id,
                             decode_replica=rep.idx,
                             bytes=len(blob)):
                try:
                    n = install(meta, blob)
                except RuntimeError:
                    n = 0
            if n:
                rep.note_affinity(preq.affinity_key)
                m = self._metrics
                if m is not None:
                    hb = getattr(m, "handoff_bytes", None)
                    if hb is not None:
                        hb.inc(len(blob))
                    hs = getattr(m, "handoff_seconds", None)
                    if hs is not None:
                        hs.observe(time.monotonic() - t0)
                events.instant("request/kv_handoff",
                               request_id=preq.handle.id,
                               prefill_replica=pre.idx,
                               decode_replica=rep.idx,
                               tokens=int(n), bytes=len(blob))
            # Decode-side refusal is final for this placement (its
            # engine said no — e.g. pool pressure); local prefill.
            return

    # -- the per-request pump ----------------------------------------------

    @thread_role("pump")
    def _pump(self, preq: _PoolRequest) -> None:
        outer = preq.handle
        requeue = False
        try:
            while True:
                try:
                    self._place(preq, requeue)
                except DeadlineExceeded as e:
                    self._finish(preq, None, e, "expired")
                    return
                except NoReplicas as e:
                    self._finish(preq, None, e, "error")
                    return
                except RequestError as e:
                    self._finish(preq, None, e, "invalid")
                    return
                verdict = self._relay(preq)
                if verdict == "done":
                    self._finish(preq,
                                 list(outer.prompt) + preq.generated,
                                 None, "ok")
                    return
                if verdict in ("failover", "migrate"):
                    # Both re-place from the last committed token with
                    # resume-from-token determinism; migration differs
                    # only in that the KV already landed on the target
                    # (radix hit instead of re-prefill) and the source
                    # is avoided, not excluded.
                    requeue = True
                    continue
                return                      # _relay already finished it
        except BaseException as e:          # noqa: BLE001 — fail loudly
            logger.exception("pool pump for request %d died", outer.id)
            self._finish(preq, None,
                         RuntimeError(f"pool pump failed: {e!r}"),
                         "error")

    def _relay(self, preq: _PoolRequest) -> str:
        """Relay committed chunks from the inner stream to the outer
        handle until the life ends: returns ``"done"``, ``"failover"``
        (replica died — the pump re-places), ``"migrate"`` (the lane
        was exported off this replica — the pump re-places onto the
        target), or ``"finished"`` when a terminal error was already
        delivered."""
        outer, inner, rep = preq.handle, preq.inner, preq.replica
        q = inner._queue
        while True:
            if preq.migrate_to is not None:
                # A migration was requested (operator move, drain
                # evacuation, defrag).  The relay thread is the single
                # consumer of the inner stream, so running the move
                # HERE means no chunk can be relayed mid-export.
                verdict = self._migrate_now(preq)
                if verdict is not None:
                    return verdict
            try:
                item = q.get(timeout=_POLL_S)
            except queue_mod.Empty:
                if rep.dead or not rep.driver.alive():
                    # The monitor declared the replica dead (hung
                    # dispatch or vanish) — or its driver thread is
                    # simply gone (a drain race can strand a late
                    # requeue): either way the inner handle will never
                    # resolve; fail over from the last COMMITTED token.
                    # (A normally-drained request delivers its _DONE
                    # before the thread exits, so reaching here with a
                    # dead thread means the handle truly dangles.)
                    return self._begin_failover(
                        preq, rep.dead_reason or "replica gone")
                continue
            if item is _DONE:
                return "done"
            if isinstance(item, DeadlineExceeded):
                self._finish(preq, None, item, "expired")
                return "finished"
            if isinstance(item, RequestError):
                self._finish(preq, None, item, "invalid")
                return "finished"
            if isinstance(item, BaseException):
                # The driver loop died with error propagation: the
                # replica is (about to be marked) dead; fail over.
                return self._begin_failover(preq, repr(item))
            # A committed chunk of generated tokens.
            preq.generated.extend(item)
            self._on_chunk(preq, item)

    def _begin_failover(self, preq: _PoolRequest, reason: str) -> str:
        rep = preq.replica
        preq.excluded.add(rep.idx)
        preq.failovers += 1
        preq.replica = preq.inner = None
        if self._metrics is not None:
            self._metrics.failovers.inc()
        events.instant("request/failover", request_id=preq.handle.id,
                       from_replica=rep.idx,
                       resumed_at=len(preq.generated),
                       reason=str(reason)[:200])
        logger.warning(
            "request %d failing over from replica %d at %d generated "
            "tokens (%s)", preq.handle.id, rep.idx,
            len(preq.generated), reason)
        return "failover"

    # -- live mid-stream migration -----------------------------------------

    @thread_role("handler", "main", "scaler", "watchdog")
    def migrate(self, request_id: int, target: Optional[int] = None,
                timeout_s: float = 30.0) -> bool:
        """Move one live request to another replica mid-stream WITHOUT
        losing its KV: export the lane (block-table rows + token
        history + rng counter, the KV_HANDOFF byte recipe), install it
        on the target, and re-place the request there — it resumes
        decoding bitwise (resume-from-token pins the rng stream; the
        radix hit on the shipped rows replaces the re-prefill failover
        would pay).  ``target`` picks a replica index; None lets the
        pool choose (warmest affinity, then load).  Returns True once
        the move committed, False when it could not happen (unknown or
        finished request, no usable target, export refusal, the
        ``TTD_NO_MIGRATION`` kill switch) — the request keeps running
        where it was in every False case EXCEPT an export that
        committed on the source and then failed to land: that one
        still completes via the normal failover re-placement, tokens
        intact (the no-token-lost contract is placement-independent).

        Blocks up to ``timeout_s`` for the pump to perform the move
        (the relay thread owns the inner stream; migration runs there
        so no chunk can race the export)."""
        if migration_killed():
            return False
        with self._lock:
            preq = self._requests.get(request_id)
        if preq is None:
            return False
        want = "auto"
        if target is not None:
            want = next((r for r in self._replicas
                         if r.idx == int(target)), None)
            if (want is None or not want.usable()
                    or not want.decode_capable()):
                return False
        done = threading.Event()
        preq.migrate_ok = False
        preq.migrate_done = done
        preq.migrate_to = want      # published last: the relay's cue
        if not done.wait(timeout_s):
            return False
        return bool(preq.migrate_ok)

    def _migrate_now(self, preq: _PoolRequest) -> Optional[str]:
        """Perform a requested migration on the relay thread; returns
        ``"migrate"`` when the lane left the source (the pump must
        re-place), None when the move could not happen and the relay
        should keep streaming from the current replica."""
        outer, src = preq.handle, preq.replica
        want = preq.migrate_to
        target = want if isinstance(want, Replica) else None
        if target is None:
            cands = [r for r in self._replicas
                     if r is not src and r.usable()
                     and r.decode_capable()
                     and r.idx not in preq.excluded]
            key = preq.affinity_key
            cands.sort(key=lambda r: (-r.affinity(key), r.load(),
                                      r.idx))
            target = cands[0] if cands else None
        ok, warm, blob_len = False, 0, 0
        t0 = time.monotonic()
        if (target is not None and target is not src
                and src is not None and target.usable()
                and not migration_killed()):
            export = getattr(src.driver, "export_lane", None)
            out = None
            if export is not None:
                try:
                    # Bounded: a replica that VANISHES mid-export
                    # (kill9 semantics — pending calls never resolve)
                    # must not wedge the relay thread forever; the
                    # timeout lands in the except arm and the stream
                    # finishes via the normal failover re-placement.
                    out = export(outer.id, timeout_s=30.0)
                except (RuntimeError, TimeoutError) as e:
                    # Source died or wedged mid-export: nothing moved
                    # (or the reply was lost AFTER the source retired
                    # the lane — then the inner handle errors out and
                    # the normal failover path resumes from the last
                    # committed token; either way no token is lost).
                    logger.warning(
                        "request %d: migration export from replica %d "
                        "failed (%s)", outer.id, src.idx, e)
            if out is not None:
                meta, blob = out
                blob_len = len(blob)
                # The source retired the lane at export — from here
                # the move MUST complete via re-placement.  The meta
                # token history is authoritative (snapshotted between
                # engine steps, always >= what the relay delivered):
                # commit the tail the stream never saw.
                toks = meta.get("tokens")
                if toks:
                    base = len(outer.prompt) + len(preq.generated)
                    fresh = [int(t) for t in toks[base:]]
                    if fresh:
                        preq.generated.extend(fresh)
                        self._on_chunk(preq, fresh)
                install = getattr(target.driver, "install_lane", None)
                if install is not None and blob:
                    try:
                        warm = int(install(meta, blob,
                                           timeout_s=30.0) or 0)
                    except (RuntimeError, TimeoutError,
                            ValueError) as e:
                        # Install refusal/death is benign: the
                        # re-placed request prefills locally —
                        # exactly the failover path, bitwise.
                        logger.warning(
                            "request %d: migration install on replica "
                            "%d refused (%s)", outer.id, target.idx, e)
                        warm = 0
                target.note_affinity(preq.affinity_key)
                preq.preferred, preq.avoid = target.idx, src.idx
                preq.replica = preq.inner = None
                preq.migrations += 1
                dt = time.monotonic() - t0
                m = self._metrics
                if m is not None:
                    c = getattr(m, "migrations", None)
                    if c is not None:
                        c.inc()
                    h = getattr(m, "migration_seconds", None)
                    if h is not None:
                        h.observe(dt)
                    b = getattr(m, "migrated_kv_bytes", None)
                    if b is not None:
                        b.inc(blob_len)
                events.instant("request/migrate", request_id=outer.id,
                               from_replica=src.idx,
                               to_replica=target.idx,
                               tokens=int(warm), bytes=blob_len,
                               resumed_at=len(preq.generated),
                               ms=round(dt * 1e3, 3))
                logger.info(
                    "request %d migrated replica %d -> %d at %d "
                    "generated tokens (%d warm, %d bytes)", outer.id,
                    src.idx, target.idx, len(preq.generated), warm,
                    blob_len)
                ok = True
        preq.migrate_ok = ok
        preq.migrate_to = None
        ev, preq.migrate_done = preq.migrate_done, None
        if ev is not None:
            ev.set()
        return "migrate" if ok else None

    def _evacuate(self, rep: Replica,
                  timeout: Optional[float] = None) -> int:
        """Migrate every live request off ``rep`` (drain-time
        evacuation): with >=2 usable replicas a drain no longer makes
        its streams WAIT for natural completion — they move and keep
        decoding elsewhere.  Returns the number of requests moved;
        whatever could not move (no survivor, export refusal, the
        kill switch) simply drains the old way."""
        if migration_killed():
            return 0
        if not any(r is not rep and r.usable() and r.decode_capable()
                   for r in self._replicas):
            return 0
        with self._lock:
            victims = [preq.handle.id
                       for preq in self._requests.values()
                       if preq.replica is rep]
        if not victims:
            return 0
        per = 30.0 if timeout is None else max(1e-3,
                                               min(30.0, timeout))
        moved = sum(self.migrate(rid, timeout_s=per)
                    for rid in victims)
        events.instant("replica/evacuate", replica=rep.idx,
                       lanes=len(victims), moved=moved)
        logger.info("replica %d evacuated: %d/%d lanes migrated",
                    rep.idx, moved, len(victims))
        return moved

    @thread_role("handler", "main", "scaler")
    def defragment(self, max_moves: int = 8) -> int:
        """Pack the least-occupied replica's lanes onto the rest of
        the fleet (bounded by ``max_moves`` and the others' spare
        slots) so low-tide scale-down can actually reclaim a worker —
        the long-tail streams that used to pin a nearly-idle replica
        now migrate off it.  Returns the number of lanes moved."""
        if migration_killed():
            return 0
        usable = [r for r in self._replicas
                  if r.usable() and r.decode_capable()
                  and not r.driver.is_draining()]
        if len(usable) < 2:
            return 0
        with self._lock:
            by_rep: dict = {}
            for preq in self._requests.values():
                if preq.replica is not None:
                    by_rep.setdefault(preq.replica.idx,
                                      []).append(preq.handle.id)
        occupied = [r for r in usable if by_rep.get(r.idx)]
        if len(occupied) < 2:
            return 0
        donor = min(occupied, key=lambda r: (len(by_rep[r.idx]),
                                             -r.idx))
        spare = sum(max(0, r.slots - r.driver.active_slots())
                    for r in usable if r is not donor)
        moves = min(max_moves, len(by_rep[donor.idx]), spare)
        if moves <= 0:
            return 0
        moved = sum(self.migrate(rid)
                    for rid in by_rep[donor.idx][:moves])
        if moved:
            events.instant("pool/defragment", donor=donor.idx,
                           moved=moved)
        return moved

    def _on_chunk(self, preq: _PoolRequest, chunk: list) -> None:
        outer = preq.handle
        now = time.monotonic()
        m = self._metrics
        if not preq.queue_wait_seen:
            preq.queue_wait_seen = True
            granted = preq.inner.slot_granted_at or now
            if m is not None:
                m.queue_wait.observe(max(0.0, granted - outer.t_submit))
        if outer.first_token_at is None:
            outer.first_token_at = now
            if m is not None:
                m.ttft.observe(now - outer.t_submit)
        if m is not None:
            m.tokens.inc(len(chunk))
            if outer.last_commit_at is not None:
                m.inter_token.observe(
                    (now - outer.last_commit_at) / len(chunk))
        outer.last_commit_at = now
        # No pool-side commit instant: the replica's driver already
        # records request/commit for every chunk (with its replica id).
        outer._push_new(list(outer.prompt) + preq.generated)

    def _finish(self, preq: _PoolRequest, tokens: Optional[list],
                error: Optional[BaseException], status: str) -> None:
        outer = preq.handle
        with self._lock:
            if outer.id not in self._requests:
                return                      # already finished
            del self._requests[outer.id]
            self._terminal[outer.id] = status
            while len(self._terminal) > _TERMINAL_KEEP:
                self._terminal.popitem(last=False)
        m = self._metrics
        if m is not None:
            m.requests.inc(label_value=status)
            if status == "ok":
                m.latency.observe(time.monotonic() - outer.t_submit)
        events.instant("request/pool_retire", request_id=outer.id,
                       status=status, failovers=preq.failovers,
                       migrations=preq.migrations)
        outer._resolve(tokens, error)
        # A migrate() caller blocked on a request that just finished
        # must not hang out its timeout: signal failure (migrate_ok
        # stays whatever the relay last published — False unless the
        # move actually committed before the finish).
        ev = preq.migrate_done
        if ev is not None:
            ev.set()

    # -- request forensics / control ---------------------------------------

    def request_status(self, request_id: int) -> str:
        with self._lock:
            status = self._terminal.get(request_id)
            if status is not None:
                return status
            preq = self._requests.get(request_id)
        if preq is None:
            return "unknown"
        rep, inner = preq.replica, preq.inner
        if rep is None or inner is None:
            return "queued"                 # placing / failing over
        status = rep.driver.request_status(request_id)
        if status in ("queued", "active"):
            return status
        return "active"     # life just ended; the pump is resolving

    def abandon(self, handle: RequestHandle) -> None:
        """Streaming client went away: collapse the deadline so the
        current life is cancelled at the replica's next sweep and the
        pump expires instead of decoding for nobody."""
        handle.deadline = time.monotonic()
        with self._lock:
            preq = self._requests.get(handle.id)
        if preq is not None:
            rep, inner = preq.replica, preq.inner
            if rep is not None and inner is not None:
                rep.driver.abandon(inner)

    # -- health monitor ----------------------------------------------------

    @thread_role("watchdog")
    def _monitor(self) -> None:
        while not self._stop.wait(self._monitor_poll_s):
            for rep in self._replicas:
                if rep.dead:
                    continue
                drv = rep.driver
                reason = None
                failure = drv.failure()
                if failure is not None:
                    reason = f"driver failed: {failure!r}"
                elif not drv.alive() and (not drv.is_draining()
                                          or drv.vanished()):
                    # Drivers that can say HOW they vanished do (a
                    # ProcDriver reports the worker's wait status —
                    # "killed by signal 9" beats "vanished").  The
                    # drain exemption covers ONLY an orderly drain: a
                    # worker SIGKILLed/OOMed mid-drain vanishes
                    # abruptly (no BYE, nonzero wait status) and must
                    # be classified dead, not pruned as a clean
                    # scale-down.
                    how = getattr(drv, "vanish_reason", None)
                    reason = ((how() if how is not None else None)
                              or "driver vanished (no corpse, no drain)")
                elif (self._watchdog_s is not None
                      and drv.steps_completed() > 0
                      and drv.step_elapsed() > self._watchdog_s):
                    # Armed only after a completed step: the first
                    # dispatch pays one-time costs and must not read as
                    # a hang.
                    reason = (f"dispatch hung > {self._watchdog_s:g}s "
                              f"(watchdog)")
                if reason is not None:
                    self._declare_dead(rep, reason)

    def _declare_dead(self, rep: Replica, reason: str) -> None:
        rep.mark_dead(reason)
        # Fence the corpse: a wedged dispatch that WAKES later must
        # not drive the device (or consume armed chaos-fault budgets)
        # after its requests failed over — the driver loop exits at
        # its next iteration instead of dispatching.
        rep.driver.poison(reason)
        events.instant("replica/dead", replica=rep.idx, reason=reason)
        logger.error("replica %d declared DEAD: %s (%d alive)",
                     rep.idx, reason, self.alive_count())

    # -- drain -------------------------------------------------------------

    def drain(self) -> None:
        """Stop admitting new pool requests; already-accepted work
        (including failover re-admissions) runs to completion.
        Idempotent and non-blocking — ``join()`` does the staged
        per-replica drain."""
        with self._lock:
            self._draining = True

    def join(self, timeout: Optional[float] = None) -> bool:
        """Drain and wait: replicas drain ONE AT A TIME (capacity
        degrades gradually — the pool analog of the single driver's
        stop-the-world drain), then the surviving pumps finish.
        Returns True when everything drained inside ``timeout``."""
        self.drain()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)

        def left() -> Optional[float]:
            return (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))

        drained = True
        for rep in self._replicas:          # sequential, by design
            if not rep.usable():
                continue
            # Evacuate BEFORE the drain flag flips: live lanes migrate
            # to a survivor and keep decoding (drain cost becomes one
            # KV ship instead of waiting out the longest stream).
            # With one replica left — or TTD_NO_MIGRATION=1 — this is
            # a no-op and the drain waits for completion, the pre-
            # migration behavior byte-for-byte.
            self._evacuate(rep, left())
            rep.driver.drain()
            drained &= rep.driver.join(left())
        # Snapshot under the lock: pumps _finish() concurrently (del
        # under ``_lock``) and a dict-values iteration racing those
        # dels raises "dictionary changed size" in THIS thread.
        with self._lock:
            pending = list(self._requests.values())
        for preq in pending:
            t = preq.thread
            if t is not None:
                t.join(left())
                drained &= not t.is_alive()
        self._stop.set()
        with self._lock:
            drained &= not self._requests
        return drained
