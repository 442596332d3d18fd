"""Deterministic fault injection for chaos/recovery testing (a copy of
the JAX package's ``runtime/faults.py``: standard library and numpy only,
the same plan grammar and environment variables, so a chaos plan written
for the JAX launcher runs unchanged here).

In the port the ``step``, ``ckpt:save`` and ``data:read`` sites are
armed (``training.trainer``, ``training.checkpoint``,
``data.filesource`` / ``data.tfrecord``); ``serve:`` and ``mesh:``
entries parse but no site calls them yet.

The reference validates its fault-tolerance stack by killing workers
under ``MultiProcessRunner`` (SURVEY.md §4.5) — coarse, external, and
only reachable from tests.  This module puts the faults *inside* the
trainer's own seams so recovery machinery (supervisor relaunch,
crash-consistent restore, data-read retry) can be exercised
deterministically from a CLI flag, in CI, against the real code paths.

A **fault plan** is a ``;``-separated list of entries
(``--fault-plan`` / ``TTD_FAULT_PLAN``)::

    step:120:raise              # raise InjectedFault at step 120
    step:200:kill9              # SIGKILL the process at step 200
    step:80:sigterm             # deliver SIGTERM (preemption sim)
    mesh:device_lost:4:step=5   # lose devices at step 5; 4 survive
    ckpt:save:partial           # corrupt the next finished save
    ckpt:save:partial:step=40   # corrupt the step-40 save specifically
    data:read:transient_io:p=0.01   # fail ~1% of record reads (seeded)
    data:read:transient_io:n=2      # fail the first 2 read ATTEMPTS
    serve:dispatch:5:raise          # engine driver dies at dispatch 5
    serve:dispatch:5:hang           # ... hangs mid-dispatch (watchdog)
    serve:dispatch:5:kill9:replica=1    # replica 1 vanishes abruptly
    serve:dispatch:5:killpid:replica=0  # REAL SIGKILL of this process

Mesh-side entries (``mesh:device_lost:<survivors>``) simulate losing
part of the device mesh mid-training: at/after the ``step=`` trigger
(default: the first observed boundary) the trainer raises
``DeviceLost(survivors)`` — the same exception ``launch.py`` converts
real runtime device failures into — which the launcher turns into the
device-loss exit-code contract (``runtime.supervisor``): surviving
device count recorded in the elastic sidecar, exit
``DEVICE_LOSS_EXIT_CODE``, supervisor relaunch onto the survivors with
the checkpoint resharded (``training.checkpoint``).  This is the
trainer-side analog of ``serve:dispatch:kill9`` at mesh granularity.

Serving-side entries (``serve:dispatch``) fire at the engine driver's
Nth decode dispatch — the serving analog of the trainer's step
boundary, so replica failover is chaos-testable the way training
recovery is.  ``replica=K`` scopes an entry to one replica of a
multi-replica gateway; entries without it fire on every driver, each
driver with its own independent ``times`` budget.
Actions mirror the process-level ones at replica granularity:
``raise`` kills the driver loop with error propagation (pending
requests learn immediately), ``hang`` wedges the dispatch
(``hang_s=`` bounds the sleep; default 3600 — the watchdog's prey),
and ``kill9`` makes an IN-PROCESS replica vanish abruptly: the driver
thread exits without resolving a single handle or recording a corpse
— nobody is notified, exactly what SIGKILL looks like to the pool's
liveness monitor.  (A true ``os.kill`` would take every replica in
the process down with it; subprocess replicas get the real thing:)
``killpid`` delivers an ACTUAL ``os.kill(os.getpid(), SIGKILL)`` at
the dispatch boundary — the process is gone before the next
instruction.  It only makes sense inside a subprocess replica worker
(``server.worker`` arms plans from ``TTD_FAULT_PLAN`` in its own
environment, so a ``replica=K``-scoped entry kills exactly one
worker of a pool); armed in a test process or a single-process
gateway it kills THAT process, by design — the whole point is that
nothing survives to fake the signal.

Data-read faults count *attempts*, and the retry loop's attempts count
too: ``n`` below ``filesource.IO_RETRY_ATTEMPTS`` (3) is absorbed by
retry-with-backoff; ``n`` at or above it makes one record's read fail
through its whole budget — the persistent-outage simulation — and the
error propagates.

Every entry accepts ``attempt=K``: it is live only on supervisor
attempt K (``TTD_SUPERVISE_ATTEMPT``, exported by
``runtime.supervisor``) — the knob that makes a kill-at-step-N plan
fire on the first launch and stay quiet after the relaunch, instead of
crash-looping the restart budget away.  Non-probabilistic entries fire
``times`` times (default once) within an attempt.

Injection points are **zero-cost when no plan is armed**: call sites
guard on the module-level ``ARMED`` flag (one attribute read — no
function call, no dict lookup) and only enter this module when a plan
is live.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

ENV_PLAN = "TTD_FAULT_PLAN"
ENV_ATTEMPT = "TTD_SUPERVISE_ATTEMPT"

# The one flag injection sites check (module attribute: reading it is a
# single LOAD_ATTR, measured ~40 ns — noise against a >1 ms train step,
# and the read only happens once per host-loop iteration, never inside
# jitted code).
ARMED = False

_PLAN: "Optional[FaultPlan]" = None


class InjectedFault(RuntimeError):
    """A fault raised on purpose by the armed plan (``raise`` action)."""


class InjectedTransientIO(OSError):
    """A transient IO error injected into a record read — the retryable
    kind (``data.filesource.read_with_retries`` absorbs it)."""


class InjectedKill(BaseException):
    """An in-process replica's ``kill9``: the engine driver loop must
    exit WITHOUT resolving handles or recording a failure — SIGKILL
    semantics at thread granularity (a BaseException so ordinary
    ``except Exception`` recovery machinery cannot absorb it)."""


class DeviceLost(RuntimeError):
    """Part of the device mesh failed mid-run.

    ``survivors`` is the usable device count after the loss (None when
    unknown — a real runtime failure where nothing can be probed).
    Raised by the ``mesh:device_lost`` injection point, or converted
    from a real runtime error by ``as_device_loss``; ``launch.py``
    turns it into the device-loss exit-code contract the supervisor
    relaunches on (``runtime.supervisor.DEVICE_LOSS_EXIT_CODE``)."""

    def __init__(self, message: str, survivors: Optional[int] = None):
        super().__init__(message)
        self.survivors = survivors


# Signatures of runtime errors that mean a device (not the program)
# died: the PJRT/XLA strings raised when a chip drops off the ICI
# fabric or its runtime process dies mid-execution.  Deliberately
# narrow — a false positive would reshard a healthy mesh on an
# ordinary crash, silently shrinking the run's compute, and relaunch
# it free of the crash budget.  Generic status-code strings
# ("DATA_LOSS", gRPC's "failed to connect to all addresses") are
# EXCLUDED on purpose: they also decorate corrupted-input reads and
# misconfigured-coordinator failures, which must stay ordinary
# budgeted crashes.
_DEVICE_LOSS_SIGNATURES = (
    "device is in an invalid state",
    "Device or slice has been lost",
    "TPU is in an unhealthy state",
)


def as_device_loss(exc: BaseException) -> Optional[DeviceLost]:
    """``DeviceLost`` view of a runtime error, or None.

    Passes an existing ``DeviceLost`` through; otherwise matches the
    error text against the known device-failure signatures.  Survivor
    count stays None for converted errors — after a real device loss
    the backend cannot be probed from this process; the relaunch
    re-discovers the device set itself."""
    if isinstance(exc, DeviceLost):
        return exc
    text = str(exc)
    if any(sig in text for sig in _DEVICE_LOSS_SIGNATURES):
        return DeviceLost(f"device loss inferred from runtime error: "
                          f"{type(exc).__name__}: {text[:500]}")
    return None


_STEP_ACTIONS = ("raise", "kill9", "sigterm", "exit")
_MESH_ACTIONS = ("device_lost",)
_CKPT_ACTIONS = ("partial",)
_DATA_ACTIONS = ("transient_io",)
_SERVE_ACTIONS = ("raise", "hang", "kill9", "killpid")


@dataclasses.dataclass
class FaultEntry:
    site: str                     # "step" | "ckpt:save" | "data:read"
    action: str
    trigger_step: Optional[int] = None   # step entries: fire at/after it
    params: dict = dataclasses.field(default_factory=dict)
    fired: int = 0
    # serve:dispatch only — fire budget PER DRIVER (keyed by replica
    # id, None standalone): an unscoped entry fires on EVERY replica's
    # driver, `times` times each, instead of N drivers racing one
    # shared budget.
    fired_per: dict = dataclasses.field(default_factory=dict)

    @property
    def times(self) -> int:
        # step/ckpt entries fire `times` times; count-based data entries
        # spell the budget `n` (``data:read:transient_io:n=3``).
        return int(self.params.get("times", self.params.get("n", 1)))

    @property
    def attempt(self) -> Optional[int]:
        a = self.params.get("attempt")
        return None if a is None else int(a)

    def live(self, attempt: int) -> bool:
        if self.attempt is not None and attempt != self.attempt:
            return False
        if self.action == "transient_io" and "p" in self.params:
            return True                  # probabilistic: no fire budget
        return self.fired < self.times


class FaultPlan:
    """Parsed plan + the per-process RNG for probabilistic entries."""

    def __init__(self, entries: list, *, seed: int = 0,
                 attempt: Optional[int] = None):
        self.entries = list(entries)
        self.attempt = (int(os.environ.get(ENV_ATTEMPT, "0"))
                        if attempt is None else int(attempt))
        self._rng = np.random.default_rng(
            np.random.SeedSequence([seed, self.attempt]))
        self._reads = 0

    def __repr__(self) -> str:
        return (f"FaultPlan(attempt={self.attempt}, "
                f"entries={self.entries!r})")


def _parse_params(parts: list) -> dict:
    params = {}
    for p in parts:
        key, sep, val = p.partition("=")
        if not sep or not key:
            raise ValueError(
                f"fault param {p!r} is not key=value")
        try:
            params[key] = float(val) if "." in val else int(val)
        except ValueError:
            raise ValueError(
                f"fault param {p!r}: value must be numeric") from None
    return params


def parse_plan(spec: str, *, seed: int = 0,
               attempt: Optional[int] = None) -> FaultPlan:
    """Parse the plan grammar (module docstring) into a ``FaultPlan``.

    Unknown sites/actions fail here — arming happens at launch time, so
    a typo'd plan dies before any training compute is spent.
    """
    entries = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = [p.strip() for p in raw.split(":")]
        site = parts[0]
        if site == "step":
            if len(parts) < 3:
                raise ValueError(
                    f"fault entry {raw!r}: want step:<N>:<action>")
            try:
                trigger = int(parts[1])
            except ValueError:
                raise ValueError(
                    f"fault entry {raw!r}: step trigger {parts[1]!r} is "
                    "not an integer") from None
            action, rest = parts[2], parts[3:]
            if action == "exit" and rest and "=" not in rest[0]:
                # tolerate step:N:exit:7 for the exit code
                rest = [f"code={rest[0]}"] + rest[1:]
            if action not in _STEP_ACTIONS:
                raise ValueError(
                    f"fault entry {raw!r}: unknown step action "
                    f"{action!r}; have {_STEP_ACTIONS}")
            entries.append(FaultEntry("step", action, trigger,
                                      _parse_params(rest)))
        elif site == "mesh":
            if len(parts) < 3 or parts[1] not in _MESH_ACTIONS:
                raise ValueError(
                    f"fault entry {raw!r}: want "
                    f"mesh:device_lost:<survivors>[:step=N]")
            try:
                survivors = int(parts[2])
            except ValueError:
                raise ValueError(
                    f"fault entry {raw!r}: survivor count {parts[2]!r} is "
                    "not an integer") from None
            if survivors < 1:
                raise ValueError(
                    f"fault entry {raw!r}: survivors must be >= 1 (a "
                    "0-device mesh has nothing to relaunch onto)")
            params = _parse_params(parts[3:])
            params["survivors"] = survivors
            # ``step=`` picks the boundary (default 1: the first one the
            # loop observes) — the step-entry trigger semantics.
            entries.append(FaultEntry(
                "mesh", parts[1], int(params.get("step", 1)), params))
        elif site == "ckpt":
            if len(parts) < 3 or parts[1] != "save":
                raise ValueError(
                    f"fault entry {raw!r}: want ckpt:save:<action>")
            action, rest = parts[2], parts[3:]
            if action not in _CKPT_ACTIONS:
                raise ValueError(
                    f"fault entry {raw!r}: unknown ckpt action "
                    f"{action!r}; have {_CKPT_ACTIONS}")
            entries.append(FaultEntry("ckpt:save", action,
                                      params=_parse_params(rest)))
        elif site == "serve":
            if len(parts) < 4 or parts[1] != "dispatch":
                raise ValueError(
                    f"fault entry {raw!r}: want serve:dispatch:<N>:"
                    f"<action>")
            try:
                trigger = int(parts[2])
            except ValueError:
                raise ValueError(
                    f"fault entry {raw!r}: dispatch trigger {parts[2]!r} "
                    "is not an integer") from None
            action, rest = parts[3], parts[4:]
            if action not in _SERVE_ACTIONS:
                raise ValueError(
                    f"fault entry {raw!r}: unknown serve action "
                    f"{action!r}; have {_SERVE_ACTIONS}")
            entries.append(FaultEntry("serve:dispatch", action, trigger,
                                      _parse_params(rest)))
        elif site == "data":
            if len(parts) < 3 or parts[1] != "read":
                raise ValueError(
                    f"fault entry {raw!r}: want data:read:<action>")
            action, rest = parts[2], parts[3:]
            if action not in _DATA_ACTIONS:
                raise ValueError(
                    f"fault entry {raw!r}: unknown data action "
                    f"{action!r}; have {_DATA_ACTIONS}")
            params = _parse_params(rest)
            if "p" in params and not 0.0 < float(params["p"]) <= 1.0:
                raise ValueError(
                    f"fault entry {raw!r}: p must be in (0, 1]")
            entries.append(FaultEntry("data:read", action, params=params))
        else:
            raise ValueError(
                f"fault entry {raw!r}: unknown site {site!r}; have "
                "step | mesh | ckpt:save | data:read | serve:dispatch")
    if not entries:
        raise ValueError(f"fault plan {spec!r} has no entries")
    return FaultPlan(entries, seed=seed, attempt=attempt)


def arm(plan, *, seed: int = 0) -> FaultPlan:
    """Arm a plan (spec string or ``FaultPlan``) process-wide."""
    global _PLAN, ARMED
    if isinstance(plan, str):
        plan = parse_plan(plan, seed=seed)
    _PLAN = plan
    ARMED = True
    logger.warning("fault plan ARMED: %r", plan)
    return plan


def disarm() -> None:
    global _PLAN, ARMED
    _PLAN = None
    ARMED = False


def arm_from_env(*, seed: int = 0) -> Optional[FaultPlan]:
    """Arm from ``TTD_FAULT_PLAN`` if set (launch calls this once,
    passing the run seed so env- and flag-armed plans produce the same
    probabilistic fault trace)."""
    spec = os.environ.get(ENV_PLAN)
    if not spec:
        return None
    return arm(spec, seed=seed)


def plan() -> Optional[FaultPlan]:
    return _PLAN


def _execute_step_action(entry: FaultEntry, step: int) -> None:
    entry.fired += 1
    if entry.action == "raise":
        raise InjectedFault(f"injected fault at step {step}")
    if entry.action == "kill9":
        logger.warning("fault injection: SIGKILL at step %d", step)
        os.kill(os.getpid(), signal.SIGKILL)
    if entry.action == "sigterm":
        logger.warning("fault injection: SIGTERM at step %d", step)
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if entry.action == "exit":
        code = int(entry.params.get("code", 1))
        logger.warning("fault injection: exit(%d) at step %d", code, step)
        # os._exit: a crash, not an orderly shutdown — no atexit, no
        # checkpoint flush, exactly what a segfault looks like to the
        # supervisor (minus the signal).
        os._exit(code)


def step_boundary(step: int) -> None:
    """Trainer step-boundary injection point.

    Fires entries whose trigger has been reached (``trigger <= step`` —
    with ``steps_per_execution`` k>1 the loop only observes every k-th
    boundary, and a trigger between two boundaries fires at the next
    one rather than never).  ``mesh:device_lost`` entries share the
    boundary: a lost chip surfaces to the host loop at the next
    dispatch, which is exactly here.
    """
    p = _PLAN
    if p is None:
        return
    for entry in p.entries:
        if entry.site not in ("step", "mesh") or not entry.live(p.attempt):
            continue
        if step < entry.trigger_step:
            continue
        if entry.site == "mesh":
            entry.fired += 1
            survivors = int(entry.params["survivors"])
            logger.warning(
                "fault injection: device loss at step %d (%d devices "
                "survive)", step, survivors)
            raise DeviceLost(
                f"injected device loss at step {step} "
                f"({survivors} devices survive)", survivors)
        _execute_step_action(entry, step)


def on_checkpoint_save(step: int, step_dir: str) -> None:
    """Checkpoint-save injection point (called AFTER the manager has
    committed the save; saves are synchronous, so the dir is whole)."""
    p = _PLAN
    if p is None:
        return
    for entry in p.entries:
        if entry.site != "ckpt:save" or not entry.live(p.attempt):
            continue
        want = entry.params.get("step")
        if want is not None and int(want) != step:
            continue
        entry.fired += 1
        _make_partial(step_dir)
        logger.warning(
            "fault injection: checkpoint step %d made PARTIAL (%s)",
            step, step_dir)


def _make_partial(step_dir: str) -> None:
    """Turn a committed checkpoint step dir into a crashed-writer one:
    drop the commit marker and truncate the array data so any restore
    attempt fails (not just the marker pre-check)."""
    marker = os.path.join(step_dir, "_CHECKPOINT_METADATA")
    if os.path.exists(marker):
        os.remove(marker)
    for root, _, files in os.walk(step_dir):
        for name in files:
            path = os.path.join(root, name)
            try:
                with open(path, "r+b") as f:
                    f.truncate(max(0, os.path.getsize(path) // 2))
            except OSError:
                pass


# Serve-site firing is the one injection point hit from N concurrent
# driver threads: the budget check-and-bump must be atomic, and the
# ACTION must run outside the lock (a hang holding it would stall every
# other driver's fault check).
_SERVE_LOCK = threading.Lock()


def on_serve_dispatch(n: int, replica: Optional[int] = None) -> None:
    """Engine-driver dispatch injection point (called by
    ``server.driver`` before the Nth ``serve_step``; ``replica`` is the
    driver's replica id in a pool, None standalone).  Triggers fire
    at/after their dispatch ordinal (the step-boundary rule), with an
    independent ``times`` budget PER DRIVER — an entry without
    ``replica=`` fires on every replica; the first matching entry wins
    a given dispatch."""
    p = _PLAN
    if p is None:
        return
    fire = None
    with _SERVE_LOCK:
        for entry in p.entries:
            if entry.site != "serve:dispatch":
                continue
            if entry.attempt is not None and p.attempt != entry.attempt:
                continue
            want = entry.params.get("replica")
            if want is not None and (replica is None
                                     or int(want) != int(replica)):
                continue
            if n < entry.trigger_step:
                continue
            if entry.fired_per.get(replica, 0) >= entry.times:
                continue
            entry.fired_per[replica] = entry.fired_per.get(replica,
                                                           0) + 1
            entry.fired += 1
            fire = entry
            break
    if fire is None:
        return
    if fire.action == "raise":
        raise InjectedFault(
            f"injected serve fault at dispatch {n}"
            + (f" (replica {replica})" if replica is not None else ""))
    if fire.action == "hang":
        hang_s = float(fire.params.get("hang_s", 3600))
        logger.warning(
            "fault injection: hanging dispatch %d (replica %s) "
            "for %gs", n, replica, hang_s)
        time.sleep(hang_s)
        return
    if fire.action == "kill9":
        logger.warning(
            "fault injection: replica %s vanishes at dispatch %d",
            replica, n)
        raise InjectedKill(
            f"injected kill9 at dispatch {n} (replica {replica})")
    if fire.action == "killpid":
        # The REAL thing: SIGKILL this whole process at the dispatch
        # boundary.  No cleanup, no flush, no exception anyone could
        # catch — the subprocess-replica chaos legs arm this in the
        # WORKER's environment so the parent gateway observes a true
        # worker death (EOF on the frame stream, waitpid says signal
        # 9), not a simulation of one.
        logger.warning(
            "fault injection: SIGKILL of pid %d at dispatch %d "
            "(replica %s)", os.getpid(), n, replica)
        os.kill(os.getpid(), signal.SIGKILL)
        return          # pragma: no cover — unreachable past SIGKILL


def on_data_read(index: int) -> None:
    """Record-read injection point (leaf data sources)."""
    p = _PLAN
    if p is None:
        return
    p._reads += 1
    for entry in p.entries:
        if entry.site != "data:read" or not entry.live(p.attempt):
            continue
        if "p" in entry.params:
            if p._rng.random() < float(entry.params["p"]):
                entry.fired += 1
                raise InjectedTransientIO(
                    f"injected transient IO on record {index}")
        else:
            entry.fired += 1
            raise InjectedTransientIO(
                f"injected transient IO on record {index} "
                f"(fault {entry.fired}/{entry.times})")
