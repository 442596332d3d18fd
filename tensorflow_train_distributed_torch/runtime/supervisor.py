"""Self-healing training supervisor: run, classify the exit, relaunch.

The reference's fault-tolerance story assumes an external cluster
manager relaunches a preempted/crashed job after
``PreemptionCheckpointHandler`` saves (SURVEY.md §5.3) — the
save-and-stop half lives in ``runtime.preemption``; this module is the
bring-it-back half, so a single command survives a ``kill -9``, a
poisoned step, or a reclaimed VM without a Borg/K8s controller above
it.

Contract:

- the child is launched as a fresh process (``sys.executable -m
  tensorflow_train_distributed_torch ...`` via the CLI, or any argv) with
  ``TTD_SUPERVISE_ATTEMPT=<n>`` exported — fault plans
  (``runtime.faults``) key one-shot faults off it, and tooling can log
  it;
- exit 0 → done;
- exit ``PREEMPTION_EXIT_CODE`` (143, ``runtime.preemption``) →
  *preemption*: the job checkpointed and stopped on purpose; relaunch
  immediately and do NOT consume the crash restart budget (a
  maintenance event is not a bug, and budgeting it would let routine
  preemptions exhaust the real crash protection);
- exit ``DEVICE_LOSS_EXIT_CODE`` (113) → *device loss*: part of the
  mesh died (``runtime.faults.DeviceLost`` — injected or inferred from
  a runtime error); the child recorded the surviving device count in
  the elastic sidecar (``TTD_ELASTIC_STATE``) before exiting, and the
  supervisor relaunches onto the survivors by exporting
  ``TTD_ELASTIC_DEVICES=<M>`` (in the JAX package the relaunch restores
  the latest checkpoint resharded onto the smaller mesh; this package
  runs on one device, so the relaunch restores onto the same device and
  the resharded restore waits for multi-GPU, ROADMAP Queue 1 step 7).
  Free of the crash budget, like preemption: losing hardware is not a
  bug in the program.
  ``TTD_NO_ELASTIC=1`` (or ``elastic=False``) reverts to classifying
  it as a plain crash — no resize, budget consumed;
- anything else (including death by signal: Popen returncode ``-N``) →
  *crash*: relaunch under jittered exponential backoff until
  ``max_restarts`` crashes have been spent, then give up with the last
  exit code.  ``restart_window_s`` makes the accounting a ROLLING
  window instead of lifetime: only crashes inside the window count
  against the budget, so a correlated burst (a rack reboot taking
  several relaunches down at once) cannot permanently exhaust the
  protection a long healthy run still deserves.  The jitter
  (``backoff_jitter``, fraction of the delay) decorrelates relaunch
  stampedes when many supervised jobs crash on the same event.

Recovery on relaunch is the CLI's existing auto-resume
(``--checkpoint-dir`` restores the latest step; crash-consistent
fallback in ``training.checkpoint`` quarantines a torn latest save and
falls back to the previous good one) — the supervisor deliberately
knows nothing about checkpoints.

Every attempt appends one JSON line to the journal (audit trail +
test surface): ``{"event": "exit", "attempt", "rc", "class",
"duration_s", "backoff_s"}`` and a final ``{"event": "done"|"giveup"}``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

from tensorflow_train_distributed_torch.runtime.lint.registry import (
    thread_role,
)

from tensorflow_train_distributed_torch.runtime import events
from tensorflow_train_distributed_torch.runtime.preemption import (
    PREEMPTION_EXIT_CODE,
)

logger = logging.getLogger(__name__)

ENV_ATTEMPT = "TTD_SUPERVISE_ATTEMPT"

# Device-loss exit-code contract (the elastic analog of
# PREEMPTION_EXIT_CODE): a child exiting with THIS code lost part of
# its device mesh (runtime.faults.DeviceLost — injected or inferred
# from a runtime error), wrote the surviving device count to the
# elastic sidecar, and wants to be relaunched onto the survivors.
# 113 carries no 128+signal meaning and collides with no conventional
# code; launch.py, the supervisor, and external schedulers share it.
DEVICE_LOSS_EXIT_CODE = 113

# Supervisor → child: where the child must record the surviving device
# count on a device loss (JSON: {"survivors": M, ...}).
ENV_ELASTIC_STATE = "TTD_ELASTIC_STATE"
# Supervisor → relaunched child: train on this many devices (the
# surviving set).  The JAX launcher shrinks its mesh to it; this
# package's one-device launcher has no smaller set to shrink to.
ENV_ELASTIC_DEVICES = "TTD_ELASTIC_DEVICES"
# Kill switch: classify device loss as a plain crash (no resize; the
# crash budget applies).
ENV_NO_ELASTIC = "TTD_NO_ELASTIC"


def classify_exit(returncode: int) -> str:
    """``clean`` | ``preemption`` | ``device_loss`` | ``crash``."""
    if returncode == 0:
        return "clean"
    if returncode == PREEMPTION_EXIT_CODE:
        return "preemption"
    if returncode == DEVICE_LOSS_EXIT_CODE:
        return "device_loss"
    return "crash"


@dataclasses.dataclass
class SupervisorResult:
    returncode: int
    attempts: int
    crashes: int
    preemptions: int
    gave_up: bool
    device_losses: int = 0


class TrainSupervisor:
    """Run ``argv`` as a child process until it exits clean, the crash
    budget is spent, or (optionally) preemptions stop being restartable.

    ``backoff_s`` doubles per budgeted crash (the exponent is the
    crash count inside ``restart_window_s`` when a window is set, the
    lifetime count otherwise — so with a window the delay decays back
    toward the base as old crashes age out), capped at
    ``backoff_max_s``, then jittered UP by up to ``backoff_jitter``
    of itself (decorrelating fleet-wide relaunch stampedes; 0
    disables).  Preemption and device-loss relaunches wait a flat
    ``backoff_s`` (no exponent — a maintenance event or dead chip is
    not a bug, but zero delay would let a child that exits at startup
    spin the loop unboundedly).  Device-loss relaunches are free of the
    CRASH budget but carry their own cap (``max_device_losses``): a
    mesh can only shrink so many times, so a child that keeps exiting
    113 — a flapping chip, or a misclassified persistent error — gives
    up instead of relaunching forever.

    The supervisor itself forwards SIGTERM/SIGINT to the live child and
    then stops relaunching (``handle_signals=True``, main thread only):
    a scheduler terminating the *supervisor* means the whole job should
    checkpoint and stop, not lose the relaunch loop out from under a
    training child mid-save.
    """

    def __init__(self, argv: Sequence[str], *,
                 max_restarts: int = 3,
                 backoff_s: float = 1.0,
                 backoff_max_s: float = 60.0,
                 backoff_jitter: float = 0.1,
                 restart_window_s: Optional[float] = None,
                 restart_on_preemption: bool = True,
                 elastic: bool = True,
                 max_device_losses: int = 16,
                 elastic_state_path: Optional[str] = None,
                 journal_path: Optional[str] = None,
                 env: Optional[dict] = None,
                 handle_signals: bool = True,
                 sleep=time.sleep,
                 rng: Optional[random.Random] = None):
        if max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {max_restarts}")
        if backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {backoff_s}")
        if not 0.0 <= backoff_jitter <= 1.0:
            raise ValueError(
                f"backoff_jitter must be in [0, 1], got {backoff_jitter}")
        if restart_window_s is not None and restart_window_s <= 0:
            raise ValueError(
                f"restart_window_s must be > 0 (None = lifetime), got "
                f"{restart_window_s}")
        if max_device_losses < 0:
            raise ValueError(
                f"max_device_losses must be >= 0, got {max_device_losses}")
        self.argv = list(argv)
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.backoff_jitter = backoff_jitter
        self.restart_window_s = restart_window_s
        self.restart_on_preemption = restart_on_preemption
        self.max_device_losses = max_device_losses
        # TTD_NO_ELASTIC=1 wins over the constructor: the operator's
        # no-redeploy veto of mesh resizing (device loss then classifies
        # as a plain crash, budget and all).
        self.elastic = (elastic and os.environ.get(
            ENV_NO_ELASTIC, "0") in ("", "0"))
        self.journal_path = journal_path
        if elastic_state_path is None and self.elastic:
            # The child needs a path it can write WITHOUT a checkpoint
            # dir configured; a journal-DERIVED sidecar when there is a
            # journal (stem-scoped: supervisors journaling different
            # files into the same directory must not read each other's
            # survivor counts), a pid-scoped tmp path otherwise.
            if journal_path:
                stem = os.path.splitext(
                    os.path.basename(journal_path))[0]
                elastic_state_path = os.path.join(
                    os.path.dirname(os.path.abspath(journal_path)),
                    f"{stem}.elastic.json")
            else:
                elastic_state_path = os.path.join(
                    tempfile.gettempdir(),
                    f"ttd_elastic_{os.getpid()}.json")
        self.elastic_state_path = elastic_state_path
        self.env = env
        self.handle_signals = handle_signals
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._proc: Optional[subprocess.Popen] = None
        self._stop_signal: Optional[int] = None
        # Surviving device count adopted after a device-loss exit; every
        # subsequent launch exports it so the relaunched child builds
        # its mesh over the survivors.
        self._elastic_devices: Optional[int] = None

    def _journal(self, record: dict) -> None:
        # Journal lines double as flight-recorder instants, so attempt
        # boundaries/relaunches land on the same timeline as the
        # trainer's step spans (runtime.events; tools/trace_report.py
        # renders both).
        events.instant(
            "supervisor/" + str(record.get("event", "event")),
            **{k: v for k, v in record.items()
               if k != "event" and isinstance(v, (str, int, float, bool))})
        if not self.journal_path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.journal_path)),
                    exist_ok=True)
        with open(self.journal_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _read_elastic_state(self) -> Optional[int]:
        """Surviving device count from the sidecar the dying child
        wrote (None when missing/unreadable/unknown — the relaunch
        then re-discovers its devices itself).  The sidecar is
        CONSUMED: a later device loss whose child failed to write one
        must read as unknown, not re-adopt this exit's stale count."""
        path = self.elastic_state_path
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                survivors = json.load(f).get("survivors")
            result = int(survivors) if survivors else None
        except (OSError, ValueError):
            logger.warning(
                "supervisor: unreadable elastic sidecar %s; relaunching "
                "with the device set unpinned", path, exc_info=True)
            result = None
        try:
            os.remove(path)
        except OSError:
            pass
        return result

    def _launch(self, attempt: int) -> int:
        env = dict(os.environ if self.env is None else self.env)
        env[ENV_ATTEMPT] = str(attempt)
        if self.elastic and self.elastic_state_path:
            env[ENV_ELASTIC_STATE] = self.elastic_state_path
        if self._elastic_devices is not None:
            env[ENV_ELASTIC_DEVICES] = str(self._elastic_devices)
        logger.info("supervisor attempt %d: %s", attempt,
                    " ".join(self.argv))
        # No stdout/stderr capture: the child IS the training job; its
        # logs stream to the operator exactly as an unsupervised run's
        # would.
        self._proc = subprocess.Popen(self.argv, env=env)
        try:
            # PEP 475: a forwarded signal interrupts this wait, runs the
            # handler, and the wait resumes until the child exits.
            return self._proc.wait()
        finally:
            self._proc = None

    def _forward_signal(self, signum, frame) -> None:
        self._stop_signal = signum
        logger.warning(
            "supervisor: got signal %d; forwarding to the child and "
            "stopping the relaunch loop after it exits", signum)
        proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signum)
            except OSError:      # child raced to exit
                pass

    @thread_role("supervisor")
    def run(self) -> SupervisorResult:
        # A sidecar left over from a PREVIOUS supervisor run is stale
        # state, not this run's survivor count: clear it so a device
        # loss whose child fails to write can never adopt it.
        if self.elastic and self.elastic_state_path:
            try:
                os.remove(self.elastic_state_path)
            except OSError:
                pass
        prev_handlers = {}
        if self.handle_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev_handlers[sig] = signal.signal(
                        sig, self._forward_signal)
                except ValueError:      # not on the main thread
                    prev_handlers.clear()
                    break
        try:
            return self._run()
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

    def _windowed_crashes(self, crash_times: list) -> int:
        """Crashes counted against the budget: all of them (lifetime),
        or only those inside the rolling ``restart_window_s``."""
        if self.restart_window_s is None:
            return len(crash_times)
        now = time.monotonic()
        return sum(1 for t in crash_times
                   if now - t <= self.restart_window_s)

    def _crash_backoff(self, consecutive: int) -> float:
        """Exponential in consecutive crashes, capped, jittered.

        The jitter multiplies UP (delay in [b, b·(1+jitter)]): shaving
        the delay below the base would defeat the backoff's purpose for
        a fraction of the fleet."""
        backoff = min(self.backoff_max_s,
                      self.backoff_s * 2 ** (consecutive - 1))
        if self.backoff_jitter and backoff:
            backoff *= 1.0 + self.backoff_jitter * self._rng.random()
        return backoff

    def _run(self) -> SupervisorResult:
        attempt = crashes = preemptions = device_losses = 0
        crash_times: list = []
        while True:
            if self._stop_signal is not None:
                # The stop signal landed while NO child was live (during
                # a backoff sleep, or between exit and relaunch): there
                # was nothing to forward it to, so stop here — launching
                # a fresh child against the scheduler's kill would run
                # the whole remaining job.
                logger.warning(
                    "supervisor: stop signal %d pending before relaunch; "
                    "not launching attempt %d", self._stop_signal, attempt)
                self._journal({"event": "stopped",
                               "signal": self._stop_signal,
                               "attempts": attempt, "crashes": crashes,
                               "preemptions": preemptions,
                               "rc": 128 + self._stop_signal})
                return SupervisorResult(128 + self._stop_signal, attempt,
                                        crashes, preemptions,
                                        gave_up=False)
            t0 = time.monotonic()
            rc = self._launch(attempt)
            duration = time.monotonic() - t0
            klass = classify_exit(rc)
            survivors = None
            if klass == "device_loss" and not self.elastic:
                logger.warning(
                    "supervisor: device-loss exit (rc=%d) with elastic "
                    "relaunch disabled (TTD_NO_ELASTIC/elastic=False); "
                    "classifying as a crash", rc)
                klass = "crash"
            backoff = 0.0
            if klass == "crash":
                crashes += 1
                crash_times.append(time.monotonic())
                backoff = self._crash_backoff(
                    self._windowed_crashes(crash_times))
            elif klass == "preemption":
                preemptions += 1
                # Flat base delay, no exponent: preemption relaunches
                # are free of the crash budget, so without it a child
                # exiting 143 right at startup would spin unboundedly.
                if self.restart_on_preemption:
                    backoff = self.backoff_s
            elif klass == "device_loss":
                device_losses += 1
                survivors = self._read_elastic_state()
                # Unknown survivors UNPIN the device set (the relaunch
                # re-discovers its devices) — keeping an older exit's
                # count would build a mesh over devices that may no
                # longer exist.
                self._elastic_devices = survivors
                # Same flat-delay rationale as preemption — hardware
                # loss is not a program bug and must not burn the crash
                # budget, but a zero delay would spin on a child that
                # loses its mesh at startup.
                backoff = self.backoff_s
            record = {"event": "exit", "attempt": attempt,
                      "rc": rc, "class": klass,
                      "duration_s": round(duration, 3),
                      "backoff_s": backoff, "time": time.time()}
            if klass == "device_loss":
                record["survivors"] = survivors
            self._journal(record)
            attempt += 1
            if klass != "clean" and self._stop_signal is not None:
                # The supervisor itself was told to stop: the child got
                # the forwarded signal (its 143 here means it saved and
                # stopped on purpose) — hand its code up, never relaunch
                # against the scheduler's will.
                self._journal({"event": "stopped",
                               "signal": self._stop_signal,
                               "attempts": attempt, "crashes": crashes,
                               "preemptions": preemptions, "rc": rc})
                return SupervisorResult(rc, attempt, crashes, preemptions,
                                        gave_up=False,
                                        device_losses=device_losses)
            if klass == "clean":
                logger.info("supervisor: clean exit after %d attempt(s)",
                            attempt)
                self._journal({"event": "done", "attempts": attempt,
                               "crashes": crashes,
                               "preemptions": preemptions})
                return SupervisorResult(0, attempt, crashes, preemptions,
                                        gave_up=False,
                                        device_losses=device_losses)
            if klass == "preemption":
                if not self.restart_on_preemption:
                    logger.warning(
                        "supervisor: preemption exit %d; restart "
                        "disabled — handing rc to the caller", rc)
                    self._journal({"event": "done", "attempts": attempt,
                                   "crashes": crashes,
                                   "preemptions": preemptions})
                    return SupervisorResult(rc, attempt, crashes,
                                            preemptions, gave_up=False,
                                            device_losses=device_losses)
                logger.warning(
                    "supervisor: preemption exit (rc=%d); relaunching "
                    "in %.2fs (crash budget untouched: %d/%d)", rc,
                    backoff, crashes, self.max_restarts)
                if backoff:
                    self._sleep(backoff)
                continue
            if klass == "device_loss":
                if device_losses > self.max_device_losses:
                    # A mesh can only shrink so many times: a child
                    # that KEEPS exiting 113 (flapping chip, unscoped
                    # fault plan, misclassified persistent error) must
                    # not relaunch forever just because the exits are
                    # crash-budget-free.
                    logger.error(
                        "supervisor: %d device-loss exits exceeded "
                        "max_device_losses=%d; giving up",
                        device_losses, self.max_device_losses)
                    self._journal({"event": "giveup", "attempts": attempt,
                                   "crashes": crashes,
                                   "preemptions": preemptions,
                                   "device_losses": device_losses,
                                   "rc": rc})
                    return SupervisorResult(
                        rc, attempt, crashes, preemptions, gave_up=True,
                        device_losses=device_losses)
                # Free of the crash budget (hardware died, not the
                # program); the relaunch builds its mesh over the
                # survivors (ENV_ELASTIC_DEVICES) and restores the
                # latest checkpoint resharded onto it.
                logger.warning(
                    "supervisor: device-loss exit (rc=%d, survivors=%s); "
                    "relaunching on the surviving devices in %.2fs "
                    "(crash budget untouched: %d/%d)", rc, survivors,
                    backoff, self._windowed_crashes(crash_times),
                    self.max_restarts)
                self._journal({"event": "resize",
                               "survivors": survivors,
                               "attempt": attempt})
                if backoff:
                    self._sleep(backoff)
                continue
            # crash — budget accounting over the rolling window when one
            # is configured: a burst of correlated crashes ages out of
            # the window instead of permanently exhausting a long run's
            # protection.
            budget_crashes = self._windowed_crashes(crash_times)
            if budget_crashes > self.max_restarts:
                logger.error(
                    "supervisor: crash rc=%d exhausted the restart "
                    "budget (%d crashes%s > %d restarts); giving up",
                    rc, budget_crashes,
                    ("" if self.restart_window_s is None else
                     f" in the last {self.restart_window_s:g}s"),
                    self.max_restarts)
                self._journal({"event": "giveup", "attempts": attempt,
                               "crashes": crashes,
                               "preemptions": preemptions, "rc": rc})
                return SupervisorResult(rc, attempt, crashes, preemptions,
                                        gave_up=True,
                                        device_losses=device_losses)
            logger.warning(
                "supervisor: crash rc=%d (%s); relaunching in %.2fs "
                "(crash %d/%d)", rc,
                f"signal {-rc}" if rc < 0 else "exit",
                backoff, budget_crashes, self.max_restarts)
            if backoff:
                self._sleep(backoff)


SUPERVISOR_FLAGS = {
    # flag -> takes a value?  (the strip list for child argv rebuild)
    "--supervise": False,
    "--max-restarts": True,
    "--restart-backoff": True,
    "--restart-backoff-max": True,
    "--restart-window": True,
    "--restart-jitter": True,
    "--no-restart-on-preemption": False,
    "--no-elastic": False,
    "--max-device-losses": True,
    "--supervisor-journal": True,
}


def strip_supervisor_flags(argv: Sequence[str]) -> list:
    """Remove supervisor-only flags from a CLI argv, producing the
    child's argv tail (the supervisor must not recurse)."""
    out = []
    i = 0
    args = list(argv)
    while i < len(args):
        a = args[i]
        flag = a.split("=", 1)[0]
        if flag in SUPERVISOR_FLAGS:
            if SUPERVISOR_FLAGS[flag] and "=" not in a:
                i += 1              # consume the separate value
            i += 1
            continue
        out.append(a)
        i += 1
    return out


def supervise_cli(argv: Sequence[str], args) -> int:
    """``launch.py --supervise`` entry: re-run this CLI (minus the
    supervisor flags) under a ``TrainSupervisor`` built from ``args``."""
    child = [sys.executable, "-m", "tensorflow_train_distributed_torch",
             *strip_supervisor_flags(argv)]
    journal = args.supervisor_journal
    if journal is None and args.checkpoint_dir:
        journal = os.path.join(args.checkpoint_dir, "supervisor.jsonl")
    sup = TrainSupervisor(
        child,
        max_restarts=args.max_restarts,
        backoff_s=args.restart_backoff,
        backoff_max_s=args.restart_backoff_max,
        backoff_jitter=args.restart_jitter,
        restart_window_s=args.restart_window or None,
        restart_on_preemption=not args.no_restart_on_preemption,
        elastic=not args.no_elastic,
        max_device_losses=args.max_device_losses,
        journal_path=journal,
    )
    return sup.run().returncode
