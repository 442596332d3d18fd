"""Preemption: SIGTERM → checkpoint at the step boundary → stop (the
single-process part of the JAX package's ``runtime/preemption.py``).

- ``PreemptionWatcher`` installs a SIGTERM (optionally SIGINT) handler
  that only flips a flag; no work happens in signal context.
- ``sync_preemption_flag`` is the all-process agreement of the JAX
  package; with one process it is the local flag.
- ``PreemptionCheckpointCallback``: at the first step boundary after the
  signal, save (``CheckpointManager.save`` waits for the device
  before it copies anything to the host), then stop training.  A rerun
  resumes from that step (``launch.run`` restores the latest step).
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

logger = logging.getLogger(__name__)

# The preemption exit-code contract, shared with ``runtime.supervisor``:
# a process exiting with THIS code checkpointed and stopped on purpose
# (SIGTERM'd by convention: 128 + 15).  Supervisors relaunch it WITHOUT
# consuming the crash restart budget — any other nonzero exit is a
# crash.  Keep launch.py, the supervisor, and external schedulers
# agreeing on the one constant.
PREEMPTION_EXIT_CODE = 143


class PreemptionWatcher:
    """Flags termination signals without doing work in signal context.

    ``install()`` chains any pre-existing handler (so test harnesses and
    outer supervisors keep working).  ``preempted`` may also be set
    programmatically (maintenance-event pollers, tests).
    ``watch_sigint=True`` adds SIGINT — Ctrl-C on an interactive run
    then means "checkpoint and stop" instead of a stack-trace death
    (the reference's ``CheckpointManagerV2`` keyboard-interrupt save).
    """

    def __init__(self, signals=(signal.SIGTERM,), *,
                 watch_sigint: bool = False):
        if watch_sigint and signal.SIGINT not in signals:
            signals = tuple(signals) + (signal.SIGINT,)
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}
        self._installed = False

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def mark_preempted(self) -> None:
        self._event.set()

    def install(self) -> "PreemptionWatcher":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "PreemptionWatcher.install() must run on the main thread "
                "(signal.signal requirement)")
        for sig in self.signals:
            self._prev[sig] = signal.getsignal(sig)
            signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        self._installed = False

    def _on_signal(self, signum, frame):
        self._event.set()
        logger.warning("received signal %d: preemption flagged", signum)
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)


def sync_preemption_flag(local_flag: bool) -> bool:
    """True iff any process was preempted.  The port runs one process,
    so this is the local flag (the JAX package OR-reduces it across
    hosts)."""
    return bool(local_flag)


class PreemptionCheckpointCallback:
    """Trainer callback: save-and-stop when any host is preempted.

    Contract (mirrors ``PreemptionCheckpointHandler.run`` semantics): the
    save happens at a step boundary every process reaches, outside the
    checkpoint interval, and is committed (saves are synchronous) before
    training stops — the checkpoint a restarted job resumes from.
    """

    def __init__(self, watcher: PreemptionWatcher,
                 checkpoint_manager=None,
                 *, exit_code: Optional[int] = None):
        self.watcher = watcher
        self._explicit_manager = checkpoint_manager
        self.exit_code = exit_code
        self.saved_step: Optional[int] = None
        self.trainer = None

    def set_trainer(self, trainer):
        self.trainer = trainer

    @property
    def checkpoint_manager(self):
        if self._explicit_manager is not None:
            return self._explicit_manager
        return getattr(self.trainer, "checkpoint_manager", None)

    def on_train_begin(self, state):
        pass

    def on_step_end(self, step: int, metrics) -> Optional[bool]:
        if not sync_preemption_flag(self.watcher.preempted):
            return None
        mgr = self.checkpoint_manager
        state = getattr(self.trainer, "_live_state", None)
        if mgr is not None and state is not None:
            mgr.save(int(state.step), state)
            self.saved_step = int(state.step)
            logger.warning(
                "preemption: checkpoint saved at step %d; stopping",
                self.saved_step)
        else:
            logger.warning("preemption: no checkpoint manager; stopping")
        if self.exit_code is not None:
            raise SystemExit(self.exit_code)
        return True  # request early stop

    def on_epoch_end(self, epoch, metrics):
        return None

    def on_train_end(self, state):
        pass
