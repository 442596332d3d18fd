"""Callback seam for the training loop (the counterpart of the JAX
package's ``training/callbacks.py``, with the same hooks and metric
names).

Hooks: train begin/end, step end (after the metrics of a window are
read), epoch end, evaluation begin/end and ``transform_state``, the one
seam that may replace the state between steps.  ``ReduceLROnPlateau``
needs the learning rate in the optimizer state
(``optimizers.inject_learning_rate``, the launcher's
``--reduce-lr-factor``).  One process runs the port, so the JAX
package's chief-only gating is gone; ``TensorBoardScalars`` is not
ported.
"""

from __future__ import annotations

import json
import logging
import math
import sys
import time
from typing import Mapping, Optional

from tensorflow_train_distributed_torch.training.optimizers import (
    get_injected_hyperparam,
    set_injected_hyperparam,
)

logger = logging.getLogger(__name__)


class Callback:
    """Base class; all hooks optional."""

    def set_trainer(self, trainer):
        self.trainer = trainer

    def on_train_begin(self, state):
        pass

    def on_step_end(self, step: int, metrics: Mapping[str, float]) -> Optional[bool]:
        """Return True to request an early stop."""

    def on_epoch_end(self, epoch: int, metrics: Mapping[str, float]) -> Optional[bool]:
        pass

    def on_eval_begin(self):
        """Mid-training evaluation window opens (no step heartbeats)."""

    def on_eval_end(self):
        pass

    def transform_state(self, state):
        """Return a replacement TrainState, or None to leave it alone.

        Called between steps after the metric and eval events — the ONE
        sanctioned seam for callbacks that must mutate training state
        (dynamic LR, hyperparameter schedules keyed on metrics).  The
        replacement must keep the state's structure and shapes.
        """
        return None

    def on_train_end(self, state):
        pass


class CallbackList:
    def __init__(self, callbacks, trainer=None):
        self.callbacks = list(callbacks)
        if trainer is not None:
            for c in self.callbacks:
                c.set_trainer(trainer)

    def train_begin(self, state):
        for c in self.callbacks:
            c.on_train_begin(state)

    def step_end(self, step, metrics) -> bool:
        stop = False
        for c in self.callbacks:
            stop |= bool(c.on_step_end(step, metrics))
        return stop

    def epoch_end(self, epoch, metrics) -> bool:
        stop = False
        for c in self.callbacks:
            stop |= bool(c.on_epoch_end(epoch, metrics))
        return stop

    # getattr: callbacks are duck-typed (PreemptionCheckpointCallback
    # and user callbacks need not subclass Callback, nor have the
    # evaluation hooks).
    def eval_begin(self):
        for c in self.callbacks:
            fn = getattr(c, "on_eval_begin", None)
            if fn is not None:
                fn()

    def eval_end(self):
        for c in self.callbacks:
            fn = getattr(c, "on_eval_end", None)
            if fn is not None:
                fn()

    def apply_state_transforms(self, state):
        for c in self.callbacks:
            fn = getattr(c, "transform_state", None)
            out = fn(state) if fn is not None else None
            if out is not None:
                state = out
        return state

    def train_end(self, state):
        for c in self.callbacks:
            c.on_train_end(state)


class History(Callback):
    """Accumulates per-log-interval metrics (Keras ``History`` analog)."""

    def __init__(self):
        self.steps: list[int] = []
        self.history: dict[str, list[float]] = {}

    def on_step_end(self, step, metrics):
        self.steps.append(step)
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(float(v))


class StepRateTracker:
    """Wall-time per optimizer step, burst-aware.

    ``Trainer.fit`` drains metrics in ``log_every`` windows, so callbacks
    see bursts of ``on_step_end`` calls microseconds apart — the naive
    consecutive-call delta is garbage (µs inside a burst, the whole window
    attributed to one step at its edge).  A burst shares one drain
    timestamp, which is when the window's last step finished; the honest
    rate is therefore (drain_t − prev_drain_t) / (drain_step −
    prev_drain_step), computed when a new burst begins.
    """

    BURST_GAP_S = 5e-4

    def __init__(self):
        self._prev = None   # (t, step) at the end of the last closed burst
        self._cur = None    # (t, step) latest call in the current burst
        self.last_ms_per_step: Optional[float] = None

    def update(self, step: int) -> Optional[float]:
        """Record a step report; returns a fresh ms/step when a window closes."""
        now = time.perf_counter()
        emitted = None
        if self._cur is not None and now - self._cur[0] > self.BURST_GAP_S:
            t1, s1 = self._cur
            if self._prev is not None and s1 > self._prev[1]:
                emitted = (t1 - self._prev[0]) / (s1 - self._prev[1]) * 1e3
                self.last_ms_per_step = emitted
            self._prev = (t1, s1)
        self._cur = (now, step)
        return emitted


class ProgressLogger(Callback):
    """Stdout progress lines with step time + throughput (chief only)."""

    def __init__(self, examples_per_step: Optional[int] = None):
        self.examples_per_step = examples_per_step
        self._tracker = StepRateTracker()

    def on_step_end(self, step, metrics):
        self._tracker.update(step)
        line = f"step {step}"
        ms = self._tracker.last_ms_per_step
        if ms is not None:
            line += f" | {ms:.1f} ms/step"
            if self.examples_per_step:
                line += f" | {self.examples_per_step / (ms / 1e3):,.0f} ex/s"
        for k, v in metrics.items():
            line += f" | {k}={float(v):.4f}"
        print(line, flush=True)


class JsonlLogger(Callback):
    """One JSON object per log event — the machine-readable metric stream
    (replaces tf.summary scalar writing for headless runs); chief only."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = None

    def on_train_begin(self, state):
        if self.path:
            self._fh = open(self.path, "a")

    def on_step_end(self, step, metrics):
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()},
               "ts": time.time()}
        out = self._fh or sys.stdout
        out.write(json.dumps(rec) + "\n")
        out.flush()

    def on_train_end(self, state):
        if self._fh:
            self._fh.close()
            self._fh = None


class EarlyStopping(Callback):
    """Stop when ``monitor`` hasn't improved for ``patience`` events
    (Keras ``EarlyStopping:2002`` analog, evaluated per log interval)."""

    def __init__(self, monitor: str = "loss", patience: int = 10,
                 min_delta: float = 0.0, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        self.monitor, self.patience = monitor, patience
        self.min_delta, self.mode = min_delta, mode
        self.best: Optional[float] = None
        self.wait = 0

    def on_step_end(self, step, metrics):
        if self.monitor not in metrics:
            return
        cur = float(metrics[self.monitor])
        better = (
            self.best is None
            or (self.mode == "min" and cur < self.best - self.min_delta)
            or (self.mode == "max" and cur > self.best + self.min_delta)
        )
        if better:
            self.best, self.wait = cur, 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            logger.info("EarlyStopping: %s plateaued at %s", self.monitor,
                        self.best)
            return True


class ReduceLROnPlateau(Callback):
    """Drop the learning rate when ``monitor`` stops improving (Keras
    ``ReduceLROnPlateau`` analog, ``tf_keras/src/callbacks.py:2915``).

    Needs the optimizer built with ``optimizers.inject_learning_rate``
    so the LR lives in optimizer STATE (the CLI's ``--reduce-lr-factor``
    does this); the reduction is a state rewrite through the
    ``transform_state`` seam, and checkpoint/resume carries the reduced
    LR because it IS state.
    """

    def __init__(self, monitor: str = "val_loss", factor: float = 0.1,
                 patience: int = 10, min_delta: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0,
                 mode: str = "min"):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor must be in (0, 1), got {factor}")
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.min_delta, self.cooldown = min_delta, cooldown
        self.min_lr, self.mode = min_lr, mode
        self.best: Optional[float] = None
        self.wait = 0
        self.cooldown_left = 0
        # COUNT, not flag: step events flush in log_every windows, so
        # several patience expirations can precede one transform_state —
        # each must apply its factor.
        self._reductions_pending = 0

    def on_train_begin(self, state):
        if get_injected_hyperparam(state.opt_state,
                                   "learning_rate") is None:
            raise ValueError(
                "ReduceLROnPlateau needs the optimizer built with "
                "optimizers.inject_learning_rate so the LR lives in "
                "optimizer state (CLI: --reduce-lr-factor builds it that "
                "way); none found in opt_state")

    def on_step_end(self, step, metrics):
        if self.monitor not in metrics:
            return
        cur = float(metrics[self.monitor])
        better = (
            self.best is None
            or (self.mode == "min" and cur < self.best - self.min_delta)
            or (self.mode == "max" and cur > self.best + self.min_delta)
        )
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.wait = 0
        if better:
            self.best, self.wait = cur, 0
            return
        if self.cooldown_left > 0:
            return
        self.wait += 1
        if self.wait >= self.patience:
            self._reductions_pending += 1
            self.wait = 0
            self.cooldown_left = self.cooldown

    def transform_state(self, state):
        if not self._reductions_pending:
            return None
        pending, self._reductions_pending = self._reductions_pending, 0
        old = get_injected_hyperparam(state.opt_state, "learning_rate")
        new_lr = max(float(old) * self.factor**pending, self.min_lr)
        if new_lr >= float(old):
            return None  # already at the floor
        new_opt, n_set = set_injected_hyperparam(state.opt_state,
                                                 "learning_rate", new_lr)
        if n_set == 0:  # guarded at train_begin; belt and braces
            return None
        logger.warning("ReduceLROnPlateau: %s plateaued (best %.5g) — lr "
                    "%.3g → %.3g", self.monitor, self.best, float(old),
                    new_lr)
        return state.replace(opt_state=new_opt)


class BestCheckpoint(Callback):
    """Keep the best-``monitor`` checkpoint (Keras ``ModelCheckpoint``
    ``save_best_only=True`` analog, ``tf_keras/src/callbacks.py:1233``).

    Saves into its OWN directory (default ``<dir>/best``), separate from
    the trainer's periodic keep-N manager: rolling saves must never evict
    the best state, and the best save must never count against keep-N.

    Save timing: step metrics flush in ``log_every`` windows AFTER the
    window's last step executed — earlier states no longer exist (the
    step updates them in place).  So only the window's LAST metric event is a save
    candidate (its step IS the live state's step), saved through the
    ``transform_state`` seam where the current state is authoritative.
    "Best" therefore means best among flush boundaries; run with
    ``log_every=1`` (or monitor ``val_*`` events, which always carry the
    evaluated state) for per-step granularity.
    """

    def __init__(self, directory: str, monitor: str = "val_loss",
                 mode: str = "min", min_delta: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        from tensorflow_train_distributed_torch.training.checkpoint import (
            CheckpointManager,
        )

        self.monitor, self.mode, self.min_delta = monitor, mode, min_delta
        self.best: Optional[float] = None
        self.best_step: Optional[int] = None
        self._candidate: Optional[float] = None
        self._mgr = CheckpointManager(directory, max_to_keep=1)

    def on_step_end(self, step, metrics):
        if self.monitor in metrics:
            # Last writer wins: within one flush window only the final
            # event's metric belongs to a state that still exists.
            self._candidate = float(metrics[self.monitor])

    def transform_state(self, state):
        if self._candidate is None:
            return None
        cur, self._candidate = self._candidate, None
        better = (
            self.best is None
            or (self.mode == "min" and cur < self.best - self.min_delta)
            or (self.mode == "max" and cur > self.best + self.min_delta)
        )
        if not better:
            return None
        if getattr(getattr(self, "trainer", None), "state_poisoned",
                   False):
            return None  # never immortalize a non-finite state
        step = int(state.step)
        self.best, self.best_step = cur, step
        self._mgr.save(step, state)
        logger.info("BestCheckpoint: %s=%.5g at step %d", self.monitor,
                    cur, step)
        return None  # observation only; the state itself is unchanged


class TerminateOnNaN(Callback):
    """Stop training when a monitored metric goes non-finite (Keras
    ``TerminateOnNaN`` analog, ``tf_keras/src/callbacks.py``)."""

    def __init__(self, monitor: str = "loss"):
        self.monitor = monitor

    def on_step_end(self, step, metrics):
        if self.monitor in metrics and not math.isfinite(
                float(metrics[self.monitor])):
            logger.error("TerminateOnNaN: step %d %s=%r — stopping", step,
                         self.monitor, metrics[self.monitor])
            # Veto further checkpoint writes: the state is poisoned and must
            # not overwrite retained good saves.
            if getattr(self, "trainer", None) is not None:
                self.trainer.state_poisoned = True
            return True


class StallWatchdog(Callback):
    """Dump stacks and warn when no step completes for ``timeout_s``.

    The reference's ClusterCoordinator ships a hang watchdog
    (``coordinator/watchdog.py``: a daemon thread that periodically dumps
    all thread stacks when progress stalls); SPMD training hangs the same
    way in practice — a wedged collective, a dead host in the process
    group, an input pipeline deadlock.  This is the trainer-side analog:
    armed from ``on_train_begin``, petted by every completed step, barking
    (log + ``faulthandler`` stack dump to stderr) every ``timeout_s`` of
    silence.  Observability only — it never kills the run.
    """

    def __init__(self, timeout_s: float = 300.0):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self._stop = None
        self._last_beat = None
        self._paused = False
        self.stall_count = 0  # exposed for tests/metrics

    def _dump_stacks(self):
        # faulthandler needs a real fd; pytest capture / notebooks swap
        # sys.stderr for fd-less streams — fall back to the pure-Python
        # dump, and never let a dump failure kill the watchdog thread.
        import faulthandler
        import traceback

        try:
            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:
            try:
                for tid, frame in sys._current_frames().items():
                    print(f"--- thread {tid} ---", file=sys.stderr)
                    traceback.print_stack(frame, file=sys.stderr)
            except Exception:
                pass

    def _loop(self):
        while not self._stop.wait(min(self.timeout_s / 4, 10.0)):
            if self._paused:
                continue
            if time.monotonic() - self._last_beat > self.timeout_s:
                self.stall_count += 1
                logger.warning(
                    "StallWatchdog: no training step completed in %.0f s "
                    "(stall #%d) — dumping thread stacks to stderr",
                    self.timeout_s, self.stall_count)
                self._dump_stacks()
                self._last_beat = time.monotonic()  # re-arm, don't spam

    def on_train_begin(self, state):
        import threading

        # monotonic: a wall-clock NTP step must neither fake a stall nor
        # mask a real one.
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="stall-watchdog", daemon=True)
        self._thread.start()

    def on_step_end(self, step, metrics):
        self._last_beat = time.monotonic()

    def on_eval_begin(self):
        # Evaluation produces no step heartbeats; a long eval window is
        # not a stall.
        self._paused = True

    def on_eval_end(self):
        self._last_beat = time.monotonic()
        self._paused = False

    def on_train_end(self, state):
        if self._stop is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            if not self._thread.is_alive():
                # Only forget the event once the thread is confirmed gone —
                # a loop blocked in a stack dump still reads self._stop.
                self._stop = None
