"""Profiling and observability: traces, annotations, memory stats (the
counterpart of the JAX package's ``runtime/profiling.py`` over
``torch.profiler``).

- ``trace(logdir)`` / ``start_trace`` / ``stop_trace``: capture a window
  of host and device activity (CUPTI on CUDA) into a Chrome trace,
  ``<logdir>/trace_<pid>_<n>.json``, loadable in Perfetto or
  ``chrome://tracing`` (the JAX trace is an XPlane for TensorBoard's
  profile plugin).
- ``annotate(name)``: a named host span that nests inside the trace
  (``torch.profiler.record_function``).
- ``ProfileCallback``: a step-window capture inside ``Trainer.fit``
  (``--profile-dir`` / ``--profile-steps`` of the launcher).
- ``device_memory_stats``: bytes in use, peak and limit of each device
  (``torch.cuda.memory_stats`` and ``mem_get_info``).
- ``SpeedMonitor``: step time and throughput between log events.
- ``CaptureServer``: on-demand capture, the launcher's
  ``--profiler-port`` (the JAX package starts ``jax.profiler``'s server
  there).  A localhost TCP listener takes one JSON line a connection,
  ``{"steps": N, "logdir": DIR}``; the trainer then traces the next N
  steps it dispatches and replies on the same connection with one JSON line,
  ``{"path": ..., "first_step": a, "last_step": b}``.
  ``request_capture`` is the client.  Each step boundary inside the
  window leaves a ``ttd/step <n>`` marker in the trace.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import queue
import socket
import threading
from typing import Iterator, Optional

from tensorflow_train_distributed_torch.training.callbacks import (
    Callback,
    StepRateTracker,
)

logger = logging.getLogger(__name__)

_ACTIVE: dict = {}
_TRACES = itertools.count()


def start_trace(logdir: str) -> None:
    """Begin capturing host and (on CUDA) device activity; the trace goes
    to ``logdir`` at ``stop_trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _ACTIVE:
        raise RuntimeError("a profiler trace is already active")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    _ACTIVE.update(prof=prof, logdir=logdir)
    logger.info("profiler trace started -> %s", logdir)


def stop_trace() -> Optional[str]:
    """End the capture and write its Chrome trace; returns its path
    (None when no trace was active)."""
    if not _ACTIVE:
        return None
    prof, logdir = _ACTIVE.pop("prof"), _ACTIVE.pop("logdir")
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_TRACES)}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace stopped -> %s", path)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a trace for the duration of the block."""
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    """Named host-side span; nests under an active trace."""
    import torch

    return torch.profiler.record_function(name)


def device_memory_stats() -> list:
    """Per-device memory stats (bytes in use, peak, limit); the CPU
    reports none, so a host without CUDA lists its one device with None
    values."""
    import torch

    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None}]
    stats = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats.append({
            "device": f"cuda:{i}",
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        })
    return stats


class ProfileCallback(Callback):
    """Capture a trace over a step window during ``fit``.

    ``start_step``/``stop_step`` follow the reference's
    ``profile_batch=(start, stop)``: the capture begins once the step
    before ``start_step`` is reported and ends once ``stop_step`` is.
    Steps are reported at the trainer's read windows (``log_every``), so
    the window snaps to them and always spans the requested steps.
    """

    def __init__(self, logdir: str, *, start_step: int = 10,
                 stop_step: int = 20):
        if stop_step < start_step:
            raise ValueError(
                f"stop_step={stop_step} < start_step={start_step}")
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = stop_step
        self.path: Optional[str] = None
        self._active = False
        self._done = False

    def on_step_end(self, step, metrics):
        if self._done:
            return
        if not self._active and step >= self.start_step - 1:
            start_trace(self.logdir)
            self._active = True
            return
        if self._active and step >= self.stop_step:
            self._stop()

    def on_train_end(self, state):
        if self._active:        # the window ran past the end of training
            self._stop()

    def _stop(self):
        self.path = stop_trace()
        self._active = False
        self._done = True


class SpeedMonitor(Callback):
    """Step time and throughput between log events: one sample per read
    window (``StepRateTracker``); ``summary()`` gives the mean, median
    and p90 step ms and, with ``examples_per_step``, examples/s."""

    def __init__(self, examples_per_step: Optional[int] = None):
        self.examples_per_step = examples_per_step
        self._tracker = StepRateTracker()
        self.step_times_ms: list = []

    def on_step_end(self, step, metrics):
        ms = self._tracker.update(step)
        if ms is not None:
            self.step_times_ms.append(ms)

    def summary(self) -> dict:
        if not self.step_times_ms:
            return {}
        import numpy as np

        arr = np.asarray(self.step_times_ms)
        out = {
            "mean_step_ms": float(arr.mean()),
            "median_step_ms": float(np.median(arr)),
            "p90_step_ms": float(np.percentile(arr, 90)),
        }
        if self.examples_per_step:
            out["examples_per_sec"] = (
                self.examples_per_step / (out["median_step_ms"] / 1e3))
        return out


STEP_MARKER = "ttd/step "


class CaptureServer(Callback):
    """``--profiler-port``: a listener on ``host:port`` (0 picks a free
    port, ``self.port``) that queues capture requests; as a ``fit``
    callback it starts a trace after the step it next reports, ends it
    once N more steps are reported (steps snap to the trainer's read
    windows, as ``ProfileCallback``'s do) and answers the request.
    Training's end closes the listener, answering an open capture with
    the steps it holds."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._sock = socket.create_server((host, port))
        self.host, self.port = host, self._sock.getsockname()[1]
        self._requests: queue.Queue = queue.Queue()
        self._active: Optional[dict] = None
        self._thread = threading.Thread(target=self._accept, daemon=True,
                                        name="ttd-capture-server")
        self._thread.start()
        logger.info("profiler capture server listening on %s:%d", host,
                    self.port)

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:         # closed
                return
            try:
                line = conn.makefile("r").readline()
                req = json.loads(line)
                steps, logdir = int(req["steps"]), str(req["logdir"])
                if steps < 1:
                    raise ValueError(f"steps must be >= 1, got {steps}")
            except (ValueError, KeyError, TypeError, OSError) as e:
                _reply(conn, {"error": f"bad capture request: {e}"})
                continue
            self._requests.put((conn, steps, logdir))

    def transform_state(self, state):
        """Every dispatch boundary of ``fit`` (after step ``state.step``):
        start a queued capture, or mark and count a step of the open
        one."""
        step = int(state.step)
        a = self._active
        if a is not None:
            with annotate(f"{STEP_MARKER}{step}"):
                pass
            a["last"] = step
            if step >= a["first"] + a["steps"] - 1:
                self._finish()
            return None
        try:
            conn, steps, logdir = self._requests.get_nowait()
        except queue.Empty:
            return None
        _sync_device()
        try:
            start_trace(logdir)
        except RuntimeError as e:
            _reply(conn, {"error": str(e)})
            return None
        self._active = dict(conn=conn, steps=steps, first=step + 1,
                            last=None)
        return None

    def _finish(self) -> None:
        a, self._active = self._active, None
        _sync_device()
        path = stop_trace()
        _reply(a["conn"], {"path": path, "first_step": a["first"],
                           "last_step": a["last"]})

    def on_train_end(self, state):
        if self._active is not None:
            self._finish()
        self.close()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        while True:
            try:
                conn, _, _ = self._requests.get_nowait()
            except queue.Empty:
                break
            _reply(conn, {"error": "training ended before the capture"})


def _sync_device() -> None:
    """The work queued so far ends before a trace starts or stops."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _reply(conn, obj: dict) -> None:
    try:
        conn.sendall((json.dumps(obj) + "\n").encode())
    except OSError:
        pass
    finally:
        conn.close()


def request_capture(port: int, steps: int, logdir: str, *,
                    host: str = "127.0.0.1",
                    timeout: Optional[float] = 600.0) -> dict:
    """Ask a ``CaptureServer`` for a trace of the next ``steps`` steps
    into ``logdir``; blocks until the reply (``path``, ``first_step``,
    ``last_step``, or ``error``)."""
    with socket.create_connection((host, port), timeout=timeout) as c:
        c.sendall((json.dumps({"steps": steps, "logdir": logdir})
                   + "\n").encode())
        line = c.makefile("r").readline()
    if not line:
        raise ConnectionError("the capture server closed the connection "
                              "without a reply")
    return json.loads(line)
