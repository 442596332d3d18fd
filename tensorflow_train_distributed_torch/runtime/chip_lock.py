"""Host-wide card lock: processes that time work on the card never overlap
(the counterpart of the JAX package's ``runtime/chip_lock.py``).

Two processes timing on one card corrupt each other's figures: each
one's kernels queue behind the other's, and a step time or a decode rate
read then measures the neighbour.  Every bench tool that drives the card
takes this lock first; ``--device cpu`` runs skip it.

- ``flock`` on a well-known path (``TTD_CHIP_LOCK_PATH``, default
  ``ttd_cuda.lock`` in the temporary directory): the kernel releases it
  when the holder dies, so a crashed bench never blocks the next.
- Children of a holder inherit the right to run through
  ``TTD_CHIP_LOCK_HELD=1`` in their environment (``tools/bench.py`` runs
  its non-ResNet families as subprocesses).  ``subprocess`` closes
  inherited descriptors by default, so a parent that wants the lock to
  outlive itself while a child still drives the card passes
  ``held_fd()`` in ``pass_fds``: the shared open file keeps the lock
  held until the child exits too.
- The holder writes its pid into the file, so a waiting process can say
  who holds the card.
"""

from __future__ import annotations

import contextlib
import errno
import os
import tempfile
import time
from typing import Optional

ENV_FLAG = "TTD_CHIP_LOCK_HELD"
_PATH_ENV = "TTD_CHIP_LOCK_PATH"

_held_fd: Optional[int] = None


def lock_path() -> str:
    return os.environ.get(_PATH_ENV) or os.path.join(
        tempfile.gettempdir(), "ttd_cuda.lock")


def held_fd() -> Optional[int]:
    """Descriptor of the lock this process holds (for ``pass_fds``)."""
    return _held_fd


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError as e:
        return e.errno == errno.EPERM
    return True


def lock_holder() -> Optional[int]:
    """Pid of the live process holding the lock, else None."""
    import fcntl

    try:
        with open(lock_path(), "r+") as f:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                content = f.read().strip()
                if content.isdigit() and _pid_alive(int(content)):
                    return int(content)
                return None         # held, holder unknown
            fcntl.flock(f, fcntl.LOCK_UN)
            return None
    except OSError:
        return None


@contextlib.contextmanager
def chip_lock(timeout: float = 900.0, poll: float = 5.0, on_wait=None):
    """Acquire the host-wide card lock, or inherit it from a parent.

    Yields "inherited" or "acquired".  ``on_wait(holder_pid, waited_s)``
    is called at each poll while blocked.  Raises ``TimeoutError`` naming
    the holder's pid when ``timeout`` runs out (never steals the lock)."""
    global _held_fd
    if os.environ.get(ENV_FLAG) == "1":
        yield "inherited"
        return
    import fcntl

    path = lock_path()
    f = open(path, "a+")
    t0 = time.monotonic()
    try:
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                waited = time.monotonic() - t0
                holder = lock_holder()
                if waited >= timeout:
                    raise TimeoutError(
                        f"card lock {path} still held"
                        + (f" by pid {holder}" if holder else "")
                        + f" after {waited:.0f}s") from None
                if on_wait is not None:
                    on_wait(holder, waited)
                time.sleep(poll)
        f.seek(0)
        f.truncate()
        f.write(str(os.getpid()))
        f.flush()
        os.environ[ENV_FLAG] = "1"
        _held_fd = f.fileno()
        try:
            yield "acquired"
        finally:
            _held_fd = None
            os.environ.pop(ENV_FLAG, None)
            f.seek(0)
            f.truncate()
            fcntl.flock(f, fcntl.LOCK_UN)
    finally:
        f.close()
