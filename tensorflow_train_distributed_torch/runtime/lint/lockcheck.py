"""Runtime lock-order sanitizer (``TTD_LOCKCHECK=1``).

The dynamic half of the concurrency discipline: while the static
checker proves lock *presence* on code paths, this module watches the
locks actually *move* and raises the moment an execution exhibits a
hazard — so every existing gateway/replica/chaos test doubles as a
race test when conftest arms it for tier-1:

- **acquisition-order graph**: every instrumented lock acquisition
  while other instrumented locks are held records ``held -> acquired``
  edges keyed by the locks' CREATION SITES (all ``EngineDriver._cv``
  instances share one node — the ordering class is the invariant, not
  the instance).  A new edge that closes a cycle raises
  ``LockOrderError`` with both directions' first-seen sites: the
  classic ABBA deadlock, caught on the first run that exhibits both
  orders, no hang required.  Nested acquisition of two SIBLING locks
  from the same creation site raises too (there is no consistent
  order between anonymous siblings).
- **guarded-attribute access**: classes decorated
  ``@concurrency_guarded`` get per-attribute descriptors enforcing
  their ``_GUARDED_BY`` spec live — an access from a role-tagged
  thread that neither holds the declared lock nor owns the attribute
  raises ``GuardViolation`` at the exact access.  Untagged threads
  (tests poking internals) pass through: runtime enforcement targets
  the package's own thread roles; the static checker covers the rest.

Instrumentation is scoped to locks CREATED BY PACKAGE CODE: the
installed factories inspect the creating frame and hand everything
else (torch, stdlib queue/logging, test code) the raw primitive —
overhead lands only where the invariants live.  ``install()`` is
idempotent; ``TTD_NO_LOCKCHECK=1`` vetoes arming entirely (the escape
hatch when the sanitizer itself misbehaves in the field).
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

from tensorflow_train_distributed_torch.runtime.lint import registry

_PKG_PREFIX = "tensorflow_train_distributed_torch"

# Raw primitives (the sanitizer's own bookkeeping must never recurse into
# itself), taken from ``_thread`` and from an object threading builds: a
# sanitizer of another package in the same process may have patched the
# factories before this module loads.
_RAW_LOCK = _thread.allocate_lock
_RAW_RLOCK = _thread.RLock
_RAW_CONDITION = type(threading.Event()._cond)


class LockOrderError(RuntimeError):
    """Two locks were acquired in both orders (potential deadlock)."""


class GuardViolation(RuntimeError):
    """A guarded attribute was touched without its declared lock."""


class _Held(threading.local):
    def __init__(self):
        self.stack: List["_InstrumentedLock"] = []


_HELD = _Held()
_GRAPH_GUARD = _RAW_LOCK()
# src name -> dst name -> first-seen description.
_EDGES: Dict[str, Dict[str, str]] = {}


def reset_graph() -> None:
    """Forget recorded edges (test isolation for the sanitizer's own
    tests; the tier-1 suite deliberately accumulates)."""
    with _GRAPH_GUARD:
        _EDGES.clear()


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> dst over recorded edges (caller holds guard)."""
    stack = [(src, [src])]
    seen = set()
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in _EDGES.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


class _InstrumentedLock:
    """Order-recording wrapper over a raw Lock/RLock.

    Speaks the full lock protocol plus the ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` trio ``threading.Condition``
    uses, so a Condition built over one keeps exact wait semantics
    while the sanitizer keeps exact held-state."""

    __slots__ = ("_inner", "name", "_reentrant", "_owner", "_count")

    def __init__(self, inner, name: str, reentrant: bool):
        self._inner = inner
        self.name = name
        self._reentrant = reentrant
        self._owner: Optional[int] = None
        self._count = 0

    # -- sanitizer bookkeeping -------------------------------------------

    def held_by_current(self) -> bool:
        return self._owner == threading.get_ident()

    def _record_acquired(self) -> None:
        held = _HELD.stack
        me = threading.get_ident()
        if held:
            with _GRAPH_GUARD:
                for h in held:
                    if h is self:
                        continue
                    if h.name == self.name:
                        raise LockOrderError(
                            f"nested acquisition of two sibling locks "
                            f"from the same creation site {self.name} "
                            f"(no consistent order can exist between "
                            f"anonymous siblings)")
                    back = _find_path(self.name, h.name)
                    if back is not None:
                        raise LockOrderError(
                            f"lock-order cycle: acquiring {self.name} "
                            f"while holding {h.name}, but the reverse "
                            f"order {' -> '.join(back)} was already "
                            f"recorded ({_EDGES[back[0]][back[1]]}) — "
                            f"potential ABBA deadlock")
                    _EDGES.setdefault(h.name, {}).setdefault(
                        self.name,
                        f"first seen on thread {me}")
        held.append(self)
        self._owner = me
        self._count = 1

    def _record_released(self) -> None:
        self._owner = None
        self._count = 0
        stack = _HELD.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break

    # -- lock protocol ----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            self._inner.acquire(blocking, timeout)
            self._count += 1
            return True
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                self._record_acquired()
            except BaseException:
                # The order violation is the error to surface — but the
                # raw lock must not stay held behind it.
                self._inner.release()
                raise
        return got

    def release(self) -> None:
        if self._reentrant and self._owner == threading.get_ident() \
                and self._count > 1:
            self._count -= 1
            self._inner.release()
            return
        self._record_released()
        self._inner.release()

    def locked(self) -> bool:
        if self._reentrant:
            # _thread.RLock has no .locked() before 3.14; ownership
            # tracking answers the same question.
            return self._owner is not None
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    # -- Condition protocol ----------------------------------------------

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        # Bookkeeping BEFORE the raw release, mirroring release(): the
        # moment the raw lock drops, another thread may acquire and
        # set _owner/_count — recording after would clobber the new
        # holder's state (spurious GuardViolations on legitimately
        # locked accesses) and could capture ITS count as ours.
        saved = self._count
        self._record_released()
        inner_state = (self._inner._release_save()
                       if hasattr(self._inner, "_release_save")
                       else self._inner.release())
        return (inner_state, saved)

    def _acquire_restore(self, state) -> None:
        inner_state, saved = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        self._record_acquired()
        self._count = saved

    def __repr__(self) -> str:
        return (f"<InstrumentedLock {self.name} "
                f"owner={self._owner} count={self._count}>")


def make_lock(name: str) -> _InstrumentedLock:
    """An instrumented non-reentrant lock (tests, explicit call sites)."""
    return _InstrumentedLock(_RAW_LOCK(), name, reentrant=False)


def make_rlock(name: str) -> _InstrumentedLock:
    return _InstrumentedLock(_RAW_RLOCK(), name, reentrant=True)


# -- factory installation --------------------------------------------------

_INSTALLED = False


def _creation_site(depth: int = 2) -> Tuple[bool, str]:
    """(created by package code?, "file.py:line") for the frame that
    called the patched factory."""
    try:
        frame = sys._getframe(depth)
    except ValueError:                          # pragma: no cover
        return False, "?"
    mod = frame.f_globals.get("__name__", "")
    site = (f"{os.path.basename(frame.f_code.co_filename)}"
            f":{frame.f_lineno}")
    return mod.startswith(_PKG_PREFIX), site


def _lock_factory():
    ours, site = _creation_site()
    if ours:
        return _InstrumentedLock(_RAW_LOCK(), site, reentrant=False)
    return _RAW_LOCK()


def _rlock_factory():
    ours, site = _creation_site()
    if ours:
        return _InstrumentedLock(_RAW_RLOCK(), site, reentrant=True)
    return _RAW_RLOCK()


def _condition_factory(lock=None):
    ours, site = _creation_site()
    if ours and lock is None:
        # The Condition's hidden RLock is where the EngineDriver's ordering
        # lives: instrument it so ``with self._cv`` edges record.
        lock = _InstrumentedLock(_RAW_RLOCK(), site, reentrant=True)
    return _RAW_CONDITION(lock)


def armed() -> bool:
    """``TTD_LOCKCHECK`` truthy and not vetoed by ``TTD_NO_LOCKCHECK``
    — ONE truthiness rule for both sanitizer halves (role tagging /
    guard install in the registry, lock-factory patching here)."""
    return registry._sanitizer_armed()


def installed() -> bool:
    return _INSTALLED


def install() -> bool:
    """Patch the lock factories (idempotent).  Call BEFORE importing
    the package modules whose objects should be instrumented — lock
    instances are wrapped at CREATION, so anything constructed earlier
    stays raw (and is simply not checked).  Returns True when armed
    and installed."""
    global _INSTALLED
    if not armed():
        return False
    if _INSTALLED:
        return True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    _INSTALLED = True
    return True


def uninstall() -> None:
    global _INSTALLED
    threading.Lock = _RAW_LOCK
    threading.RLock = _RAW_RLOCK
    threading.Condition = _RAW_CONDITION
    _INSTALLED = False


# -- guarded-attribute runtime enforcement ---------------------------------


class _AttrGuard:
    """Data descriptor enforcing one ``_GUARDED_BY`` entry live."""

    __slots__ = ("attr", "lock_name", "owners", "_key")

    def __init__(self, attr: str, lock_name: Optional[str],
                 owners: Tuple[str, ...]):
        self.attr = attr
        self.lock_name = lock_name
        self.owners = owners
        self._key = f"__ttd_guarded_{attr}"

    def _check(self, inst, writing: bool) -> None:
        role = registry.current_role()
        if role is None:
            return          # untagged thread: static checker territory
        if self.lock_name is None:
            # Atomic-publish attribute: owner-only writes, free reads.
            if writing and role not in self.owners:
                raise GuardViolation(
                    f"{type(inst).__name__}.{self.attr}: write from "
                    f"role '{role}' (owners: {self.owners})")
            return
        lock = getattr(inst, self.lock_name, None)
        if isinstance(lock, _RAW_CONDITION):
            # A Condition-guarded attribute (EngineDriver's ``_cv``):
            # the ordering/ownership state lives in the Condition's
            # INNER lock, which the factory instrumented at creation.
            lock = getattr(lock, "_lock", None)
        if not isinstance(lock, _InstrumentedLock):
            return          # raw/absent lock: cannot verify, let it go
        if lock.held_by_current():
            return
        if role in self.owners:
            # Owner-role lock-free access: reads are the sanctioned
            # single-writer pattern; container writes are statically
            # checked (a descriptor cannot see them anyway).
            return
        raise GuardViolation(
            f"{type(inst).__name__}.{self.attr}: access from role "
            f"'{role}' without holding self.{self.lock_name} "
            f"(owners: {self.owners or '()'})")

    def __get__(self, inst, owner=None):
        if inst is None:
            return self
        try:
            value = inst.__dict__[self._key]
        except KeyError:
            raise AttributeError(self.attr) from None
        self._check(inst, writing=False)
        return value

    def __set__(self, inst, value) -> None:
        if self._key in inst.__dict__:      # first write = construction
            self._check(inst, writing=True)
        inst.__dict__[self._key] = value

    def __delete__(self, inst) -> None:
        self._check(inst, writing=True)
        del inst.__dict__[self._key]


def install_attr_guards(cls, specs) -> None:
    """Install runtime guards for a ``@concurrency_guarded`` class
    (called by the registry decorator when the sanitizer is armed)."""
    for attr, (lock_name, owners) in specs.items():
        setattr(cls, attr, _AttrGuard(attr, lock_name, owners))
