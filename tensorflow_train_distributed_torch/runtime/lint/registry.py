"""Annotation registry: the vocabulary both lint halves read.

Declarations live IN the code they protect, as plain attributes the
static checker parses from the AST and the runtime sanitizer reads
live:

- ``@thread_role("handler", ...)`` on a function/method declares which
  thread role(s) it runs on.  The static concurrency checker seeds its
  per-class call-graph role propagation from these; when the runtime
  sanitizer is armed (``TTD_LOCKCHECK=1``) the decorator additionally
  tags the calling thread with the role for the duration of the call
  (only when the thread has no role yet — a role marks the THREAD
  ENTRY, nested annotated calls keep the outer identity), which is how
  the per-attribute guards know who is touching them.

- ``@locks_held("_cv")`` declares a helper that must only be called
  with the named lock(s) already held: the checker verifies every call
  site instead of the body's (lock-free) accesses.

- ``@dispatch_critical`` marks a function as living inside the
  overlap-critical decode window: the dispatch-purity checker forbids
  host syncs (``.item()``, ``.tolist()``, ``.cpu()``, ``float()`` of a
  tensor, ``np.asarray``, ``torch.cuda.synchronize()``, a tensor in a
  branch test, slow ``os.environ`` reads) in it (``runtime/lint/
  dispatch.py``).

- ``_GUARDED_BY`` (class attribute) maps shared-attribute name ->
  guard spec.  A spec is ``("_lock",)`` (every access must hold
  ``self._lock``), ``("_lock", "role", ...)`` (writes must hold the
  lock; lock-free reads are allowed on the listed owner role(s) —
  the single-writer/locked-reader pattern), or ``(None, "role", ...)``
  (no lock: an atomic-publish attribute only the owner role(s) may
  write; anyone may read a single field).  ``@concurrency_guarded``
  on the class validates the spec and, when the sanitizer is armed,
  installs the runtime per-attribute guards.

Known thread roles (``THREAD_ROLES``) are closed on purpose: a typo'd
role must fail loudly, and a NEW role is a design event the registry
should witness.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Callable, Dict, Optional, Tuple

#: The thread roles this codebase runs (see README "Static analysis &
#: concurrency discipline").  main: the process main thread (CLIs,
#: tests, offline serve/bench loops).  handler: gateway HTTP handler
#: threads.  driver: an EngineDriver loop thread (one per replica) —
#: the only role that may touch a ServingEngine's mutating surface.
#: pump: a ReplicaPool per-request pump thread.  watchdog: the replica
#: pool's health-monitor thread.  supervisor: the training supervisor's
#: relaunch loop.  loadgen: bench load-generation threads.  trainer:
#: the training host loop (fit + host callbacks).  reader: a frame
#: reader over a subprocess replica's driver protocol (one per worker,
#: both sides: the parent-side ProcDriver reader and the worker's
#: frame loop) — the only role that may touch a ProcDriver's
#: parent-side request table.  scaler: the elastic proc pool's
#: scale/respawn thread (spawns and drains workers; owns the published
#: replica list).
#: acceptor: the network pool's TCP listener thread (admits dial-in
#: workers; owns NetPool's published replica list the way the scaler
#: owns ProcPool's).  dialer: a standalone worker daemon's
#: gateway-dialing loop (tools/serve_worker — connect, serve, re-dial
#: with backoff).
THREAD_ROLES = frozenset({
    "main", "handler", "driver", "pump", "watchdog", "supervisor",
    "loadgen", "trainer", "reader", "scaler", "acceptor", "dialer",
})

_ROLE_TLS = threading.local()


def _sanitizer_armed() -> bool:
    # Import-cycle-free read (lockcheck imports nothing from here at
    # module scope); decoration-time check, deliberately cheap.
    if os.environ.get("TTD_NO_LOCKCHECK", "0") not in ("", "0"):
        return False
    return os.environ.get("TTD_LOCKCHECK", "0") not in ("", "0")


def current_role() -> Optional[str]:
    """The role tag of the calling thread (None when untagged — e.g.
    a test poking internals directly; the runtime guards let untagged
    threads through and leave enforcement to the static checker)."""
    stack = getattr(_ROLE_TLS, "stack", None)
    return stack[-1] if stack else None


def _push_role(role: str) -> bool:
    stack = getattr(_ROLE_TLS, "stack", None)
    if stack is None:
        stack = _ROLE_TLS.stack = []
    if stack:
        return False          # thread entry already tagged: keep it
    stack.append(role)
    return True


def _pop_role() -> None:
    _ROLE_TLS.stack.pop()


def thread_role(*roles: str) -> Callable:
    """Declare the thread role(s) a function runs on.

    Multiple roles mean "any of these" (e.g. an engine scrape accessor
    serving both the EngineDriver loop and handler-thread scrapes).  The
    FIRST role is the one the runtime sanitizer tags the thread with
    when the function is a thread entry point.
    """
    if not roles:
        raise ValueError("thread_role needs at least one role")
    for r in roles:
        if r not in THREAD_ROLES:
            raise ValueError(
                f"unknown thread role {r!r} (known: "
                f"{sorted(THREAD_ROLES)}); new roles are added in "
                f"runtime/lint/registry.py, deliberately")

    def deco(fn):
        fn.__ttd_thread_roles__ = tuple(roles)
        if not _sanitizer_armed():
            return fn

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _push_role(roles[0]):
                try:
                    return fn(*args, **kwargs)
                finally:
                    _pop_role()
            return fn(*args, **kwargs)

        wrapper.__ttd_thread_roles__ = tuple(roles)
        return wrapper

    return deco


def locks_held(*locks: str) -> Callable:
    """Declare a helper callable only with the named lock(s) held
    (checked at every call site by the static concurrency checker;
    the body is then analyzed as if the locks were held)."""
    if not locks:
        raise ValueError("locks_held needs at least one lock name")

    def deco(fn):
        fn.__ttd_locks_held__ = tuple(locks)
        return fn

    return deco


def dispatch_critical(fn: Callable) -> Callable:
    """Mark a function as inside the overlap-critical decode window
    (no host syncs allowed — the dispatch-purity checker enforces)."""
    fn.__ttd_dispatch_critical__ = True
    return fn


def compile_site(*, buckets=(), donates=(), statics=(), static_names=(),
                 max_compiles: Optional[int] = 8,
                 site: Optional[str] = None) -> Callable:
    """Declare a hot program's compile discipline, as the JAX package
    declares each ``jax.jit`` site (``buckets``: the bucket rule that pads
    its dynamic dims; ``donates`` / ``statics`` / ``static_names``; the
    ``max_compiles`` budget of distinct signatures).

    Eager PyTorch has no compile to watch, so in this package the
    declaration is all there is: it is free whether or not a sanitizer
    is armed, the function comes back untouched, and the site's name and
    arguments are recorded on it (``__ttd_compile_site__``).  No static
    checker reads it: the JAX package's compile checker holds ``jax.jit``
    sites, and the port has none.
    """
    def deco(fn):
        try:
            fn.__ttd_compile_site__ = dict(
                site=site or getattr(fn, "__qualname__", repr(fn)),
                buckets=buckets, donates=tuple(donates),
                statics=tuple(statics), static_names=tuple(static_names),
                max_compiles=max_compiles)
        except (AttributeError, TypeError):     # pragma: no cover
            pass
        return fn

    return deco


def memory_budget(*, pool, budget_bytes: Optional[int] = None,
                  budget_fn: Optional[Callable] = None,
                  project_fn: Optional[Callable] = None,
                  lifetime="owner",
                  site: Optional[str] = None) -> Callable:
    """Declare a device-memory ALLOCATOR's pool and budget (the third
    lint vertical — memory — mirroring ``@compile_site`` for compiles).

    - ``pool``: the pool name the allocation charges (str, or a
      callable over the allocator's args for multi-pool allocators —
      the engine's ``_fresh_cache`` mints grid pools AND batch-1
      prefill caches);
    - ``budget_bytes`` / ``budget_fn``: the owner's HBM budget in
      bytes (a callable receives the allocator's args; returning None
      means track-only — gauges and spans, no enforcement).  One of
      the two is REQUIRED (the static checker flags a budget-less
      declaration);
    - ``project_fn``: projected bytes of the allocation BEFORE it runs
      (the engine's memoized cache ``eval_shape``) — with it, an
      over-budget allocation raises ``MemoryBudgetError`` before any
      buffer exists; without it, the first call of each signature
      charges after the fact and later calls pre-check off the memo;
    - ``lifetime``: ``"owner"`` (charge lives until the owning
      instance dies — the constant pools) or ``"leaf"`` (released as
      the minted buffers die — transient allocations); callable for
      allocators that mint both.

    Like ``@thread_role`` and ``@compile_site``, the declaration is
    free when the sanitizer (``TTD_MEMCHECK=1``) is unarmed: the
    function comes back untouched.
    """
    def deco(fn):
        # Deferred import: the registry stays import-light (the
        # compile_site convention).
        from tensorflow_train_distributed_torch.runtime.lint import (
            memcheck,
        )

        return memcheck.annotate(
            fn, pool=pool, budget_bytes=budget_bytes,
            budget_fn=budget_fn, project_fn=project_fn,
            lifetime=lifetime, site=site)

    return deco


def _normalize_spec(attr: str, spec) -> Tuple[Optional[str], Tuple[str, ...]]:
    """-> (lock_name_or_None, owner_roles)."""
    if isinstance(spec, str):
        return spec, ()
    if isinstance(spec, (tuple, list)) and spec:
        lock = spec[0]
        owners = tuple(spec[1:])
        if lock is not None and not isinstance(lock, str):
            raise TypeError(f"_GUARDED_BY[{attr!r}]: lock must be a str "
                            f"or None, got {lock!r}")
        for r in owners:
            if r not in THREAD_ROLES:
                raise ValueError(
                    f"_GUARDED_BY[{attr!r}]: unknown owner role {r!r}")
        if lock is None and not owners:
            raise ValueError(
                f"_GUARDED_BY[{attr!r}]: a lockless attribute needs at "
                f"least one owner role")
        return lock, owners
    raise TypeError(f"_GUARDED_BY[{attr!r}]: spec must be a str or a "
                    f"non-empty tuple, got {spec!r}")


def guard_specs(cls) -> Dict[str, Tuple[Optional[str], Tuple[str, ...]]]:
    """The class's normalized ``_GUARDED_BY`` declarations."""
    raw = getattr(cls, "_GUARDED_BY", None) or {}
    return {attr: _normalize_spec(attr, spec) for attr, spec in raw.items()}


def concurrency_guarded(cls):
    """Class decorator: validate ``_GUARDED_BY`` and (when the runtime
    sanitizer is armed) install per-attribute access guards."""
    specs = guard_specs(cls)        # raises on malformed declarations
    if specs and _sanitizer_armed():
        # Deferred import: lockcheck pulls nothing heavy, but keeping
        # the registry import-light matters for child processes.
        from tensorflow_train_distributed_torch.runtime.lint import lockcheck
        lockcheck.install_attr_guards(cls, specs)
    return cls
