"""Memory-budget discipline: the device-allocator registry and its live-byte
sanitizer, over torch tensors (the runtime half of the JAX package's
``runtime/lint/memcheck.py``; its AST checker waits for the rest of the
lint package, ROADMAP Queue 1 step 8).

- **arming** (``TTD_MEMCHECK=1``; ``TTD_NO_MEMCHECK=1`` vetoes it, and is
  re-read per allocation as a live escape hatch): allocators declared
  with ``registry.memory_budget`` are wrapped when they are DECORATED,
  that is when their module is imported, so arm before importing the
  package (the JAX contract).  Unarmed, the declaration returns the
  function untouched.
- **the ledger**: an armed allocator charges a per-``(owner, pool)``
  ledger with the bytes of the tensors it returns.  BEFORE it runs, the
  projected bytes (the spec's ``project_fn``, or the memo of an earlier
  allocation with the same signature) are checked against the owner's
  budget, and an allocation that would exceed it raises
  ``MemoryBudgetError`` with the owner's live set listed, pool by pool
  and allocation by allocation.  ``lifetime="owner"`` charges live as
  long as the owner (a same-site allocation replaces the previous one);
  ``lifetime="leaf"`` charges are released as the tensors die.
- **bytes**: a storage is counted once, however many views of it a tree
  holds (keyed by its ``untyped_storage().data_ptr()``; meta tensors,
  whose storages have no address, by the tensor that owns the storage),
  and at the storage's full size — what it pins on the device.  A leaf
  charge is released by ``weakref.finalize`` on the tensor that owns the
  storage (a view's ``_base``), which dies with the last view of it.

``track`` charges a stored tree explicitly (the engine's preloaded
prefix pairs).  Every charge records a ``memory/<pool>`` span in the
flight recorder (``runtime.events``), with a ``memory/near_miss``
instant once a pool crosses 90% of its budget.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import itertools
import os
import threading
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tensorflow_train_distributed_torch.runtime import events

_ARM_ENV = "TTD_MEMCHECK"
_KILL_ENV = "TTD_NO_MEMCHECK"


class MemoryBudgetError(RuntimeError):
    """An allocation would exceed its owner's declared device budget."""


# -- arming ----------------------------------------------------------------


def _truthy(v: Optional[str]) -> bool:
    return v is not None and v not in ("", "0")


def armed() -> bool:
    """``TTD_MEMCHECK`` truthy and not vetoed by ``TTD_NO_MEMCHECK``;
    read at decoration time (allocators wrap at import)."""
    if _truthy(os.environ.get(_KILL_ENV)):
        return False
    return _truthy(os.environ.get(_ARM_ENV))


# Re-read per allocation: an operator can disarm a misbehaving sanitizer
# live.
_vetoed = events.make_env_flag_reader(_KILL_ENV)


# -- pool registry ---------------------------------------------------------


@dataclass(frozen=True)
class PoolSpec:
    """One allocator's declared memory discipline."""

    site: str
    pool: object                   # str, or callable(*args, **kw) -> str
    budget_bytes: Optional[int] = None
    budget_fn: Optional[Callable] = None
    project_fn: Optional[Callable] = None
    lifetime: object = "owner"     # "owner" | "leaf", or callable
    method: bool = False           # args[0] is the owning instance


@dataclass
class _Alloc:
    label: str
    nbytes: int
    leaves_left: int = 0           # leaf-lifetime bookkeeping


@dataclass
class _OwnerLedger:
    """Live allocations of one owner (an engine, a trainer; None for a
    module-level allocator), split by pool."""

    pools: Dict[str, Dict[int, _Alloc]] = field(default_factory=dict)
    peak: Dict[str, int] = field(default_factory=dict)


_STATE_LOCK = threading.Lock()
_SITES: Dict[str, PoolSpec] = {}
_LEDGERS: Dict[object, _OwnerLedger] = {}
# (site, owner token, signature) -> bytes: a repeat allocation of a known
# signature is checked BEFORE it runs even without a project_fn.  The
# owner is part of the key: two engines share signatures, not bytes.
_PROJ: Dict[tuple, int] = {}
_AIDS = itertools.count(1)
_TOKENS = itertools.count(1)
_IN_ALLOC = threading.local()      # re-entrancy guard: outermost wins


def register_site(spec: PoolSpec) -> PoolSpec:
    with _STATE_LOCK:
        _SITES[spec.site] = spec
    return spec


def sites() -> Tuple[str, ...]:
    """Registered allocator sites (populated at import of annotated
    modules)."""
    with _STATE_LOCK:
        return tuple(sorted(_SITES))


def reset() -> None:
    """Forget every ledger and projection (test isolation)."""
    with _STATE_LOCK:
        _RELEASES.clear()
        _PURGES.clear()
        _LEDGERS.clear()
        _PROJ.clear()


# -- bytes of a tree ---------------------------------------------------------


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and dataclasses (a
    ``KVCache``), depth first."""
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _storage_owner(t):
    """The tensor that owns ``t``'s storage (itself, or a view's base)."""
    return t if t._base is None else t._base


def _storages(tree) -> List[tuple]:
    """[(key, bytes, owning tensor)] of the distinct storages under
    ``tree``: views of one storage count once, at its full size."""
    seen, out = set(), []
    for t in _tensors(tree):
        owner = _storage_owner(t)
        st = t.untyped_storage()
        ptr = st.data_ptr()
        key = (str(t.device), ptr) if ptr else ("id", id(owner))
        if key in seen:
            continue
        seen.add(key)
        out.append((key, int(st.nbytes()), owner))
    return out


def tree_bytes(tree) -> int:
    """Device bytes a tree's tensors pin: each storage once, whole.  Host
    metadata only (no sync); meta tensors project for free."""
    return sum(n for _, n, _ in _storages(tree))


def _purge_owner(tok) -> None:
    # The owner's finalizer: like ``_release`` it only queues, since a
    # collection inside a _STATE_LOCK section would deadlock on the lock.
    _PURGES.append(tok)


def _owner_token(x) -> object:
    """Stable ledger key of an allocation's owning instance, purged when
    the owner is collected (``id()`` alone would merge a dead engine's
    ledger into whatever reuses its address)."""
    if x is None:
        return None
    tok = getattr(x, "__ttd_mc_token__", None)
    if tok is not None:
        return ("tok", tok)
    with _STATE_LOCK:
        tok = getattr(x, "__ttd_mc_token__", None)
        if tok is not None:
            return ("tok", tok)
        try:
            tok = next(_TOKENS)
            object.__setattr__(x, "__ttd_mc_token__", tok)
        except (AttributeError, TypeError):
            return ("id", type(x).__name__, id(x))
    entry = ("tok", tok)
    try:
        weakref.finalize(x, _purge_owner, entry)
    except TypeError:              # pragma: no cover - not weakref-able
        pass
    return entry


# -- the ledger --------------------------------------------------------------


def live_bytes(owner=None, pool: Optional[str] = None) -> int:
    """Live charged bytes: of one owner (pass the object), one pool, both,
    or everything (``owner=None`` sums every owner)."""
    tok = _owner_token(owner) if owner is not None else None
    total = 0
    with _STATE_LOCK:
        _drain_releases_locked()
        for otok, ledger in _LEDGERS.items():
            if owner is not None and otok != tok:
                continue
            for pname, allocs in ledger.pools.items():
                if pool is not None and pname != pool:
                    continue
                total += sum(a.nbytes for a in allocs.values())
    return total


def _live_tok(tok) -> int:
    with _STATE_LOCK:
        _drain_releases_locked()
        ledger = _LEDGERS.get(tok)
        if ledger is None:
            return 0
        return sum(a.nbytes for allocs in ledger.pools.values()
                   for a in allocs.values())


def _replaceable_bytes(tok, pool: str, site: str) -> int:
    """Bytes of the owner-lifetime charge a same-site allocation is about
    to replace: the budget check counts the rebuild, not both."""
    with _STATE_LOCK:
        _drain_releases_locked()
        ledger = _LEDGERS.get(tok)
        if ledger is None:
            return 0
        allocs = ledger.pools.get(pool) or {}
        return sum(a.nbytes for a in allocs.values() if a.label == site)


def live_by_pool() -> Dict[str, float]:
    """``{pool: live bytes}`` across every owner."""
    out: Dict[str, float] = {}
    with _STATE_LOCK:
        _drain_releases_locked()
        for ledger in _LEDGERS.values():
            for pname, allocs in ledger.pools.items():
                if allocs:
                    out[pname] = out.get(pname, 0.0) + float(
                        sum(a.nbytes for a in allocs.values()))
    return out


def peak_by_pool() -> Dict[str, float]:
    """``{pool: peak live bytes}`` across owners."""
    out: Dict[str, float] = {}
    with _STATE_LOCK:
        _drain_releases_locked()
        for ledger in _LEDGERS.values():
            for pname, peak in ledger.peak.items():
                out[pname] = max(out.get(pname, 0.0), float(peak))
    return out


def _live_set_locked(tok) -> List[tuple]:
    ledger = _LEDGERS.get(tok)
    if ledger is None:
        return []
    return [(pname, a.label, a.nbytes)
            for pname, allocs in ledger.pools.items()
            for a in allocs.values()]


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return (f"{n:.1f} {unit}" if unit != "B"
                    else f"{int(n)} {unit}")
        n /= 1024
    return f"{n:.1f} GiB"          # pragma: no cover - loop returns


def _budget_error(site: str, pool: str, projected: int, budget: int,
                  tok) -> MemoryBudgetError:
    with _STATE_LOCK:
        _drain_releases_locked()
        live = _live_set_locked(tok)
    total = sum(b for _, _, b in live)
    lines = [f"  live {p}/{label}: {_fmt_bytes(b)}"
             for p, label, b in sorted(live, key=lambda t: -t[2])]
    listing = "\n".join(lines) or "  (no live allocations)"
    return MemoryBudgetError(
        f"memory budget exceeded at allocator '{site}': allocating "
        f"{_fmt_bytes(projected)} into pool '{pool}' would put the "
        f"owner at {_fmt_bytes(total + projected)} live, over its "
        f"declared budget of {_fmt_bytes(budget)}.  The offending "
        f"allocation against the live set:\n{listing}\n"
        f"Shrink the pool (e.g. --kv-pool-blocks), raise the declared "
        f"budget, or find the leak in the listing above")


# Finalizers run at collection time, which any allocation can trigger,
# including one inside a _STATE_LOCK section: they only append here, and
# every ledger reader drains the queue under the lock first.
_RELEASES: deque = deque()
_PURGES: deque = deque()        # owner tokens whose owner was collected


def _release(tok, pool: str, aid: int, nbytes: int) -> None:
    _RELEASES.append((tok, pool, aid, nbytes))


def _drain_releases_locked() -> None:
    while True:
        try:
            tok = _PURGES.popleft()
        except IndexError:
            break
        _LEDGERS.pop(tok, None)
        for k in [k for k in _PROJ if k[1] == tok]:
            del _PROJ[k]
    while True:
        try:
            tok, pool, aid, nbytes = _RELEASES.popleft()
        except IndexError:
            return
        ledger = _LEDGERS.get(tok)
        allocs = None if ledger is None else ledger.pools.get(pool)
        a = None if allocs is None else allocs.get(aid)
        if a is None:
            continue
        a.nbytes = max(0, a.nbytes - nbytes)
        a.leaves_left -= 1
        if a.leaves_left <= 0 or a.nbytes == 0:
            del allocs[aid]


def _charge(tok, pool: str, site: str, nbytes: int, result,
            lifetime: str) -> None:
    """Record one allocation: ``"leaf"`` releases each storage's bytes
    when the tensor owning it dies; ``"owner"`` pins the charge until the
    owner dies, a same-site charge replacing the previous one."""
    aid = next(_AIDS)
    label = site if lifetime == "owner" else f"{site}#{aid}"
    storages = _storages(result) if lifetime == "leaf" else []
    with _STATE_LOCK:
        _drain_releases_locked()
        ledger = _LEDGERS.setdefault(tok, _OwnerLedger())
        allocs = ledger.pools.setdefault(pool, {})
        if lifetime == "owner":
            for old in [k for k, a in allocs.items() if a.label == label]:
                del allocs[old]
        allocs[aid] = _Alloc(label=label, nbytes=nbytes,
                             leaves_left=len(storages) or 1)
        live = sum(a.nbytes for a in allocs.values())
        ledger.peak[pool] = max(ledger.peak.get(pool, 0), live)
    for _, nb, owner in storages:
        try:
            weakref.finalize(owner, _release, tok, pool, aid, nb)
        except TypeError:          # pragma: no cover - exotic leaf
            pass


# -- the armed wrapper -------------------------------------------------------


def _sig_entry(x) -> object:
    """Hashable size-determining key of one allocator argument: tensors
    by (shape, dtype), containers by their entries."""
    import torch

    if x is None or type(x) in (bool, int, float, str, bytes):
        return ("v", x)
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_sig_entry(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _sig_entry(v)) for k, v in x.items()))
    return ("obj", type(x).__name__)


def _signature(args, kwargs, method: bool) -> tuple:
    sig = [_sig_entry(a) for a in (args[1:] if method else args)]
    for k in sorted(kwargs):
        sig.append((k, _sig_entry(kwargs[k])))
    return tuple(sig)


def _resolve(value, args, kwargs):
    return value(*args, **kwargs) if callable(value) else value


def _default_site(fn) -> str:
    mod = getattr(fn, "__module__", "") or ""
    qual = getattr(fn, "__qualname__", None) or getattr(
        fn, "__name__", None) or repr(fn)
    return f"{mod.rsplit('.', 1)[-1]}.{qual}"


def _wrap(fn, spec: PoolSpec):
    site = spec.site

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _vetoed() or getattr(_IN_ALLOC, "depth", 0):
            # Vetoed live, or nested under an outer annotated allocator:
            # the outermost call owns the charge.
            return fn(*args, **kwargs)
        owner = args[0] if spec.method and args else None
        tok = _owner_token(owner)
        pool = str(_resolve(spec.pool, args, kwargs))
        lifetime = str(_resolve(spec.lifetime, args, kwargs))
        budget = (spec.budget_fn(*args, **kwargs)
                  if spec.budget_fn is not None else spec.budget_bytes)
        sig = _signature(args, kwargs, spec.method)
        _IN_ALLOC.depth = 1
        try:
            projected = _PROJ.get((site, tok, sig))
            if projected is None and spec.project_fn is not None:
                try:
                    projected = int(spec.project_fn(*args, **kwargs))
                except Exception:  # noqa: BLE001 - projection must
                    projected = None  # never break the allocator
            if projected is not None and budget is not None:
                live = _live_tok(tok)
                if lifetime == "owner":
                    live -= _replaceable_bytes(tok, pool, site)
                if live + projected > budget:
                    raise _budget_error(site, pool, projected, budget,
                                        tok)
            span = events.span("memory/" + pool, pool=pool, site=site,
                               bytes=int(projected or 0), live=0,
                               budget=int(budget or 0))
            with span:
                result = fn(*args, **kwargs)
                actual = (projected if projected is not None
                          else tree_bytes(result))
                _PROJ.setdefault((site, tok, sig), actual)
                _charge(tok, pool, site, actual, result, lifetime)
                live = _live_tok(tok)
                attrs = getattr(span, "_attrs", None)
                if attrs is not None:
                    attrs["bytes"] = int(actual)
                    attrs["live"] = int(live)
            if budget is not None:
                if live > budget:
                    # An unprojected first call that overran: the buffers
                    # exist, the error surfaces now.
                    raise _budget_error(site, pool, actual, budget, tok)
                if live > 0.9 * budget:
                    events.instant("memory/near_miss", pool=pool,
                                   site=site, live=int(live),
                                   budget=int(budget))
            return result
        finally:
            _IN_ALLOC.depth = 0

    wrapper.__ttd_memory_pool__ = spec.pool
    wrapper.__ttd_memcheck_wrapped__ = True
    return wrapper


def track(owner, pool: str, tree, label: str,
          budget: Optional[int] = None) -> None:
    """Charge a STORED tree (leaf lifetime: released as its tensors die).
    No-op unless armed.  Raises ``MemoryBudgetError`` when the charge
    lands over ``budget`` (the store happened; the error stops the
    growth)."""
    if not armed() or _vetoed():
        return
    tok = _owner_token(owner)
    nbytes = tree_bytes(tree)
    _charge(tok, pool, f"track:{label}", nbytes, tree, "leaf")
    events.instant("memory/" + pool, pool=pool, site=f"track:{label}",
                   bytes=int(nbytes),
                   live=int(live_bytes(owner=owner, pool=pool)))
    if budget is not None and live_bytes(owner=owner) > budget:
        raise _budget_error("track:" + label, pool, nbytes, budget, tok)


def annotate(fn, *, pool, budget_bytes=None, budget_fn=None,
             project_fn=None, lifetime="owner",
             site: Optional[str] = None):
    """Implementation of ``registry.memory_budget``."""
    name = site or _default_site(fn)
    try:
        params = list(inspect.signature(fn).parameters)
    except (ValueError, TypeError):    # pragma: no cover - C callables
        params = []
    spec = register_site(PoolSpec(
        site=name, pool=pool, budget_bytes=budget_bytes,
        budget_fn=budget_fn, project_fn=project_fn, lifetime=lifetime,
        method=bool(params) and params[0] in ("self", "cls")))
    try:
        fn.__ttd_memory_pool__ = pool
    except (AttributeError, TypeError):  # pragma: no cover
        pass
    if not armed():
        return fn
    return _wrap(fn, spec)
