"""Memory-budget discipline: the device-allocator registry, its live-byte
sanitizer and its static checker, over torch tensors (the JAX package's
``runtime/lint/memcheck.py``).

- **the static checker** (``memcheck``, registered in ``core``): a module
  that declares any ``@memory_budget`` pool is a hot allocator module
  (``serving.py`` is required to be), and inside one every host-side
  device allocation (``torch.empty`` / ``zeros`` / ``ones`` / ``full``
  and the like, ``*_like`` and ``arange`` / ``tensor`` among them, given
  a ``device=`` that is not the literal ``"cpu"`` or ``"meta"``, and
  ``.cuda()``) must be reachable from an ``@memory_budget`` allocator
  through the module's own calls.  A device allocation outside one is an
  unbudgeted pool in the making.  Every ``@memory_budget`` must declare a
  budget (``budget_bytes`` or ``budget_fn``) and a ``pool``.  The JAX
  checker's donation rule (a donated buffer kept alive behind a
  ``@compile_site`` program's call) has no counterpart: torch has no
  donated buffers, and eager calls free nothing their caller still
  holds.

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

import ast
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
from tensorflow_train_distributed_torch.runtime.lint.core import (
    Finding,
    decorator_name,
    dotted_name,
    register_checker,
)

CHECKER = "memcheck"

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


# -- static checker --------------------------------------------------------

#: Torch calls that allocate on the device their ``device=`` names.
_ALLOC_FNS = {"empty", "zeros", "ones", "full", "empty_like", "zeros_like",
              "ones_like", "full_like", "empty_strided", "arange", "tensor",
              "as_tensor", "rand", "randn", "randint", "randperm"}
#: ``device=`` literals that allocate nothing on a card.
_HOST_DEVICES = {"cpu", "meta"}

#: Files that must declare at least one ``@memory_budget`` pool, by their
#: package-relative paths (a ``tools/bench_serving.py`` must not match
#: ``serving.py``'s rule).  The JAX package also requires its trainer;
#: the port's trainer declares no pool (its state is counted by
#: ``training/memory.plan_state_memory`` instead).
_REQUIRED_HOT = (
    os.path.join("tensorflow_train_distributed_torch", "serving.py"),
)


def _has_decorator(fn, name: str) -> Optional[ast.expr]:
    for dec in fn.decorator_list:
        dname = decorator_name(dec)
        if dname and dname.split(".")[-1] == name:
            return dec
    return None


def _kwarg(call: Optional[ast.expr], name: str) -> Optional[ast.expr]:
    if not isinstance(call, ast.Call):
        return None
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _host_device(node: ast.expr) -> bool:
    """``node`` is a literal host device: "cpu", "meta" or
    ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] in _HOST_DEVICES
    if (isinstance(node, ast.Call) and dotted_name(node.func) == "torch.device"
            and node.args):
        return _host_device(node.args[0])
    return False


def _is_alloc_call(node: ast.Call) -> bool:
    name = dotted_name(node.func) or ""
    if isinstance(node.func, ast.Attribute) and node.func.attr == "cuda":
        return True
    if not (name.startswith("torch.") and name.count(".") == 1
            and name.split(".")[1] in _ALLOC_FNS):
        return False
    device = _kwarg(node, "device")
    return device is not None and not _host_device(device)


def _func_defs(tree: ast.Module) -> List[ast.FunctionDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _called_names(fn: ast.FunctionDef) -> set:
    """Names ``fn``'s body calls directly (``helper(...)``) or through an
    instance (``self.helper(...)``): the sanction closure's edges."""
    out = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            out.add(f.id)
        elif isinstance(f, ast.Attribute):
            out.add(f.attr)
    return out


def _sanctioned_functions(tree: ast.Module) -> set:
    """FunctionDef nodes (by id) whose device allocations are owned:
    ``@memory_budget`` allocators and everything they reach through the
    module's own calls; nested defs inherit their enclosing def's
    sanction."""
    defs = _func_defs(tree)
    by_name: Dict[str, List[ast.FunctionDef]] = {}
    for d in defs:
        by_name.setdefault(d.name, []).append(d)
    sanctioned = {id(d) for d in defs
                  if _has_decorator(d, "memory_budget") is not None}
    parents: Dict[int, int] = {}
    for d in defs:
        for child in ast.walk(d):
            if child is not d and isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                parents.setdefault(id(child), id(d))
    changed = True
    while changed:
        changed = False
        for d in defs:
            if id(d) not in sanctioned and parents.get(id(d)) in sanctioned:
                sanctioned.add(id(d))
                changed = True
        for d in defs:
            if id(d) not in sanctioned:
                continue
            for callee in _called_names(d):
                for target in by_name.get(callee, ()):
                    if id(target) not in sanctioned:
                        sanctioned.add(id(target))
                        changed = True
    return sanctioned


def _enclosing_chain(tree: ast.Module) -> Dict[int, List[ast.AST]]:
    """node id -> chain of enclosing FunctionDefs (innermost last)."""
    chains: Dict[int, List[ast.AST]] = {}

    def visit(node, chain):
        for child in ast.iter_child_nodes(node):
            nchain = chain
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nchain = chain + [child]
            chains[id(child)] = nchain
            visit(child, nchain)

    chains[id(tree)] = []
    visit(tree, [])
    return chains


def _unbudgeted_alloc_findings(tree: ast.Module, path: str) -> List[Finding]:
    sanctioned = _sanctioned_functions(tree)
    chains = _enclosing_chain(tree)
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_alloc_call(node)):
            continue
        chain = chains.get(id(node), [])
        if any(id(d) in sanctioned for d in chain):
            continue
        where = chain[-1].name if chain else "<module scope>"
        out.append(Finding(
            CHECKER, path, node.lineno,
            f"un-annotated device allocation: {dotted_name(node.func)}(...) "
            f"in '{where}' is not reachable from any @memory_budget "
            f"allocator — declare the pool it belongs to "
            f"(runtime/lint/registry.memory_budget) so the sanitizer and "
            f"ttd_engine_hbm_bytes can see it"))
    return out


def _declaration_findings(tree: ast.Module, path: str) -> List[Finding]:
    out: List[Finding] = []
    for d in _func_defs(tree):
        dec = _has_decorator(d, "memory_budget")
        if dec is None:
            continue
        if (_kwarg(dec, "budget_bytes") is None
                and _kwarg(dec, "budget_fn") is None):
            out.append(Finding(
                CHECKER, path, d.lineno,
                f"'{d.name}': @memory_budget declares a pool but no "
                f"budget — add budget_bytes=... or budget_fn=... (a pool "
                f"without a budget is a gauge, not a discipline; a "
                f"budget_fn may return None to track only at run time, "
                f"but the declaration must say so)"))
        if _kwarg(dec, "pool") is None:
            out.append(Finding(
                CHECKER, path, d.lineno,
                f"'{d.name}': @memory_budget without pool=... — the "
                f"ledger, the gauges and the spans all key on the pool "
                f"name"))
    return out


def _module_is_hot(tree: ast.Module) -> bool:
    return any(_has_decorator(d, "memory_budget") is not None
               for d in _func_defs(tree))


@register_checker(CHECKER)
def check(tree: ast.Module, lines, path: str, ctx) -> List[Finding]:
    findings: List[Finding] = []
    hot = _module_is_hot(tree)
    if any(path.endswith(req) for req in _REQUIRED_HOT) and not hot:
        findings.append(Finding(
            CHECKER, path, 1,
            "registered hot allocator module declares no @memory_budget "
            "pool — its big device allocators must be budget-annotated"))
    if hot:
        findings.extend(_unbudgeted_alloc_findings(tree, path))
        findings.extend(_declaration_findings(tree, path))
    return findings
