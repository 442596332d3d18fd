"""Thread-role concurrency checker (the JAX package's
``runtime/lint/concurrency.py``, over the port's classes).

The static half of the concurrency discipline: a class that declares
``_GUARDED_BY`` (attribute -> guard spec, see ``registry``) gets its
methods analyzed as a call graph seeded from ``@thread_role`` entry
points, and every access to a guarded attribute is checked against the
rule its spec declares:

- ``("_lock",)``            every access must hold ``self._lock``;
- ``("_lock", "driver")``   WRITES must hold the lock; lock-free READS
                            are allowed only on paths provably confined
                            to the owner role(s): the single-writer /
                            locked-reader pattern (the engine's stats
                            dicts: the driver loop reads its own writes
                            lock-free, scrape threads lock);
- ``(None, "watchdog")``    an atomic-publish attribute: no lock
                            exists, only the owner role(s) may WRITE,
                            single-field reads are free.

"Provably held" is lexical: a ``with self._lock:`` block, or a helper
declared ``@locks_held("_lock")`` (whose call sites are then checked
instead).  Role confinement is a fixpoint over the class's internal
call graph: a method's roles are its own ``@thread_role`` declaration
unioned with every caller's roles, so a helper reachable from both
the driver loop and a handler-thread entry point must lock, even
though the driver path alone would not need to.

The spec grammar and the roles are the port's ``registry``'s (an owner
role outside ``registry.THREAD_ROLES`` is a finding, as the registry
refuses it at import); on the same source the findings are the JAX
checker's.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from tensorflow_train_distributed_torch.runtime.lint.core import (
    Finding,
    register_checker,
)
from tensorflow_train_distributed_torch.runtime.lint.registry import (
    THREAD_ROLES,
)

CHECKER = "concurrency"

# Container-method calls that mutate the receiver (a
# ``self._admit.append(...)`` is a WRITE to ``_admit``).
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "clear", "remove", "discard", "add",
    "update", "setdefault", "move_to_end", "sort", "reverse",
})


def _decorator_name(dec: ast.expr) -> Optional[str]:
    target = dec.func if isinstance(dec, ast.Call) else dec
    if isinstance(target, ast.Name):
        return target.id
    if isinstance(target, ast.Attribute):
        return target.attr
    return None


def _decorator_str_args(dec: ast.expr) -> Tuple[str, ...]:
    if not isinstance(dec, ast.Call):
        return ()
    out = []
    for a in dec.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            out.append(a.value)
    return tuple(out)


def _parse_spec(attr: str, node: ast.expr):
    """AST mirror of ``registry._normalize_spec`` -> (lock, owners) or
    an error string."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value, ()
    if isinstance(node, (ast.Tuple, ast.List)) and node.elts:
        first = node.elts[0]
        if not (isinstance(first, ast.Constant)
                and (first.value is None or isinstance(first.value, str))):
            return f"_GUARDED_BY[{attr!r}]: lock must be a str or None"
        lock = first.value
        owners = []
        for e in node.elts[1:]:
            if not (isinstance(e, ast.Constant)
                    and isinstance(e.value, str)):
                return f"_GUARDED_BY[{attr!r}]: owner roles must be strs"
            if e.value not in THREAD_ROLES:
                return (f"_GUARDED_BY[{attr!r}]: unknown owner role "
                        f"{e.value!r} (known: {sorted(THREAD_ROLES)})")
            owners.append(e.value)
        if lock is None and not owners:
            return (f"_GUARDED_BY[{attr!r}]: a lockless attribute needs "
                    f"an owner role")
        return lock, tuple(owners)
    return (f"_GUARDED_BY[{attr!r}]: spec must be a string or a "
            f"non-empty tuple literal")


@dataclasses.dataclass
class _Access:
    attr: str
    line: int
    held: frozenset
    write: bool


@dataclasses.dataclass
class _Method:
    name: str
    line: int
    roles: Set[str]
    locks_held: Tuple[str, ...]
    accesses: List[_Access] = dataclasses.field(default_factory=list)
    # (callee name, locks held at the call site, line)
    calls: List[Tuple[str, frozenset, int]] = dataclasses.field(
        default_factory=list)


class _MethodWalker:
    """One method's lexical walk: tracks the ``with self.<lock>:``
    nesting and records guarded-attribute accesses + self-calls."""

    def __init__(self, method: _Method, guarded: Set[str],
                 locks: Set[str]):
        self.m = method
        self.guarded = guarded
        self.locks = locks
        self._parents: Dict[int, ast.AST] = {}

    def run(self, fn: ast.FunctionDef) -> None:
        for node in ast.walk(fn):
            for child in ast.iter_child_nodes(node):
                self._parents[id(child)] = node
        base = frozenset(self.m.locks_held)
        for stmt in fn.body:
            self._walk(stmt, base)

    def _walk(self, node: ast.AST, held: frozenset) -> None:
        if isinstance(node, ast.With):
            acquired = set()
            for item in node.items:
                ce = item.context_expr
                self._walk(ce, held)
                if (isinstance(ce, ast.Attribute)
                        and isinstance(ce.value, ast.Name)
                        and ce.value.id == "self"
                        and ce.attr in self.locks):
                    acquired.add(ce.attr)
            inner = held | frozenset(acquired)
            for stmt in node.body:
                self._walk(stmt, inner)
            return
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            if node.attr in self.guarded:
                self.m.accesses.append(_Access(
                    node.attr, node.lineno, held, self._is_write(node)))
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"):
                self.m.calls.append((f.attr, held, node.lineno))
        for child in ast.iter_child_nodes(node):
            self._walk(child, held)

    def _is_write(self, node: ast.Attribute) -> bool:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            return True
        parent = self._parents.get(id(node))
        # self.attr[k] = v / del self.attr[k] / self.attr[k] += 1:
        # the Subscript target carries Store/Del.
        if (isinstance(parent, ast.Subscript) and parent.value is node
                and isinstance(parent.ctx, (ast.Store, ast.Del))):
            return True
        # self.attr.append(...) and friends.
        if (isinstance(parent, ast.Attribute) and parent.value is node
                and parent.attr in _MUTATORS):
            gp = self._parents.get(id(parent))
            if isinstance(gp, ast.Call) and gp.func is parent:
                return True
        return False


def _analyze_class(cls: ast.ClassDef, path: str) -> List[Finding]:
    findings: List[Finding] = []
    specs: Dict[str, Tuple[Optional[str], Tuple[str, ...]]] = {}
    spec_line = cls.lineno
    for stmt in cls.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == "_GUARDED_BY"):
            spec_line = stmt.lineno
            if not isinstance(stmt.value, ast.Dict):
                findings.append(Finding(
                    CHECKER, path, stmt.lineno,
                    f"{cls.name}._GUARDED_BY must be a dict literal"))
                return findings
            for k, v in zip(stmt.value.keys, stmt.value.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    findings.append(Finding(
                        CHECKER, path, stmt.lineno,
                        f"{cls.name}._GUARDED_BY keys must be string "
                        f"attribute names"))
                    continue
                parsed = _parse_spec(k.value, v)
                if isinstance(parsed, str):
                    findings.append(Finding(CHECKER, path, stmt.lineno,
                                            f"{cls.name}: {parsed}"))
                    continue
                specs[k.value] = parsed
    if not specs:
        return findings
    guarded = set(specs)
    locks = {lock for lock, _ in specs.values() if lock is not None}

    methods: Dict[str, _Method] = {}
    for stmt in cls.body:
        if not isinstance(stmt, ast.FunctionDef):
            continue
        roles: Set[str] = set()
        held: Tuple[str, ...] = ()
        for dec in stmt.decorator_list:
            dn = _decorator_name(dec)
            if dn == "thread_role":
                roles.update(_decorator_str_args(dec))
            elif dn == "locks_held":
                held = held + _decorator_str_args(dec)
        m = _Method(stmt.name, stmt.lineno, roles, held)
        if stmt.name != "__init__":     # construction precedes sharing
            _MethodWalker(m, guarded, locks).run(stmt)
        methods[stmt.name] = m

    # Role fixpoint over the class-internal call graph: a callee runs
    # on every role any caller runs on.
    changed = True
    while changed:
        changed = False
        for m in methods.values():
            for callee, _, _ in m.calls:
                target = methods.get(callee)
                if target is not None and not m.roles <= target.roles:
                    target.roles |= m.roles
                    changed = True

    # locks_held call-site verification.
    for m in methods.values():
        for callee, held, line in m.calls:
            target = methods.get(callee)
            if target is None or not target.locks_held:
                continue
            missing = [lk for lk in target.locks_held if lk not in held]
            if missing:
                findings.append(Finding(
                    CHECKER, path, line,
                    f"{cls.name}.{m.name} calls {callee}() declared "
                    f"@locks_held({', '.join(map(repr, missing))}) "
                    f"without holding the lock(s)"))

    # Guarded-attribute access verification.
    for m in methods.values():
        for acc in m.accesses:
            lock, owners = specs[acc.attr]
            if lock is not None and lock in acc.held:
                continue
            role_confined = bool(m.roles) and m.roles <= set(owners)
            if acc.write:
                if lock is None and role_confined:
                    continue
                if lock is None:
                    what = (f"write to atomic-publish attribute "
                            f"'{acc.attr}' (owner role(s) "
                            f"{sorted(owners)}) on a path with role(s) "
                            f"{sorted(m.roles) or '<undeclared>'}")
                else:
                    what = (f"write to '{acc.attr}' without holding "
                            f"self.{lock}")
                findings.append(Finding(
                    CHECKER, path, acc.line,
                    f"{cls.name}.{m.name}: {what}"))
            else:
                if lock is None or role_confined:
                    continue
                reason = ("method has no declared or inherited thread "
                          "role" if not m.roles else
                          f"path runs on role(s) {sorted(m.roles)}, "
                          f"owner(s) {sorted(owners) or 'none'}")
                findings.append(Finding(
                    CHECKER, path, acc.line,
                    f"{cls.name}.{m.name}: read of '{acc.attr}' "
                    f"without holding self.{lock} ({reason})"))

    # Declared locks must exist somewhere in the class (a typo'd lock
    # name would silently never match a with-block).
    assigned_attrs = {
        t.attr
        for stmt in ast.walk(cls)
        for t in ast.walk(stmt)
        if isinstance(t, ast.Attribute)
        and isinstance(t.ctx, ast.Store)
        and isinstance(t.value, ast.Name) and t.value.id == "self"
    }
    for attr, (lock, _) in sorted(specs.items()):
        if lock is not None and lock not in assigned_attrs:
            findings.append(Finding(
                CHECKER, path, spec_line,
                f"{cls.name}: declared lock '{lock}' for '{attr}' is "
                f"never assigned on self"))
    return findings


@register_checker(CHECKER)
def check(tree: ast.Module, lines, path: str, ctx) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_analyze_class(node, path))
    return findings
