"""Dispatch-purity checker: host syncs and host nondeterminism inside the
decode window (the torch form of the JAX package's
``runtime/lint/dispatch.py``).

``@dispatch_critical`` functions are the overlap-critical decode window
(``ServingEngine._dispatch_chunk`` and its helpers): everything between
harvesting chunk N and enqueueing chunk N+1 must stay free of host
syncs, or the one-chunk lookahead quietly degrades to the synchronous
path while the overlap statistics still report overlap.  An eager CUDA
tensor syncs the host wherever Python needs its value, so flagged are:

- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``: a tensor's
  value on the host;
- ``float(...)`` / ``int(...)`` / ``bool(...)`` of a non-constant: the
  same for a tensor (a host value earns a suppression saying so);
- ``np.asarray(...)`` / ``np.array(...)``: a CUDA tensor's values;
- ``torch.cuda.synchronize()`` and any ``.synchronize()`` (a stream's,
  an event's);
- a tensor in an ``if`` / ``while`` / ``assert`` / conditional
  expression test: ``torch.*`` calls, tensor reductions (``.any()``,
  ``.all()``, ``.sum()``, ...) and names the function bound to a
  ``torch.*`` result;
- ``os.environ[...]`` / ``os.environ.get(...)``: ~1 us a read on a
  per-chunk path (read a module flag, or the flight recorder's
  ``os.environ._data`` fast path);

and host-side nondeterminism, which makes two runs of the same requests
differ:

- ``time.time()`` / ``time.time_ns()``: the wall clock (it steps under
  NTP; ``time.monotonic`` and ``time.perf_counter`` time the window and
  feed no result, so they pass);
- ``random.*`` / ``np.random.*``: the host's global generators;
- ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` /
  ``rand_like`` / ``randn_like`` / ``randint_like`` / ``normal`` /
  ``bernoulli`` / ``multinomial`` without a ``generator=``: torch's
  global generator.

The JAX checker's second population, jitted functions (Python effects
that burn in at trace time, and ``static_argnums`` fed a traced value,
``_static_arg_hazards``), has no counterpart: eager PyTorch traces
nothing, and the port has no ``torch.compile`` site.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from tensorflow_train_distributed_torch.runtime.lint.core import (
    Finding,
    decorator_name,
    dotted_name,
    register_checker,
)

CHECKER = "dispatch"

_HOST_VALUE_METHODS = {"item", "tolist", "cpu", "numpy"}
_MATERIALIZERS = {"np.asarray", "np.array", "numpy.asarray",
                  "numpy.array"}
_WALL_CLOCKS = {"time.time", "time.time_ns"}
_TORCH_RANDOM = {"rand", "randn", "randint", "randperm", "rand_like",
                 "randn_like", "randint_like", "normal", "bernoulli",
                 "multinomial"}
# Tensor methods whose result, in a branch test, is read on the host.
_REDUCTIONS = {"any", "all", "sum", "max", "min", "mean", "amax", "amin",
               "eq", "ne", "gt", "lt", "ge", "le", "isfinite", "isnan",
               "isinf", "equal", "allclose", "nonzero", "count_nonzero"}


def _is_dispatch_critical(fn: ast.FunctionDef) -> bool:
    return any((decorator_name(d) or "").split(".")[-1]
               == "dispatch_critical" for d in fn.decorator_list)


def _torch_names(fn: ast.FunctionDef) -> Set[str]:
    """Local names ``fn`` binds to the result of a ``torch.*`` call."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and (dotted_name(node.value.func) or "").startswith("torch.")):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
    return out


def _tensor_test(test: ast.expr, tensors: Set[str]) -> Optional[str]:
    """What makes ``test`` read a tensor on the host, or None."""
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id in tensors:
            return f"'{node.id}' (bound to a torch result)"
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name.startswith("torch."):
                return f"{name}(...)"
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REDUCTIONS):
                return f".{node.func.attr}()"
    return None


def _hazards(fn: ast.FunctionDef, path: str) -> List[Finding]:
    out: List[Finding] = []
    tensors = _torch_names(fn)

    def flag(node, msg):
        out.append(Finding(CHECKER, path, node.lineno,
                           f"{fn.name}: {msg} inside dispatch-critical "
                           f"window"))

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            name = dotted_name(f) or ""
            if isinstance(f, ast.Attribute):
                if f.attr in _HOST_VALUE_METHODS and not node.args:
                    flag(node, f".{f.attr}() host sync (a tensor's value "
                               f"on the host)")
                elif f.attr == "synchronize":
                    flag(node, f"{name or '.synchronize'}() host sync")
                elif name in _MATERIALIZERS:
                    flag(node, f"{name}() device-value materialization / "
                               f"host sync")
                elif name in _WALL_CLOCKS:
                    flag(node, f"{name}(): wall clock (use "
                               f"time.monotonic)")
                elif name.startswith(("random.", "np.random.",
                                      "numpy.random.")):
                    flag(node, f"{name}(): host-side randomness from a "
                               f"global generator")
                elif (name.startswith("torch.")
                      and f.attr in _TORCH_RANDOM
                      and not any(kw.arg == "generator"
                                  for kw in node.keywords)):
                    flag(node, f"{name}() without generator=: torch's "
                               f"global generator")
                elif name == "os.environ.get":
                    flag(node, "os.environ.get(): slow env read on a hot "
                               "path (hoist to a module flag or use the "
                               "os.environ._data fast path)")
            elif isinstance(f, ast.Name):
                if f.id in ("float", "int", "bool") and len(node.args) == 1:
                    a = node.args[0]
                    if isinstance(a, ast.UnaryOp):
                        a = a.operand        # float(-1e9) is constant
                    if not isinstance(a, ast.Constant):
                        flag(node, f"{f.id}() on a non-constant (a host "
                                   f"sync if the argument is a tensor)")
        elif isinstance(node, ast.Subscript):
            if dotted_name(node.value) == "os.environ":
                flag(node, "os.environ[...]: slow env read on a hot "
                           "path (hoist to a module flag or use the "
                           "os.environ._data fast path)")
        elif isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            what = _tensor_test(node.test, tensors)
            if what is not None:
                flag(node, f"tensor in a branch test, {what}: the host "
                           f"waits for its value")
    return out


@register_checker(CHECKER)
def check(tree: ast.Module, lines, path: str, ctx) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and _is_dispatch_critical(node)):
            findings.extend(_hazards(node, path))
    return findings
