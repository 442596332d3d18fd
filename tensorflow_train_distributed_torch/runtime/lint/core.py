"""ttd-lint core: findings, suppressions, file walking, the runner (the
static half of the JAX package's ``runtime/lint/core.py``, over the port).

Checkers are functions ``(tree, source_lines, path, ctx) -> [Finding]``
registered in ``CHECKERS``; ``run_lint`` parses each file once and
fans it to every requested checker, then drops findings suppressed by
the one shared suppression format:

    some_code()    # ttd-lint: disable=concurrency -- scrape is read-only
    other_code()   # ttd-lint: disable=concurrency,dispatch -- bench path

A suppression names the checker it silences (never a bare
``disable``) AND carries a trailing ``-- <why>`` reason, so grepping
for a checker's name finds every place it was overridden.  The
framework lints its own escape hatch: a suppression without a reason,
and a suppression that silenced nothing in this run (the hazard it
excused is gone, or the comment drifted off its line), are both
reported as ``suppression`` findings.  Only suppressions naming a
checker that ran are audited, so ``--checker``-scoped runs never flag
another checker's suppressions.

The default scope is the port's package and the repository's
``chip_smoke.py``; the documentation the checkers hold names to is the
README's port section (``LintContext.port_readme``) and the evidence
that a switch is exercised is the port's own tests,
``tests/test_torch_*.py`` (``LintContext.tests_corpus``).
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import io
import os
import re
import tokenize
from typing import (
    Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple,
)

_SUPPRESS_RE = re.compile(
    r"#\s*ttd-lint:\s*disable=([a-z0-9_,\- ]+?)(?:\s+--\s*(\S.*))?$")

# Directories never linted: fixtures plant bugs for the checkers' own
# tests; caches and build trees are noise.
_SKIP_DIRS = {"__pycache__", "lint_fixtures", ".git", "_build", "build"}

#: The README heading that opens the port's section; the section runs to
#: the next heading of the same level.
PORT_README_HEADING = "## PyTorch / H100 port"


def dotted_name(node: ast.expr) -> Optional[str]:
    """``a.b.c`` for a chain of names and attributes, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def decorator_name(dec: ast.expr) -> Optional[str]:
    """The dotted name of a decorator, called or not."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    return dotted_name(target)


@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str
    path: str
    line: int
    message: str

    def format(self, root: Optional[str] = None) -> str:
        path = (os.path.relpath(self.path, root)
                if root else self.path)
        return f"{path}:{self.line}: [{self.checker}] {self.message}"


def _parse_suppression(text: str) -> Optional[Tuple[Set[str], Optional[str]]]:
    """``(checker_names, reason_or_None)`` for a suppression comment,
    None when ``text`` carries no suppression at all."""
    m = _SUPPRESS_RE.search(text)
    if not m:
        return None
    names = {n.strip() for n in m.group(1).split(",") if n.strip()}
    reason = m.group(2)
    return names, (reason.strip() if reason else None)


def _suppressed(lines: Sequence[str], lineno: int, checker: str) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    parsed = _parse_suppression(lines[lineno - 1])
    return parsed is not None and checker in parsed[0]


def _iter_suppression_comments(
        source: str) -> Iterator[Tuple[int, Set[str], Optional[str]]]:
    """``(lineno, checker_names, reason)`` for every real suppression
    comment: tokenized, so docstring examples of the format (this
    module's, for one) are not mistaken for live suppressions."""
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            parsed = _parse_suppression(tok.string)
            if parsed is not None:
                yield tok.start[0], parsed[0], parsed[1]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return


#: Stable per-checker exit-code bits for the CLI, the JAX package's
#: (OR'd together, so a caller can tell which disciplines failed from the
#: code alone; ``--json`` carries the same map).  0 = clean, 2 = usage
#: error, 1 = findings from an unregistered source (io/syntax).  The port
#: has no static ``compilecheck`` (no ``jax.jit``, no ``torch.compile``
#: site), but its bit stays reserved so a code means the same in both
#: packages.  Bits past 128 cannot survive the 8-bit process status, so
#: ``exit_code`` folds them into bit 1.
CHECKER_EXIT_BITS: Dict[str, int] = {
    "concurrency": 4,
    "dispatch": 8,
    "kill-switch": 16,
    "prometheus": 32,
    "compilecheck": 64,
    "suppression": 128,
    "memcheck": 256,
}


def exit_code(findings: Sequence["Finding"]) -> int:
    """The CLI exit status for a finding list: OR of each finding
    checker's bit (1 for io/syntax), 0 when clean.  Bits past the 8-bit
    process-status range fold into bit 1 (a memcheck-only run exits 1,
    never a false 0: the shell truncates 256 to 0)."""
    code = 0
    for f in findings:
        code |= CHECKER_EXIT_BITS.get(f.checker, 1)
    if code > 255:
        code = (code & 0xFF) | 1
    return code


def iter_source_files(paths: Sequence[str]) -> List[str]:
    """Every ``.py`` under the given files/dirs (sorted, skip-listed
    dirs pruned)."""
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for f in filenames:
                if f.endswith(".py"):
                    out.append(os.path.join(dirpath, f))
    return sorted(set(out))


def _section(text: str, heading: str) -> str:
    """The lines of ``text`` from ``heading`` to the next heading of its
    level ("" when the heading is missing)."""
    level = heading.split(" ", 1)[0] + " "
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if line.strip() == heading:
            end = next((j for j in range(i + 1, len(lines))
                        if lines[j].startswith(level)), len(lines))
            return "\n".join(lines[i:end])
    return ""


class LintContext:
    """Cross-file state checkers may need: the repo root for README and
    test lookups, and the documents read once per run."""

    def __init__(self, root: Optional[str] = None):
        if root is None:
            # runtime/lint/core.py -> the repo root is four levels up.
            root = os.path.abspath(os.path.join(
                os.path.dirname(__file__), "..", "..", ".."))
        self.root = root
        self._docs: Dict[str, str] = {}

    def read_doc(self, relpath: str) -> str:
        if relpath not in self._docs:
            full = os.path.join(self.root, relpath)
            try:
                with open(full, encoding="utf-8") as f:
                    self._docs[relpath] = f.read()
            except OSError:
                self._docs[relpath] = ""
        return self._docs[relpath]

    def port_readme(self) -> str:
        """The README's port section: where the port's switches and
        metric names are documented for its users."""
        key = "<port readme>"
        if key not in self._docs:
            self._docs[key] = _section(self.read_doc("README.md"),
                                       PORT_README_HEADING)
        return self._docs[key]

    def tests_corpus(self) -> str:
        """The port's test sources, ``tests/test_torch_*.py``, joined:
        the kill-switch checker's evidence that a switch is exercised.
        A JAX-package test exercises the JAX package's switch, not the
        port's, so it does not count."""
        key = "<tests>"
        if key not in self._docs:
            chunks = []
            pattern = os.path.join(self.root, "tests", "test_torch_*.py")
            for path in sorted(glob.glob(pattern)):
                try:
                    with open(path, encoding="utf-8") as fh:
                        chunks.append(fh.read())
                except OSError:
                    pass
            self._docs[key] = "\n".join(chunks)
        return self._docs[key]


# name -> checker fn; filled by the checker modules at import.
CHECKERS: Dict[str, Callable] = {}


def register_checker(name: str):
    def deco(fn):
        CHECKERS[name] = fn
        return fn
    return deco


def _load_checkers() -> None:
    # Imported lazily so ``import runtime.lint.core`` alone stays light;
    # each module registers itself.
    from tensorflow_train_distributed_torch.runtime.lint import (  # noqa: F401
        concurrency,
        dispatch,
        flags,
        memcheck,
        prometheus,
    )


def default_paths(root: str) -> List[str]:
    """The port's package and the repository's ``chip_smoke.py``."""
    return [os.path.join(root, "tensorflow_train_distributed_torch"),
            os.path.join(root, "chip_smoke.py")]


def run_lint(paths: Optional[Sequence[str]] = None,
             checkers: Optional[Sequence[str]] = None,
             root: Optional[str] = None) -> List[Finding]:
    """Run the requested checkers (default: all) over ``paths`` (default:
    ``default_paths``), dropping suppressed findings."""
    _load_checkers()
    ctx = LintContext(root)
    if paths is None:
        paths = [p for p in default_paths(ctx.root) if os.path.exists(p)]
    if checkers is None:
        names = sorted(CHECKERS)
    else:
        unknown = [c for c in checkers if c not in CHECKERS]
        if unknown:
            raise ValueError(f"unknown checker(s) {unknown}; "
                             f"known: {sorted(CHECKERS)}")
        names = list(checkers)
    findings: List[Finding] = []
    for path in iter_source_files(list(paths)):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            findings.append(Finding("io", path, 0, f"unreadable: {e}"))
            continue
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            findings.append(Finding(
                "syntax", path, e.lineno or 0, f"syntax error: {e.msg}"))
            continue
        lines = source.splitlines()
        used: set = set()          # (lineno, checker) actually silenced
        for name in names:
            for f_ in CHECKERS[name](tree, lines, path, ctx):
                if _suppressed(lines, f_.line, f_.checker):
                    used.add((f_.line, f_.checker))
                else:
                    findings.append(f_)
        # Reasons are mandatory, and a suppression that silenced nothing
        # (for a checker that ran) hides a hazard that is gone: report
        # both.
        ran = set(names)
        for lineno, sup_names, reason in _iter_suppression_comments(source):
            active = sorted(sup_names & ran)
            if not active:
                continue
            if reason is None:
                findings.append(Finding(
                    "suppression", path, lineno,
                    "suppression missing a reason: write '# ttd-lint: "
                    "disable=<checker> -- <why>'"))
            for c in active:
                if (lineno, c) not in used:
                    findings.append(Finding(
                        "suppression", path, lineno,
                        f"unused suppression for checker '{c}' (no "
                        f"finding was silenced on this line — remove "
                        f"it, or re-anchor it to the hazard)"))
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    return findings
