"""Kill-switch / env-flag checker (the JAX package's
``runtime/lint/flags.py``, over the port).

Every ``TTD_*`` name referenced in the port's source must be (1)
documented in the README's port section and (2) exercised by at least
one of the port's tests (``tests/test_torch_*.py``): an undocumented
kill switch is an operator trap, and an untested one is a switch nobody
knows still works.  A JAX-package test exercises the JAX package's
switch, not the port's, so it does not count.  This includes stdout tags
that look like env vars (``TTD_RESULT:``): an operator grepping logs
meets them before reading the source.

Family names are honoured: ``TTD_K8S_REPLICAS`` is satisfied by the
README documenting either the exact name or a ``TTD_K8S_*`` family
entry.  Suppress a deliberate exception with ``# ttd-lint:
disable=kill-switch -- <why>`` on the referencing line.
"""

from __future__ import annotations

import re
from typing import List

from tensorflow_train_distributed_torch.runtime.lint.core import (
    Finding,
    register_checker,
)

CHECKER = "kill-switch"

# Trailing underscore excluded: ``TTD_FOO_*`` family globs in docs are
# not variable references.
_VAR_RE = re.compile(r"\bTTD_[A-Z0-9_]*[A-Z0-9]\b")


def _family_documented(var: str, doc: str) -> bool:
    """Exact name, or any ``TTD_FOO_*`` family glob whose prefix matches
    the var."""
    if var in doc:
        return True
    parts = var.split("_")
    for i in range(2, len(parts)):
        if "_".join(parts[:i]) + "_*" in doc:
            return True
    return False


@register_checker(CHECKER)
def check(tree, lines, path: str, ctx) -> List[Finding]:
    readme = ctx.port_readme()
    tests = ctx.tests_corpus()
    findings: List[Finding] = []
    seen: set = set()
    for lineno, line in enumerate(lines, start=1):
        for m in _VAR_RE.finditer(line):
            var = m.group(0)
            if var in seen:
                continue
            seen.add(var)
            if not _family_documented(var, readme):
                findings.append(Finding(
                    CHECKER, path, lineno,
                    f"env flag {var} is not documented in README.md's "
                    f"port section"))
            if var not in tests:
                findings.append(Finding(
                    CHECKER, path, lineno,
                    f"env flag {var} is not exercised by any test "
                    f"under tests/test_torch_*.py"))
    return findings
