"""ttd-lint CLI over the port: static concurrency, dispatch-purity,
kill-switch, metric-convention and memory-budget analysis (the
counterpart of the repository's ``tools/ttd_lint.py``).

Usage::

    python -m tensorflow_train_distributed_torch.tools.ttd_lint
    python -m tensorflow_train_distributed_torch.tools.ttd_lint \\
        --checker concurrency path/to/file.py
    python -m tensorflow_train_distributed_torch.tools.ttd_lint --json
    python -m tensorflow_train_distributed_torch.tools.ttd_lint --list

With no paths it lints the port's package and ``chip_smoke.py``.  Exit
status: 0 clean, 2 usage error; findings exit with the OR of each
failing checker's bit (concurrency=4, dispatch=8, kill-switch=16,
prometheus=32, suppression=128, memcheck=256 folded into bit 1 in the
8-bit process status and exact in ``--json``; io/syntax=1;
``core.CHECKER_EXIT_BITS``).  ``--json`` prints ``{"findings": [...],
"counts": {...}, "exit_bits": {...}, "exit_code": N}``.  The tier-1 test
``tests/test_torch_ttd_lint.py::test_port_tree_lints_clean`` runs the
same entry over the whole port and asserts zero findings.

Suppress a deliberate exception with ``# ttd-lint: disable=<checker> --
<why>`` on the offending line (the reason is mandatory and unused
suppressions are reported).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from tensorflow_train_distributed_torch.runtime.lint import core

    core._load_checkers()
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        ".."))
    parser = argparse.ArgumentParser(
        prog="ttd_lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: the port's "
                             "package and chip_smoke.py)")
    parser.add_argument("--checker", action="append", default=None,
                        metavar="NAME",
                        help="run only this checker (repeatable); "
                             "default: all")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output: findings, "
                             "per-checker counts and the exit code as "
                             "one JSON object")
    parser.add_argument("--list", action="store_true",
                        help="list known checkers and exit")
    args = parser.parse_args(argv)

    if args.list:
        for name in sorted(core.CHECKERS):
            print(name)
        return 0
    try:
        findings = core.run_lint(paths=args.paths or None,
                                 checkers=args.checker, root=repo)
    except ValueError as e:
        print(f"ttd_lint: {e}", file=sys.stderr)
        return 2
    code = core.exit_code(findings)
    if args.json:
        counts: dict = {}
        for f in findings:
            counts[f.checker] = counts.get(f.checker, 0) + 1
        print(json.dumps({
            "findings": [{"checker": f.checker,
                          "path": os.path.relpath(f.path, repo),
                          "line": f.line,
                          "message": f.message} for f in findings],
            "counts": counts,
            "exit_bits": core.CHECKER_EXIT_BITS,
            "exit_code": code,
        }, indent=2))
        return code
    for f in findings:
        print(f.format(root=repo))
    if findings:
        print(f"ttd_lint: {len(findings)} finding(s)", file=sys.stderr)
    return code


if __name__ == "__main__":
    sys.exit(main())
