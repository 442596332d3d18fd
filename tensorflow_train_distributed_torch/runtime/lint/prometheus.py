"""Prometheus metric-conventions checker (the JAX package's
``runtime/lint/prometheus.py``, over the port):

- every metric registered via ``*.counter("name", ...)`` /
  ``*.fn_counter`` (or the ``Counter`` / ``FnCounter`` constructors of
  ``server/metrics.py``) must end in ``_total``;
- every ``*.histogram("name", ...)`` / ``Histogram(...)`` must end in
  ``_seconds`` (latency histograms observe seconds; a byte or count
  histogram earns a suppression with its reason on the line);
- every ``ttd_*`` metric name registered anywhere must appear
  (backticked) in the README's port section: the scrape surface the
  port promises its operators.

Checked statically from the registration call sites, so stub metrics
and future registries are held to the same rules without instantiating
anything.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from tensorflow_train_distributed_torch.runtime.lint.core import (
    Finding,
    register_checker,
)

CHECKER = "prometheus"

_COUNTER_FNS = {"counter", "fn_counter"}
_HISTOGRAM_FNS = {"histogram"}
_GAUGE_FNS = {"gauge", "labeled_gauge"}
_ALL_FNS = _COUNTER_FNS | _HISTOGRAM_FNS | _GAUGE_FNS
# Constructor names double as registration sites (Counter("x", ...)).
_CTOR_MAP = {"Counter": "counter", "FnCounter": "fn_counter",
             "Histogram": "histogram", "Gauge": "gauge",
             "LabeledGauge": "labeled_gauge"}


def _metric_name(node: ast.Call) -> Optional[str]:
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


@register_checker(CHECKER)
def check(tree: ast.Module, lines, path: str, ctx) -> List[Finding]:
    readme = ctx.port_readme()
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        kind = None
        if isinstance(f, ast.Attribute) and f.attr in _ALL_FNS:
            kind = f.attr
        elif isinstance(f, ast.Name) and f.id in _CTOR_MAP:
            kind = _CTOR_MAP[f.id]
        if kind is None:
            continue
        name = _metric_name(node)
        if name is None:
            continue            # dynamic name: nothing to check
        if kind in _COUNTER_FNS and not name.endswith("_total"):
            findings.append(Finding(
                CHECKER, path, node.lineno,
                f"counter '{name}' must end in _total"))
        if kind in _HISTOGRAM_FNS and not name.endswith("_seconds"):
            findings.append(Finding(
                CHECKER, path, node.lineno,
                f"histogram '{name}' must end in _seconds"))
        if name.startswith("ttd_") and f"`{name}`" not in readme:
            findings.append(Finding(
                CHECKER, path, node.lineno,
                f"metric '{name}' missing from README's metric list (port "
                f"section)"))
    return findings
