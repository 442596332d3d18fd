"""Step-metric accumulation (host side; a copy of the JAX package's
``training/metrics.py``, numpy only).

Replaces the Keras metric/History plumbing (``tf_keras/src/callbacks.py:1189``)
with a running-mean accumulator over the scalar dict each jitted step
returns.  Metrics under pjit are global (already cross-replica reduced inside
the step via the mean over the sharded batch), so host aggregation is an
average across steps.

Weighted-mean tasks (the Task ``loss_weight`` contract — e.g. MLM metrics
over masked tokens) aggregate as the true weighted mean across batches,
matching Keras's weighted-metric semantics: a batch with twice the masked
tokens counts twice.  ``loss_weight`` itself reports the *total* weight
evaluated.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


class MetricAccumulator:
    def __init__(self):
        self._sums: dict[str, float] = {}
        self._weights: dict[str, float] = {}
        self._weight_total = 0.0
        self._saw_weight = False

    def update(self, metrics: Mapping[str, float]):
        w = float(np.asarray(metrics.get("loss_weight", 1.0)))
        if "loss_weight" in metrics:
            self._weight_total += w
            self._saw_weight = True
        if w <= 0.0:
            # A zero-weight batch (e.g. no masked tokens) carries no metric
            # information: its values are 0/0 artifacts — adding them would
            # poison the sums (NaN·0) or the denominator.
            return
        for k, v in metrics.items():
            if k == "loss_weight":
                continue
            v = float(np.asarray(v))
            self._sums[k] = self._sums.get(k, 0.0) + v * w
            self._weights[k] = self._weights.get(k, 0.0) + w

    def result(self) -> dict[str, float]:
        out = {k: self._sums[k] / self._weights[k] for k in self._sums}
        if self._saw_weight:
            out["loss_weight"] = self._weight_total
        return out

    def reset(self):
        self._sums.clear()
        self._weights.clear()
        self._weight_total = 0.0
        self._saw_weight = False
