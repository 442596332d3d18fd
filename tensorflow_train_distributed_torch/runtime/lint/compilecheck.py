"""Compile discipline: the runtime surface the serving fleet reads.

The JAX package's ``runtime/lint/compilecheck.py`` has two halves: a
static checker (every ``jax.jit`` site declares its buckets, donations
and statics) and a runtime sanitizer (``TTD_COMPILECHECK=1``) that
records each new compiled signature a site dispatches, counts compiles
process-wide and keeps per-program roofline counters (flops and bytes
from XLA's cost analysis, over a trailing window).  The fleet reads the
sanitizer through ``total_compiles`` (``ttd_engine_compiles_total``),
``program_stats`` (a worker's STATS relay), ``peak_flops_per_s`` /
``peak_hbm_bytes_per_s`` and ``mfu_by_program`` / ``mbu_by_program``
(the ``ttd_engine_mfu_pct`` / ``ttd_engine_mbu_pct`` gauges).

This module is that runtime surface only, with JAX's names and return
shapes.  Eager PyTorch compiles no programs (``registry.compile_site`` is
a declaration here), so the ledger stays empty: ``total_compiles()`` is
0, ``program_stats()`` is ``{}`` and the mfu/mbu gauges render no
series, as the JAX fleet shows them unarmed.  The JAX module's AST
``check()`` half has no counterpart: the port has no ``jax.jit`` and no
``torch.compile`` site to hold to a declaration (``runtime/lint``'s
docstring).

The peaks read ``TTD_PEAK_FLOPS`` / ``TTD_PEAK_HBM_BYTES`` as JAX's do;
without them, the data sheet of the card this process already drives
(``training/memory.py``'s table: the H100's 989 TFLOP/s dense bf16,
3.35 TB/s), else None.  A process that has not initialised CUDA (a fleet's
parent, whose workers own the card) never initialises it here.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

_ARM_ENV = "TTD_COMPILECHECK"
_KILL_ENV = "TTD_NO_COMPILECHECK"
_PEAK_FLOPS_ENV = "TTD_PEAK_FLOPS"
_PEAK_HBM_ENV = "TTD_PEAK_HBM_BYTES"

def _truthy(v: Optional[str]) -> bool:
    return v is not None and v.strip().lower() not in ("", "0", "false",
                                                       "no", "off")


def armed() -> bool:
    """``TTD_COMPILECHECK`` truthy and not vetoed by
    ``TTD_NO_COMPILECHECK`` (JAX's rule; nothing here is wrapped either
    way)."""
    if _truthy(os.environ.get(_KILL_ENV)):
        return False
    return _truthy(os.environ.get(_ARM_ENV))


def total_compiles() -> int:
    """Compile events observed at instrumented sites: always 0 here (an
    eager engine compiles nothing per signature)."""
    return 0


def program_stats() -> Dict[str, dict]:
    """Per-site roofline counters (``{site: {"dispatches",
    "flops_total", "bytes_total", "flops_per_s", "bytes_per_s"}}``):
    empty, as JAX's is when no instrumented site has dispatched."""
    return {}


def _env_float(name: str) -> Optional[float]:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return None


def _datasheet() -> Optional[tuple]:
    try:        # lazy, and only where this process already drives a card
        import torch

        if not torch.cuda.is_initialized():
            return None
        kind = torch.cuda.get_device_name(torch.cuda.current_device())
    except Exception:  # noqa: BLE001 — no torch / no card
        return None
    from tensorflow_train_distributed_torch.training import memory

    tflops = memory.peak_tflops(kind)
    if tflops is None:
        return None
    return tflops * 1e12, memory.hbm_bandwidth_bytes_per_sec(kind)


def peak_flops_per_s() -> Optional[float]:
    """The mfu denominator: ``TTD_PEAK_FLOPS`` when set, else the card's
    datasheet peak; None when unknown."""
    if os.environ.get(_PEAK_FLOPS_ENV, ""):
        return _env_float(_PEAK_FLOPS_ENV)
    peaks = _datasheet()
    return peaks[0] if peaks else None


def peak_hbm_bytes_per_s() -> Optional[float]:
    """The mbu denominator: ``TTD_PEAK_HBM_BYTES`` (bytes/s) when set,
    else the card's datasheet bandwidth; None when unknown."""
    if os.environ.get(_PEAK_HBM_ENV, ""):
        return _env_float(_PEAK_HBM_ENV)
    peaks = _datasheet()
    return peaks[1] if peaks else None


def mfu_by_program() -> Dict[str, float]:
    """``{site: achieved flops as % of peak}`` over the trailing window;
    empty when nothing dispatched or the peak is unknown."""
    stats = program_stats()
    peak = peak_flops_per_s() if stats else None
    if not peak:
        return {}
    return {site: round(100.0 * s["flops_per_s"] / peak, 3)
            for site, s in stats.items() if s["dispatches"]}


def mbu_by_program() -> Dict[str, float]:
    """``{site: achieved HBM bytes as % of peak}`` over the trailing
    window; empty when nothing dispatched or the peak is unknown."""
    stats = program_stats()
    peak = peak_hbm_bytes_per_s() if stats else None
    if not peak:
        return {}
    return {site: round(100.0 * s["bytes_per_s"] / peak, 3)
            for site, s in stats.items() if s["dispatches"]}
