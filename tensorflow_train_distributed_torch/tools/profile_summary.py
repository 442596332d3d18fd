"""Summarize a torch.profiler Chrome trace: device time by kind a step,
the busy share of the window and the longest idle gaps.

Reads the traces ``runtime/profiling.py`` writes (``trace(logdir)``,
``--profile-dir`` of the launcher and of ``tools/bench_lm.py``):
``<logdir>/trace_<pid>_<n>.json``.  Device events are the trace's
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; each kernel's name
goes to one kind of ``KINDS`` (``classify``), the table
``chip_smoke.py``'s profiles read too.  Steps are the host spans
(``user_annotation``) named
``STEP_SPAN`` (``tools/bench_lm.py`` marks each profiled step so), else
the window counts as one step.  The window runs from the first step span
or device event to the last one's end; busy is the union of the device
events in it.  A trace with no device events (a CPU run) is "not
measured": no device time, share or gap is read from it.

    python -m tensorflow_train_distributed_torch.tools.profile_summary \\
        <trace dir or .json> [--top 12] [--gaps 5] [--json]

(The JAX tool reads XPlane protos; that reader has no counterpart.)
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

#: The kinds of device time, in the order they are tested.
KINDS = ("matmul", "conv", "batch_norm", "gmm", "tgmm", "flash_attention",
         "flash_attention_bwd", "splash_attention", "splash_attention_bwd",
         "paged_attention", "paged_kv_gather", "cross_entropy", "rms_norm",
         "other")
STEP_SPAN = "ttd_step"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def classify(name: str) -> str:
    """A device kernel's name -> its kind (``KINDS``).  K7 is K2's kernels
    with ``BAND = true`` (its di pass has no band and counts as
    flash_attention_bwd)."""
    low = name.lower()
    band = "true>" in low or "lb1ee" in low
    if "paged_attention" in low:
        return "paged_attention"
    if "paged_kv_gather" in low:
        return "paged_kv_gather"
    if "ttd_grouped" in low:
        return "tgmm" if "tgmm_" in low else "gmm"
    if "flash_bwd" in low:
        return "splash_attention_bwd" if band else "flash_attention_bwd"
    if "flash_fwd" in low:
        return "splash_attention" if band else "flash_attention"
    if "ce_fwd_kernel" in low or "ce_bwd_kernel" in low:
        return "cross_entropy"
    if "rms_norm" in low:
        return "rms_norm"
    if "batch_norm" in low or "bn_fw" in low or "bn_bw" in low:
        return "batch_norm"
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad")):
        return "conv"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "matmul")):
        return "matmul"
    return "other"


def find_trace(path: str) -> str:
    """``path`` itself when it is a file, else the newest ``*.json``
    under it."""
    if os.path.isfile(path):
        return path
    hits = glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
    if not hits:
        raise FileNotFoundError(f"no *.json trace under {path}")
    return max(hits, key=os.path.getmtime)


def _merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(path: str, top: int = 12, gaps: int = 5) -> dict:
    """The summary record of the Chrome trace at ``path`` (a file or a
    directory: ``find_trace``)."""
    path = find_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in _DEVICE_CATS and "dur" in e]
    steps = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") == STEP_SPAN and "dur" in e]
    n_steps = max(len(steps), 1)
    out = {"trace": path, "steps": n_steps}
    if not device:
        out.update(device="not measured", device_ms_per_step=None,
                   busy_share=None, window_ms=None, idle_gaps_ms=None,
                   kinds={k: None for k in KINDS})
        return out
    ms = collections.Counter()
    count = collections.Counter()
    spans = []
    for e in device:
        kind = classify(e.get("name", ""))
        ms[kind] += e["dur"] / 1e3
        count[kind] += 1
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    edges = spans + [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in steps]
    t0 = min(a for a, _ in edges)
    t1 = max(b for _, b in edges)
    busy = _merge(spans)
    busy_us = sum(b - a for a, b in busy)
    idle, prev = [], t0
    for a, b in busy:
        if a > prev:
            idle.append((a - prev) / 1e3)
        prev = b
    if t1 > prev:
        idle.append((t1 - prev) / 1e3)
    total = sum(ms.values())
    out.update(
        device="measured", device_ms_per_step=total / n_steps,
        window_ms=(t1 - t0) / 1e3, busy_ms=busy_us / 1e3,
        busy_share=busy_us / (t1 - t0) if t1 > t0 else None,
        idle_gaps_ms=sorted(idle, reverse=True)[:gaps],
        kinds={k: {"ms_per_step": ms[k] / n_steps,
                   "share": ms[k] / total if total else 0.0,
                   "launches_per_step": count[k] / n_steps}
               for k in KINDS},
        top=[k for k, _ in ms.most_common(top)])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace", help="trace directory or .json file")
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--gaps", type=int, default=5,
                   help="how many of the longest idle gaps to list")
    p.add_argument("--json", action="store_true",
                   help="print the summary as one JSON line")
    args = p.parse_args(argv)
    try:
        rec = summarize(args.trace, args.top, args.gaps)
    except (OSError, ValueError) as e:
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        return 1
    if args.json:
        print(json.dumps(rec))
        return 0
    print(f"# {rec['trace']}")
    if rec["device"] == "not measured":
        print("device time: not measured (the trace holds no device "
              "events)")
        return 0
    print(f"{rec['steps']} steps, {rec['device_ms_per_step']:.3f} device "
          f"ms/step; busy {rec['busy_ms']:.3f} of a "
          f"{rec['window_ms']:.3f}-ms window ({100 * rec['busy_share']:.1f}"
          "%)")
    print(f"{'ms/step':>10}  {'share':>6}  {'launches/step':>13}  kind")
    for k in rec["top"]:
        row = rec["kinds"][k]
        print(f"{row['ms_per_step']:10.3f}  {100 * row['share']:5.1f}%  "
              f"{row['launches_per_step']:13.1f}  {k}")
    print("longest idle gaps (ms): "
          + ", ".join(f"{g:.3f}" for g in rec["idle_gaps_ms"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
