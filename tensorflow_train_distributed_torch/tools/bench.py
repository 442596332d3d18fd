"""The bench families on one card: ResNet-50 training images/s in process,
and the other families' tools as subprocesses, in one record.

    python -m tensorflow_train_distributed_torch.tools.bench \\
        [--families resnet,lm,bert,vit,input] [--configs resnet50,...] \\
        [--device cuda|cpu]

Emit contract, on success and on failure: the last line of standard
output is a compact headline JSON (``metric``, ``value``, ``unit``,
``vs_baseline``, the device, the best config and its MFU; under 500
bytes).  The full record (every config and family) is written to
``FULL_EMIT_PATH`` (``bench_out/``, which git ignores) and printed on the
line before when it fits ``_MAX_FULL_LINE``.

- ``resnet``: each of ``--configs`` (resnet50 and its space-to-depth stem
  by default) in this process: the port's ``Trainer`` step with SGD
  momentum 0.9 (Nesterov, 0.1), label smoothing, weight decay, the
  ``mixed_bfloat16`` policy, on one batch of N(0, 1) images already on
  the card (the input pipeline is ``input``'s); MFU 3 x 8.18 GFLOP an
  image (``tools/roofline.py``; the JAX tool counts 12.3).  Each config
  is traced for 3 steps after its timed window into ``--profile-dir``.
- ``lm``, ``bert``, ``vit``, ``gen`` (opt-in), ``input``: the
  ``tools/bench_{lm,bert,vit,generate,input}.py`` runs of
  ``FAMILY_ARGS``, each a subprocess (a fresh allocator a family) that
  inherits the card lock: ``TTD_CHIP_LOCK_HELD`` in its environment and
  the lock's descriptor in ``pass_fds``, so the lock stays held if this
  process dies first.

The card lock is held for the whole run.  ``vs_baseline`` is null: the
reference publishes no number (BASELINE.json).  There is no CPU
fallback: ``--device cuda`` with no card ends with a failure headline and
a nonzero exit, and ``--device cpu`` runs every family on the CPU with
every device metric null.  The JAX tool's TPU probe and acquire loop,
its last-known-TPU record and its CPU fallback have no counterpart
(ROADMAP "No counterpart needed"); their flags are refused.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

from tensorflow_train_distributed_torch.tools import bench_lm as B

HEADLINE_METRIC = "resnet50_train_images_per_sec"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(_ROOT, "bench_out")
FULL_EMIT_PATH = os.path.join(OUT_DIR, "last_emit.json")
_MAX_FULL_LINE = 4096
_HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "device",
                  "device_kind", "card", "config", "mfu", "measured_at")
_TOOLS = "tensorflow_train_distributed_torch.tools."

# family -> (tool module, its arguments, the record's key).
FAMILY_ARGS = {
    "lm": ("bench_lm", ["--preset", "llama_125m", "--batch-per-chip", "8",
                        "--seq", "2048", "--no-remat", "--warmup", "3",
                        "--iters", "10"], "llama_125m"),
    "bert": ("bench_bert", ["--preset", "bert_base", "--batch-per-chip",
                            "32", "--seq", "128", "--warmup", "3",
                            "--iters", "20"], "bert_base"),
    "gen": ("bench_generate", ["--preset", "llama_125m", "--batch", "8",
                               "--prompt-len", "128", "--max-new", "256"],
            "llama_125m_decode"),
    "vit": ("bench_vit", ["--preset", "vit_b16", "--batch-per-chip", "64",
                          "--warmup", "3", "--iters", "10"], "vit_b16"),
    "input": ("bench_input", ["--records", "128", "--image-hw", "192",
                              "--size", "160", "--batch", "32",
                              "--workers", "2"], "host_input"),
}

# JAX flags without a counterpart: dest -> why.
_REFUSED = {
    "acquire_timeout": "the TPU probe and acquire loop",
    "probe_timeout": "the TPU probe and acquire loop",
    "init_timeout": "the TPU backend-init watchdog",
    "allow_cpu_fallback": "the CPU fallback (no number is taken on the "
                          "CPU in place of the card's)",
    "no_persist": "the last-known-TPU record",
}


def _headline(record: dict) -> dict:
    h = {k: record[k] for k in _HEADLINE_KEYS if k in record}
    err = record.get("error")
    if err is not None:
        err = str(err)
        h["error"] = err if len(err) <= 160 else err[:157] + "..."
    return h


def _emit(record: dict) -> None:
    """Persist the full record and print it when it fits a line; the last
    line is always the compact headline."""
    try:
        os.makedirs(os.path.dirname(FULL_EMIT_PATH), exist_ok=True)
        with open(FULL_EMIT_PATH, "w") as f:
            json.dump(record, f)
    except OSError:
        pass
    full = json.dumps(record)
    if len(full) <= _MAX_FULL_LINE:
        print(full, flush=True)
    else:
        print(f"# full record ({len(full)} bytes) -> {FULL_EMIT_PATH}",
              flush=True)
    print(json.dumps(_headline(record)), flush=True)


def _watchdog(seconds: float, record: dict, what: str):
    """Emit the failure record and exit if not cancelled in time (a
    compile or first step that wedges); ``record`` is read when it fires,
    so the configs measured before the hang land in it."""
    def _fire():
        out = dict(record, error=f"in-process {what} exceeded "
                                 f"{seconds:.0f}s")
        _emit(out)
        os._exit(1)

    t = threading.Timer(seconds, _fire)
    t.daemon = True
    t.start()
    return t


def bench_config(preset_name: str, batch: int, warmup: int, iters: int,
                 device: str, profile_dir: str = "") -> dict:
    """Training images/s of one ResNet preset on a batch already on the
    device."""
    import numpy as np

    from tensorflow_train_distributed_torch.models import resnet
    from tensorflow_train_distributed_torch.tools import roofline
    from tensorflow_train_distributed_torch.training import optimizers

    cfg = resnet.RESNET_PRESETS[preset_name]
    trainer = B.trainer_for(resnet.make_task(cfg, device="meta"),
                            optimizers.sgd(0.1, momentum=0.9, nesterov=True),
                            device)
    rng = np.random.default_rng(0)
    shape = (batch, 112, 112, 12) if cfg.space_to_depth else (batch, 224,
                                                              224, 3)
    data = {"image": rng.standard_normal(shape, dtype=np.float32),
            "label": rng.integers(0, cfg.num_classes, batch).astype(
                np.int32)}
    _, timing = B.train_timing(
        trainer, data, device=device, warmup=warmup, iters=iters,
        profile_dir=os.path.join(profile_dir, preset_name)
        if profile_dir else "")
    flops = (3 * roofline.RESNET50_FWD_FLOPS * batch
             if preset_name.startswith("resnet50") else None)
    rates = B.rate_fields(timing, batch, flops or 0.0, device)
    out = {"images_per_sec": rates["value"],
           "step_time_ms": rates["step_time_ms"],
           "peak_mem_gib": rates["peak_mem_gib"], "batch_per_chip": batch,
           "mfu": rates["mfu"] if flops else None,
           "mfu_formula": roofline.FORMULAS["resnet50"] if flops else None}
    if rates.get("implausible"):
        out["implausible"] = True
    if timing["trace"]:
        out["trace"] = timing["trace"]
    return out


def _run_family(module: str, args: list, timeout_s: float):
    """(record | None, error | None) of a family's subprocess, which
    inherits the card lock."""
    from tensorflow_train_distributed_torch.runtime import chip_lock

    fd = chip_lock.held_fd()
    kw = {"pass_fds": (fd,)} if fd is not None else {}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    try:
        out = subprocess.run([sys.executable, "-m", _TOOLS + module, *args],
                             capture_output=True, text=True,
                             timeout=timeout_s, env=env, **kw)
    except subprocess.TimeoutExpired:
        return None, f"family bench timed out after {timeout_s:.0f}s"
    lines = [ln for ln in out.stdout.strip().splitlines()
             if ln.startswith("{")]
    if not lines:
        tail = (out.stderr or out.stdout).strip().splitlines()
        return None, ("family bench printed no JSON: "
                      + (tail[-1][-200:] if tail else f"rc={out.returncode}"))
    try:
        rec = json.loads(lines[-1])
    except ValueError:
        return None, f"unparseable family JSON: {lines[-1][:200]!r}"
    if out.returncode != 0 or rec.get("error"):
        return None, rec.get("error", f"rc={out.returncode}")
    return rec, None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--configs", default="resnet50,resnet50_s2d",
                   help="comma-separated RESNET_PRESETS names")
    p.add_argument("--families", default="resnet,lm,bert,vit,input",
                   help="resnet (in process) and the subprocess families "
                        "lm, bert, vit, input; gen (decode) is opt-in")
    p.add_argument("--batch-per-chip", type=int, default=256)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--lock-timeout", type=float, default=900.0,
                   help="seconds to wait for the card lock")
    p.add_argument("--bench-timeout", type=float, default=1200.0,
                   help="watchdog on the in-process ResNet phase")
    p.add_argument("--family-timeout", type=float, default=900.0,
                   help="timeout of each family subprocess")
    p.add_argument("--profile-dir", default=os.path.join(OUT_DIR,
                                                         "profiles"),
                   help="trace directory of the ResNet configs ('' off; "
                        "off by default on the CPU)")
    p.add_argument("--no-cpu-fallback", action="store_true",
                   help="the port's only behaviour (kept for the JAX "
                        "tool's command lines)")
    for dest in _REFUSED:
        flag = "--" + dest.replace("_", "-")
        if dest in ("allow_cpu_fallback", "no_persist"):
            p.add_argument(flag, action="store_true", help="refused")
        else:
            p.add_argument(flag, type=float, default=None, help="refused")
    B.add_device_args(p)
    args = p.parse_args(argv)
    record = {"metric": HEADLINE_METRIC, "value": None,
              "unit": "images/sec", "vs_baseline": None}
    for dest, what in _REFUSED.items():
        if getattr(args, dest) not in (None, False):
            _emit(dict(record, error="--" + dest.replace("_", "-")
                       + f": not ported: {what} has no counterpart (ROADMAP "
                         "'No counterpart needed')"))
            return 2
    try:
        return _run(args, record)
    except Exception as e:  # noqa: BLE001 — the one-headline contract
        _emit(dict(record, error=f"{type(e).__name__}: {e}"))
        return 1


def _run(args, record: dict) -> int:
    from tensorflow_train_distributed_torch.runtime.chip_lock import (
        chip_lock,
    )

    device = B.resolve_device(args)
    record["device"] = device
    configs = [c for c in args.configs.split(",") if c]
    families = [f for f in args.families.split(",") if f]
    unknown = [f for f in families if f != "resnet" and f not in FAMILY_ARGS]
    if unknown:
        raise ValueError(f"unknown families {unknown}; known: resnet, "
                         f"{', '.join(FAMILY_ARGS)}")
    lock = (chip_lock(timeout=args.lock_timeout, on_wait=lambda pid, w: print(
        "# waiting for the card lock"
        + (f" (held by pid {pid})" if pid else "") + f", {w:.0f}s",
        file=sys.stderr)) if device == "cuda" else B.card_lock(device))
    results, failures, family_results = {}, {}, {}
    with lock as how:
        record["card_lock"] = how or "none"
        if "resnet" in families:
            B.require_card(device)
            record.update(B.device_fields(device))
            profile_dir = args.profile_dir if device == "cuda" else ""
            wd = _watchdog(args.bench_timeout,
                           dict(record, configs=results,
                                failed_configs=failures), "measure")
            try:
                for name in configs:
                    try:
                        results[name] = bench_config(
                            name, args.batch_per_chip, args.warmup,
                            args.iters, device, profile_dir)
                    except Exception as e:  # noqa: BLE001 — recorded
                        failures[name] = f"{type(e).__name__}: {e}"
            finally:
                wd.cancel()
        for fam in families:
            if fam == "resnet":
                continue
            module, fargs, key = FAMILY_ARGS[fam]
            rec, err = _run_family(module, fargs + ["--device", device],
                                   args.family_timeout)
            if err:
                failures[fam] = err
            else:
                family_results[key] = rec
    record["measured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())
    if failures:
        record["failed_configs"] = failures
    if not results and not family_results:
        _emit(dict(record, error=f"all configs failed: {failures}"))
        return 1
    record["configs"] = {**results, **family_results}
    plausible = {n: r for n, r in results.items()
                 if not r.get("implausible") and r["images_per_sec"]}
    if plausible:
        best = max(plausible, key=lambda n: plausible[n]["images_per_sec"])
        record.update(value=plausible[best]["images_per_sec"], config=best,
                      mfu=plausible[best]["mfu"])
    elif results:
        record["config"] = next(iter(results))
    else:
        # A families-only run: the first family carries the headline.
        first = next(iter(family_results.values()))
        record.update(metric=first.get("metric"), value=first.get("value"),
                      unit=first.get("unit"), mfu=first.get("mfu"))
        for k in ("device_kind", "card"):
            if k in first:
                record[k] = first[k]
    _emit(record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
