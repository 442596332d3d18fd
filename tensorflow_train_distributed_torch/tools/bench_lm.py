"""Decoder (Llama-family) training throughput: tokens/s, MFU and peak
memory through the port's ``Trainer`` step, on one card.

    python -m tensorflow_train_distributed_torch.tools.bench_lm \\
        [--preset llama_125m] [--batch-per-chip 8] [--seq 2048] \\
        [--warmup 3] [--iters 10] [--profile-dir DIR] [--device cuda|cpu]

The step is the port's eager ``Trainer.train_step`` under the JAX tool's
recipe: bf16 compute over f32 masters (``mixed_bfloat16``), adamw (1e-4,
b2 0.95, weight decay 0.1), the preset's remat, random weights and
tokens from seed 0.  MFU is ``tools/roofline.py``'s decoder formula,
(6 (N - V d) + 6 L S d) a token over the card's bf16 peak (the JAX tool
counts the embedding in N; PERF.md §2 does not).  ``--profile-dir``
traces two more steps after the timed window (never inside it) through
``runtime/profiling.py``; render the trace with
``tools/profile_summary.py``.

This module is also the home of the helpers the other bench tools share:
the device flags and record fields, the card lock, the memory guard, the
timing loop and the failure record.  The rules they keep:

- ``--device cuda`` (the default) runs on the card under
  ``runtime/chip_lock.py``; with no card it ends with a failure record as
  the last line and a nonzero exit.  There is no CPU fallback.
- ``--device cpu`` runs the same code on the kernels' plain versions.
  Every device metric (rates, step times, MFU, MBU, peak memory) is then
  null: a CPU run measures no device.  ``--platform cpu`` (the JAX
  tools' flag) means ``--device cpu``.
- Every record names the device: ``torch.cuda.get_device_name(0)``, the
  device count and ``nvidia-smi``'s name and power limit.
- Times are the host clock around work that ends in
  ``torch.cuda.synchronize()``, after warm-up steps that are not counted;
  peak memory is ``torch.cuda.max_memory_allocated()`` after
  ``reset_peak_memory_stats()``.
- The last line of standard output is one JSON record.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

NOT_MEASURED = "not measured"
# A record's device metrics on the CPU.
CPU_NOTE = ("not measured: a --device cpu run takes no device metric "
            "(rates, step times, MFU, MBU and peak memory are null)")


class NoCard(RuntimeError):
    """``--device cuda`` on a host where torch sees no CUDA device."""


# -- device flags and record fields ----------------------------------------


def add_device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the card; the default) or cpu (the plain "
                        "kernels; no device metric is measured)")
    p.add_argument("--platform", default="",
                   help="the JAX tools' flag: 'cpu' means --device cpu, "
                        "'gpu' or 'cuda' --device cuda")


def resolve_device(args) -> str:
    platform = getattr(args, "platform", "")
    if not platform:
        return args.device
    if platform == "cpu":
        return "cpu"
    if platform in ("gpu", "cuda"):
        return "cuda"
    raise ValueError(f"--platform {platform!r}: the port runs on 'cuda' or "
                     "'cpu' (no TPU probe or fallback: ROADMAP 'No "
                     "counterpart needed')")


def smi_line() -> str:
    """``nvidia-smi``'s "name, power.limit" of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return NOT_MEASURED
    return out[0] if out else NOT_MEASURED


def require_card(device: str) -> None:
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise NoCard("--device cuda but torch.cuda.is_available() is "
                     "false: no card, and no CPU fallback (a --device cpu "
                     "run measures no device metric)")


def device_fields(device: str) -> dict:
    """The device a record ran on."""
    import torch

    if device == "cpu":
        return {"device": "cpu", "device_kind": "cpu", "device_count": 0,
                "card": None, "note": CPU_NOTE}
    return {"device": "cuda", "device_kind": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(), "card": smi_line()}


def peak_flops(device: str, dtype: str = "bf16"):
    """The card's peak FLOP/s for ``dtype`` (``training/memory.py``); None
    on the CPU or a card the table does not know."""
    from tensorflow_train_distributed_torch.training import memory

    if device == "cpu":
        return None
    import torch

    tflops = memory.peak_tflops(torch.cuda.get_device_name(0), dtype)
    return None if tflops is None else tflops * 1e12


def hbm_bytes_per_sec(device: str):
    from tensorflow_train_distributed_torch.training import memory

    if device == "cpu":
        return None
    import torch

    return memory.hbm_bandwidth_bytes_per_sec(torch.cuda.get_device_name(0))


def card_lock(device: str):
    """The host-wide card lock on the card; nothing on the CPU."""
    from tensorflow_train_distributed_torch.runtime.chip_lock import (
        chip_lock,
    )

    return chip_lock() if device == "cuda" else contextlib.nullcontext()


def sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


# -- the memory guard ---------------------------------------------------------


def card_budget_bytes(device: str):
    """The card's free memory now (``torch.cuda.mem_get_info``); None on
    the CPU, where the guard does not apply."""
    import torch

    if device == "cpu":
        return None
    return torch.cuda.mem_get_info()[0]


def check_hbm_budget(n_params: int, *, budget_bytes, force: bool,
                     device_kind: str = "", extra_bytes: int = 0,
                     task=None, batch: int = 0, seq: int = 0) -> None:
    """Refuse a run whose training step would not fit ``budget_bytes``:
    print a refusal record and exit 2, unless ``force``.  ``budget_bytes``
    None skips the guard.

    With a ``task`` (built on the meta device) the step is
    ``training.memory.plan_train_memory``'s at ``batch`` x ``seq`` (the
    exact state, the activations the model calibrated on the card
    estimates, the optimizer update's temporaries), plus ``extra_bytes``.
    Where the planner does not cover the model (it raises: MoE, no layer
    dims), or without a task, the state alone counts
    (``STATE_BYTES_PER_PARAM`` a parameter, plus ``extra_bytes``): a run
    that passes can still run out of memory, and then ends with a failure
    record.  The record's ``activations`` says which was counted."""
    import numpy as np

    from tensorflow_train_distributed_torch.training import memory

    if budget_bytes is None:
        return
    state = n_params * memory.STATE_BYTES_PER_PARAM
    act, counted = None, "not counted: no model given"
    if task is not None:
        try:
            plan = memory.plan_train_memory(
                task, {"tokens": np.zeros((batch, seq), np.int32)})
        except ValueError as e:
            counted = f"not counted: {e}"
        else:
            state = plan["state_bytes_per_device"]
            act = plan["activation_bytes_per_device"]
            counted = f"counted (the step's peak: {plan['peak_phase']})"
    need = (state if act is None else plan["step_bytes_per_device"]) \
        + extra_bytes
    if need <= budget_bytes or force:
        return
    print(json.dumps({
        "error": "refused: the training step exceeds the card's free "
                 "memory; rerun with --force-hbm to try anyway",
        "estimated_gib": round(need / 2 ** 30, 2),
        "budget_gib": round(budget_bytes / 2 ** 30, 2),
        "state_gib": round(state / 2 ** 30, 2),
        "activation_gib": None if act is None else round(act / 2 ** 30, 2),
        "activations": counted,
        "other_gib": round(extra_bytes / 2 ** 30, 2),
        "device_kind": device_kind}), flush=True)
    raise SystemExit(2)


# -- timing -------------------------------------------------------------------


def timed_steps(step, *, warmup: int, iters: int, device: str,
                profile_dir: str = "", profile_steps: int = 2) -> dict:
    """Run ``step()`` ``warmup`` times, then time ``iters`` calls on the
    host clock up to ``torch.cuda.synchronize()``.  Returns ``step_s``
    and ``peak_bytes`` (None on the CPU, where nothing is timed either:
    ``step_s`` None) and, with ``profile_dir``, the path of a Chrome trace
    of ``profile_steps`` more calls, each under the ``STEP_SPAN``
    annotation that ``tools/profile_summary.py`` counts steps by."""
    import torch

    from tensorflow_train_distributed_torch.runtime import profiling
    from tensorflow_train_distributed_torch.tools.profile_summary import (
        STEP_SPAN,
    )

    for _ in range(max(warmup, 1)):
        step()
    sync(device)
    out = {"step_s": None, "peak_bytes": None, "trace": None}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    sync(device)
    if device == "cuda":
        out["step_s"] = (time.perf_counter() - t0) / iters
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if profile_dir:
        profiling.start_trace(profile_dir)
        try:
            for _ in range(profile_steps):
                with profiling.annotate(STEP_SPAN):
                    step()
            sync(device)
        finally:
            out["trace"] = profiling.stop_trace()
    return out


def rate_fields(timing: dict, per_step: float, flops_per_step, device: str,
                dtype: str = "bf16") -> dict:
    """``value`` (units a second), ``step_time_ms``, ``mfu`` and
    ``peak_mem_gib`` from ``timed_steps``; all None on the CPU."""
    step_s = timing["step_s"]
    if step_s is None:
        return {"value": None, "step_time_ms": None, "mfu": None,
                "peak_mem_gib": None}
    peak = peak_flops(device, dtype)
    mfu = None if peak is None else flops_per_step / step_s / peak
    out = {"value": per_step / step_s, "step_time_ms": step_s * 1e3,
           "mfu": mfu, "peak_mem_gib": timing["peak_bytes"] / 2 ** 30}
    if mfu is not None and mfu > 0.75:
        # No training step sustains 75% of the peak: a timing fault.
        out["implausible"] = True
    return out


# -- the run ------------------------------------------------------------------


class Refused(ValueError):
    """A JAX flag the port does not implement (the record names why)."""


def run_tool(args, metric: str, unit: str, fn, *, headline=None,
             **fields) -> int:
    """``fn(device)`` under the card lock (the record's ``card_lock``:
    "acquired", "inherited" from a parent, or "none" on the CPU); prints
    its record as the last line (then ``headline(record)`` after it,
    where given) and returns 0.  A failure prints a record with ``error``
    and a null ``value`` and returns 1 (2 for a refused flag); the memory
    guard's refusal exits 2 itself."""
    try:
        device = resolve_device(args)
        require_card(device)
        with card_lock(device) as how:
            rec = fn(device)
            rec["card_lock"] = how or "none"
    except Exception as e:  # noqa: BLE001 — the one-record contract
        print(json.dumps({"metric": metric, "value": None, "unit": unit,
                          "device": getattr(args, "device", None),
                          "error": f"{type(e).__name__}: {e}", **fields}),
              flush=True)
        return 2 if isinstance(e, Refused) else 1
    print(json.dumps(rec), flush=True)
    if headline is not None:
        print(json.dumps(headline(rec)), flush=True)
    return 0


def trainer_for(task, tx, device: str, policy: str = "mixed_bfloat16"):
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy,
    )
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    return Trainer(task, tx, policy=Policy.from_name(policy),
                   config=TrainerConfig(seed=0, log_every=1_000_000),
                   device=device)


def lm_batch(vocab: int, batch: int, seq: int) -> dict:
    """Random tokens and targets from seed 0, as the JAX tools draw them."""
    import numpy as np

    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
            "targets": rng.integers(0, vocab, (batch, seq)).astype(np.int32)}


def train_timing(trainer, host_batch: dict, *, device: str, warmup: int,
                 iters: int, profile_dir: str = "") -> tuple:
    """(state, timing) of ``trainer``'s step on ``host_batch``, copied to
    the device once (the step is timed without the host's data)."""
    from tensorflow_train_distributed_torch.data.pipeline import to_device

    state = trainer.create_state()
    batch = to_device(host_batch, device)
    timing = timed_steps(lambda: trainer.train_step(state, batch),
                         warmup=warmup, iters=iters, device=device,
                         profile_dir=profile_dir)
    return state, timing


# -- bench_lm -----------------------------------------------------------------


def bench_lm(preset: str, batch: int, seq: int, warmup: int, iters: int, *,
             device: str = "cuda", remat=None, remat_policy=None,
             force_hbm: bool = False, sliding_window: int = 0,
             fused_qkv: bool = False, profile_dir: str = "") -> dict:
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import llama
    from tensorflow_train_distributed_torch.tools import roofline
    from tensorflow_train_distributed_torch.training import optimizers

    cfg = llama.LLAMA_PRESETS[preset]
    if sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=sliding_window)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    if fused_qkv:
        cfg = dataclasses.replace(cfg, fused_qkv=True)
    if seq > cfg.max_positions:
        raise ValueError(f"--seq {seq} > max_positions {cfg.max_positions}")
    n_params = sum(math.prod(s) for s in convert.expected_shapes(cfg)
                   .values())
    dev = device_fields(device)
    task = llama.CausalLmTask(cfg, device="meta")
    check_hbm_budget(n_params, budget_bytes=card_budget_bytes(device),
                     force=force_hbm, device_kind=dev["device_kind"],
                     task=task, batch=batch, seq=seq)
    trainer = trainer_for(task, optimizers.adamw(1e-4, b1=0.9, b2=0.95,
                                                 weight_decay=0.1), device)
    state, timing = train_timing(trainer, lm_batch(cfg.vocab_size, batch,
                                                   seq),
                                 device=device, warmup=warmup, iters=iters,
                                 profile_dir=profile_dir)
    n_params = state.num_params()
    per_token, formula = roofline.decoder_flops_per_token(n_params, cfg, seq)
    tokens = batch * seq
    rec = {"metric": f"{preset}_train_tokens_per_sec",
           "unit": "tokens/sec", "batch_per_chip": batch, "seq_len": seq,
           "n_chips": 1, "tokens_per_step": tokens, "n_params": n_params,
           "remat": cfg.remat, "remat_policy": cfg.remat_policy,
           "policy": "mixed_bfloat16", "mfu_formula": formula,
           "warmup": warmup, "iters": iters}
    rec.update(rate_fields(timing, tokens, per_token * tokens, device))
    if cfg.sliding_window:
        rec["sliding_window"] = cfg.sliding_window
    if cfg.fused_qkv:
        rec["fused_qkv"] = True
    if timing["trace"]:
        rec["trace"] = timing["trace"]
    rec.update(dev)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="llama_125m")
    p.add_argument("--sliding-window", type=int, default=0,
                   help="override the preset with sliding-window "
                        "attention (K7); 0 = preset default")
    p.add_argument("--batch-per-chip", type=int, default=8)
    p.add_argument("--profile-dir", default="",
                   help="trace 2 more steps after the timed window into "
                        "this directory (tools/profile_summary.py)")
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--iters", type=int, default=10)
    rm = p.add_mutually_exclusive_group()
    rm.add_argument("--remat", dest="remat", action="store_true",
                    default=None, help="force activation remat on")
    rm.add_argument("--no-remat", dest="remat", action="store_false",
                    help="disable remat (faster when memory allows)")
    sc = p.add_mutually_exclusive_group()
    sc.add_argument("--scan-layers", dest="scan_layers",
                    action="store_true", default=None)
    sc.add_argument("--no-scan-layers", dest="scan_layers",
                    action="store_false", default=None,
                    help="refused: the JAX scan-vs-unroll A/B")
    p.add_argument("--fused-qkv", action="store_true",
                   help="one fused q/k/v projection")
    p.add_argument("--remat-policy", default=None,
                   choices=("full", "dots", "no_ffn"))
    p.add_argument("--force-hbm", action="store_true",
                   help="skip the memory guard")
    add_device_args(p)
    args = p.parse_args(argv)

    def run(device):
        if args.scan_layers is not None:
            raise Refused(
                "--scan-layers/--no-scan-layers: no counterpart (eager "
                "PyTorch runs the layers as one loop either way; ROADMAP "
                "'No counterpart needed')")
        return bench_lm(args.preset, args.batch_per_chip, args.seq,
                        args.warmup, args.iters, device=device,
                        remat=args.remat, remat_policy=args.remat_policy,
                        force_hbm=args.force_hbm,
                        sliding_window=args.sliding_window,
                        fused_qkv=args.fused_qkv,
                        profile_dir=args.profile_dir)

    return run_tool(args, f"{args.preset}_train_tokens_per_sec",
                    "tokens/sec", run)


if __name__ == "__main__":
    sys.exit(main())
