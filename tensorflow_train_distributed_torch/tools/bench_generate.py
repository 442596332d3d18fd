"""Decode throughput through ``models/generate.py``: generated tokens/s,
ms a decode step, prefill seconds and MBU, on one card.

    python -m tensorflow_train_distributed_torch.tools.bench_generate \\
        [--preset llama_125m] [--batch 8] [--prompt-len 128] \\
        [--max-new 128] [--kv-cache int8] [--quant int8] \\
        [--sliding-window W] [--device cuda|cpu]

``generate()`` prefills the prompt in one call, then decodes one token a
call; weights are random from seed 0 (``convert.init_params``), prompts
from numpy's seed 0.  Two timed variants separate prefill from the
decode loop: ``max_new`` tokens and one token (prefill and the first
pick), so a decode step is (full - one) / (max_new - 1); ``--max-new``
below 2 is refused.  MBU is ``tools/roofline.py``'s
``decode_bytes_per_step`` (every weight but the embedding, the experts
the step runs, the KV rows of the mean context a lane: the prompt plus
half the new tokens, or the window) over the card's HBM rate.  MoE
presets decode through the same ``generate()``; the KV and window flags
apply to llama-family presets only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

from tensorflow_train_distributed_torch.tools import bench_lm as B


def mean_context(prompt_len: int, max_new: int, window=None) -> float:
    """KV rows a decode call reads, averaged over the ``max_new - 1``
    single-token calls (the t-th sees prompt + t rows, a ring of
    ``window`` at most)."""
    rows = [prompt_len + t for t in range(1, max_new)]
    if window:
        rows = [min(r, window) for r in rows]
    return sum(rows) / len(rows)


def bench_generate(preset: str, batch: int, prompt_len: int, max_new: int,
                   warmup: int, iters: int, *, device: str = "cuda",
                   temperature: float = 0.0, force_hbm: bool = False,
                   sliding_window: int = 0, quant: str = "",
                   kv_cache_int8: bool = False) -> dict:
    import numpy as np
    import torch

    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import generate, llama, moe
    from tensorflow_train_distributed_torch.models.quant import (
        quantize_params,
        quantized_bytes,
    )
    from tensorflow_train_distributed_torch.tools import roofline

    if max_new < 2:
        raise ValueError(f"max_new must be >= 2, got {max_new}")
    if preset in llama.LLAMA_PRESETS:
        cfg = llama.LLAMA_PRESETS[preset]
    elif preset in moe.MOE_PRESETS:
        cfg = moe.MOE_PRESETS[preset]
        if kv_cache_int8 or sliding_window:
            raise ValueError("--kv-cache/--sliding-window apply to "
                             "llama-family presets only")
    else:
        raise ValueError(f"unknown preset {preset!r}: not in LLAMA_PRESETS "
                         "or MOE_PRESETS")
    if kv_cache_int8:
        cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    if sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=sliding_window)
    if prompt_len + max_new > cfg.max_positions:
        raise ValueError(f"prompt+new = {prompt_len + max_new} > "
                         f"max_positions {cfg.max_positions}")
    if quant not in ("", "int8"):
        raise ValueError(f"--quant supports 'int8', got {quant!r}")
    dev = B.device_fields(device)
    n_params = sum(math.prod(s) for s in
                   convert.expected_shapes(cfg).values())
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    rows = prompt_len + max_new
    if cfg.sliding_window:
        rows = min(rows, cfg.sliding_window)
    kv_row = (cfg.attn_head_dim + 4 if cfg.kv_cache_int8
              else cfg.attn_head_dim * itemsize)
    cache_bytes = 2 * cfg.num_layers * batch * rows * cfg.kv_heads * kv_row
    budget = B.card_budget_bytes(device)
    need = n_params * itemsize + cache_bytes
    if budget is not None and need > budget and not force_hbm:
        print(json.dumps({
            "error": "refused: the decode working set exceeds the card's "
                     "free memory; rerun with --force-hbm to try anyway",
            "estimated_gib": round(need / 2 ** 30, 2),
            "budget_gib": round(budget / 2 ** 30, 2),
            "device_kind": dev["device_kind"]}), flush=True)
        raise SystemExit(2)
    gen = torch.Generator(device=device).manual_seed(0)
    params = convert.init_params(cfg, gen, device=device)
    scales = None
    if quant:
        params, scales = quantize_params(params)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                          (batch, prompt_len)),
                             device=device)

    def run(n):
        return generate.generate(cfg, params, prompt, n,
                                 temperature=temperature,
                                 seed=1 if temperature > 0 else None,
                                 quant_scales=scales, device=device)

    def timed(n):
        for _ in range(max(warmup, 1)):
            run(n)
        B.sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            run(n)
        B.sync(device)
        return (time.perf_counter() - t0) / iters

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dt_full, dt_one = timed(max_new), timed(1)
    context = mean_context(prompt_len, max_new, cfg.sliding_window)
    byte_bound = roofline.decode_bytes_per_step(cfg, params, scales, batch,
                                                context)
    rec = {"metric": f"{preset}_decode_tokens_per_sec",
           "unit": "tokens/sec", "batch": batch, "prompt_len": prompt_len,
           "max_new_tokens": max_new, "n_params": n_params,
           "weight_bytes": quantized_bytes(params)
           + (quantized_bytes(scales) if scales else 0),
           "decode_bytes_per_step": byte_bound["bytes"],
           "mean_context": context,
           "mbu_formula": roofline.FORMULAS["decode_mbu"],
           "warmup": warmup, "iters": iters}
    if device == "cuda":
        step_s = max(dt_full - dt_one, 1e-9) / (max_new - 1)
        bw = B.hbm_bytes_per_sec(device)
        rec.update(
            value=batch / step_s, ms_per_token_step=step_s * 1e3,
            time_per_call_ms=dt_full * 1e3, prefill_ms=dt_one * 1e3,
            call_tokens_per_sec=batch * max_new / dt_full,
            mbu=None if bw is None else byte_bound["bytes"] / step_s / bw,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    else:
        rec.update(value=None, ms_per_token_step=None, time_per_call_ms=None,
                   prefill_ms=None, call_tokens_per_sec=None, mbu=None,
                   peak_mem_gib=None)
    if cfg.sliding_window:
        rec["sliding_window"] = cfg.sliding_window
        rec["kv_cache_rows"] = rows
    if quant:
        rec["quant"] = quant
    if cfg.kv_cache_int8:
        rec["kv_cache"] = "int8"
    rec.update(dev)
    return rec


def _at_least_two(s: str) -> int:
    v = int(s)
    if v < 2:
        raise argparse.ArgumentTypeError(
            f"--max-new must be >= 2 (a decode step is timed against a "
            f"max_new=1 prefill call), got {v}")
    return v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="llama_125m")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--max-new", type=_at_least_two, default=128)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--force-hbm", action="store_true",
                   help="skip the memory guard")
    p.add_argument("--sliding-window", type=int, default=0,
                   help="decode over a rolling ring of this many rows "
                        "(K7 prefill); 0 = preset default")
    p.add_argument("--kv-cache", default="", choices=["", "int8"],
                   help="'int8': the int8 KV cache (an f32 scale a row "
                        "and kv head)")
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="'int8': weight-only int8 (models.quant)")
    B.add_device_args(p)
    args = p.parse_args(argv)
    return B.run_tool(
        args, f"{args.preset}_decode_tokens_per_sec", "tokens/sec",
        lambda device: bench_generate(
            args.preset, args.batch, args.prompt_len, args.max_new,
            args.warmup, args.iters, device=device,
            temperature=args.temperature, force_hbm=args.force_hbm,
            sliding_window=args.sliding_window, quant=args.quant,
            kv_cache_int8=args.kv_cache == "int8"))


if __name__ == "__main__":
    sys.exit(main())
