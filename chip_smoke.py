#!/usr/bin/env python3
"""On-card smoke test of tensorflow_train_distributed_torch on an H100.

    python3 chip_smoke.py            # one H100

1. Device: prints the card's name and power limit, requires compute
   capability 9.0, builds the CUDA kernels from ``csrc/`` and prints the
   build time.
2. Kernels against their plain PyTorch versions on the card, at the serving
   path's shapes: RMSNorm [8, 4096] and [128, 4096] bf16; paged attention
   over 8 lanes, 32 heads (MHA), head_dim 128, block 16, 64 blocks a lane,
   ragged lengths, q_len 1, bf16 and int8 pools; the paged KV gather of the
   same pool.  Prints each kernel's error against its stated tolerance,
   median time (CUDA events, launches queued back to back behind a device
   sleep so host overhead is not timed), bound, the plain version's time
   and one PyTorch library call's time as a yardstick the port never calls.
3. The serving engine on Llama-2-7B at full width and depth (bf16, random
   weights from a seed): 8 slots, chunk 8, cache_len 1024, block 16; a
   dozen greedy requests of 16-300 prompt tokens, two sharing a 64-token
   prefix, 32 new tokens each.  The kernels' launch counts are zeroed just
   before and read just after; every kernel must have run, and paged
   attention exactly layers x decode steps.  Prints decode ms/step,
   tokens/s and peak memory, and checks the engine against a re-prefill of
   prompt + generated tokens in a fresh cache.
4. The same engine with an int8 KV cache at full width and 4 layers.

Every phase raises on failure; the last line is the JSON device record
only when all passed.  Exits non-zero without CUDA, or when run outside
the repository.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12      # dense tensor-core bf16
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores

SEED = 0
KERNELS = {
    "rms_norm": dict(
        source="tensorflow_train_distributed_torch/csrc/rms_norm.cu",
        replaces="tensorflow_train_distributed_tpu/ops/pallas_kernels.py:396"),
    "paged_attention": dict(
        source="tensorflow_train_distributed_torch/csrc/paged_attention.cu",
        replaces="tensorflow_train_distributed_tpu/ops/pallas_kernels.py:290"),
    "paged_kv_gather": dict(
        source="tensorflow_train_distributed_torch/csrc/paged_kv_gather.cu",
        replaces="tensorflow_train_distributed_tpu/ops/pallas_kernels.py:121"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, *, launches: int = 40, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean device time of ``launches``
    back-to-back calls, timed with CUDA events.  A device sleep queued
    first keeps the stream busy while the host enqueues, so the events
    bracket device work only."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 -------------------------------------------------------------------


def phase_device():
    import torch
    from tensorflow_train_distributed_torch.ops import cuda_build

    log(f"card: {smi_line()}")
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {torch.cuda.get_device_name(0)} capability {cap} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is "
                           f"sm_{cap[0]}{cap[1]}")
    t0 = time.perf_counter()
    cuda_build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({cuda_build.build_info.get('path')})")
    for line in cuda_build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")


# -- phase 2 -------------------------------------------------------------------


def _check(what, got, want, allowed, rule) -> float:
    """Elementwise ``|got - want| <= allowed``; logs and returns the max
    absolute error, raises where any element is outside."""
    diff = (got.float() - want.float()).abs()
    worst = (diff / allowed).max().item()
    err = diff.max().item()
    log(f"  {what}: max_abs_err {err:.3e}; worst |err| / allowed "
        f"{worst:.3f} (allowed: {rule}) {'ok' if worst <= 1 else 'FAIL'}")
    if not worst <= 1:
        raise AssertionError(f"{what}: error {err:.3e} outside {rule}")
    return err


def _report(name, shape, ms, plain_ms, lib_ms, bnd):
    log(f"  {name} {shape}: kernel {ms * 1e3:.1f} us, bound "
        f"{bnd[0] * 1e3:.1f} us ({bnd[1]}), plain {plain_ms * 1e3:.1f} us, "
        f"library {lib_ms * 1e3:.1f} us")


def phase_kernels() -> dict:
    """Kernel vs plain version at the slice's shapes; returns the rows of
    the kernels' JSON line (without launch counts)."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}

    # RMSNorm: [8, 4096] (a decode step) and [128, 4096] (prefill rows).
    d = 4096
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(
        torch.bfloat16)
    for n in (8, 128):
        x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
        y = K.rms_norm(x, scale)
        ref = K.rms_norm_reference(x, scale)
        torch.cuda.synchronize()
        # Both compute in f32 and round once to bf16; f32 results a few
        # ulps apart may round to neighbouring bf16 values, and one bf16
        # step is at most 2^-7 of the value.
        err = _check(f"rms_norm [{n}, {d}] bf16", y, ref,
                     2 ** -7 * ref.float().abs() + 1e-6,
                     "one bf16 step: 2^-7 |ref| + 1e-6")
        ms = device_ms(lambda: K.rms_norm(x, scale))
        plain = device_ms(lambda: K.rms_norm_reference(x, scale))
        lib = device_ms(lambda: F.rms_norm(x, (d,), scale, 1e-5))
        bnd = bound(2 * n * d * 2 + d * 2, 4 * n * d, PEAK_F32_FLOPS)
        _report("rms_norm", f"[{n}, {d}] bf16", ms, plain, lib, bnd)
        if n == 8:      # the decode step's shape goes into the JSON line
            rows["rms_norm"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=lib)

    # Paged pool: 8 lanes x 64 blocks of 16 rows, 32 kv heads x 128.
    lanes, heads, hd, bs, n_blk = 8, 32, 128, 16, 64
    nb = 1 + lanes * n_blk
    c = n_blk * bs
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    table = perm[:lanes * n_blk].view(lanes, n_blk).to(torch.int32)
    lengths = torch.randint(16, c - 1, (lanes,), generator=gen, device=dev,
                            dtype=torch.int32)
    q = torch.randn(lanes, 1, heads, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    visible = (lengths.long() + 1).clamp(max=c).sum().item()
    kpool = torch.randn(nb, bs, heads, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    vpool = torch.randn(nb, bs, heads, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    k8 = torch.randint(-127, 128, (nb, bs, heads, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (nb, bs, heads, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    ks = torch.rand(nb, bs, heads, generator=gen, device=dev) / 127 + 1e-4
    vs = torch.rand(nb, bs, heads, generator=gen, device=dev) / 127 + 1e-4
    pos = torch.arange(c, device=dev)
    mask = (pos[None, :] <= lengths.long()[:, None])[:, None, None, :]
    # The f32 reference is the same math as the kernel's: the query is
    # rescaled so that it applies the bf16-rounded scale the bf16 path
    # applies, and int8 rows come dequantised through bf16 as the kernel
    # and the reference dequantise them.
    s_bf16 = torch.tensor(hd ** -0.5, dtype=torch.bfloat16).item()
    s_f32 = torch.tensor(hd ** -0.5, dtype=torch.float32).item()
    q32 = q.float() * (s_bf16 / s_f32)
    for kind, kp, vp, sc in (("bf16", kpool, vpool, None),
                             ("int8", k8, v8, (ks, vs))):
        kw = {} if sc is None else dict(k_scales=sc[0], v_scales=sc[1])
        out = K.paged_attention(q, kp, vp, table, lengths, **kw)
        ref = K.paged_attention_reference(q, kp, vp, table, lengths, **kw)
        if sc is None:
            k32, v32 = kp.float(), vp.float()
        else:
            k32 = (kp.to(q.dtype) * sc[0][..., None].to(q.dtype)).float()
            v32 = (vp.to(q.dtype) * sc[1][..., None].to(q.dtype)).float()
        ref32 = K.paged_attention_reference(q32, k32, v32, table, lengths)
        del k32, v32
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        log(f"  paged_attention {kind}: outputs up to "
            f"{ref32.abs().max().item():.3f}, median magnitude "
            f"{ref32.abs().median().item():.3f}")
        # The kernel keeps f32 to the end and rounds its output once to
        # bf16 (at most 2^-8 of the value), plus the f32 tests' 2e-5 for
        # another summation order.
        _check(f"paged_attention {kind} vs f32 reference", out, ref32,
               2 ** -8 * ref32.abs() + 2e-5, "2^-8 |ref32| + 2e-5")
        # The plain version on the same inputs also rounds logits and
        # softmax weights to bf16: its own distance from the f32 math,
        # measured here, is allowed on top.
        err = _check(f"paged_attention {kind} vs its plain version", out,
                     ref, (ref.float() - ref32).abs()
                     + 2 ** -8 * ref32.abs() + 2e-5,
                     "|ref - ref32| + 2^-8 |ref32| + 2e-5")
        ms = device_ms(lambda: K.paged_attention(q, kp, vp, table, lengths,
                                                 **kw))
        plain = device_ms(lambda: K.paged_attention_reference(
            q, kp, vp, table, lengths, **kw), launches=10)
        kc = K.paged_kv_gather_reference(kp, table, c)
        vc = K.paged_kv_gather_reference(vp, table, c)
        if sc is not None:
            kc = kc.to(q.dtype) * K.paged_kv_gather_reference(
                sc[0][..., None], table, c).to(q.dtype)
            vc = vc.to(q.dtype) * K.paged_kv_gather_reference(
                sc[1][..., None], table, c).to(q.dtype)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, kc, vc))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask))
        elem = kp.element_size()
        nbytes = (visible * heads * hd * elem * 2 + q.numel() * 2 * 2
                  + table.numel() * 4 + lanes * 4
                  + (visible * heads * 4 * 2 if sc else 0))
        bnd = bound(nbytes, 4 * visible * heads * hd, PEAK_BF16_FLOPS)
        shape = (f"{lanes} lanes x {heads} heads x hd {hd}, bs {bs}, "
                 f"{n_blk} blocks, {visible} visible rows, {kind}")
        _report("paged_attention", shape, ms, plain, lib, bnd)
        if kind == "bf16":      # the main path's pool type
            rows["paged_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=lib)

    # Gather: the bf16 pool (bitwise) and the f32 scale pool [nb, bs, 32, 1].
    for kind, pool in (("bf16", kpool), ("f32 scales", ks[..., None])):
        out = K.paged_kv_gather(pool, table, c)
        ref = K.paged_kv_gather_reference(pool, table, c)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"paged_kv_gather {kind}: not bitwise")
        log(f"  paged_kv_gather {kind}: bitwise equal ok")
        if kind != "bf16":
            continue
        ms = device_ms(lambda: K.paged_kv_gather(pool, table, c))
        plain = device_ms(lambda: K.paged_kv_gather_reference(pool, table,
                                                              c))
        flat = table.reshape(-1)
        lib = device_ms(lambda: pool.index_select(0, flat))
        bnd = bound(2 * out.numel() * out.element_size() + table.numel() * 4,
                    0, PEAK_BF16_FLOPS)
        shape = f"pool [{nb}, {bs}, {heads}, {hd}] bf16 -> [{lanes}, {c}]"
        _report("paged_kv_gather", shape, ms, plain, lib, bnd)
        rows["paged_kv_gather"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd[0],
            bound_by=bnd[1], library_ms=lib)
    return rows


# -- phases 3 and 4 -------------------------------------------------------------


def _requests(rng, n, lo, hi, vocab, prefix_len):
    """``n`` prompts of lo..hi tokens; #0 and #1 share a ``prefix_len``
    prefix (adjacent, so #1's admission finds #0's blocks)."""
    prefix = rng.integers(1, vocab, prefix_len).tolist()
    prompts = []
    for i in range(n):
        length = int(rng.integers(lo, hi + 1))
        body = rng.integers(1, vocab, length).tolist()
        prompts.append(prefix + body[:max(1, length - prefix_len)]
                       if i < 2 else body)
    return prompts


def _consistency(eng, out, checks, max_new, tol):
    """Re-prefill prompt + generated tokens (all but the last) in a fresh
    batch-1 cache; compare its last-position logits with the decode step
    that produced the last token, and count the generated tokens the
    teacher-forced argmax agrees with."""
    import torch

    model = eng._model
    agree = total = 0
    worst = 0.0
    for rid, prompt in checks:
        toks = out[rid]
        n_prompt = len(prompt)
        cache = model.init_cache(1, eng.cache_len)
        with torch.no_grad():
            logits = model(torch.tensor([toks[:-1]], device="cuda"),
                           cache)[0].float()
        assert torch.isfinite(logits).all()
        dec = eng.decode_logits[rid]
        if len(dec) != max_new - 1:
            raise AssertionError(f"request {rid}: {len(dec)} decode logits "
                                 f"recorded, expected {max_new - 1}")
        diff = (logits[-1] - dec[-1]).abs().max().item()
        scale = logits[-1].std().item()
        worst = max(worst, diff / max(scale, 1.0))
        pred = logits[n_prompt - 1:].argmax(-1).tolist()
        gen = toks[n_prompt:]
        agree += sum(int(a == b) for a, b in zip(pred, gen))
        total += len(gen)
        log(f"  request {rid}: last-step logits max |diff| {diff:.4f} "
            f"(logit std {scale:.3f}); teacher-forced argmax agrees on "
            f"{sum(int(a == b) for a, b in zip(pred, gen))}/{len(gen)}")
    if worst > tol:
        raise AssertionError(f"decode vs re-prefill logits differ by "
                             f"{worst:.4f} x max(std, 1) > {tol}")
    log(f"  consistency: worst |diff| / max(std, 1) = {worst:.4f} "
        f"(tolerance {tol}); tokens agree {agree}/{total}")
    if agree < 0.5 * total:
        raise AssertionError(f"only {agree}/{total} tokens agree")
    return agree, total


def _profile_chunk(eng, vocab):
    """One decode chunk of ``eng.slots`` full lanes under torch.profiler
    (CUPTI): the device's busy share of the chunk's wall time and the
    kernel time by kind.  Profiling adds host time, so the share read
    here is a lower bound of the unprofiled one."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 1)
    for _ in range(eng.slots):
        eng.submit(rng.integers(1, vocab, 100).tolist(), 2 * eng.chunk + 1)
    eng.serve_step()                   # admissions and the first chunk
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve_step()               # one decode chunk, no admissions
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
    kinds = {"matmul": 0.0, "paged_attention": 0.0, "rms_norm": 0.0,
             "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if us <= 0:
            continue
        name = e.key
        low = name.lower()
        kind = ("paged_attention" if "paged_attention" in low
                else "rms_norm" if "rms_norm" in low
                else "matmul" if any(k in low for k in (
                    "gemm", "gemv", "cutlass", "xmma", "nvjet", "matmul"))
                else "other")
        kinds[kind] += us
        top.append((us, e.count, name[:60]))
    busy = sum(kinds.values())
    if busy == 0:
        log("  profile: the profiler recorded no device time (not measured)")
        return None
    top.sort(reverse=True)
    out = dict(chunk_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               busy_share_profiled=busy / wall_us,
               kernel_ms_by_kind={k: v / 1e3 for k, v in kinds.items()})
    log(f"  profile (one chunk of {eng.chunk} steps, {eng.slots} lanes): "
        f"{json.dumps(out)}")
    for us, count, name in top[:8]:
        log(f"    {us / 1e3:8.3f} ms  x{count:<5d} {name}")
    return out


def phase_engine(config, *, label, n_requests, max_new, lo, hi,
                 check_requests, tol, profile_chunk=False):
    import numpy as np
    import torch
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.serving import ServingEngine

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = convert.init_params(config, gen, device="cuda")
    eng = ServingEngine(config, params, slots=8, chunk=8, cache_len=1024,
                        kv_block_size=16, record_logits=True, device="cuda")
    del params
    torch.cuda.synchronize()
    log(f"{label}: {config.num_layers} layers, d_model {config.d_model}, "
        f"weights + pool ready in {time.perf_counter() - t0:.1f} s")
    # Warm-up request (cuBLAS handles, allocator), before the counts reset.
    eng.submit([1] * 16, 2)
    eng.run()
    eng.stats.update(decode_steps=0, decode_s=0.0, prefill_s=0.0,
                     prefill_tokens=0)
    eng.decode_logits.clear()
    prompts_rng = np.random.default_rng(SEED)
    prompts = _requests(prompts_rng, n_requests, lo, hi, config.vocab_size,
                        64)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for rid, p in zip(rids, prompts):
        toks = out[rid]
        if (len(toks) != len(p) + max_new or toks[:len(p)] != p
                or not all(0 <= t < config.vocab_size for t in toks)):
            raise AssertionError(f"request {rid}: malformed output")
    steps = eng.stats["decode_steps"]
    generated = len(rids) * max_new
    log(f"  launches {counts}; decode steps {steps}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never ran: {counts}")
    if counts["paged_attention"] != config.num_layers * steps:
        raise AssertionError(
            f"paged_attention launches {counts['paged_attention']} != "
            f"layers x decode steps {config.num_layers * steps}")
    if eng.kv_stats["prefix_hits"] < 1:
        raise AssertionError(f"no radix prefix hit: {eng.kv_stats}")
    stats = dict(
        requests=len(rids), generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall,
        decode_ms_per_step=eng.stats["decode_s"] / steps * 1e3,
        decode_steps=steps, prefill_tokens=eng.stats["prefill_tokens"],
        prefill_s=eng.stats["prefill_s"], peak_mem_gib=peak / 2 ** 30,
        kv_stats=dict(eng.kv_stats))
    log(f"  {label}: {json.dumps(stats)}")
    agree, total = _consistency(
        eng, out, [(rids[i], prompts[i]) for i in check_requests], max_new,
        tol)
    stats.update(tokens_agree=agree, tokens_checked=total)
    if profile_chunk:
        stats["profile"] = _profile_chunk(eng, config.vocab_size)
    return counts, stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an H100",
              file=sys.stderr)
        return 2
    try:
        from tensorflow_train_distributed_torch.models.llama import (
            LLAMA_PRESETS,
        )
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    engines = {}
    log("== phase 1: device and build")
    phase_device()
    log("== phase 2: kernels against their plain versions")
    rows = phase_kernels()
    log("== phase 3: serving engine, llama2_7b full width and depth")
    counts, stats = phase_engine(
        LLAMA_PRESETS["llama2_7b"], label="llama2_7b bf16",
        n_requests=12, max_new=32, lo=16, hi=300, check_requests=[1, 5],
        tol=0.25, profile_chunk=True)
    engines["llama2_7b_bf16"] = stats
    torch.cuda.empty_cache()
    log("== phase 4: int8 KV cache, full width, 4 layers")
    cfg = dataclasses.replace(LLAMA_PRESETS["llama2_7b"], num_layers=4,
                              kv_cache_int8=True)
    _, stats = phase_engine(cfg, label="llama2_7b[4 layers] kv int8",
                            n_requests=6, max_new=16, lo=16, hi=200,
                            check_requests=[1], tol=0.25)
    engines["llama2_7b_4layers_kv_int8"] = stats

    kernels = [dict(name=name, route="cuda", source=meta["source"],
                    replaces=meta["replaces"], launches=counts[name],
                    **rows[name])
               for name, meta in KERNELS.items()]
    print(json.dumps({"engines": engines}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
