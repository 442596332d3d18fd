#!/usr/bin/env python3
"""On-card smoke test of tensorflow_train_distributed_torch on an H100.

    python3 chip_smoke.py            # one H100

1. Device: prints the card's name and power limit, requires compute
   capability 9.0, builds the CUDA kernels from ``csrc/`` and prints the
   build time.
2. Kernels against their plain PyTorch versions on the card, at the serving
   path's shapes: RMSNorm [8, 4096] and [128, 4096] bf16; paged attention
   over 8 lanes, 32 heads (MHA), head_dim 128, block 16, 64 blocks a lane,
   ragged lengths up to 1,024 rows, q_len 1, bf16 and int8 pools, and the
   engine's short lanes (90-130 rows, bf16); the paged KV gather of the
   same pool at all 8 lanes and at the engine's radix hit (one lane's 64
   blocks), and of the int8 engine's f32 scale pool, bitwise with every
   body.  Prints each kernel's error against its stated tolerance,
   median time (CUDA events, launches queued back to back behind a device
   sleep so host overhead is not timed), bound, the plain version's time
   and one PyTorch library call's time as a yardstick the port never calls.
   RMSNorm, paged attention and the gather name the body that served
   them (K1f: warp or block; K4: ring or staged; K5: bulk or block) and
   time the other body on the same inputs.
3. The serving engine on Llama-2-7B at full width and depth (bf16, random
   weights from a seed): 8 slots, chunk 8, cache_len 1024, block 16; a
   dozen greedy requests of 16-300 prompt tokens, two sharing a 64-token
   prefix, 32 new tokens each.  The kernels' launch counts are zeroed just
   before and read just after; every kernel must have run, and paged
   attention exactly layers x decode steps.  Prints decode ms/step,
   tokens/s and peak memory, and checks the engine against a re-prefill of
   prompt + generated tokens in a fresh cache.
4. The same engine with an int8 KV cache at full width and 4 layers.
5. The training kernels against their plain versions at the training
   path's shapes: RMSNorm forward (writing r; its body named and the
   block body timed beside it) and backward (dx and dscale; the block
   body's backward with the einsum column sum, dx alone and
   ``F.rms_norm``'s two-gradient backward timed beside it) at [16384,
   768] bf16 and at mistral_7b_lm's rows [65536, 4096] (phase 10's path);
   cross-entropy
   forward and backward [16384, 32000] f32; flash attention forward and
   backward at llama_125m's B 8, H 12, S 2048, D 64, at Llama-2-7B's
   head (B 1, H 32, S 2048, D 128) and GQA 4:1 over packed rows, causal
   bf16.  Each is held elementwise against an f32 computation of the
   same function and against the plain version, and timed beside its
   bound, the plain version and one library call; flash attention's
   lines name the body that served it and its TFLOP/s.
6. The trainer on llama_125m_lm at full width and depth, built as the
   CLI builds it (b 8 x s 2048, bf16 compute, adamw + clip + warmup
   cosine, 20 steps from seed 0).  Counts are zeroed just before the run
   and read just after; each training kernel must have run exactly
   20 x its launches a step under full remat.  The loss must stay finite
   and fall.  Prints step ms, tokens/s, peak memory, the losses, an MFU
   (its formula beside it) and a profiled step's device time by kind.
6b. (a) One step's gradients of llama_125m cut to 2 layers, kernels
   against the plain versions on the card, at f32 and bf16; (b) five f32
   steps of a small decoder with 64-wide heads on the card against the
   same steps on the CPU.
7. The grouped-matmul kernels (gmm, tgmm) against their plain versions:
   the forward (bf16 x bf16 -> f32), the grad_lhs (f32 x bf16 read
   transposed -> bf16) and the grad_rhs (tgmm, bf16 x f32 -> bf16) at
   moe_370m's expert shapes (16,384 rows, 8 experts, 768 <-> 2048, group
   sizes from a top-2 routing of random tokens), at Mixtral-8x7B's
   (8,192 rows, 4096 <-> 14336, 8 experts) and at Qwen1.5-MoE-A2.7B's
   (8,192 rows, 2048 <-> 1408, 60 experts), and on edge cases (empty
   groups, ragged groups, k and n off the tiles, rows past the sizes'
   sum).  Each is held elementwise against an f32 computation and the
   plain version within ``K.gmm_tolerance`` (each output's own depth),
   and timed beside its bound, the plain per-group loop and
   ``F.grouped_mm`` where that call takes the operands.  Two controls
   must fall outside that bound: the plain result with 32 of one group's
   products left out, and the f32-math products run with the cotangent
   rounded to bf16.
8. The trainer on moe_370m with the dropless gmm dispatch at full width
   and depth, fed as ``tools/bench_moe.py`` feeds the JAX trainer
   (``MoeLmTask``, adamw 1e-4 b2 0.95 wd 0.1, bf16 compute over f32
   params) with ``SyntheticLM`` batches of 8 x 1024, 20 steps from seed
   0.  Counts are zeroed just before the run and read just after; every
   kernel of the path must have run exactly 20 x its launches a step.
   The loss must stay finite and its last window below its first (no
   token can be dropped: every routed row is in the group sizes by
   construction).  Prints step ms, tokens/s, peak memory, the MFU by the
   active-parameter formula and a profiled step's device time by kind.
8b. (a) One step's gradients of moe_370m cut to 2 layers, kernels against
   the plain versions, at f32 and bf16; (b) five f32 steps of
   moe_tiny_lm_gmm on the card against the same steps on the CPU.
9. The splash kernel (K7, forward and backward) against its plain
   version: Mistral-7B's attention (B 1, H 32, KVH 8, S 8192, D 128,
   window 4096, bf16), packed rows with sinks, and edge cases at small
   sizes in f32 and bf16 (window 1, windows off the tile, sinks = window,
   sinks past one tile, window >= S, which must equal K2's causal kernels
   bit for bit).  Each is held elementwise against an f32 computation of
   the same function and against the plain version; the first two are
   timed, with the body that served them (wgmma, mma.sync or FMA) and
   their TFLOP/s, beside the bound, the plain version,
   ``local_attention_chunked`` (K7's CPU path),
   SDPA with the band as a boolean mask and ``flex_attention`` with a
   sliding-window block mask (compiled where it compiles; never on the
   main path).
10. The trainer on mistral_7b_lm at full width (d 4096, 32 / 8 heads, ffn
   14336, window 4096) cut to 4 layers, built as the CLI builds it (b 8 x
   s 8192, bf16 over f32, adamw + clip + warmup cosine, 10 steps from
   seed 0).  Counts are zeroed just before the run and read just after:
   per step exactly 8 splash / 4 splash backward launches and no flash
   attention, RMSNorm 17 / 9, cross-entropy 1 / 1.  The losses must stay
   finite, and the first batch's must fall under the trained weights
   (a batch the run did not see is read before and after and reported).
   Prints step ms, tokens/s, peak memory, the MFU (its
   formula beside it, attention at the window's mean visible keys) and a
   profiled step's device time by kind.
10b. (a) One step's gradients of the phase-10 model cut to 2 layers at
   b 1 x s 8192, kernels against the plain versions, f32 and bf16; (b)
   five f32 steps of a small windowed decoder (window 128, 4 sinks, seq
   512) on the card (K7) against the same steps on the CPU
   (``local_attention_chunked``).

11. The launcher (``python -m tensorflow_train_distributed_torch``) on
   llama_125m_lm at full width and depth, as subprocesses: (a) 12 steps
   with a checkpoint every 4 (keep 2), the last 100 of SyntheticLM's
   100,000 sequences held out and evaluated for 4 batches every 6 steps
   and at the end, a JSON-lines log; (b) the same with the step-8 save
   torn and a kill -9 at step 10 (``--fault-plan``), which must die by
   SIGKILL; (c) the rerun as supervisor attempt 1, which must quarantine
   ``corrupt/8``, restore step 4, take the data up mid-epoch and end with
   a step-12 checkpoint bit for bit equal to (a)'s and the same
   evaluation; (d) ``--eval-only`` on (a)'s directory, which must report
   (a)'s final ``loss`` and ``perplexity``.  Run (a) reports its kernel
   launches, which must be 12 training steps and 12 evaluation batches'
   worth; each run reports its step time, save, restore and evaluation
   seconds and bytes; (e) the launcher on phase 6's flags (20 steps, read
   every 5, ``--log-grad-norm``, no checkpoint or evaluation), whose step
   time stands beside phase 6's on the same terms.  The checkpoint
   directories are deleted at the end.

12. K2's full (non-causal) attention at BERT-base's heads (B 256, H 12,
   S 128, D 64) and Transformer-big's (B 64, H 16, S 256, D 64), f32 (as
   both configs compute) and bf16, and causal f32 at the Transformer's;
   K3f and K3b at BERT's logits [32768, 30522] f32 (V % 4 = 2: the
   kernels' scalar loads), at V 30,521 and at LeNet's [128, 10].  Each held against an f32
   computation and the plain version, timed beside its bound, the plain
   version and SDPA or ``F.cross_entropy``.
13. bert_base_mlm through the launcher at full width and depth (b 256 x
   s 128, mixed_bfloat16, 20 steps, a save every 10, 4 held-out
   evaluation batches); the same killed at step 15 and rerun, whose
   step-20 checkpoint must equal the uninterrupted run's bit for bit
   (dropout 0.1 on: the (seed, step) generator).  K2 forward and backward
   12 a step, K3f and K3b 1, exactly.
14. transformer_big_wmt through the launcher at full width and depth
   (seq 256 so attention meets K2's gate, b 64, 20 steps, a save), then
   ``--eval-only`` beam search (beam 4) of one batch of 8 and its BLEU.
   K2 18 forward and 18 backward a step, exactly; the beam search's
   launches counted too.
15. resnet50_imagenet through the launcher (224², b 256, bf16, SGD with
   Nesterov momentum, 20 steps, a save every 10), killed at step 15 and
   rerun, whose step-20 checkpoint must equal the uninterrupted run's
   bit for bit (the launcher pins cuDNN's deterministic algorithms); 5
   steps each of the s2d and s2d_bnsub variants; each of the three trainers on one
   batch already on the card.  No hand kernel runs on this path
   (cuDNN's convolutions; the label-smoothed loss takes no K3).
16. mnist (LeNet) through the launcher, 100 steps: the last 10 steps'
   mean loss at most half the first step's; K3f and K3b once a step.
17. Five f32 steps on the card against the CPU port: a BERT with 64-wide
   heads (K2, K3 at vocab 1,001) and resnet_tiny, whose BatchNorm
   running statistics are held like the params.
   Each launcher run prints its step time, examples a second, peak
   memory and the kernels' launches; checkpoints go under the
   git-ignored ``_family_smoke/``, deleted at the end.

Every phase raises on failure; the last line is the JSON device record
only when all passed.  Exits non-zero without CUDA, or when run outside
the repository.
"""

import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12      # dense tensor-core bf16
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores
# f32 products as the three bf16 products of an exact split
PEAK_F32_SPLIT_FLOPS = PEAK_BF16_FLOPS / 3

SEED = 0
_CSRC = "tensorflow_train_distributed_torch/csrc/"
_PK = "tensorflow_train_distributed_tpu/ops/pallas_kernels.py"
_FA = "jax/experimental/pallas/ops/tpu/flash_attention.py"
_MB = "jax/experimental/pallas/ops/tpu/megablox/gmm.py"
_SP = ("jax/experimental/pallas/ops/tpu/splash_attention/"
       "splash_attention_kernel.py")
# (name, source, the TPU kernel it replaces, the main path that runs it:
# "serve" (phase 3), "train" (phase 6), "moe_train" (phase 8) or
# "window_train" (phase 10)).
# RMSNorm's forward is on every path; it has a row for serving, llama_125m
# training and mistral_7b_lm training, and its backward one for each
# training path, each with that path's launches and shapes (moe_370m's
# rows are llama_125m's shape).
KERNELS = [
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "serve"),
    ("paged_attention", _CSRC + "paged_attention.cu", _PK + ":290", "serve"),
    ("paged_kv_gather", _CSRC + "paged_kv_gather.cu", _PK + ":121", "serve"),
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "train"),
    ("rms_norm_bwd", _CSRC + "rms_norm.cu", _PK + ":429", "train"),
    ("cross_entropy", _CSRC + "cross_entropy.cu", _PK + ":545", "train"),
    ("cross_entropy_bwd", _CSRC + "cross_entropy.cu", _PK + ":584", "train"),
    ("flash_attention", _CSRC + "flash_attention_fwd.cu", _FA + ":589",
     "train"),
    ("flash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _FA + ":941",
     "train"),                                          # and dq, :1287
    ("gmm", _CSRC + "grouped_matmul.cu", _MB + ":314", "moe_train"),
    ("tgmm", _CSRC + "grouped_matmul.cu", _MB + ":573", "moe_train"),
    ("splash_attention", _CSRC + "flash_attention_fwd.cu", _SP + ":895",
     "window_train"),
    ("splash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _SP + ":1857",
     "window_train"),                                   # and dq, :1405
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "window_train"),
    ("rms_norm_bwd", _CSRC + "rms_norm.cu", _PK + ":429", "window_train"),
    # Phase 11: the launcher drives llama_125m_lm's kernels (training and
    # evaluation) in its own process; the numbers beside them are phase
    # 5's, at the same shapes.
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "launch"),
    ("rms_norm_bwd", _CSRC + "rms_norm.cu", _PK + ":429", "launch"),
    ("cross_entropy", _CSRC + "cross_entropy.cu", _PK + ":545", "launch"),
    ("cross_entropy_bwd", _CSRC + "cross_entropy.cu", _PK + ":584",
     "launch"),
    ("flash_attention", _CSRC + "flash_attention_fwd.cu", _FA + ":589",
     "launch"),
    ("flash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _FA + ":941",
     "launch"),
    # Phases 13 and 14: BERT's full-attention encoder and fused loss at
    # vocab 30,522, and the Transformer's encoder, causal decoder and
    # cross-attention, all f32 as the configs compute; the numbers beside
    # them are phase 12's at the same shapes.
    ("flash_attention", _CSRC + "flash_attention_fwd.cu", _FA + ":589",
     "bert"),
    ("flash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _FA + ":941",
     "bert"),
    ("cross_entropy", _CSRC + "cross_entropy.cu", _PK + ":545", "bert"),
    ("cross_entropy_bwd", _CSRC + "cross_entropy.cu", _PK + ":584", "bert"),
    ("flash_attention", _CSRC + "flash_attention_fwd.cu", _FA + ":589",
     "wmt"),
    ("flash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _FA + ":941",
     "wmt"),
    # Phase 16: LeNet's loss (no label smoothing) at [128, 10].
    ("cross_entropy", _CSRC + "cross_entropy.cu", _PK + ":545", "mnist"),
    ("cross_entropy_bwd", _CSRC + "cross_entropy.cu", _PK + ":584",
     "mnist"),
]
SERVE_KERNELS = [k[0] for k in KERNELS if k[3] == "serve"]
LAUNCH_KERNELS = [k[0] for k in KERNELS if k[3] == "launch"]
TRAIN_KERNELS = [k[0] for k in KERNELS if k[3] == "train"]
# The MoE trainer runs the training kernels and the grouped matmuls.
MOE_TRAIN_KERNELS = TRAIN_KERNELS + [k[0] for k in KERNELS
                                     if k[3] == "moe_train"]


# Every timed case of phases 2 and 5 that the kernels' JSON line does not
# carry (the other body's time, shapes off the main path), printed as one
# JSON line.
CASES = []


def log(msg: str) -> None:
    print(msg, flush=True)


def _drain_stamps(log_every: int):
    """A trainer callback holding, in ``times``, the host time at which
    each ``log_every``-th step's metrics arrive (each drain of the
    metrics waits for the device)."""
    from tensorflow_train_distributed_torch.training.callbacks import (
        Callback,
    )

    class Stamps(Callback):
        def __init__(self):
            self.times = []

        def on_step_end(self, step, metrics):
            if step % log_every == 0 and "loss" in metrics:
                self.times.append(time.perf_counter())

    return Stamps()


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, *, launches: int = 40, repeats: int = 5,
              warmup: int = 3) -> float:
    """Median over ``repeats`` of the mean device time of ``launches``
    back-to-back calls, timed with CUDA events.  A device sleep queued
    first keeps the stream busy while the host enqueues, so the events
    bracket device work only."""
    import torch

    for _ in range(warmup):
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


def in_turns(fn, other_fn) -> tuple:
    """``device_ms`` of ``fn`` and of ``other_fn`` taken in turns (fn,
    other, other, fn), each the mean of its two: for two calls whose
    times lie within the drift of the card's clock over one timing."""
    a = device_ms(fn)
    b = device_ms(other_fn) + device_ms(other_fn)
    return (a + device_ms(fn)) / 2, b / 2


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _fma_note(fma) -> str:
    return "" if fma is None else f", FMA route's bound {fma[0] * 1e3:.1f} us"


def product_bound(nbytes: float, flops: float, f32: bool):
    """The bound of work that is products (attention, grouped matmuls):
    bf16 on the tensor cores, f32 as the three bf16 products of an exact
    split (the route K6 takes), so at three times the bf16 operations.
    Returns it and, for f32, the FMA route's bound at 67 TFLOP/s (None
    for bf16), logged beside it."""
    if not f32:
        return bound(nbytes, flops, PEAK_BF16_FLOPS), None
    return (bound(nbytes, 3 * flops, PEAK_BF16_FLOPS),
            bound(nbytes, flops, PEAK_F32_FLOPS))


# -- phase 1 ------------------------------------------------------------------


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


# -- phase 2 ------------------------------------------------------------------


def _worst_ratio(got, want, allowed) -> float:
    """max |got - want| / allowed elementwise (0 where they are equal)."""
    import torch

    diff = (got.float() - want.float()).abs()
    return torch.where(diff == 0, 0.0, diff / allowed).max().item()


def _check(what, got, want, allowed, rule) -> float:
    """Elementwise ``|got - want| <= allowed``; logs and returns the max
    absolute error, raises where any element is outside."""
    worst = _worst_ratio(got, want, allowed)
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {what}: max_abs_err {err:.3e}; worst |err| / allowed "
        f"{worst:.3f} (allowed: {rule}) {'ok' if worst <= 1 else 'FAIL'}")
    if not worst <= 1:
        raise AssertionError(f"{what}: error {err:.3e} outside {rule}")
    return err


def _report(name, shape, ms, plain_ms, lib_ms, bnd, body=None):
    served = f" ({body} body)" if body else ""
    log(f"  {name} {shape}: kernel {ms * 1e3:.1f} us{served}, bound "
        f"{bnd[0] * 1e3:.1f} us ({bnd[1]}), plain {plain_ms * 1e3:.1f} us, "
        f"library {lib_ms * 1e3:.1f} us")


def _other_body_ms(other, fn) -> dict:
    """Times the kernel's body ``other``, the one the library did not
    choose, on the same inputs (``fn(other)``)."""
    ms = device_ms(lambda: fn(other))
    log(f"    the {other} body on the same inputs: {ms * 1e3:.1f} us")
    return {f"{other}_body_ms": ms}


def _paged_case(label, q, kp, vp, sc, table, lengths, c) -> dict:
    """K4 on one pool and set of lanes: held against the f32 reference
    and the plain version, timed beside both bodies, its bound, the plain
    version and SDPA over the gathered rows."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    lanes, _, heads, hd = q.shape
    kw = {} if sc is None else dict(k_scales=sc[0], v_scales=sc[1])
    body = K.paged_attention_body(q, kp, vp)
    out = K.paged_attention(q, kp, vp, table, lengths, **kw)
    ref = K.paged_attention_reference(q, kp, vp, table, lengths, **kw)
    # The f32 reference is the same math as the kernel's: the query is
    # rescaled so that it applies the bf16-rounded scale the bf16 path
    # applies, and int8 rows come dequantised through bf16 as the kernel
    # and the reference dequantise them.
    s_bf16 = torch.tensor(hd ** -0.5, dtype=torch.bfloat16).item()
    s_f32 = torch.tensor(hd ** -0.5, dtype=torch.float32).item()
    q32 = q.float() * (s_bf16 / s_f32)
    if sc is None:
        k32, v32 = kp.float(), vp.float()
    else:
        k32 = (kp.to(q.dtype) * sc[0][..., None].to(q.dtype)).float()
        v32 = (vp.to(q.dtype) * sc[1][..., None].to(q.dtype)).float()
    ref32 = K.paged_attention_reference(q32, k32, v32, table, lengths)
    del k32, v32
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    log(f"  paged_attention {label}: {body} body; outputs up to "
        f"{ref32.abs().max().item():.3f}, median magnitude "
        f"{ref32.abs().median().item():.3f}")
    # The kernel keeps f32 to the end and rounds its output once to bf16
    # (at most 2^-8 of the value), plus the f32 tests' 2e-5 for another
    # summation order.
    _check(f"paged_attention {label} vs f32 reference", out, ref32,
           2 ** -8 * ref32.abs() + 2e-5, "2^-8 |ref32| + 2e-5")
    # The plain version on the same inputs also rounds logits and softmax
    # weights to bf16: its own distance from the f32 math, measured here,
    # is allowed on top.
    err = _check(f"paged_attention {label} vs its plain version", out, ref,
                 (ref.float() - ref32).abs() + 2 ** -8 * ref32.abs() + 2e-5,
                 "|ref - ref32| + 2^-8 |ref32| + 2e-5")

    def call(body=None):
        return K.paged_attention(q, kp, vp, table, lengths, body=body, **kw)

    ms = device_ms(call)
    plain = device_ms(lambda: K.paged_attention_reference(
        q, kp, vp, table, lengths, **kw), launches=10)
    # SDPA over the rows the lanes can see (whole pool blocks), gathered
    # and dequantised beforehand: the same function on the same inputs.
    bs = kp.shape[1]
    rows = min(c, -(-(int(lengths.max().item()) + 1) // bs) * bs)
    kc = K.paged_kv_gather_reference(kp, table, rows)
    vc = K.paged_kv_gather_reference(vp, table, rows)
    if sc is not None:
        kc = kc.to(q.dtype) * K.paged_kv_gather_reference(
            sc[0][..., None], table, rows).to(q.dtype)
        vc = vc.to(q.dtype) * K.paged_kv_gather_reference(
            sc[1][..., None], table, rows).to(q.dtype)
    pos = torch.arange(rows, device=q.device)
    mask = (pos[None, :] <= lengths.long()[:, None])[:, None, None, :]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, kc, vc))
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    visible = (lengths.long() + 1).clamp(max=c).sum().item()
    nbytes = (visible * heads * hd * kp.element_size() * 2
              + q.numel() * 2 * 2 + table.numel() * 4 + lanes * 4
              + (visible * heads * 4 * 2 if sc else 0))
    bnd = bound(nbytes, 4 * visible * heads * hd, PEAK_BF16_FLOPS)
    shape = (f"{lanes} lanes x {heads} heads x hd {hd}, bs {bs}, "
             f"{table.shape[1]} blocks, {visible} visible rows, {label}")
    _report("paged_attention", shape, ms, plain, lib, bnd, body)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0],
               bound_by=bnd[1], library_ms=lib)
    return dict(row, case=label, body=body, visible_rows=visible,
                **_other_body_ms("staged", call))


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
        body = K.rms_norm_body(x, scale)
        ms = device_ms(lambda: K.rms_norm(x, scale))
        plain = device_ms(lambda: K.rms_norm_reference(x, scale))
        lib = device_ms(lambda: F.rms_norm(x, (d,), scale, 1e-5))
        bnd = bound(2 * n * d * 2 + d * 2, 4 * n * d, PEAK_F32_FLOPS)
        _report("rms_norm", f"[{n}, {d}] bf16", ms, plain, lib, bnd, body)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0],
                   bound_by=bnd[1], library_ms=lib)
        CASES.append(dict(row, kernel="rms_norm", case=f"[{n}, {d}] bf16",
                          body=body, **_other_body_ms(
                              "warp" if body == "block" else "block",
                              lambda b: K.rms_norm_forward(
                                  x, scale, 1e-5, with_r=False, body=b))))
        if n == 8:      # the decode step's shape goes into the JSON line
            rows["rms_norm"] = row

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
    # The engine's short lanes: 90-130 rows, as its profiled chunk fills
    # them (100-token prompts and the tokens decoded since).
    short = torch.randint(90, 131, (lanes,), generator=gen, device=dev,
                          dtype=torch.int32)
    for label, kp, vp, sc, lens in (
            ("bf16", kpool, vpool, None, lengths),
            ("int8", k8, v8, (ks, vs), lengths),
            ("bf16, short lanes", kpool, vpool, None, short)):
        case = _paged_case(label, q, kp, vp, sc, table, lens, c)
        CASES.append(dict(case, kernel="paged_attention"))
        if label == "bf16":      # the main path's pool type
            rows["paged_attention"] = {
                k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}

    # Gather (K5), bitwise for every body that runs, on the bf16 pool and
    # the int8 engine's f32 scale pool [nb, bs, 32, 1] (128-byte rows):
    # all 8 lanes (64 MiB of bf16 rows) and the engine's radix hit, one
    # lane's [1, 64] table (8 MiB).  The one-lane calls take the lanes in
    # turn, so each reads blocks the seven calls before it did not (cold
    # in the 50 MB L2, as the engine's 32-layer pool is).  The bf16 cases
    # are timed with every body and in turns with index_select over the
    # same blocks (the two copies run at about the same rate); the
    # engine's lane is the main path's shape.
    one_lane = [table[i:i + 1] for i in range(lanes)]
    for label, pool, tables, timed in (
            ("bf16, 8 lanes", kpool, [table], True),
            ("bf16, the engine's lane", kpool, one_lane, True),
            ("f32 scales, 8 lanes", ks[..., None], [table], False),
            ("f32 scales, the engine's lane", ks[..., None], one_lane,
             False)):
        body = K.paged_kv_gather_body(pool)
        runs = [b for b in K.PAGED_KV_GATHER_BODIES
                if b == "block" or body != "block"]
        for b in runs:
            for t in tables:
                out = K.paged_kv_gather(pool, t, c, body=b)
                if not torch.equal(out, K.paged_kv_gather_reference(pool, t,
                                                                    c)):
                    raise AssertionError(f"paged_kv_gather {label}, {b} "
                                         f"body: not bitwise")
        torch.cuda.synchronize()
        log(f"  paged_kv_gather {label}: {body} body; bitwise equal ok "
            f"(bodies {runs})")
        if not timed:
            continue
        turn = itertools.cycle(tables)
        flats = itertools.cycle([t.reshape(-1) for t in tables])

        def call(b=None):
            return K.paged_kv_gather(pool, next(turn), c, body=b)

        ms, lib = in_turns(call, lambda: pool.index_select(0, next(flats)))
        plain = device_ms(lambda: K.paged_kv_gather_reference(
            pool, next(turn), c))
        bnd = bound(2 * out.numel() * out.element_size()
                    + tables[0].numel() * 4, 0, PEAK_BF16_FLOPS)
        shape = (f"pool [{nb}, {bs}, {heads}, {hd}] bf16 -> "
                 f"[{out.shape[0]}, {c}], {label}")
        _report("paged_kv_gather", shape, ms, plain, lib, bnd, body)
        row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd[0],
                   bound_by=bnd[1], library_ms=lib)
        others = {}
        for b in runs:
            if b != body:
                others.update(_other_body_ms(b, call))
        CASES.append(dict(row, kernel="paged_kv_gather", case=label,
                          body=body, **others))
        if label == "bf16, the engine's lane":
            rows["paged_kv_gather"] = row
    return rows


# -- phases 3 and 4 -----------------------------------------------------------


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
                else "batch_norm" if ("batch_norm" in low or "bn_fw" in low
                                      or "bn_bw" in low)
                else "conv" if any(k in low for k in (
                    "conv", "fprop", "dgrad", "wgrad"))
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
    counts = {k: K.launch_counts()[k] for k in SERVE_KERNELS}
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


# -- phase 5 ------------------------------------------------------------------


def _backward_ms(out, inputs, grad, launches=20) -> float:
    """Device time of one autograd backward of an already built graph."""
    import torch

    return device_ms(lambda: torch.autograd.grad(out, inputs, grad,
                                                 retain_graph=True),
                     launches=launches)


def _leaf(*ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


def _rms_norm_fwd_case(gen, n: int, d: int) -> dict:
    """K1f as the training path calls it (also writing r for the backward)
    at its rows [B*S, d_model] bf16: [16384, 768] for llama_125m_lm (and
    moe_370m), [65536, 4096] for mistral_7b_lm."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    y, r = K.rms_norm_forward(x, s, 1e-5, with_r=True)
    ref = K.rms_norm_reference(x, s)
    r32 = torch.rsqrt(x.float().square().mean(-1) + 1e-5)
    torch.cuda.synchronize()
    # As phase 2: f32 math rounded once to bf16; r is f32 in another
    # summation order.
    err = _check(f"rms_norm [{n}, {d}] bf16 (with r)", y, ref,
                 2 ** -7 * ref.float().abs() + 1e-6,
                 "one bf16 step: 2^-7 |ref| + 1e-6")
    _check("rms_norm r", r, r32, 1e-6 * r32.abs(), "1e-6 |ref|")
    del ref, r32
    body = K.rms_norm_body(x, s)

    def call(b=None):
        return K.rms_norm_forward(x, s, 1e-5, with_r=True, body=b)

    ms = device_ms(call)
    plain = device_ms(lambda: K.rms_norm_reference(x, s))
    lib = device_ms(lambda: F.rms_norm(x, (d,), s, 1e-5))
    bnd = bound(2 * n * d * 2 + n * 4 + d * 2, 4 * n * d, PEAK_F32_FLOPS)
    _report("rms_norm", f"[{n}, {d}] bf16 with r", ms, plain, lib, bnd, body)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0],
               bound_by=bnd[1], library_ms=lib)
    CASES.append(dict(row, kernel="rms_norm", case=f"[{n}, {d}] bf16 with r",
                      body=body, **_other_body_ms("block", call)))
    return row


def _rms_norm_bwd_case(gen, n: int, d: int) -> dict:
    """K1b, the whole ``_rms_norm_pallas_bwd`` (dx and dscale), at the
    training path's rows [B*S, d_model], bf16 activations and scale (the
    bf16 policy casts the scale): [16384, 768] for llama_125m_lm (and
    moe_370m), [65536, 4096] for mistral_7b_lm.  Held against f32 and the
    plain version; timed with its body beside the other body's whole
    backward (the block body: its dx kernel and the einsum column sum),
    both bodies' dx alone, the plain version's two-gradient autograd,
    ``F.rms_norm``'s backward with x and the scale as leaves (the same
    function) and with x alone (dx only)."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    g = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    _, r = K.rms_norm_forward(x, s, 1e-5, with_r=True)
    body = K.rms_norm_bwd_body(x, s, g)
    dx, ds = K.rms_norm_backward(x, s, r, g)
    xp, sp = _leaf(x, s)
    yp = K.rms_norm_reference(xp, sp)
    plain, plain_ds = torch.autograd.grad(yp, (xp, sp), g, retain_graph=True)
    x32, s32, g32 = x.float(), s.float(), g.float()
    (x32l,) = _leaf(x32)
    (ref32,) = torch.autograd.grad(K.rms_norm_reference(x32l, s32), x32l,
                                   g32)
    del x32l
    rr = torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-5)
    c = (g32 * s32 * x32).mean(-1, keepdim=True)
    terms = (rr * g32 * s32).abs() + (x32 * rr ** 3 * c).abs()
    ds32 = torch.einsum("nd,nd->d", g32, x32 * rr)
    mass = torch.einsum("nd,nd->d", g32.abs(), (x32 * rr).abs())
    del c, x32, g32
    torch.cuda.synchronize()
    shape = f"[{n}, {d}] bf16"
    # f32 math rounded once to bf16 (one bf16 step, at most 2^-7 of the
    # value), plus 1e-5 of the two terms of r*g*s - x*r^3*mean(g*s*x) for
    # f32 sums in another order.
    allowed = 2 ** -7 * ref32.abs() + 1e-5 * terms
    del terms
    _check(f"rms_norm_bwd {shape} dx vs f32", dx, ref32, allowed,
           "2^-7 |ref32| + 1e-5 (|r g s| + |x r^3 c|)")
    err = _check(f"rms_norm_bwd {shape} dx vs its plain version", dx, plain,
                 (plain.float() - ref32).abs() + allowed,
                 "|plain - ref32| + the above")
    del allowed, ref32, plain
    # dscale: the f32 column sum rounded once to bf16 (one bf16 step),
    # plus 1e-5 of sum_rows |g x r| for f32 sums in another order.
    ds_allowed = 2 ** -7 * ds32.abs() + 1e-5 * mass
    _check(f"rms_norm_bwd {shape} ds vs the f32 column sum", ds, ds32,
           ds_allowed, "2^-7 |ref32| + 1e-5 sum_rows |g x r|")
    err_ds = _check(f"rms_norm_bwd {shape} ds vs its plain version", ds,
                    plain_ds, (plain_ds.float() - ds32).abs() + ds_allowed,
                    "|plain - ref32| + the above")
    torch.cuda.empty_cache()

    def whole(b=None):
        return K.rms_norm_backward(x, s, r, g, body=b)

    def dx_only(b=None):
        return K.rms_norm_backward(x, s, r, g, with_ds=False, body=b)

    other = "block" if body == "warp" else "warp"
    ms = device_ms(whole)
    other_ms = device_ms(lambda: whole(other))
    dx_ms = device_ms(dx_only)
    dx_other_ms = device_ms(lambda: dx_only(other))
    plain_ms = _backward_ms(yp, [xp, sp], g)
    del yp
    xl, sl = _leaf(x, s)
    yl = F.rms_norm(xl, (d,), sl, 1e-5)
    lib = _backward_ms(yl, [xl, sl], g)
    del yl
    (xl1,) = _leaf(x)
    yl1 = F.rms_norm(xl1, (d,), s, 1e-5)
    lib_dx = _backward_ms(yl1, xl1, g)
    del yl1
    bnd = bound(3 * n * d * 2 + n * 4 + 2 * d * 2, 10 * n * d,
                PEAK_F32_FLOPS)
    _report("rms_norm_bwd", f"{shape} dx + ds", ms, plain_ms, lib, bnd,
            body)
    log(f"    the {other} body's whole backward (its dx kernel"
        f"{' and the einsum column sum' if other == 'block' else ''}): "
        f"{other_ms * 1e3:.1f} us; dx alone: {body} {dx_ms * 1e3:.1f} us, "
        f"{other} {dx_other_ms * 1e3:.1f} us, F.rms_norm (x alone a leaf) "
        f"{lib_dx * 1e3:.1f} us")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
               bound_by=bnd[1], library_ms=lib, max_abs_err_ds=err_ds)
    CASES.append(dict(row, kernel="rms_norm_bwd", case=f"{shape} dx + ds",
                      body=body, **{f"{other}_body_ms": other_ms},
                      dx_only_ms=dx_ms, **{f"{other}_dx_only_ms": dx_other_ms},
                      library_dx_only_ms=lib_dx))
    return row


def _cross_entropy_cases(gen, n: int = 16384, v: int = 32000) -> dict:
    """K3f and K3b at a training path's logits: [B*S, vocab] f32 (the
    task casts logits to f32 first): [16384, 32000] for llama_125m_lm,
    [32768, 30522] for bert_base_mlm (V % 4 = 2: the scalar loads)."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    logits = 3 * torch.randn(n, v, generator=gen, device="cuda")
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda",
                           dtype=torch.int32)
    g = torch.full((n,), 1.0 / n, device="cuda")     # d(mean loss)
    loss, lse = K.cross_entropy_forward(logits, labels)
    (lp,) = _leaf(logits)
    plain = K.cross_entropy_reference(lp, labels)
    torch.cuda.synchronize()
    # One f32 logsumexp over 32,000 columns each, summed in another order.
    err_f = _check(f"cross_entropy [{n}, {v}] f32 vs plain", loss,
                   plain, 2e-5 + 1e-6 * plain.abs(), "2e-5 + 1e-6 |ref|")
    dl = K.cross_entropy_backward(logits, labels, lse, g)
    (dplain,) = torch.autograd.grad(plain, lp, g, retain_graph=True)
    pg = torch.exp(logits - torch.logsumexp(logits, -1, keepdim=True)
                   ) * g[:, None]
    torch.cuda.synchronize()
    # (p - onehot) g with p = exp(x - lse): lse within 2e-5 moves p by
    # 2e-5 of itself; 3e-5 (|ref| + p g).
    err_b = _check("cross_entropy_bwd vs plain", dl, dplain,
                   3e-5 * (dplain.abs() + pg), "3e-5 (|ref| + p g)")
    del pg
    lab64 = labels.long()
    rows = {}
    nbytes_f = 4 * n * v + 4 * n + 8 * n
    nbytes_b = 8 * n * v + 12 * n
    ms = device_ms(lambda: K.cross_entropy_forward(logits, labels),
                   launches=20)
    plain_ms = device_ms(lambda: K.cross_entropy_reference(logits, labels),
                         launches=10)
    lib = device_ms(lambda: F.cross_entropy(logits, lab64,
                                            reduction="none"), launches=10)
    bnd = bound(nbytes_f, 4 * n * v, PEAK_F32_FLOPS)
    _report("cross_entropy", f"[{n}, {v}] f32", ms, plain_ms, lib, bnd)
    rows["cross_entropy"] = dict(max_abs_err=err_f, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bnd[0], bound_by=bnd[1],
                                 library_ms=lib)
    ms = device_ms(lambda: K.cross_entropy_backward(logits, labels, lse, g),
                   launches=20)
    plain_ms = _backward_ms(plain, lp, g, launches=10)
    (ll,) = _leaf(logits)
    lib_out = F.cross_entropy(ll, lab64, reduction="none")
    lib = _backward_ms(lib_out, ll, g, launches=10)
    bnd = bound(nbytes_b, 4 * n * v, PEAK_F32_FLOPS)
    _report("cross_entropy_bwd", f"[{n}, {v}] f32", ms, plain_ms, lib, bnd)
    rows["cross_entropy_bwd"] = dict(max_abs_err=err_b, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bnd[0],
                                     bound_by=bnd[1], library_ms=lib)
    return rows


def _segments(gen, b, s):
    """[B, S] int32 packed rows: documents of random lengths, ids rising
    along each row."""
    import torch

    cuts = torch.sort(torch.randint(1, s, (b, 5), generator=gen,
                                    device="cuda"), dim=1).values
    pos = torch.arange(s, device="cuda")
    return (pos[None, :, None] >= cuts[:, None, :]).sum(-1).to(torch.int32)


def _flash_f32(q, k, v, do, causal, seg, scale, window=None, sinks=0):
    """The flash function (with ``window``, the splash function) in f32
    from the same (bf16) inputs, one (batch row, kv head) at a time, with
    the magnitude terms its error bounds need: the exact out/dq/dk/dv, and
    for each the sum of |terms| that bf16 rounding of p, dS and o can move
    (see ``_flash_case``).  Also returns the visible (query, key) pairs,
    summed over heads."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K

    rep = q.shape[1] // k.shape[1]
    names = ("out", "dq", "dk", "dv", "out_t", "dq_t", "dk_t", "dv_t")
    res = {n: [] for n in names}
    pairs = 0
    n = q.shape[2]
    for i in range(q.shape[0]):
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device)
        if causal:
            keep = keep.tril()
        if window is not None:
            keep = keep & K.splash_mask(n, window, sinks, q.device)
        if seg is not None:
            keep = keep & (seg[i][:, None] == seg[i][None, :])
        pairs += int(keep.sum()) * q.shape[1]
        mask = torch.where(keep, 0.0, K.FLASH_MASK_VALUE)
        row = {nm: [] for nm in names}
        for g in range(k.shape[1]):
            # The group's query heads [rep, S, D] against kv head g [S, D].
            q32 = q[i, g * rep:(g + 1) * rep].float()
            g32 = do[i, g * rep:(g + 1) * rep].float()
            k32, v32 = k[i, g].float(), v[i, g].float()
            p = torch.softmax((q32 @ k32.t()) * scale + mask, -1)
            out = p @ v32
            dp = g32 @ v32.t()
            di = (g32 * out).sum(-1, keepdim=True)
            ds = p * (dp - di) * scale
            del dp
            dio = (g32.abs() * out.abs()).sum(-1, keepdim=True)  # o rounding
            dsa = ds.abs()
            pt = p.transpose(-1, -2)
            row["out"].append(out)
            row["out_t"].append(p @ v32.abs())
            row["dq"].append(ds @ k32)
            row["dq_t"].append(dsa @ k32.abs()
                               + scale * dio * (p @ k32.abs()))
            # dk, dv of kv head g sum over its query group.
            row["dk"].append((ds.transpose(-1, -2) @ q32).sum(0))
            row["dk_t"].append((dsa.transpose(-1, -2) @ q32.abs()
                                + scale * pt @ (dio * q32.abs())).sum(0))
            row["dv"].append((pt @ g32).sum(0))
            row["dv_t"].append((pt @ g32.abs()).sum(0))
            del p, pt, ds, dsa
        for nm in names:
            stack = torch.cat if nm[:2] in ("ou", "dq") else torch.stack
            res[nm].append(stack(row[nm]))
    return {nm: torch.stack(v) for nm, v in res.items()}, pairs


def _flash_case(gen, label, b, h, kvh, s, d, *, packed, main,
                causal=True, dtype=None) -> dict:
    """K2 forward and backward on [B, H, S, D] views of [B, S, H, D]
    storage (the model's layout), causal or full, bf16 (default) or f32,
    against the plain version and an f32 computation of the same
    function."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32

    def bshd(heads):
        return torch.randn(b, s, heads, d, generator=gen, device="cuda").to(
            dtype).transpose(1, 2)

    q, k, v, do = bshd(h), bshd(kvh), bshd(kvh), bshd(h)
    seg = _segments(gen, b, s) if packed else None
    scale = d ** -0.5
    o, lse = K.flash_attention_forward(q, k, v, seg, causal, scale)
    dq, dk, dv = K.flash_attention_backward(q, k, v, o, lse, do, seg,
                                            causal, scale)
    qp, kp, vp = _leaf(q, k, v)
    op = K.flash_attention_reference(qp, kp, vp, causal=causal,
                                     segment_ids=seg, sm_scale=scale)
    gp = torch.autograd.grad(op, (qp, kp, vp), do, retain_graph=True)
    ref, pairs = _flash_f32(q, k, v, do, causal, seg, scale)
    torch.cuda.synchronize()
    rows, errs = {}, {}
    # bf16: the kernel rounds p to bf16 before p.v and dS before dS.k /
    # dS^T.q, reads o in bf16 for di, and rounds its outputs once; each
    # rounding moves a value by at most 2^-8 of itself (bf16 keeps 8
    # significant bits).  So it stays within 2^-7 of (|ref32| + the sum of
    # |terms| those roundings touch), a factor 2 for the f32 sums.  f32
    # (the FMA body): only the order of f32 sums differs, at most S terms
    # deep, so S 2^-24 <= 2^-16 of the same magnitude at S <= 256, times
    # 4 for the chained products and the exp: 2^-14.  Against the plain
    # version, its own measured distance from ref32 is allowed on top.
    rel, rule = (2 ** -14, "2^-14") if f32 else (2 ** -7, "2^-7")
    for name, got, plain in (("out", o, op), ("dq", dq, gp[0]),
                             ("dk", dk, gp[1]), ("dv", dv, gp[2])):
        r32 = ref[name]
        allowed = rel * (r32.abs() + ref[name + "_t"]) + 1e-6
        _check(f"flash {label} {name} vs f32", got, r32, allowed,
               f"{rule} (|ref32| + |terms|) + 1e-6")
        errs[name] = _check(f"flash {label} {name} vs plain", got, plain,
                            (plain.float() - r32).abs() + allowed,
                            "|plain - ref32| + the above")
    del ref
    shape = (f"B {b} H {h} KVH {kvh} S {s} D {d} "
             f"{'causal' if causal else 'full'} {'f32' if f32 else 'bf16'}"
             + (" packed" if packed else ""))
    es = q.element_size()
    in_bytes = (q.numel() + k.numel() + v.numel()) * es
    fwd_bytes = in_bytes + o.numel() * es + lse.numel() * 4
    bwd_bytes = (in_bytes + 2 * o.numel() * es + lse.numel() * 4
                 + (dq.numel() + dk.numel() + dv.numel()) * es)
    rep = h // kvh
    kr, vr = (t.repeat_interleave(rep, 1) for t in (k, v))
    mask = None
    if seg is not None:
        mask = seg[:, None, :, None] == seg[:, None, None, :]
        if causal:
            mask = mask & torch.ones(s, s, dtype=torch.bool,
                                     device="cuda").tril()

    def lib_fwd(qq, kk, vv):
        if mask is None:
            return F.scaled_dot_product_attention(qq, kk, vv,
                                                  is_causal=causal)
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

    ms = device_ms(lambda: K.flash_attention_forward(q, k, v, seg, causal,
                                                     scale), launches=10)
    plain_ms = device_ms(lambda: K.flash_attention_reference(
        q, k, v, causal=causal, segment_ids=seg, sm_scale=scale),
        launches=3)
    lib = device_ms(lambda: lib_fwd(q, kr, vr), launches=10)
    bnd, fma = product_bound(fwd_bytes, 4 * d * pairs, f32)
    _report("flash_attention", shape, ms, plain_ms, lib, bnd)
    body = K.flash_attention_body(q.dtype, d)
    log(f"  flash_attention {shape}: {body} body, "
        f"{4 * d * pairs / ms / 1e9:.1f} TFLOP/s"
        + _fma_note(fma))
    rows["flash_attention"] = dict(max_abs_err=errs["out"], ms=ms,
                                   plain_ms=plain_ms, bound_ms=bnd[0],
                                   bound_by=bnd[1], library_ms=lib,
                                   fma_bound_ms=fma and fma[0])
    ms = device_ms(lambda: K.flash_attention_backward(
        q, k, v, o, lse, do, seg, causal, scale), launches=10)
    plain_ms = _backward_ms(op, (qp, kp, vp), do, launches=3)
    ql, kl, vl = _leaf(q, kr, vr)
    lib = _backward_ms(lib_fwd(ql, kl, vl), (ql, kl, vl), do, launches=10)
    bnd, fma = product_bound(bwd_bytes, 10 * d * pairs, f32)
    _report("flash_attention_bwd", shape, ms, plain_ms, lib, bnd)
    log(f"  flash_attention_bwd {shape}: {body} body, "
        f"{10 * d * pairs / ms / 1e9:.1f} TFLOP/s"
        + _fma_note(fma))
    rows["flash_attention_bwd"] = dict(
        max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]), ms=ms,
        plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib,
        fma_bound_ms=fma and fma[0])
    log(f"  flash {label}: {pairs} visible (query, key) pairs")
    if not main:
        for name, row in rows.items():
            CASES.append(dict(row, kernel=name, case=f"{label}: {shape}"))
        return {}
    return rows


def phase_train_kernels() -> dict:
    """The training kernels against their plain versions at the training
    path's shapes; returns their rows of the kernels' JSON line by path:
    "train" (llama_125m_lm) and "window_train" (K1f and K1b at
    mistral_7b_lm's rows)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = {"rms_norm": _rms_norm_fwd_case(gen, 16384, 768),
            "rms_norm_bwd": _rms_norm_bwd_case(gen, 16384, 768)}
    torch.cuda.empty_cache()
    rows.update(_cross_entropy_cases(gen))
    torch.cuda.empty_cache()
    # llama_125m's attention (the JSON line's shape), Llama-2-7B's head,
    # and GQA over packed rows.
    rows.update(_flash_case(gen, "llama_125m", 8, 12, 12, 2048, 64,
                            packed=False, main=True))
    torch.cuda.empty_cache()
    _flash_case(gen, "llama2_7b head", 1, 32, 32, 2048, 128, packed=False,
                main=False)
    _flash_case(gen, "gqa packed", 2, 16, 4, 1024, 128, packed=True,
                main=False)
    torch.cuda.empty_cache()
    window = {"rms_norm": _rms_norm_fwd_case(gen, 65536, 4096)}
    torch.cuda.empty_cache()
    window["rms_norm_bwd"] = _rms_norm_bwd_case(gen, 65536, 4096)
    torch.cuda.empty_cache()
    return {"train": rows, "window_train": window}


# -- phase 6 ------------------------------------------------------------------


def train_launches_per_step(num_layers: int) -> dict:
    """Kernel launches of one training step of a decoder under full remat:
    every block's forward runs twice (the forward, and again in the
    backward), the final norm and the loss once."""
    n = num_layers
    return {"flash_attention": 2 * n, "flash_attention_bwd": n,
            "rms_norm": 4 * n + 1, "rms_norm_bwd": 2 * n + 1,
            "cross_entropy": 1, "cross_entropy_bwd": 1}


def phase_train(steps: int = 20, log_every: int = 5) -> tuple:
    """The trainer on llama_125m_lm at full width and depth, through the
    CLI's own construction (``train.make_trainer``): b 8 x s 2048, bf16
    compute over f32 params, adamw + clip 1.0 + warmup_cosine, random
    weights from seed 0.  Counts are zeroed just before ``fit`` and read
    just after."""
    import math

    import torch
    from tensorflow_train_distributed_torch import train as T
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.ops import kernels as K

    name = "llama_125m_lm"
    args = T.build_parser().parse_args(
        ["--config", name, "--steps", str(steps), "--seed", str(SEED),
         "--log-every", str(log_every), "--log-grad-norm", "--device",
         "cuda"])
    entry = registry.get_entry(name)
    cfg = entry["config"]
    drains = _drain_stamps(log_every)
    _, trainer, batches = T.make_trainer(args, entry, callbacks=[drains])
    state = trainer.create_state()
    torch.cuda.synchronize()
    stamps = drains.times

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = trainer.fit(batches, steps=steps, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts()[k] for k in TRAIN_KERNELS}
    others = {k: v for k, v in K.launch_counts().items()
              if k not in TRAIN_KERNELS and v}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for _, m in history]
    for step, m in history:
        log(f"  step {step}: loss {m['loss']:.4f} accuracy "
            f"{m['accuracy']:.4f} lr {m['lr']:.3e} grad_norm "
            f"{m['grad_norm']:.3f}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    want = {k: steps * v for k, v in
            train_launches_per_step(cfg.num_layers).items()}
    log(f"  launches {counts} (expected {want}); others {others}")
    if counts != want or others:
        raise AssertionError(f"training launches {counts}, others {others};"
                             f" expected {want}")
    # Window times between metric drains (each drain waits for the
    # device); the first window, which holds the warm-up, is left out.
    windows = [(b - a) / log_every for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(windows) if windows else wall / steps
    b, s = entry["global_batch_size"], entry["dataset_kwargs"]["seq_len"]
    tokens = b * s
    n_params = state.num_params()
    n_dense = n_params - cfg.vocab_size * cfg.d_model    # no embedding
    flops = (6 * n_dense + 6 * cfg.num_layers * s * cfg.d_model) * tokens
    stats = dict(
        config=name, steps=steps, batch=b, seq=s, params=n_params,
        step_ms=step_s * 1e3, window_ms_per_step=[w * 1e3 for w in windows],
        tokens_per_s=tokens / step_s, peak_mem_gib=peak / 2 ** 30,
        wall_s=wall, losses=losses,
        mfu=flops / step_s / PEAK_BF16_FLOPS,
        mfu_formula="(6 (N - V d) + 6 L S d) tokens / step_s / 989e12")
    stats["profile"] = _profile_train_step(trainer, state, batches)
    log(f"  training: {json.dumps(stats)}")
    return counts, stats


def _profile_train_step(trainer, state, batches):
    """One more training step under torch.profiler (CUPTI), after the
    counted run: the device's busy share of the step's wall time and the
    kernel time by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tensorflow_train_distributed_torch.data.pipeline import to_device

    batch = to_device(next(iter(batches)), "cuda")
    trainer.train_step(state, batch)            # same shapes, warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = dict.fromkeys(("matmul", "conv", "batch_norm", "gmm", "tgmm",
                           "flash_attention", "flash_attention_bwd",
                           "splash_attention", "splash_attention_bwd",
                           "cross_entropy", "rms_norm", "other"), 0.0)
    top, n_kernels = [], 0
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        n_kernels += e.count
        low = e.key.lower()
        # K7 is K2's kernels with BAND = true (the di pass has no band and
        # counts as flash_attention_bwd).
        band = "true>" in low or "lb1ee" in low
        kind = ("tgmm" if "ttd_grouped" in low and "tgmm_" in low
                else "gmm" if "ttd_grouped" in low
                else ("splash_attention_bwd" if band
                      else "flash_attention_bwd") if "flash_bwd" in low
                else ("splash_attention" if band
                      else "flash_attention") if "flash_fwd" in low
                else "cross_entropy" if ("ce_fwd_kernel" in low
                                         or "ce_bwd_kernel" in low)
                else "rms_norm" if "rms_norm" in low
                else "batch_norm" if ("batch_norm" in low or "bn_fw" in low
                                      or "bn_bw" in low)
                else "conv" if any(k in low for k in (
                    "conv", "fprop", "dgrad", "wgrad"))
                else "matmul" if any(k in low for k in (
                    "gemm", "gemv", "cutlass", "xmma", "nvjet", "matmul"))
                else "other")
        kinds[kind] += us
        top.append((us, e.count, e.key[:70]))
    busy = sum(kinds.values())
    if busy == 0:
        log("  profile: the profiler recorded no device time (not measured)")
        return None
    top.sort(reverse=True)
    for us, count, name in top[:12]:
        log(f"    {us / 1e3:8.3f} ms  x{count:<5d} {name}")
    return dict(step_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                busy_share_profiled=busy / wall_us, device_kernels=n_kernels,
                kernel_ms_by_kind={k: v / 1e3 for k, v in kinds.items()})


# -- phases 6b and 8b ---------------------------------------------------------


class _plain_kernels:
    """Context in which the training kernels' wrappers compute their plain
    versions on CUDA tensors (the comparison models of phases 6b, 8b and
    10b only)."""

    NAMES = ("rms_norm", "cross_entropy", "flash_attention",
             "splash_attention", "gmm")

    def __enter__(self):
        from tensorflow_train_distributed_torch.ops import kernels as K

        self.saved = {n: getattr(K, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(K, n, getattr(K, n + "_reference"))

    def __exit__(self, *exc):
        from tensorflow_train_distributed_torch.ops import kernels as K

        for n, fn in self.saved.items():
            setattr(K, n, fn)


def _grad_check(label, make_task, host, bounds) -> dict:
    """One step's gradients of ``make_task(dtype)`` on the card, kernels
    against the same model with every training wrapper on its plain
    version, for each (precision, dtype, bound) of ``bounds``: each
    leaf's relative L2 distance, the largest held to the bound."""
    import torch
    from tensorflow_train_distributed_torch.data.pipeline import to_device
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy)
    from tensorflow_train_distributed_torch.training.trainer import Trainer

    out = {}
    for precision, dtype, tol in bounds:
        trainer = Trainer(make_task(dtype), optimizers.sgd(0.0),
                          policy=Policy.from_name(precision), device="cuda")
        state = trainer.create_state()
        params = list(state.params.values())
        batch = trainer.policy.cast_to_compute(to_device(host, "cuda"))
        got, loss_k, _ = trainer._microbatch_grads(params, batch, None)
        with _plain_kernels():
            want, loss_p, _ = trainer._microbatch_grads(params, batch, None)
        worst, worst_name = 0.0, ""
        for name, a, b in zip(state.params, got, want):
            rel = ((a.float() - b.float()).norm()
                   / b.float().norm().clamp_min(1e-30)).item()
            if rel > worst:
                worst, worst_name = rel, name
        log(f"  grads {label} {precision}: loss kernels {loss_k.item():.6f}"
            f" plain {loss_p.item():.6f}; worst leaf {worst_name} relative "
            f"L2 {worst:.3e} (bound {tol}) {'ok' if worst <= tol else 'FAIL'}")
        if not worst <= tol:
            raise AssertionError(f"{label} {precision} grads: {worst_name} "
                                 f"differs by {worst:.3e} > {tol}")
        out[precision] = dict(worst_leaf=worst_name, worst_rel_l2=worst,
                              bound=tol)
        del trainer, state, params, got, want
        torch.cuda.empty_cache()
    return out


def phase_grad_check() -> dict:
    """(a) llama_125m cut to 2 layers, b 8 x s 2048.  f32: the same math
    in other orders; bf16: the kernels and the plain versions round at
    other places (p, dS, the norms' outputs)."""
    import dataclasses

    import torch
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS, CausalLmTask)

    src = SyntheticLM(num_examples=64, seq_len=2048, vocab_size=32_000)
    host = next(iter(HostBatches(src, 8, seed=SEED)))
    return _grad_check(
        "llama_125m[2 layers]",
        lambda dtype: CausalLmTask(dataclasses.replace(
            LLAMA_PRESETS["llama_125m"], num_layers=2, dtype=dtype),
            device="meta"), host,
        (("float32", torch.float32, 1e-4),
         ("bfloat16", torch.bfloat16, 3e-2)))


def phase_moe_grad_check() -> dict:
    """(a) moe_370m with gmm cut to 2 layers, b 8 x s 1024.  f32: other
    summation orders (1e-4).  bf16: besides the roundings at other
    places, a token whose top-2 choice is a near-tie may go to another
    expert on one side: each such row moves ~1/sqrt(rows an expert) of
    that expert's gradient, so the bound is 0.1."""
    import dataclasses

    import torch
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models.moe import (
        MOE_PRESETS, MoeLmTask)

    src = SyntheticLM(num_examples=64, seq_len=1024, vocab_size=32_000)
    host = next(iter(HostBatches(src, 8, seed=SEED)))
    return _grad_check(
        "moe_370m[2 layers] gmm",
        lambda dtype: MoeLmTask(dataclasses.replace(
            MOE_PRESETS["moe_370m"], num_layers=2, dispatch="gmm",
            dtype=dtype), device="meta"), host,
        (("float32", torch.float32, 1e-4),
         ("bfloat16", torch.bfloat16, 1e-1)))


def _card_vs_cpu(label, make_task, cfg, kernels, *, seq=None, vocab=None,
                 steps, source=None) -> dict:
    """``steps`` f32 steps of ``make_task()`` on the card against the same
    steps of the port on the CPU, whose plain versions the CPU tests hold
    to the JAX package, over ``source`` (default: ``SyntheticLM`` rows of
    ``seq`` tokens); every kernel in ``kernels`` must have run, and the
    model state (BatchNorm's running statistics) must agree as the
    params do."""
    import torch
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.training import (
        optimizers, schedules)
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy)
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer, TrainerConfig)

    params = convert.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 device="cpu", dtype=torch.float32)
    runs = {}
    for device in ("cpu", "cuda"):
        lr = schedules.by_name("warmup_cosine", 3e-3, steps, warmup_steps=1)
        tx = optimizers.make_optimizer("adamw", lr, weight_decay=0.01,
                                       grad_clip_norm=1.0)
        trainer = Trainer(make_task(), tx, policy=Policy.from_name("float32"),
                          config=TrainerConfig(log_every=1,
                                               log_grad_norm=True),
                          lr_schedule=lr, device=device)
        state = trainer.create_state({k: v.clone() for k, v in
                                      params.items()})
        K.reset_launch_counts()
        src = source or SyntheticLM(num_examples=64, seq_len=seq,
                                    vocab_size=vocab)
        state, history = trainer.fit(HostBatches(src, 8, seed=SEED),
                                     steps=steps, state=state)
        runs[device] = (history, {k: p.detach().cpu() for k, p in
                                  state.params.items()},
                        K.launch_counts(),
                        {k: v.cpu() for k, v in state.model_state.items()})
    counts = {k: runs["cuda"][2][k] for k in kernels}
    if counts and min(counts.values()) <= 0:
        raise AssertionError(f"{label}: a kernel did not run: {counts}")
    dl = max(abs(a["loss"] - b["loss"]) for (_, a), (_, b) in
             zip(runs["cpu"][0], runs["cuda"][0]))
    dg = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
             for (_, a), (_, b) in zip(runs["cpu"][0], runs["cuda"][0]))
    card = {**runs["cuda"][1], **runs["cuda"][3]}
    dp = max(((card[k] - p).norm() / p.norm()).item()
             for k, p in {**runs["cpu"][1], **runs["cpu"][3]}.items())
    losses = [(a["loss"], b["loss"]) for (_, a), (_, b) in
              zip(runs["cpu"][0], runs["cuda"][0])]
    log(f"  {label} card vs cpu, {steps} steps f32: losses {losses}")
    # f32 on both sides, other kernels and summation orders, carried
    # through five adamw steps.
    ok = dl <= 1e-4 and dg <= 1e-3 and dp <= 1e-4
    log(f"  max |loss diff| {dl:.3e} (bound 1e-4), grad_norm relative "
        f"{dg:.3e} (1e-3), params and model state relative L2 {dp:.3e} "
        f"(1e-4); launches "
        f"{counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the card's training run left the "
                             f"CPU's")
    return dict(max_loss_diff=dl, grad_norm_rel=dg, params_rel_l2=dp,
                launches=counts)


def phase_card_vs_cpu(steps: int = 5) -> dict:
    """(b) A llama_tiny-width decoder with 64-wide heads (so the flash
    kernel takes it; GQA 2:1) at f32 and seq 128."""
    import dataclasses

    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS, CausalLmTask)

    cfg = dataclasses.replace(LLAMA_PRESETS["llama_tiny"], num_heads=2,
                              num_kv_heads=1, head_dim=64, remat=True)
    return _card_vs_cpu("llama_tiny[hd 64]",
                        lambda: CausalLmTask(cfg, device="meta"), cfg,
                        TRAIN_KERNELS, seq=128, vocab=256, steps=steps)


def phase_moe_card_vs_cpu(steps: int = 5) -> dict:
    """(b) moe_tiny_lm_gmm (f32, seq 32: its attention takes the plain
    path, the grouped matmuls the kernels)."""
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.models.moe import MoeLmTask

    entry = registry.get_entry("moe_tiny_lm_gmm")
    cfg = entry["config"]
    return _card_vs_cpu("moe_tiny_lm_gmm",
                        lambda: MoeLmTask(cfg, device="meta"), cfg,
                        ["gmm", "tgmm"],
                        seq=entry["dataset_kwargs"]["seq_len"],
                        vocab=entry["dataset_kwargs"]["vocab_size"],
                        steps=steps)


# -- phase 7 ------------------------------------------------------------------


def _routed_sizes(gen, tokens, d, experts, top_k):
    """[E] int32 group sizes of a top-k routing of ``tokens`` random
    tokens through a random f32 router, rows padded to 128 on the last
    expert (``models/moe.py``'s pad)."""
    import torch

    x = torch.randn(tokens, d, generator=gen, device="cuda")
    w = torch.randn(d, experts, generator=gen, device="cuda") / d ** 0.5
    top = torch.topk(torch.softmax(x @ w, -1), top_k).indices.reshape(-1)
    sizes = torch.zeros(experts, dtype=torch.int64, device="cuda")
    sizes.scatter_add_(0, top, torch.ones_like(top))
    m = tokens * top_k
    sizes[-1] += -(-m // 128) * 128 - m
    return sizes.to(torch.int32)


def _library_ms(fn, **timing):
    """``device_ms`` of a library call, or None where the call does not
    take these operands (``F.grouped_mm`` wants bf16)."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"  library call refused: {str(e).splitlines()[0][:160]}")
        return None
    return device_ms(fn, **timing)


def _gmm_case(gen, label, kind, m, k, n, sizes, *, timing=None,
              timed=True, old_body=False, want_body=None) -> dict:
    """One grouped matmul as the MoE step runs it, for a forward product
    of width k -> n over ``sizes`` (``near``: where ``F.grouped_mm``
    cannot compute the function itself, its nearest call, timed as a
    yardstick and kept out of ``library_ms``):

    - ``fwd``: gmm, lhs [m, k] bf16 x rhs [E, k, n] bf16 -> [m, n] f32
      (tensor cores, depth k);
    - ``grad_lhs``: gmm, cotangent [m, n] f32 x the same rhs read
      transposed -> [m, k] bf16 (f32 math, depth n);
    - ``tgmm``: grad_rhs, lhs [m, k] bf16 (read as [k, m]) x cotangent
      [m, n] f32 -> [E, k, n] bf16 (f32 math, depth: each group's rows).

    Held against the f32 computation within ``K.gmm_tolerance``, and
    against the plain version within that plus the plain version's own
    distance from the f32 values.  Two controls show the bound is tight
    enough to catch a wrong kernel: the plain result with 32 of one
    group's summed products left out, and, for the f32-math products, the
    kernel run with the cotangent rounded to bf16 (the tensor-core
    path).  Each must fall outside the bound.

    The bound of the f32 products is that of the route the "wgmma" body
    takes: three bf16 tensor-core products (the f32 operand split
    exactly into three bf16 terms), 3 x 2mkn at 989 TFLOP/s, or the
    bytes; the FMA route's 2mkn at 67 TFLOP/s is logged beside it.
    ``old_body``: also time, forced, the older body these operands took
    before the "wgmma" body ("mma.sync" for bf16 x bf16, "FMA" for the
    f32 products).  ``want_body``: the body the library must choose."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    e = sizes.shape[0]
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    offs = torch.cumsum(sizes, 0).to(torch.int32)
    spans = K._group_spans(sizes, m)
    g0, lo, hi = max(spans, key=lambda sp: sp[2] - sp[1])  # largest group
    near = None
    if kind in ("fwd", "grad_lhs"):
        w = randn(e, k, n)
    if kind == "fwd":
        a, depth, out_dtype = randn(m, k), k, torch.float32
        run = lambda b=None: K.gmm_forward(a, w, sizes, out_dtype, False,
                                           body=b)
        body = K.gmm_body(a, w, False)
        plain = lambda aa, ww, dt: K.gmm_reference(
            aa, ww, sizes, preferred_element_type=dt)
        lib = lambda: F.grouped_mm(a, w, offs=offs, out_dtype=out_dtype)
        # The library's nearest call: the same products, bf16 output.
        near = lambda: F.grouped_mm(a, w, offs=offs)
        operands, flops = (a, w), 2 * int(sizes.sum()) * k * n
        bf16_control = None
    elif kind == "grad_lhs":
        a, depth, out_dtype = randn(m, n, dtype=torch.float32), n, bf
        run = lambda b=None: K.gmm_forward(a, w, sizes, out_dtype, True,
                                           body=b)
        body = K.gmm_body(a, w, True)
        plain = lambda aa, ww, dt: K.gmm_reference(
            aa, ww, sizes, preferred_element_type=dt, transpose_rhs=True)
        lib = lambda: F.grouped_mm(a, w.transpose(1, 2), offs=offs,
                                   out_dtype=out_dtype)
        operands, flops = (a, w), 2 * int(sizes.sum()) * k * n
        bf16_control = lambda: K.gmm_forward(a.to(bf), w, sizes, bf, True)
    else:
        x = randn(m, k)
        w = randn(m, n, dtype=torch.float32)        # the cotangent
        a, out_dtype = x, bf
        depth = torch.tensor([end - start for _, start, end in spans],
                             dtype=torch.float32, device="cuda")[:, None, None]
        run = lambda b=None: K.tgmm_forward(x, w, sizes, out_dtype, body=b)
        body = K.tgmm_body(x, w)
        plain = lambda aa, ww, dt: K.tgmm_reference(
            aa.t(), ww, sizes, preferred_element_type=dt)
        lib = lambda: F.grouped_mm(x.t(), w, offs=offs, out_dtype=out_dtype)
        operands, flops = (x, w), 2 * m * k * n
        bf16_control = lambda: K.tgmm_forward(x, w.to(bf), sizes, bf)
    tensor_cores = all(t.dtype == bf for t in operands)
    if want_body is not None and body != want_body:
        raise AssertionError(f"{kind} {label}: body {body}, expected "
                             f"{want_body}")
    got = run()
    ref32 = plain(*operands, torch.float32)
    sumsq32 = plain(*(t.float() ** 2 for t in operands), torch.float32)
    ref = plain(*operands, out_dtype)
    torch.cuda.synchronize()
    rule = (f"K.gmm_tolerance, {'tensor cores' if tensor_cores else 'f32'}"
            f"{', bf16 output' if out_dtype == bf else ''}")
    allowed = K.gmm_tolerance(got, ref32, sumsq32, depth, tensor_cores)
    _check(f"{kind} {label} vs f32", got, ref32, allowed, rule)
    err = _check(f"{kind} {label} vs its plain version", got, ref,
                 (ref.float() - ref32).abs() + allowed,
                 "|plain - ref32| + the above")
    controls, ratios = {}, {}
    if timed and hi - lo >= 32:
        # 32 products of group g0's sums left out.
        cut = [operands[0].clone(), operands[1]]
        if kind == "tgmm":
            cut[0][lo:lo + 32] = 0
        else:
            cut[0][lo:hi, :32] = 0
        controls["dropped 32 products"] = plain(*cut, out_dtype)
        del cut
    if timed and bf16_control is not None:
        controls["bf16 cotangent"] = bf16_control()
    for what, bad in controls.items():
        worst = _worst_ratio(bad, ref32, K.gmm_tolerance(
            bad, ref32, sumsq32, depth, tensor_cores))
        log(f"  control {kind} {label}, {what}: worst |err| / allowed "
            f"{worst:.3g} {'rejected' if worst > 1 else 'ACCEPTED'}")
        if not worst > 1:
            raise AssertionError(f"{kind} {label}: the bound accepts a "
                                 f"result with {what}")
        ratios[what] = worst
    del controls, sumsq32, ref32, allowed
    nbytes = (sum(t.numel() * t.element_size() for t in operands)
              + got.numel() * got.element_size() + 4 * e)
    bnd, fma_bnd = product_bound(nbytes, flops, not tensor_cores)
    shape = (f"{label}: m {m}, {k} -> {n}, E {e}, "
             f"{' x '.join(str(t.dtype)[6:] for t in operands)} -> "
             f"{str(out_dtype)[6:]}")
    old = "mma.sync" if tensor_cores else "FMA"
    row = dict(case=label, kind=kind, shape=shape, body=body,
               max_abs_err=err, ms=None, plain_ms=None, bound_ms=bnd[0],
               bound_by=bnd[1],
               fma_bound_ms=None if fma_bnd is None else fma_bnd[0],
               library_ms=None, near_library_ms=None,
               old_body=old if old_body else None, old_body_ms=None,
               control_worst_ratio=ratios)
    if timed:
        timing = timing or {}
        row.update(ms=device_ms(run, **timing),
                   old_body_ms=(device_ms(lambda: run(old), **timing)
                                if old_body else None),
                   plain_ms=device_ms(lambda: plain(*operands, out_dtype),
                                      **timing),
                   library_ms=_library_ms(lib, **timing))
        if near is not None and row["library_ms"] is None:
            row["near_library_ms"] = _library_ms(near, **timing)
        lib_txt = ("refused" if row["library_ms"] is None
                   else f"{row['library_ms'] * 1e3:.1f} us")
        if row["near_library_ms"] is not None:
            lib_txt += (f"; with a bf16 output "
                        f"{row['near_library_ms'] * 1e3:.1f} us")
        old_txt = (f", {old} body {row['old_body_ms'] * 1e3:.1f} us"
                   if old_body else "")
        fma_txt = ("" if fma_bnd is None else
                   f"; the FMA route's bound {fma_bnd[0] * 1e3:.1f} us")
        log(f"  {kind} {shape}: {body} body {row['ms'] * 1e3:.1f} us "
            f"({flops / row['ms'] / 1e9:.1f} TFLOP/s){old_txt}, bound "
            f"{bnd[0] * 1e3:.1f} us ({bnd[1]}"
            f"{'' if tensor_cores else ', three bf16 products'}{fma_txt}), "
            f"plain {row['plain_ms'] * 1e3:.1f} us, F.grouped_mm {lib_txt}")
    del got, ref
    torch.cuda.empty_cache()
    return row


def phase_moe_kernels() -> tuple:
    """gmm and tgmm against their plain versions at the MoE shapes.
    Returns (rows of the kernels' JSON line, every case's record)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cases = []
    # moe_370m: 8 x 1024 tokens, top-2 of 8 experts; the FFN's two widths.
    sizes = _routed_sizes(gen, 8 * 1024, 768, 8, 2)
    log(f"  moe_370m group sizes {sizes.tolist()}")
    for kind in ("fwd", "grad_lhs", "tgmm"):
        for k, n in ((768, 2048), (2048, 768)):
            cases.append(_gmm_case(gen, f"moe_370m {k}->{n}", kind, 16384,
                                   k, n, sizes, old_body=True,
                                   want_body="wgmma"))
    # Mixtral-8x7B: 4096 tokens x top-2 of 8, 4096 -> 14336 (962 GFLOP a
    # call: few timed launches).
    sizes = _routed_sizes(gen, 4096, 4096, 8, 2)
    for kind in ("fwd", "grad_lhs", "tgmm"):
        cases.append(_gmm_case(gen, "mixtral_8x7b", kind, 8192, 4096, 14336,
                               sizes, timing=dict(launches=2, repeats=3,
                                                  warmup=1),
                               want_body="wgmma"))
    # Qwen1.5-MoE-A2.7B: 2048 tokens x top-4 of 60, 2048 -> 1408.
    sizes = _routed_sizes(gen, 2048, 2048, 60, 4)
    for kind in ("fwd", "grad_lhs", "tgmm"):
        cases.append(_gmm_case(gen, "qwen15_moe_a27b", kind, 8192, 2048,
                               1408, sizes, timing=dict(launches=10),
                               want_body="wgmma"))
    # Edge cases: empty and ragged groups, k and n off the tiles, rows
    # past the sizes' sum (the kernel writes zeros there).
    for sizes_l, k, n in (([0, 37, 0, 200, 40], 72, 100),
                          ([300, 0], 200, 40), ([1, 0, 0], 16, 8)):
        sizes = torch.tensor(sizes_l, dtype=torch.int32, device="cuda")
        for kind in ("fwd", "grad_lhs", "tgmm"):
            _gmm_case(gen, f"edge {sizes_l}", kind, 320, k, n, sizes,
                      timed=False)
    rows = {"gmm": next(c for c in cases if c["kind"] == "fwd"),
            "tgmm": next(c for c in cases if c["kind"] == "tgmm")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {k: {f: v[f] for f in keys} for k, v in rows.items()}, cases


# -- phase 8 ------------------------------------------------------------------


def moe_launches_per_step(cfg) -> dict:
    """Kernel launches of one MoE training step under full remat: the
    decoder's (``train_launches_per_step``), plus for each MoE layer
    three gmm in the forward, three again in the recompute and three
    grad_lhs gmm, and three tgmm (grad_rhs) in the backward."""
    n_moe = -(-cfg.num_layers // cfg.moe_every)
    out = train_launches_per_step(cfg.num_layers)
    out.update(gmm=9 * n_moe, tgmm=3 * n_moe)
    return out


def phase_moe_train(steps: int = 20, log_every: int = 5) -> tuple:
    """The trainer on moe_370m with dispatch "gmm" at full width and depth,
    fed as ``tools/bench_moe.py`` feeds the JAX trainer: ``MoeLmTask``,
    adamw(1e-4, b1 0.9, b2 0.95, weight decay 0.1), bf16 compute over f32
    params, ``SyntheticLM`` 8 x 1024 at vocab 32000, random weights from
    seed 0.  Counts are zeroed just before ``fit`` and read just after."""
    import dataclasses
    import math

    import torch
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models.moe import (
        MOE_PRESETS, MoeLmTask)
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy)
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer, TrainerConfig)

    cfg = dataclasses.replace(MOE_PRESETS["moe_370m"], dispatch="gmm")
    b, s = 8, 1024
    drains = _drain_stamps(log_every)
    trainer = Trainer(
        MoeLmTask(cfg, device="meta"),
        optimizers.adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.1),
        policy=Policy.from_name("bfloat16"),
        config=TrainerConfig(seed=SEED, log_every=log_every,
                             log_grad_norm=True), device="cuda",
        callbacks=[drains])
    state = trainer.create_state()
    batches = HostBatches(SyntheticLM(seq_len=s, vocab_size=cfg.vocab_size),
                          b, seed=SEED)
    torch.cuda.synchronize()
    stamps = drains.times

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = trainer.fit(batches, steps=steps, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts()[k] for k in MOE_TRAIN_KERNELS}
    others = {k: v for k, v in K.launch_counts().items()
              if k not in MOE_TRAIN_KERNELS and v}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for _, m in history]
    for step, m in history:
        log(f"  step {step}: loss {m['loss']:.4f} ce {m['ce_loss']:.4f} "
            f"aux {m['aux_loss']:.4f} accuracy {m['accuracy']:.4f} "
            f"grad_norm {m['grad_norm']:.3f} expert load "
            f"{m['expert_load_min']:.3f}-{m['expert_load_max']:.3f}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    first = statistics.mean(losses[:log_every])
    last = statistics.mean(losses[-log_every:])
    if not last < first:
        raise AssertionError(f"loss did not fall: first window {first}, "
                             f"last {last}")
    want = {k: steps * v for k, v in moe_launches_per_step(cfg).items()}
    log(f"  launches {counts} (expected {want}); others {others}")
    if counts != want or others:
        raise AssertionError(f"MoE training launches {counts}, others "
                             f"{others}; expected {want}")
    windows = [(t1 - t0_) / log_every for t0_, t1 in zip(stamps, stamps[1:])]
    step_s = statistics.median(windows) if windows else wall / steps
    tokens = b * s
    n_expert = sum(p.numel() for k, p in state.params.items()
                   if ".experts." in k)
    n_dense = state.num_params() - n_expert
    active = n_dense + n_expert * cfg.top_k / cfg.num_experts
    flops_per_token = 6 * active + 12 * cfg.num_layers * cfg.d_model * s * 0.5
    stats = dict(
        config="moe_370m", dispatch="gmm", steps=steps, batch=b, seq=s,
        params=state.num_params(), active_params=int(active),
        step_ms=step_s * 1e3, window_ms_per_step=[w * 1e3 for w in windows],
        tokens_per_s=tokens / step_s, peak_mem_gib=peak / 2 ** 30,
        wall_s=wall, losses=losses, first_window_loss=first,
        last_window_loss=last,
        mfu=flops_per_token * tokens / step_s / PEAK_BF16_FLOPS,
        mfu_formula="(6 (N_dense + N_expert k / E) + 12 L d S / 2) tokens"
                    " / step_s / 989e12 (tools/bench_moe.py)")
    stats["profile"] = _profile_train_step(trainer, state, batches)
    log(f"  moe training: {json.dumps(stats)}")
    return counts, stats


# -- phase 9 ------------------------------------------------------------------


def _flex_ms(q, k, v, window, sinks, do):
    """Forward and backward times of ``flex_attention`` (compiled; the
    compile is not timed) with a sliding-window block mask on the same
    inputs, or (None, None) where it does not compile here."""
    import torch

    try:
        import torch._inductor.config as inductor_config
        from torch.nn.attention.flex_attention import (
            create_block_mask, flex_attention)

        inductor_config.compile_threads = 1     # no worker processes

        def band(b, h, qi, ki):
            return (qi >= ki) & ((qi - ki < window) | (ki < sinks))

        s = q.shape[2]
        block = create_block_mask(band, B=None, H=None, Q_LEN=s, KV_LEN=s,
                                  device="cuda")
        flex = torch.compile(flex_attention)
        t0 = time.perf_counter()
        ql, kl, vl = _leaf(q, k, v)
        out = flex(ql, kl, vl, block_mask=block, scale=1.0)
        torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)
        torch.cuda.synchronize()
        log(f"  flex_attention compiled in {time.perf_counter() - t0:.1f} s")
        fwd = device_ms(lambda: flex(q, k, v, block_mask=block, scale=1.0),
                        launches=10)
        return fwd, _backward_ms(out, (ql, kl, vl), do, launches=10)
    except Exception as e:          # any failure to build is "not run"
        log(f"  flex_attention not run: {type(e).__name__}: "
            f"{str(e).splitlines()[0][:160] if str(e) else ''}")
        return None, None


def _splash_case(gen, label, b, h, kvh, s, d, window, sinks, *, packed,
                 dtype, timed=False) -> dict:
    """K7 forward and backward (the launch functions, on the pre-scaled
    query) on [B, H, S, D] views of [B, S, H, D] storage, held against an
    f32 computation of the same function and against the plain version;
    with ``timed``, timed beside the bound, the plain version,
    ``local_attention_chunked``, SDPA with the band as a boolean mask and
    ``flex_attention``."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import attention as TA
    from tensorflow_train_distributed_torch.ops import kernels as K

    def bshd(heads):
        return torch.randn(b, s, heads, d, generator=gen, device="cuda").to(
            dtype).transpose(1, 2)

    q, k, v, do = bshd(h), bshd(kvh), bshd(kvh), bshd(h)
    seg = _segments(gen, b, s) if packed else None
    qs = K.splash_scaled_q(q, d ** -0.5)
    o, lse = K.splash_attention_forward(qs, k, v, seg, window, sinks)
    dq, dk, dv = K.splash_attention_backward(qs, k, v, o, lse, do, seg,
                                             window, sinks)
    ref, pairs = _flash_f32(qs, k, v, do, True, seg, 1.0, window=window,
                            sinks=sinks)
    qp, kp, vp = _leaf(qs, k, v)
    op = K.splash_attention_reference(qp, kp, vp, window=window,
                                      sinks=sinks, segment_ids=seg,
                                      sm_scale=1.0)
    gp = torch.autograd.grad(op, (qp, kp, vp), do, retain_graph=True)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    # bf16: as K2 (_flash_case): the kernel rounds p before p.v, dS before
    # its products, reads o in bf16 and rounds its outputs, each at most
    # 2^-8 of a value, so 2^-7 (|ref32| + |terms|).  f32: other summation
    # orders over up to S terms, 2^-14 of the same.  Against the plain
    # version, its measured distance from ref32 on top.
    unit = 2 ** -7 if bf16 else 2 ** -14
    errs = {}
    tag = (f"splash {label} {'bf16' if bf16 else 'f32'}")
    for name, got, plain in (("out", o, op), ("dq", dq, gp[0]),
                             ("dk", dk, gp[1]), ("dv", dv, gp[2])):
        r32 = ref[name]
        allowed = unit * (r32.abs() + ref[name + "_t"]) + 1e-6
        rule = f"2^{-7 if bf16 else -14} (|ref32| + |terms|) + 1e-6"
        _check(f"{tag} {name} vs f32", got, r32, allowed, rule)
        errs[name] = _check(f"{tag} {name} vs plain", got, plain,
                            (plain.float() - r32).abs() + allowed,
                            "|plain - ref32| + the above")
    del ref
    if window >= s:
        # Nothing but causality is masked: K2's causal kernels, bit for bit.
        o2, lse2 = K.flash_attention_forward(qs, k, v, seg, True, 1.0)
        g2 = K.flash_attention_backward(qs, k, v, o2, lse2, do, seg, True,
                                        1.0)
        same = all(torch.equal(a, c) for a, c in
                   zip((o, lse, dq, dk, dv), (o2, lse2, *g2)))
        log(f"  {tag}: window {window} >= S {s}, equal to K2 causal bit for "
            f"bit: {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{tag}: differs from K2's causal output")
    row = dict(case=label, dtype=str(dtype)[6:], shape=dict(
        b=b, h=h, kvh=kvh, s=s, d=d, window=window, sinks=sinks,
        packed=packed), pairs=pairs, max_abs_err=errs["out"],
        max_abs_err_bwd=max(errs["dq"], errs["dk"], errs["dv"]))
    if not timed:
        return row
    elem = q.element_size()
    in_bytes = (q.numel() + k.numel() + v.numel()) * elem
    fwd_bytes = in_bytes + o.numel() * elem + lse.numel() * 4
    bwd_bytes = (in_bytes + 2 * o.numel() * elem + lse.numel() * 4
                 + (dq.numel() + dk.numel() + dv.numel()) * elem)
    rep = h // kvh
    kr, vr = (t.repeat_interleave(rep, 1) for t in (k, v))
    mask = K.splash_mask(s, window, sinks, "cuda")
    if seg is not None:
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                              scale=1.0)

    def chunked(qq, kk, vv):
        return TA.local_attention_chunked(qq, kk, vv, window=window,
                                          segment_ids=seg, sinks=sinks,
                                          softmax_scale=1.0)

    fb = product_bound(fwd_bytes, 4 * d * pairs, not bf16)[0]
    bb = product_bound(bwd_bytes, 10 * d * pairs, not bf16)[0]
    row.update(
        ms=device_ms(lambda: K.splash_attention_forward(
            qs, k, v, seg, window, sinks), launches=10),
        plain_ms=device_ms(lambda: K.splash_attention_reference(
            qs, k, v, window=window, sinks=sinks, segment_ids=seg,
            sm_scale=1.0), launches=3),
        bound_ms=fb[0], bound_by=fb[1],
        library_ms=device_ms(lambda: sdpa(qs, kr, vr), launches=10),
        bwd_ms=device_ms(lambda: K.splash_attention_backward(
            qs, k, v, o, lse, do, seg, window, sinks), launches=10),
        plain_bwd_ms=_backward_ms(op, (qp, kp, vp), do, launches=3),
        bwd_bound_ms=bb[0], bwd_bound_by=bb[1])
    del op, gp
    ql, kl, vl = _leaf(qs, kr, vr)
    row["library_bwd_ms"] = _backward_ms(sdpa(ql, kl, vl), (ql, kl, vl), do,
                                         launches=10)
    if s % window == 0:
        row["chunked_ms"] = device_ms(lambda: chunked(qs, kr, vr),
                                      launches=3)
        ql, kl, vl = _leaf(qs, kr, vr)
        row["chunked_bwd_ms"] = _backward_ms(chunked(ql, kl, vl),
                                             (ql, kl, vl), do, launches=3)
    del ql, kl, vl
    torch.cuda.empty_cache()
    row["flex_ms"], row["flex_bwd_ms"] = (
        _flex_ms(qs, kr, vr, window, sinks, do) if seg is None
        else (None, None))
    shape = (f"B {b} H {h} KVH {kvh} S {s} D {d} window {window} sinks "
             f"{sinks}{' packed' if packed else ''} {row['dtype']}")

    def us(x):
        return "not run" if x is None else f"{x * 1e3:.1f} us"

    row["body"] = K.flash_attention_body(dtype, d)
    log(f"  splash_attention {shape}: kernel {us(row['ms'])} "
        f"({row['body']} body, {4 * d * pairs / row['ms'] / 1e9:.1f} "
        f"TFLOP/s), bound "
        f"{us(fb[0])} ({fb[1]}), plain {us(row['plain_ms'])}, chunked "
        f"{us(row.get('chunked_ms'))}, SDPA (mask) {us(row['library_ms'])}"
        f", flex {us(row['flex_ms'])}")
    log(f"  splash_attention_bwd {shape}: kernel {us(row['bwd_ms'])} "
        f"({row['body']} body, {10 * d * pairs / row['bwd_ms'] / 1e9:.1f} "
        f"TFLOP/s), bound "
        f"{us(bb[0])} ({bb[1]}), plain {us(row['plain_bwd_ms'])}, chunked "
        f"{us(row.get('chunked_bwd_ms'))}, SDPA (mask) "
        f"{us(row['library_bwd_ms'])}, flex {us(row['flex_bwd_ms'])}")
    log(f"  splash {label}: {pairs} visible (query, key) pairs")
    return row


def phase_window_kernels() -> tuple:
    """K7 against its plain version: Mistral-7B's attention (the JSON
    line's shape), packed rows with sinks, and the edge cases at small
    sizes in f32 and bf16.  Returns (rows of the kernels' JSON line, every
    case's record)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    bf, f32 = torch.bfloat16, torch.float32
    main = _splash_case(gen, "mistral_7b head", 1, 32, 8, 8192, 128, 4096, 0,
                        packed=False, dtype=bf, timed=True)
    torch.cuda.empty_cache()
    cases = [main, _splash_case(gen, "packed sinks", 2, 16, 4, 4096, 128,
                                1024, 4, packed=True, dtype=bf, timed=True)]
    torch.cuda.empty_cache()
    # window 1 (the diagonal), windows off the tile (100, 4095, and 129
    # and 4096 at S 4224, which cut the wgmma body's 128-row kv tiles),
    # sinks = window, sinks past one tile, window >= S (K2's causal
    # output), packed rows whose boundaries fall inside the band, GQA 4:1
    # and 1:1, head_dim 64/128.
    for dtype in (bf, f32):
        for args, kw in (
                (("window 1", 1, 4, 1, 1024, 64, 1, 0), {}),
                (("window 100", 2, 4, 4, 512, 128, 100, 0), dict(
                    packed=True)),
                (("window 4095", 1, 2, 2, 4096, 64, 4095, 0), {}),
                (("window 129", 1, 4, 2, 512, 128, 129, 0), {}),
                (("window 4096 S 4224", 1, 4, 1, 4224, 64, 4096, 0), {}),
                (("sinks 130", 2, 4, 2, 1024, 64, 300, 130), dict(
                    packed=True)),
                (("sinks = window", 1, 8, 2, 1024, 128, 200, 200), {}),
                (("window >= S", 2, 4, 2, 512, 64, 600, 0), dict(
                    packed=True))):
            cases.append(_splash_case(gen, *args, dtype=dtype,
                                      packed=kw.get("packed", False)))
        torch.cuda.empty_cache()
    fwd = {f: main[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}
    bwd = dict(max_abs_err=main["max_abs_err_bwd"], ms=main["bwd_ms"],
               plain_ms=main["plain_bwd_ms"], bound_ms=main["bwd_bound_ms"],
               bound_by=main["bwd_bound_by"],
               library_ms=main["library_bwd_ms"])
    return {"splash_attention": fwd, "splash_attention_bwd": bwd}, cases


# -- phases 10 and 10b --------------------------------------------------------


def window_launches_per_step(num_layers: int) -> dict:
    """Kernel launches of one windowed training step under full remat: the
    decoder's, with the splash kernel in the flash kernel's place."""
    out = train_launches_per_step(num_layers)
    out["splash_attention"] = out.pop("flash_attention")
    out["splash_attention_bwd"] = out.pop("flash_attention_bwd")
    return out


def phase_window_train(steps: int = 10, log_every: int = 2,
                       num_layers: int = 4) -> tuple:
    """The trainer on mistral_7b_lm at full width, cut to ``num_layers``
    layers, through the CLI's own construction (``train.make_trainer``):
    b 8 x s 8192, window 4096, bf16 compute over f32 params, adamw + clip
    1.0 + warmup_cosine, random weights from seed 0.  Counts are zeroed
    just before ``fit`` and read just after.

    The loss that must fall is the first batch's: its step-1 loss (the
    initial weights) against its loss under the trained weights.  The
    step losses themselves move with the batch (SyntheticLM rows repeat
    with periods from 4 to 8192 tokens), by more than ten steps move
    them.  A batch the run does not see is read before and after, and
    reported."""
    import math

    import torch
    from tensorflow_train_distributed_torch import train as T
    from tensorflow_train_distributed_torch.data.pipeline import to_device
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.ops import kernels as K

    name = "mistral_7b_lm"
    args = T.build_parser().parse_args(
        ["--config", name, "--steps", str(steps), "--seed", str(SEED),
         "--log-every", str(log_every), "--log-grad-norm", "--device",
         "cuda"])
    entry = registry.get_entry(name)
    cfg = dataclasses.replace(entry["config"], num_layers=num_layers)
    entry = dict(entry, config=cfg)
    drains = _drain_stamps(log_every)
    task, trainer, batches = T.make_trainer(args, entry, callbacks=[drains])
    state = trainer.create_state()
    order = iter(batches)
    first = next(order)
    for _ in range(steps - 1):
        next(order)
    unseen = next(order)

    def batch_loss(host):
        with torch.no_grad():
            loss, _ = task.loss_fn(trainer.policy.cast_to_compute(
                to_device(host, "cuda")))
        return loss.item()

    unseen_before = batch_loss(unseen)
    torch.cuda.synchronize()
    stamps = drains.times

    kernels = list(window_launches_per_step(num_layers))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = trainer.fit(batches, steps=steps, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts()[k] for k in kernels}
    others = {k: v for k, v in K.launch_counts().items()
              if k not in kernels and v}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for _, m in history]
    for step, m in history:
        log(f"  step {step}: loss {m['loss']:.4f} accuracy "
            f"{m['accuracy']:.4f} lr {m['lr']:.3e} grad_norm "
            f"{m['grad_norm']:.3f}")
    first_after, unseen_after = batch_loss(first), batch_loss(unseen)
    log(f"  first batch: loss {losses[0]:.4f} at step 1, {first_after:.4f}"
        f" trained; a batch the run did not see: {unseen_before:.4f} -> "
        f"{unseen_after:.4f}")
    if not all(math.isfinite(x) for x in losses + [first_after]):
        raise AssertionError(f"non-finite loss: {losses}, {first_after}")
    if not first_after < losses[0]:
        raise AssertionError(f"the first batch's loss did not fall: "
                             f"{losses[0]} -> {first_after}")
    want = {k: steps * v for k, v in
            window_launches_per_step(num_layers).items()}
    log(f"  launches {counts} (expected {want}); others {others}")
    if counts != want or others:
        raise AssertionError(f"windowed training launches {counts}, others "
                             f"{others}; expected {want} and no flash "
                             f"attention")
    windows = [(b - a) / log_every for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(windows) if windows else wall / steps
    b, s = entry["global_batch_size"], entry["dataset_kwargs"]["seq_len"]
    w = cfg.sliding_window
    tokens = b * s
    n_params = state.num_params()
    n_dense = n_params - cfg.vocab_size * cfg.d_model    # no embedding
    keys = sum(min(i + 1, w) for i in range(s)) / s    # mean visible keys
    flops = (6 * n_dense + 12 * num_layers * cfg.d_model * keys) * tokens
    stats = dict(
        config=name, num_layers=num_layers, steps=steps, batch=b, seq=s,
        window=w, params=n_params, step_ms=step_s * 1e3,
        window_ms_per_step=[x * 1e3 for x in windows],
        tokens_per_s=tokens / step_s, peak_mem_gib=peak / 2 ** 30,
        wall_s=wall, losses=losses, first_batch_trained_loss=first_after,
        unseen_batch_loss=[unseen_before, unseen_after],
        mean_visible_keys=keys,
        mfu=flops / step_s / PEAK_BF16_FLOPS,
        mfu_formula=(f"(6 (N - V d) + 12 L d {keys:.1f}) tokens / step_s "
                     f"/ 989e12 ({keys:.1f} = mean visible keys)"))
    stats["profile"] = _profile_train_step(trainer, state, batches)
    log(f"  windowed training: {json.dumps(stats)}")
    return counts, stats


def phase_window_grad_check() -> dict:
    """(a) The phase-10 model cut to 2 layers, at b 1 x s 8192 (the plain
    version's [B, 32, 8192, 8192] f32 scores take 8.6 GB a batch row).
    f32: other summation orders; bf16: the kernels round p, dS and the
    norms' outputs at other places than the plain versions."""
    import torch
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS, CausalLmTask)

    cfg = dataclasses.replace(LLAMA_PRESETS["mistral_7b"], num_layers=2)
    src = SyntheticLM(num_examples=8, seq_len=8192,
                      vocab_size=cfg.vocab_size)
    host = next(iter(HostBatches(src, 1, seed=SEED)))
    return _grad_check(
        "mistral_7b[2 layers]",
        lambda dtype: CausalLmTask(dataclasses.replace(cfg, dtype=dtype),
                                   device="meta"), host,
        (("float32", torch.float32, 1e-4),
         ("bfloat16", torch.bfloat16, 3e-2)))


def phase_window_card_vs_cpu(steps: int = 5) -> dict:
    """(b) A small windowed decoder: d 256, 4 heads / 2 kv, head_dim 64,
    ffn 512, vocab 256, 2 layers, seq 512, window 128, 4 sinks, full
    remat, f32.  The card runs K7; the CPU runs local_attention_chunked."""
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS, CausalLmTask)

    cfg = dataclasses.replace(
        LLAMA_PRESETS["llama_tiny"], d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, ffn_size=512, num_layers=2,
        sliding_window=128, attention_sinks=4, remat=True)
    return _card_vs_cpu("windowed decoder[w 128, 4 sinks]",
                        lambda: CausalLmTask(cfg, device="meta"), cfg,
                        list(window_launches_per_step(2)), seq=512,
                        vocab=256, steps=steps)


# -- phase 11 -----------------------------------------------------------------


LAUNCH_DIR = "_launch_smoke"      # git-ignored; deleted at the phase's end
LAUNCH_FLAGS = ["--config", "llama_125m_lm", "--steps", "12",
                "--checkpoint-every", "4", "--max-to-keep", "2",
                "--eval-split", "0.001", "--eval-steps", "4",
                "--eval-every", "6", "--log-every", "2", "--seed",
                str(SEED)]
CHAOS_PLAN = "ckpt:save:partial:step=8:attempt=0;step:10:kill9:attempt=0"
# Run (e): phase 6's flags (``phase_train``'s defaults), no checkpoint and
# no evaluation, so its step time compares with phase 6's.
PHASE6_FLAGS = ["--config", "llama_125m_lm", "--steps", "20", "--seed",
                str(SEED), "--log-every", "5", "--log-grad-norm"]


def eval_launches_per_batch(num_layers: int) -> dict:
    """Kernel launches of one evaluation batch: the forward alone."""
    return {"flash_attention": num_layers, "rms_norm": 2 * num_layers + 1,
            "cross_entropy": 1}


def _launcher(label, *flags, env=None, timeout=600):
    """One launcher process; (returncode, stdout JSON lines, stderr, the
    ``launch summary`` of its log or None, wall seconds)."""
    import os

    e = dict(os.environ)
    e.pop("TTD_FAULT_PLAN", None)
    e.pop("TTD_SUPERVISE_ATTEMPT", None)
    e.update(env or {})
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch",
         *flags], env=e, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    summary = None
    for x in proc.stderr.splitlines():
        if "launch summary: " in x:
            summary = json.loads(x.split("launch summary: ", 1)[1])
    log(f"  ({label}) exit {proc.returncode} in {wall:.1f} s")
    return proc.returncode, lines, proc.stderr, summary, wall


def _file_digest(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def phase_launcher() -> tuple:
    """Phase 11 (the module docstring): the launcher's runs (a)-(e) on
    llama_125m_lm; returns (run (a)'s kernel launches, the stats)."""
    import os
    import shutil

    from tensorflow_train_distributed_torch.models import registry

    cfg = registry.get_entry("llama_125m_lm")["config"]
    root = os.path.abspath(LAUNCH_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    a_dir, b_dir = os.path.join(root, "a"), os.path.join(root, "b")
    try:
        ra, la, ea, sa, wa = _launcher(
            "a: uninterrupted", *LAUNCH_FLAGS, "--checkpoint-dir", a_dir,
            "--jsonl-log", os.path.join(root, "a.jsonl"))
        if ra != 0 or sa is None:
            raise AssertionError(f"launcher (a) failed:\n{ea[-4000:]}")
        rb, _, eb, _, wb = _launcher(
            "b: torn save at 8, kill -9 at 10", *LAUNCH_FLAGS,
            "--checkpoint-dir", b_dir, "--fault-plan", CHAOS_PLAN)
        if rb != -9:
            raise AssertionError(f"launcher (b) exited {rb}, not by "
                                 f"SIGKILL:\n{eb[-4000:]}")
        rc, lc, ec, sc, wc = _launcher(
            "c: rerun as attempt 1", *LAUNCH_FLAGS, "--checkpoint-dir",
            b_dir, "--fault-plan", CHAOS_PLAN,
            env={"TTD_SUPERVISE_ATTEMPT": "1"})
        if rc != 0 or sc is None:
            raise AssertionError(f"launcher (c) failed:\n{ec[-4000:]}")
        for want in ("restored checkpoint step 4",
                     "data stream resumed at epoch 0, batch 4"):
            if want not in ec:
                raise AssertionError(f"launcher (c) did not log {want!r}")
        if not os.path.isdir(os.path.join(b_dir, "corrupt", "8")):
            raise AssertionError("launcher (c) did not quarantine step 8")
        digests = {}
        for name in ("tensors.bin", "manifest.json"):
            da = _file_digest(os.path.join(a_dir, "12", name))
            dc = _file_digest(os.path.join(b_dir, "12", name))
            if da != dc:
                raise AssertionError(f"resumed step-12 {name} differs from "
                                     f"the uninterrupted run's")
            digests[name] = da
        val_a = [x for x in la if "val_loss" in x]
        val_c = [x for x in lc if "val_loss" in x]
        if [x["step"] for x in val_a] != [6, 12] or val_c != val_a:
            raise AssertionError(f"evaluations differ: {val_a} vs {val_c}")
        if la[-1].get("eval") != lc[-1].get("eval"):
            raise AssertionError(f"final evaluations differ: {la[-1]} vs "
                                 f"{lc[-1]}")
        rd, ld, ed, sd, wd = _launcher(
            "d: --eval-only on (a)", *LAUNCH_FLAGS, "--checkpoint-dir",
            a_dir, "--eval-only")
        if rd != 0 or ld != [{"step": 12, "eval": la[-1]["eval"]}]:
            raise AssertionError(f"eval-only gave {ld}, (a) "
                                 f"{la[-1]}:\n{ed[-4000:]}")
        re_, le, ee, se, we = _launcher("e: phase 6's flags",
                                        *PHASE6_FLAGS)
        if re_ != 0 or se is None or se["step"] != 20:
            raise AssertionError(f"launcher (e) failed:\n{ee[-4000:]}")
        losses = [x["loss"] for x in la if "loss" in x]
        losses_e = [x["loss"] for x in le if "loss" in x]
        if not all(math.isfinite(x) for x in losses + losses_e):
            raise AssertionError(f"non-finite launcher loss: {losses}, "
                                 f"{losses_e}")
        counts = {k: sa["launches"].get(k, 0) for k in LAUNCH_KERNELS}
        others = {k: v for k, v in sa["launches"].items()
                  if k not in LAUNCH_KERNELS}
        want = {k: 12 * v for k, v in
                train_launches_per_step(cfg.num_layers).items()}
        for k, v in eval_launches_per_batch(cfg.num_layers).items():
            want[k] += 3 * 4 * v           # 3 evaluations of 4 batches
        log(f"  launches {counts} (expected {want}); others {others}")
        if counts != want or others:
            raise AssertionError(f"launcher launches {counts}, others "
                                 f"{others}; expected {want}")
        stats = dict(
            card=smi_line(), config="llama_125m_lm", steps=12,
            step_ms=sa["step_ms"],
            window_ms_per_step=sa["window_ms_per_step"],
            resumed_step_ms=sc["step_ms"], eval_s=sa["eval_s"],
            save_s=sa["save_s"] + sc["save_s"],
            save_bytes=sa["save_bytes"], restore=sc["restore"],
            eval_only_restore=sd["restore"], eval_only_eval_s=sd["eval_s"],
            phase6_flags_step_ms=se["step_ms"],
            phase6_flags_window_ms_per_step=se["window_ms_per_step"],
            wall_s=dict(a=wa, b=wb, c=wc, d=wd, e=we), val=val_a,
            eval=la[-1]["eval"], step12_sha256=digests, losses=losses)
        log(f"  launcher: {json.dumps(stats)}")
        return counts, stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phases 12-17: the other model families -----------------------------------

FAMILY_DIR = "_family_smoke"      # git-ignored; deleted at the phases' end
KILL_AT_15 = "step:15:kill9:attempt=0"
BERT_FLAGS = ["--config", "bert_base_mlm", "--steps", "20", "--precision",
              "mixed_bfloat16", "--checkpoint-every", "10", "--max-to-keep",
              "2", "--eval-split", "0.011", "--eval-steps", "4",
              "--log-every", "5", "--seed", str(SEED)]
# Registry batch 512 cut to 64 for one card; seq 256 so that attention
# meets K2's gate; the noam multiplier and warm-up set so 20 steps train
# (the registry's warm-up 0 starts Adam at 0.0625).
WMT_FLAGS = ["--config", "transformer_big_wmt", "--dataset-kwarg",
             "seq_len=256", "--global-batch-size", "64", "--steps", "20",
             "--learning-rate", "0.2", "--warmup-steps", "20",
             "--log-every", "5", "--seed", str(SEED)]
WMT_BLEU_FLAGS = ["--eval-only", "--eval-steps", "1", "--bleu-eval", "1",
                  "--beam-size", "4", "--global-batch-size", "8"]
# Registry batch 1024 cut to 256 for one card; SGD with Nesterov
# momentum, which the registry's lr 0.4 is for (the launcher's default
# adamw at 0.4 diverges).
RESNET_FLAGS = ["--config", "resnet50_imagenet", "--global-batch-size",
                "256", "--optimizer", "momentum", "--steps", "20",
                "--checkpoint-every", "10", "--max-to-keep", "2",
                "--log-every", "5", "--seed", str(SEED)]
# ResNet-50 v1.5's published forward cost: 4.09e9 multiply-adds a
# 224x224 image (torchvision's resnet50, which is v1.5), 2 FLOPs each.
RESNET50_FWD_FLOPS = 2 * 4.09e9


def bert_launches(num_layers: int, steps: int, eval_batches: int) -> dict:
    """K2 and K3 launches of ``steps`` BERT training steps and
    ``eval_batches`` evaluation batches: one full-attention forward a
    layer (and its backward in training), one fused loss."""
    n = num_layers
    return {"flash_attention": n * (steps + eval_batches),
            "flash_attention_bwd": n * steps,
            "cross_entropy": steps + eval_batches,
            "cross_entropy_bwd": steps}


def wmt_launches(cfg, steps: int, eval_batches: int = 0,
                 bleu_batches: int = 0, max_len: int = 0) -> dict:
    """K2 launches of the Transformer: a forward is the encoder's
    full self-attention, the decoder's causal self-attention and its
    cross-attention, each layer; beam decoding runs the encoder once a
    batch and the decoder at each of ``max_len`` positions.  The
    label-smoothed loss takes no K3."""
    e, d = cfg.num_encoder_layers, cfg.num_decoder_layers
    fwd = e + 2 * d
    return {"flash_attention": fwd * (steps + eval_batches)
            + bleu_batches * (e + 2 * d * max_len),
            "flash_attention_bwd": fwd * steps}


def _non_embedding_params(cfg) -> int:
    from tensorflow_train_distributed_torch import convert

    return sum(math.prod(shape) for name, shape in
               convert.expected_shapes(cfg).items()
               if not name.endswith(("embedding", "pos_embedding"))
               and "batch_stats" not in name)


def _expect_launches(label, summary, want) -> dict:
    got = {k: summary["launches"].get(k, 0) for k in want}
    others = {k: v for k, v in summary["launches"].items() if k not in want}
    log(f"  {label} launches {got} (expected {want}); others {others}")
    if got != want or others:
        raise AssertionError(f"{label}: launches {got}, others {others}; "
                             f"expected {want}")
    return got


def _same_checkpoint(label, a_dir, c_dir, step) -> None:
    """The rerun's step checkpoint must equal the uninterrupted run's,
    bit for bit."""
    import os

    for f in ("tensors.bin", "manifest.json"):
        if (_file_digest(os.path.join(a_dir, str(step), f))
                != _file_digest(os.path.join(c_dir, str(step), f))):
            raise AssertionError(f"{label}: the resumed step-{step} {f} "
                                 f"differs from the uninterrupted run's")
    log(f"  {label}: the resumed step-{step} checkpoint equals the "
        f"uninterrupted run's bit for bit")


def _kill_and_resume(label, flags, root) -> tuple:
    """(a) the run, (b) the same killed at step 15 after the step-10 save,
    (c) its rerun as supervisor attempt 1, which must restore step 10;
    returns ((a), (c)) as ``_launcher`` results and the two directories."""
    import os

    a_dir, b_dir = os.path.join(root, "a"), os.path.join(root, "b")
    ra = _launcher(f"{label} a: uninterrupted", *flags, "--checkpoint-dir",
                   a_dir)
    if ra[0] != 0 or ra[3] is None:
        raise AssertionError(f"{label} (a) failed:\n{ra[2][-4000:]}")
    rb = _launcher(f"{label} b: kill -9 at step 15", *flags,
                   "--checkpoint-dir", b_dir, "--fault-plan", KILL_AT_15)
    if rb[0] != -9:
        raise AssertionError(f"{label} (b) exited {rb[0]}, not by SIGKILL:"
                             f"\n{rb[2][-4000:]}")
    rc = _launcher(f"{label} c: rerun as attempt 1", *flags,
                   "--checkpoint-dir", b_dir, "--fault-plan", KILL_AT_15,
                   env={"TTD_SUPERVISE_ATTEMPT": "1"})
    if rc[0] != 0 or rc[3] is None:
        raise AssertionError(f"{label} (c) failed:\n{rc[2][-4000:]}")
    if "restored checkpoint step 10" not in rc[2]:
        raise AssertionError(f"{label} (c) did not restore step 10")
    return ra, rc, a_dir, b_dir


def _losses(label, lines) -> list:
    losses = [x["loss"] for x in lines if "loss" in x]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    return losses


def _run_stats(label, summary, batch, wall) -> dict:
    step_s = summary["step_ms"] / 1e3
    stats = dict(step_ms=summary["step_ms"],
                 window_ms_per_step=summary["window_ms_per_step"],
                 examples_per_s=batch / step_s,
                 peak_mem_gib=summary["peak_mem_bytes"] / 2 ** 30,
                 save_s=summary["save_s"], eval_s=summary["eval_s"],
                 wall_s=wall)
    log(f"  {label}: {stats['step_ms']:.1f} ms a step, "
        f"{stats['examples_per_s']:.1f} examples/s, peak "
        f"{stats['peak_mem_gib']:.2f} GiB")
    return stats


def phase_family_kernels() -> tuple:
    """Phase 12: K2 full attention at BERT-base's (B 256, H 12, S 128) and
    Transformer-big's (B 64, H 16, S 256) heads (D 64), f32 as both
    models compute and bf16, and causal f32 at the Transformer's; K3f and
    K3b at BERT's logits [32768, 30522] f32, at an odd vocabulary and at
    LeNet's [128, 10].  Returns the "bert", "wmt" and "mnist" rows of the
    kernels' JSON line."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    f32 = torch.float32
    bert = _flash_case(gen, "bert_base", 256, 12, 12, 128, 64,
                       packed=False, main=True, causal=False, dtype=f32)
    torch.cuda.empty_cache()
    _flash_case(gen, "bert_base bf16", 256, 12, 12, 128, 64, packed=False,
                main=False, causal=False)
    torch.cuda.empty_cache()
    wmt = _flash_case(gen, "transformer_big", 64, 16, 16, 256, 64,
                      packed=False, main=True, causal=False, dtype=f32)
    torch.cuda.empty_cache()
    _flash_case(gen, "transformer_big bf16", 64, 16, 16, 256, 64,
                packed=False, main=False, causal=False)
    _flash_case(gen, "transformer_big decoder", 64, 16, 16, 256, 64,
                packed=False, main=False, causal=True, dtype=f32)
    torch.cuda.empty_cache()
    bert.update(_cross_entropy_cases(gen, 32768, 30522))
    torch.cuda.empty_cache()
    for name, row in _cross_entropy_cases(gen, 32768, 30521).items():
        CASES.append(dict(row, kernel=name, case="[32768, 30521] f32"))
    torch.cuda.empty_cache()
    return bert, wmt, _cross_entropy_cases(gen, 128, 10)


def phase_bert() -> tuple:
    """Phase 13: bert_base_mlm through the launcher at full width and
    depth (b 256 x s 128, mixed_bfloat16, 20 steps, a save every 10,
    4 held-out evaluation batches), then killed at step 15 and rerun: the
    rerun's step-20 checkpoint must equal the uninterrupted run's bit for
    bit (dropout 0.1 is on, so this holds the (seed, step) generator)."""
    import os
    import shutil

    from tensorflow_train_distributed_torch.models import registry

    entry = registry.get_entry("bert_base_mlm")
    cfg = entry["config"]
    root = os.path.abspath(os.path.join(FAMILY_DIR, "bert"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        ra, rc, a_dir, b_dir = _kill_and_resume("bert", BERT_FLAGS, root)
        _same_checkpoint("bert", a_dir, b_dir, 20)
        la, lc = ra[1], rc[1]
        if la[-1].get("eval") != lc[-1].get("eval"):
            raise AssertionError(f"bert evaluations differ: {la[-1]} vs "
                                 f"{lc[-1]}")
        losses = _losses("bert", la)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"bert loss did not fall: {losses}")
        counts = _expect_launches("bert", ra[3],
                                  bert_launches(cfg.num_layers, 20, 4))
        b, s = entry["global_batch_size"], 128
        stats = _run_stats("bert_base_mlm", ra[3], b, ra[4])
        n_ne = _non_embedding_params(cfg)
        flops = (6 * n_ne + 12 * cfg.num_layers * s * cfg.hidden_size) \
            * b * s
        step_s = stats["step_ms"] / 1e3
        stats.update(
            card=smi_line(), config="bert_base_mlm", batch=b, seq=s,
            non_embedding_params=n_ne, losses=losses, eval=la[-1]["eval"],
            resume="bitwise", resumed_step_ms=rc[3]["step_ms"],
            restore=rc[3]["restore"], save_bytes=ra[3]["save_bytes"],
            mfu=flops / step_s / PEAK_F32_SPLIT_FLOPS,
            mfu_fma=flops / step_s / PEAK_F32_FLOPS,
            mfu_formula="(6 N_non_embedding + 12 L S d) B S / step_s / "
                        "(989e12 / 3) (the config computes in f32: its "
                        "products as an exact three-way bf16 split; "
                        "mfu_fma at 67e12)")
        stats["device_fed"] = _device_fed(
            "bert_base_mlm", ["--precision", "mixed_bfloat16"],
            profile=True)
        log(f"  bert: {json.dumps(stats)}")
        return counts, stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_wmt() -> tuple:
    """Phase 14: transformer_big_wmt through the launcher at full width
    and depth (b 64 x s 256, bf16 policy over its f32 compute, 20 steps,
    a save at the end), then ``--eval-only`` beam search (beam 4, GNMT
    penalty) of one batch of 8 and its BLEU."""
    import os
    import shutil

    from tensorflow_train_distributed_torch.models import registry

    cfg = registry.get_entry("transformer_big_wmt")["config"]
    root = os.path.abspath(os.path.join(FAMILY_DIR, "wmt"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        ra = _launcher("wmt a: 20 steps", *WMT_FLAGS, "--checkpoint-dir",
                       root)
        if ra[0] != 0 or ra[3] is None:
            raise AssertionError(f"wmt (a) failed:\n{ra[2][-4000:]}")
        counts = _expect_launches("wmt", ra[3], wmt_launches(cfg, 20))
        losses = _losses("wmt", ra[1])
        if not losses[-1] < losses[0]:
            raise AssertionError(f"wmt loss did not fall: {losses}")
        rb = _launcher("wmt b: --eval-only, beam 4 BLEU", *WMT_FLAGS,
                       *WMT_BLEU_FLAGS, "--checkpoint-dir", root)
        if rb[0] != 0 or rb[3] is None:
            raise AssertionError(f"wmt (b) failed:\n{rb[2][-4000:]}")
        ev = rb[1][-1]["eval"]
        if not (math.isfinite(ev["loss"]) and 0.0 <= ev["bleu"] <= 100.0):
            raise AssertionError(f"wmt evaluation: {ev}")
        bleu_counts = _expect_launches("wmt bleu", rb[3], wmt_launches(
            cfg, 0, eval_batches=1, bleu_batches=1, max_len=256))
        b, s = 64, 256
        stats = _run_stats("transformer_big_wmt", ra[3], b, ra[4])
        n_ne = _non_embedding_params(cfg)
        d, le, ld = cfg.d_model, cfg.num_encoder_layers, \
            cfg.num_decoder_layers
        # Each parameter meets one token of its stream (source for the
        # encoder, target for the decoder): 6 N B S; the tied logits 6 d V
        # a target token; attention 12 S d a layer and token, the
        # decoder's causal self-attention half of it.
        flops = (6 * n_ne + 6 * d * cfg.vocab_size
                 + 12 * s * d * (le + 0.5 * ld + ld)) * b * s
        step_s = stats["step_ms"] / 1e3
        stats.update(
            card=smi_line(), config="transformer_big_wmt", batch=b, seq=s,
            tokens_per_s=b * s / step_s, non_embedding_params=n_ne,
            losses=losses, eval=ev, bleu_s=rb[3]["bleu_s"],
            bleu_launches=bleu_counts, restore=rb[3]["restore"],
            mfu=flops / step_s / PEAK_F32_SPLIT_FLOPS,
            mfu_fma=flops / step_s / PEAK_F32_FLOPS,
            mfu_formula="(6 N_non_embedding + 6 d V + 12 S d (L_enc + "
                        "1.5 L_dec)) B S / step_s / (989e12 / 3) (f32 "
                        "compute, as for bert; mfu_fma at 67e12)")
        stats["device_fed"] = _device_fed(
            "transformer_big_wmt", WMT_FLAGS[2:12], profile=True)
        log(f"  wmt: {json.dumps(stats)}")
        return counts, stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _device_fed(name: str, flags, *, steps: int = 10,
                profile: bool = False) -> dict:
    """The trainer of registry entry ``name``, built as the launcher
    builds it from ``flags``, on one batch already on the card: the step
    time without the host's data (ResNet's synthetic images take ~1.5 ms
    each to make); with ``profile``, one more step under torch.profiler."""
    import torch
    from tensorflow_train_distributed_torch import launch
    from tensorflow_train_distributed_torch.data.pipeline import to_device
    from tensorflow_train_distributed_torch.models import registry

    args = launch.build_parser().parse_args(
        ["--config", name, *flags, "--device", "cuda"])
    entry = registry.get_entry(name)
    torch.backends.cudnn.deterministic = True      # as the launcher runs
    torch.backends.cudnn.benchmark = False
    _, trainer, loader = launch.make_trainer(args, entry)
    state = trainer.create_state()
    host = next(iter(loader))
    batch = to_device(host, "cuda")
    for _ in range(2):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    b = next(iter(host.values())).shape[0]
    out = dict(step_ms=step_s * 1e3, examples_per_s=b / step_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               loss=float(m["loss"]))
    if profile:
        out["profile"] = _profile_train_step(trainer, state, [host])
    log(f"  {name} device-fed: {json.dumps(out)}")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return out


def phase_resnet() -> dict:
    """Phase 15: resnet50_imagenet through the launcher (224², b 256,
    bf16, SGD with momentum, 20 steps, a save every 10), killed at step
    15 and rerun (the launcher pins cuDNN's deterministic algorithms, so
    the step-20 checkpoints must be equal bit for bit), 5 steps each of
    the s2d and s2d_bnsub variants, and each of the three trainers fed
    one batch already on the card."""
    import os
    import shutil

    root = os.path.abspath(os.path.join(FAMILY_DIR, "resnet"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        ra, rc, a_dir, b_dir = _kill_and_resume("resnet", RESNET_FLAGS,
                                                root)
        _same_checkpoint("resnet", a_dir, b_dir, 20)
        _expect_launches("resnet", ra[3], {})
        losses = _losses("resnet", ra[1])
        stats = _run_stats("resnet50_imagenet", ra[3], 256, ra[4])
        stats.update(card=smi_line(), config="resnet50_imagenet", batch=256,
                     losses=losses, resume="bitwise",
                     resumed_step_ms=rc[3]["step_ms"],
                     save_bytes=ra[3]["save_bytes"],
                     mfu=3 * RESNET50_FWD_FLOPS * 256 / (
                         stats["step_ms"] / 1e3) / PEAK_BF16_FLOPS,
                     mfu_formula="3 x 2 x 4.09e9 x B / step_s / 989e12")
        for name in ("resnet50_imagenet_s2d", "resnet50_imagenet_s2d_bnsub"):
            r = _launcher(name, "--config", name, *RESNET_FLAGS[2:6],
                          "--steps", "5", "--log-every", "1", "--seed",
                          str(SEED))
            if r[0] != 0 or r[3] is None:
                raise AssertionError(f"{name} failed:\n{r[2][-4000:]}")
            _expect_launches(name, r[3], {})
            stats[name] = dict(_run_stats(name, r[3], 256, r[4]),
                               losses=_losses(name, r[1]))
        stats["device_fed"] = {
            name: _device_fed(name, RESNET_FLAGS[2:6],
                              profile=name == "resnet50_imagenet")
            for name in ("resnet50_imagenet", "resnet50_imagenet_s2d",
                         "resnet50_imagenet_s2d_bnsub")}
        for row in stats["device_fed"].values():
            row["mfu"] = (3 * RESNET50_FWD_FLOPS * row["examples_per_s"]
                          / PEAK_BF16_FLOPS)
        log(f"  resnet: {json.dumps(stats)}")
        return stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_mnist() -> dict:
    """Phase 16: mnist (LeNet) through the launcher, 100 steps of 128:
    the mean loss of the last 10 steps must be at most half the first
    step's.  Its loss (no label smoothing) takes K3 at [128, 10], once a
    step."""
    r = _launcher("mnist", "--config", "mnist", "--steps", "100",
                  "--log-every", "1", "--seed", str(SEED))
    if r[0] != 0 or r[3] is None:
        raise AssertionError(f"mnist failed:\n{r[2][-4000:]}")
    counts = _expect_launches("mnist", r[3], {"cross_entropy": 100,
                                              "cross_entropy_bwd": 100})
    losses = _losses("mnist", r[1])
    last = statistics.mean(losses[-10:])
    log(f"  mnist: loss {losses[0]:.4f} at step 1, mean of the last 10 "
        f"{last:.4f} (must be <= {losses[0] / 2:.4f})")
    if not last <= losses[0] / 2:
        raise AssertionError(f"mnist loss did not halve: {losses}")
    return counts, dict(_run_stats("mnist", r[3], 128, r[4]),
                        first_loss=losses[0], last10_mean_loss=last,
                        card=smi_line())


def phase_family_card_vs_cpu(steps: int = 5) -> dict:
    """Phase 17: five f32 steps on the card against the CPU port: a BERT
    with 64-wide heads at seq 128 (K2 full attention, K3 at an odd vocab
    of 1,001) and resnet_tiny (cuDNN convolutions, K3 at its 10 classes;
    its BatchNorm running statistics held like the params)."""
    import dataclasses

    from tensorflow_train_distributed_torch.data.datasets import (
        SyntheticImageNet,
        SyntheticMLM,
    )
    from tensorflow_train_distributed_torch.models import bert, registry

    bcfg = dataclasses.replace(bert.BERT_PRESETS["bert_tiny"],
                               hidden_size=128, num_heads=2,
                               intermediate_size=256, max_positions=128,
                               vocab_size=1001)
    out = {"bert[hd 64]": _card_vs_cpu(
        "bert_tiny[hd 64]", lambda: bert.BertMlmTask(bcfg, device="meta"),
        bcfg, ["flash_attention", "flash_attention_bwd", "cross_entropy",
               "cross_entropy_bwd"], steps=steps,
        source=SyntheticMLM(num_examples=64, seq_len=128, vocab_size=1001))}
    entry = registry.get_entry("resnet_tiny")
    out["resnet_tiny"] = _card_vs_cpu(
        "resnet_tiny", lambda: registry.make_task(entry, device="meta"),
        entry["config"], ["cross_entropy", "cross_entropy_bwd"],
        steps=steps,
        source=SyntheticImageNet(num_examples=64, num_classes=10,
                                 image_size=32))
    return out


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
    rows = {"serve": phase_kernels()}
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
    torch.cuda.empty_cache()
    log("== phase 5: training kernels against their plain versions")
    train_rows = phase_train_kernels()
    rows["train"] = train_rows["train"]
    log("== phase 6: trainer, llama_125m_lm full width and depth")
    train_counts, training = phase_train()
    torch.cuda.empty_cache()
    log("== phase 6b: gradients against the plain versions; card vs CPU")
    training["grad_check"] = phase_grad_check()
    training["card_vs_cpu"] = phase_card_vs_cpu()
    torch.cuda.empty_cache()
    log("== phase 7: grouped-matmul kernels against their plain versions")
    rows["moe_train"], moe_cases = phase_moe_kernels()
    log("== phase 8: MoE trainer, moe_370m gmm full width and depth")
    moe_counts, moe_training = phase_moe_train()
    torch.cuda.empty_cache()
    log("== phase 8b: MoE gradients against the plain versions; card vs "
        "CPU")
    moe_training["grad_check"] = phase_moe_grad_check()
    moe_training["card_vs_cpu"] = phase_moe_card_vs_cpu()
    torch.cuda.empty_cache()
    log("== phase 9: splash kernel against its plain version")
    rows["window_train"], window_cases = phase_window_kernels()
    rows["window_train"].update(train_rows["window_train"])
    log("== phase 10: windowed trainer, mistral_7b_lm full width, 4 layers")
    window_counts, window_training = phase_window_train()
    torch.cuda.empty_cache()
    log("== phase 10b: windowed gradients against the plain versions; card "
        "vs CPU")
    window_training["grad_check"] = phase_window_grad_check()
    window_training["card_vs_cpu"] = phase_window_card_vs_cpu()
    torch.cuda.empty_cache()
    log("== phase 11: the launcher, llama_125m_lm: run, kill -9, resume, "
        "eval-only, phase 6's flags")
    launch_counts, launcher = phase_launcher()
    launcher["trainer_step_ms_phase6"] = training["step_ms"]
    rows["launch"] = {k: rows["train"][k] for k in LAUNCH_KERNELS}
    torch.cuda.empty_cache()
    log("== phase 12: K2 full attention and K3 at the new families' shapes")
    rows["bert"], rows["wmt"], rows["mnist"] = phase_family_kernels()
    log("== phase 13: the launcher, bert_base_mlm: run, kill -9, resume")
    families = {}
    bert_counts, families["bert_base_mlm"] = phase_bert()
    log("== phase 14: the launcher, transformer_big_wmt: run, beam BLEU")
    wmt_counts, families["transformer_big_wmt"] = phase_wmt()
    log("== phase 15: the launcher, resnet50_imagenet (s2d, bnsub): run, "
        "kill -9, resume")
    families["resnet50_imagenet"] = phase_resnet()
    log("== phase 16: the launcher, mnist")
    mnist_counts, families["mnist"] = phase_mnist()
    torch.cuda.empty_cache()
    log("== phase 17: bert and resnet_tiny card vs CPU")
    families["card_vs_cpu"] = phase_family_card_vs_cpu()

    paths = {"serve": counts, "train": train_counts,
             "moe_train": moe_counts, "window_train": window_counts,
             "launch": launch_counts, "bert": bert_counts,
             "wmt": wmt_counts, "mnist": mnist_counts}
    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces, path=path, launches=paths[path][name],
                    **rows[path][name])
               for name, source, replaces, path in KERNELS]
    print(json.dumps({"engines": engines}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"moe_training": moe_training}), flush=True)
    print(json.dumps({"moe_kernel_cases": moe_cases}), flush=True)
    print(json.dumps({"window_training": window_training}), flush=True)
    print(json.dumps({"window_kernel_cases": window_cases}), flush=True)
    print(json.dumps({"launcher": launcher}), flush=True)
    print(json.dumps({"families": families}), flush=True)
    print(json.dumps({"kernel_cases": CASES}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
