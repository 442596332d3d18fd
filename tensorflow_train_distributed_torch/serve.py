"""Batch-serve mixed-length requests through the port's serving engine.

The offline CLI of ``serving.ServingEngine`` (counterpart of the JAX
package's ``tools/serve.py``): every request is collected up front, the
engine runs to completion, and each result is one JSONL line ``{"id",
"prompt", "tokens"}`` (tokens = prompt + continuation); standard error
ends with a ``serve summary`` JSON line (the kernels' launch counts, the
engine's host timings, its speculative statistics and acceptance rate,
its overlap ratio and its staged-prefill statistics).

The engine pipelines by default: the next decode chunk is dispatched
before the previous one is harvested (``--no-overlap`` turns that off)
and an admitted prompt's prefill advances ``--prefill-budget`` tokens a
step between decode chunks (default one prefill piece; ``--no-interleave``
or ``--prefill-budget 0`` admits atomically).  Outputs are bit for bit
the same either way.  ``--speculative-draft-config`` with
``--speculative-draft-checkpoint`` (a checkpoint of the port's launcher)
serves speculatively: the draft proposes ``--speculative-k`` tokens a slot
and round, and greedy output stays the target's own; ``--spec-depth
adaptive[:K1,K2,...]`` lets the depth follow the measured acceptance and
``--spec-depth fixed:K`` pins it.  With ``--kv-int8`` the draft's KV is
int8 too.  ``--prefix IDS`` preloads a shared system prompt once
(``preload_prefix``); requests that extend it prefill only their suffix.

For online serving (HTTP, admission control, deadlines, streaming,
``/metrics``, replicas) use ``serve_http.py``; its engine flags are this
CLI's (``add_engine_args``, ``build_engine``), and its subprocess and
dial-in workers rebuild the engine from them (``worker_engine_factory``),
so the same requests answer with the same tokens online and offline.

Both decoder families serve.  ``--dispatch {dense,gmm}`` overrides an MoE
config's expert dispatch (one parameter tree serves both): the dropless
``gmm`` keeps bucketed and chunked prefill and prefix caching, while
``dense`` prefills each prompt at its exact length and refuses
``--prefix`` and ``--prefill-chunk`` (``serving``'s docstring; the JAX
CLI's hint about one XLA prefill program per prompt length has no
counterpart in this eager engine).  ``--quant int8`` serves int8
weight-only kernels (``models.quant``), the draft's too.  ``--kv-int8``
is for Llama-family configs.

Weights come from ``--checkpoint-dir`` (the parameters of the newest
checkpoint the port's launcher wrote there, restored without the rest of
the train state), ``--params-npz`` (an ``np.savez`` of the flat flax
parameter dict, ``convert.load_npz``), ``--init-from-hf`` (a local
HuggingFace checkpoint directory, Llama-family or sparse-MoE, read by
``models/import_hf.py`` straight onto the device in the config's dtype;
an MoE import serves at capacity E / k, HF's routing) or, without any of
them, are made at random from ``--seed`` on the device.  A LoRA
checkpoint is served merged: its ``lora_spec.json`` gives rank, alpha and
targets (``--lora-*`` flags that contradict it exit non-zero), the
adapters are checked against it and folded into their kernels
(``lora.merge_lora``) before the engine is built.

``--no-paged-kv`` serves on the per-slot linear cache (same tokens).
``--kv-pool-blocks auto`` solves the pool's size and the engine's
budget from the card's memory less ``--hbm-headroom`` (``serving``'s
docstring); as in the JAX CLI the headroom must also hold the weights and
the CUDA context, which the default 0.1 does not for Llama-2-7B on an
80-GB card.  ``--hbm-budget-bytes`` declares a budget by hand.  Under
``TTD_MEMCHECK=1`` (set before the process starts) the budget is
enforced, and the summary carries the sanitizer's live and peak bytes by
pool beside the pool's size, the budget and, on CUDA, the peak of
allocated memory and the card's total.

  python -m tensorflow_train_distributed_torch.serve --config llama2_7b_sft \\
      --prompt 1,2,3 --prompt 4,5,6,7,8 --max-new 32 --cache-len 1024
  python -m tensorflow_train_distributed_torch.serve --config llama_tiny_sft \\
      --params-npz params.npz --requests reqs.jsonl --device cpu
  python -m tensorflow_train_distributed_torch.serve --config llama_tiny_sft \\
      --checkpoint-dir ck --prompt 1,2,3 --device cpu
  python -m tensorflow_train_distributed_torch.serve --config mixtral_8x7b \\
      --quant int8 --dispatch dense --prompt 1,2,3 --cache-len 1024
  python -m tensorflow_train_distributed_torch.serve --config llama_tiny_sft \\
      --checkpoint-dir ck --speculative-draft-config llama_tiny_sft \\
      --speculative-draft-checkpoint draft_ck --spec-depth adaptive:0,2,4 \\
      --prompt 1,2,3 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.models import registry
from tensorflow_train_distributed_torch.models.llama import LlamaConfig
from tensorflow_train_distributed_torch.models.moe import MoeConfig
from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.runtime.lint import memcheck


def _int_or_auto(v: str):
    """``--kv-pool-blocks`` values: an int, or the literal 'auto'."""
    return v if v == "auto" else int(v)


def parse_prompt(spec: str, flag: str = "--prompt") -> list:
    try:
        ids = [int(t) for t in spec.split(",") if t.strip()]
    except ValueError:
        raise SystemExit(f"{flag} must be comma-separated token ids, got "
                         f"{spec!r}")
    if not ids:
        raise SystemExit(f"{flag} needs at least one token id")
    return ids


def read_requests(path: str, max_new: int) -> list:
    """JSONL ``{"prompt": [ids], "max_new": N?, "seed": S?}`` per line."""
    if not os.path.isfile(path):
        raise SystemExit(f"no requests file at {path}")
    reqs = []
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                prompt = rec["prompt"]
                vals = [*prompt, rec.get("max_new", max_new),
                        rec.get("seed", 0)]
                if (not isinstance(prompt, list) or not prompt
                        or not all(isinstance(v, int)
                                   and not isinstance(v, bool)
                                   for v in vals)):
                    raise ValueError("'prompt' must be a non-empty list of "
                                     "integer ids; max_new/seed integers")
            except (json.JSONDecodeError, KeyError, TypeError,
                    ValueError) as e:
                raise SystemExit(f"{path}:{i + 1}: bad request line ({e})")
            reqs.append({"prompt": prompt,
                         "max_new": rec.get("max_new", max_new),
                         "seed": rec.get("seed")})
    return reqs


def parse_spec_depth_arg(arg: str, fixed_k: int):
    """``--spec-depth`` -> (speculative_k, spec_depths or None): '' keeps
    ``--speculative-k``; 'fixed:K' pins K; 'adaptive' takes the depths
    (0, 2, 4, 8); 'adaptive:K1,K2,...' names them."""
    try:
        if not arg:
            return fixed_k, None
        if arg.startswith("fixed:"):
            return int(arg.split(":", 1)[1]), None
        if arg == "adaptive":
            return fixed_k, (0, 2, 4, 8)
        if arg.startswith("adaptive:"):
            return fixed_k, tuple(int(x)
                                  for x in arg.split(":", 1)[1].split(","))
    except ValueError:
        pass
    raise SystemExit(f"--spec-depth must be 'fixed:K', 'adaptive' or "
                     f"'adaptive:K1,K2,...', got {arg!r}")


def decoder_config(name: str, verb: str):
    """The registry config of a decoder (Llama or MoE family), or
    SystemExit."""
    try:
        cfg = registry.get_config(name)
    except ValueError as e:
        raise SystemExit(str(e))
    if not isinstance(cfg, (LlamaConfig, MoeConfig)):
        raise SystemExit(f"--config {name} is not a decoder LM; {verb} "
                         "needs a llama- or moe-family config")
    return cfg


def apply_dispatch_arg(args, cfg):
    """``--dispatch``, applied to the config before the weights load
    (dense and gmm share one parameter tree)."""
    if not getattr(args, "dispatch", None):
        return cfg
    if not isinstance(cfg, MoeConfig):
        raise SystemExit("--dispatch selects the MoE expert-dispatch "
                         "formulation; it does not apply to dense "
                         "decoder configs")
    return dataclasses.replace(cfg, dispatch=args.dispatch)


def load_draft(args, cfg):
    """(draft config, draft params) for ``--speculative-draft-*``, or
    (None, None).  The draft's KV is int8 when the target's is."""
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    if args.speculative_draft_checkpoint and not \
            args.speculative_draft_config:
        raise SystemExit("--speculative-draft-checkpoint needs "
                         "--speculative-draft-config")
    if not args.speculative_draft_config:
        return None, None
    if not args.speculative_draft_checkpoint:
        raise SystemExit("--speculative-draft-checkpoint is required with "
                         "--speculative-draft-config")
    try:
        draft_cfg = registry.get_config(args.speculative_draft_config)
    except ValueError as e:
        raise SystemExit(str(e))
    if not isinstance(draft_cfg, LlamaConfig):
        raise SystemExit("the draft config must be a llama-family decoder")
    if cfg.kv_cache_int8:
        draft_cfg = dataclasses.replace(draft_cfg, kv_cache_int8=True)
    params = CheckpointManager(
        args.speculative_draft_checkpoint).restore_params()
    if params is None:
        raise SystemExit(f"no checkpoint in "
                         f"{args.speculative_draft_checkpoint}")
    return draft_cfg, params


def lora_serving_spec(args, cfg):
    """The LoRA spec to merge with: the checkpoint's ``lora_spec.json``,
    or the ``--lora-*`` flags, which must agree with it; None for a
    checkpoint without LoRA.  Exits on a contradiction."""
    from tensorflow_train_distributed_torch.models.lora import (
        LoraSpec,
        load_spec,
        validate_targets,
    )

    sidecar = load_spec(args.checkpoint_dir) if args.checkpoint_dir else None
    flags_given = args.lora_alpha is not None or args.lora_targets is not None
    if isinstance(cfg, MoeConfig) and (flags_given or args.lora_rank
                                       or sidecar is not None):
        raise SystemExit(
            "--lora-* applies to llama-family configs only (and this "
            "checkpoint dir carries a lora_spec.json sidecar, which a "
            "MoE config cannot serve)" if sidecar is not None else
            "--lora-* applies to llama-family configs only")
    if flags_given and not args.lora_rank:
        raise SystemExit("--lora-alpha/--lora-targets need --lora-rank too "
                         "(a lone flag would be dropped in favour of the "
                         "checkpoint's lora_spec.json)")
    if not args.lora_rank:
        return sidecar
    try:
        spec = LoraSpec(
            rank=args.lora_rank,
            alpha=16.0 if args.lora_alpha is None else args.lora_alpha,
            targets=validate_targets((args.lora_targets
                                      or "query,value").split(",")))
    except ValueError as e:
        raise SystemExit(str(e))
    if sidecar is not None and spec != sidecar:
        raise SystemExit(f"--lora-* flags {spec} disagree with the "
                         f"checkpoint's lora_spec.json {sidecar}: drop the "
                         "flags (the sidecar is authoritative) or fix them")
    return spec


def _import_hf(args, cfg) -> tuple:
    """(config, params) of ``--init-from-hf``, on ``--device`` in the
    config's dtype; an importer's refusal exits with its message."""
    from tensorflow_train_distributed_torch.models import import_hf

    importer = (import_hf.import_moe if isinstance(cfg, MoeConfig)
                else import_hf.import_llama)
    try:
        return importer(args.init_from_hf, cfg, device=args.device)
    except (ValueError, FileNotFoundError) as e:
        raise SystemExit(str(e))


def load_params(args, cfg) -> tuple:
    """(config, the served weights) (the module docstring), LoRA adapters
    merged; the config is ``cfg``, or the import's for ``--init-from-hf``
    (an MoE import's capacity E / k)."""
    from tensorflow_train_distributed_torch.models.lora import (
        check_spec_matches,
        merge_lora,
    )
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    if sum(map(bool, (args.checkpoint_dir, args.params_npz,
                      args.init_from_hf))) > 1:
        raise SystemExit("--checkpoint-dir, --params-npz and "
                         "--init-from-hf each name the weights; pass one")
    if args.init_from_hf:
        cfg, params = _import_hf(args, cfg)
    elif args.checkpoint_dir:
        params = CheckpointManager(args.checkpoint_dir).restore_params()
        if params is None:
            raise SystemExit(f"no checkpoint in {args.checkpoint_dir}")
    elif args.params_npz:
        params = convert.load_npz(args.params_npz, cfg)
    else:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        params = convert.init_params(cfg, gen, device=args.device)
    spec = lora_serving_spec(args, cfg)
    if spec is not None:
        try:
            check_spec_matches(params, spec)
        except ValueError as e:
            raise SystemExit(str(e))
        params = merge_lora(params, spec)
    return cfg, params


def add_engine_args(p) -> None:
    """The model and engine flags, shared by this CLI, ``serve_http.py``
    and ``serve_worker.py``'s factory (``worker_engine_factory``): one
    definition, so the offline CLI, the online gateway and every worker
    load and configure the engine alike."""
    p.add_argument("--config", required=True,
                   help=f"decoder config: {', '.join(registry.available())}")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--params-npz", default="",
                     help="np.savez of the flat flax params (default: "
                          "random weights from --seed)")
    src.add_argument("--checkpoint-dir", default="",
                     help="serve the newest checkpoint the launcher wrote "
                          "here (LoRA adapters merged per its "
                          "lora_spec.json)")
    src.add_argument("--init-from-hf", default="", metavar="DIR",
                     help="local HuggingFace checkpoint (llama-family or "
                          "sparse-MoE) to serve directly")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="the rank the checkpoint's adapters were trained "
                        "with (default: its lora_spec.json)")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--lora-targets", default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights without --params-npz")
    p.add_argument("--prefix", default="", metavar="IDS",
                   help="comma-separated token ids of a shared prompt "
                        "prefix (a system prompt): prefilled once before "
                        "the requests, and every request that extends it "
                        "prefills only its suffix (preload_prefix)")
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--cache-len", type=int, default=0,
                   help="0 -> config.max_positions")
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--kv-pool-blocks", type=_int_or_auto, default=None,
                   help="paged KV cache: total physical blocks in the "
                        "pool (default: slots * ceil(cache_len / "
                        "block_size) — the linear cache's exact "
                        "memory). Admission is keyed on free blocks: "
                        "shrink to trade memory for queueing, grow to "
                        "serve more/longer shared prefixes warm. "
                        "'auto' solves the pool size AND "
                        "--hbm-budget-bytes exactly from the device's "
                        "reported memory (pool rows + prefill "
                        "transients + draft pools + --hbm-headroom), "
                        "so one binary lands correctly sized on any "
                        "chip; TTD_NO_HBM_AUTOSIZE=1 restores the "
                        "default heuristic")
    p.add_argument("--hbm-headroom", type=float, default=0.1,
                   help="fraction of device memory the autosize solve "
                        "leaves free; only meaningful with "
                        "--kv-pool-blocks auto. The weights, the CUDA "
                        "context and activations live outside the solved "
                        "pools, so the headroom must hold them: the "
                        "default 0.1 of an 80-GB card leaves 8 GB, less "
                        "than Llama-2-7B's 13.5 GB of bf16 weights "
                        "(pass e.g. 0.3 there)")
    p.add_argument("--no-paged-kv", action="store_true",
                   help="serve on the per-slot LINEAR KV cache instead "
                        "of the paged block pool (no cross-request "
                        "prefix sharing beyond --prefix); "
                        "TTD_NO_PAGED_KV=1 is the no-redeploy "
                        "equivalent. Outputs are bitwise-identical "
                        "either way — this is a memory-layout kill "
                        "switch")
    p.add_argument("--hbm-budget-bytes", type=int, default=None,
                   help="declared device-memory budget for the engine's "
                        "memory pools (memcheck): with TTD_MEMCHECK=1, "
                        "the allocation that would exceed it raises "
                        "MemoryBudgetError with the live set diffed "
                        "(instead of an opaque CUDA OOM later), and "
                        "admission refuses requests whose projected "
                        "bytes cannot fit. Default: track-only, no "
                        "enforcement")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache (per-row f32 scales; llama-family "
                        "configs)")
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="'int8': int8 weight-only kernels with per-channel "
                        "scales (models.quant), the draft's too")
    p.add_argument("--dispatch", default="", choices=["", "dense", "gmm"],
                   help="MoE expert-dispatch override (MoE configs only): "
                        "'gmm' is dropless, so its outputs legitimately "
                        "differ from capacity-dropped 'dense', and keeps "
                        "bucketed/chunked prefill and prefix caching; "
                        "'dense' prefills at the exact prompt length and "
                        "refuses --prefix. Default: the config's own")
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--speculative-draft-config", default=None,
                   help="serve speculatively with this registry config as "
                        "the draft (same vocab); greedy output stays the "
                        "target's, sampled output its distribution")
    p.add_argument("--speculative-draft-checkpoint", default=None,
                   help="the draft's weights: a checkpoint directory of "
                        "the port's launcher (its newest checkpoint)")
    p.add_argument("--speculative-k", type=int, default=4,
                   help="draft tokens a slot proposes each round")
    p.add_argument("--spec-depth", default="",
                   help="'fixed:K' pins the depth K; 'adaptive' picks "
                        "among depths 0,2,4,8 each round from the "
                        "measured acceptance, 'adaptive:K1,K2,...' among "
                        "these (TTD_NO_ADAPTIVE_SPEC=1 pins "
                        "--speculative-k)")
    p.add_argument("--no-overlap", action="store_true",
                   help="harvest each decode chunk before dispatching the "
                        "next (TTD_NO_OVERLAP=1 likewise); outputs are "
                        "the same")
    p.add_argument("--prefill-budget", type=int, default=None,
                   help="prefill tokens an admitted prompt advances per "
                        "engine step between decode chunks (default one "
                        "prefill piece; 0 admits atomically)")
    p.add_argument("--no-interleave", action="store_true",
                   help="atomic admission, as --prefill-budget 0 "
                        "(TTD_NO_INTERLEAVE=1 likewise); outputs are the "
                        "same")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the "
                        "kernels' plain versions)")


def engine_config(args):
    """The served config: ``--config`` with ``--dispatch`` and
    ``--kv-int8`` applied."""
    cfg = apply_dispatch_arg(args, decoder_config(args.config, "serving"))
    if args.kv_int8:
        if isinstance(cfg, MoeConfig):
            raise SystemExit("--kv-int8 applies to llama-family configs "
                             "only (MoeConfig has no kv_cache_int8 knob)")
        cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    return cfg


def parse_prefix_arg(args, cfg) -> list:
    """``--prefix`` ids, screened against the vocabulary before any
    weights load."""
    prefix = parse_prompt(args.prefix, "--prefix") if args.prefix else []
    bad = sorted({t for t in prefix if not 0 <= t < cfg.vocab_size})
    if bad:
        raise SystemExit(f"--prefix ids outside vocab [0, "
                         f"{cfg.vocab_size}): {bad[:8]}")
    return prefix


def build_engine(args, cfg, prefix: list):
    """Load the weights (and the draft's), quantize, build the engine and
    preload ``prefix``: shared by this CLI, ``serve_http.py`` and the
    fleet's workers.  A ValueError exits with its message."""
    from tensorflow_train_distributed_torch.serving import ServingEngine

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")
    spec_k, spec_depths = parse_spec_depth_arg(args.spec_depth,
                                               args.speculative_k)
    draft_cfg, draft_params = load_draft(args, cfg)
    if spec_depths is not None and draft_cfg is None:
        raise SystemExit("--spec-depth adaptive needs "
                         "--speculative-draft-config")
    cfg, params = load_params(args, cfg)
    quant_scales = draft_quant_scales = None
    if args.quant == "int8":
        from tensorflow_train_distributed_torch.models.quant import (
            quantize_params,
        )

        # Both models: decode streams both models' weights.
        params, quant_scales = quantize_params(params)
        if draft_params is not None:
            draft_params, draft_quant_scales = quantize_params(draft_params)
    try:
        eng = ServingEngine(
            cfg, params, slots=args.slots, chunk=args.chunk,
            cache_len=args.cache_len or None, eos_id=args.eos_id,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, prefill_chunk=args.prefill_chunk,
            draft_config=draft_cfg, draft_params=draft_params,
            quant_scales=quant_scales, draft_quant_scales=draft_quant_scales,
            speculative_k=spec_k if draft_cfg is not None else 0,
            spec_depths=spec_depths, overlap=not args.no_overlap,
            prefill_budget=0 if args.no_interleave else args.prefill_budget,
            paged=not args.no_paged_kv, kv_block_size=args.kv_block_size,
            kv_pool_blocks=args.kv_pool_blocks,
            hbm_budget_bytes=args.hbm_budget_bytes,
            hbm_headroom=args.hbm_headroom, device=args.device)
        if prefix:
            eng.preload_prefix(prefix)
    except ValueError as e:
        raise SystemExit(str(e))
    return eng


def worker_engine_factory(spec: dict):
    """The fleet's production engine factory (``server.worker`` resolves
    ``tensorflow_train_distributed_torch.serve:worker_engine_factory``):
    ``spec`` is the launcher's parsed flags, serialized (``vars(args)``),
    so every worker replays the flag set the parent screened with.  The
    warm pass (one request of one token) runs before the worker's HELLO:
    the parent's ``wait_ready`` covers it, and the pool's hung-dispatch
    watchdog never times a cold first step (cuBLAS handles, the kernels'
    first load).  Requests are seeded on their own, so the warm pass
    changes no later output."""
    args = argparse.Namespace(**spec)
    cfg = engine_config(args)
    eng = build_engine(args, cfg, parse_prefix_arg(args, cfg))
    eng.submit([1], 1)
    eng.run()
    return eng


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_engine_args(p)
    p.add_argument("--prompt", action="append", default=[], metavar="IDS",
                   help="comma-separated token ids; repeat per request")
    p.add_argument("--requests", default="",
                   help="JSONL file: {'prompt': [ids], 'max_new': N, "
                        "'seed': S} per line")
    p.add_argument("--output", default="-",
                   help="output JSONL path ('-' = stdout)")
    args = p.parse_args(argv)

    cfg = engine_config(args)
    prefix = parse_prefix_arg(args, cfg)
    reqs = [{"prompt": parse_prompt(s), "max_new": args.max_new,
             "seed": None} for s in args.prompt]
    if args.requests:
        reqs += read_requests(args.requests, args.max_new)
    if not reqs:
        raise SystemExit("no requests (--prompt or --requests)")
    eng = build_engine(args, cfg, prefix)
    try:
        ids = [eng.submit(r["prompt"], r["max_new"], seed=r["seed"])
               for r in reqs]
    except ValueError as e:
        raise SystemExit(str(e))
    out = eng.run()
    summary = {"launches": {k: v for k, v in K.launch_counts().items() if v},
               **eng.stats, "overlap_ratio": eng.overlap_ratio(),
               "prefill_stats": eng.prefill_stats,
               "kv_stats": eng.kv_stats, "paged": eng.paged,
               "kv_pool_blocks": eng.kv_blocks_total(),
               "kv_pool_bytes": eng.kv_pool_bytes(),
               "prefill_pair_bytes": eng._prefill_pair_bytes(),
               "hbm_budget_bytes": eng.hbm_budget_bytes,
               "hbm_autosized_bytes": eng.hbm_autosized_bytes(),
               "memcheck": memcheck.armed() and {
                   "live_by_pool": memcheck.live_by_pool(),
                   "peak_by_pool": memcheck.peak_by_pool()}}
    if eng.device.type == "cuda":
        summary.update(
            peak_mem_bytes=torch.cuda.max_memory_allocated(eng.device),
            device_total_bytes=torch.cuda.mem_get_info(eng.device)[1])
    if eng.draft_config is not None:
        s = eng.spec_stats
        summary.update(spec_stats=s, acceptance=(
            s["drafted_accepted"] / s["drafted"] if s["drafted"] else 0.0))
    print("serve summary: " + json.dumps(summary), file=sys.stderr)
    lines = [json.dumps({"id": rid, "prompt": r["prompt"],
                         "tokens": out[rid]}) + "\n"
             for rid, r in zip(ids, reqs)]
    if args.output == "-":
        sys.stdout.writelines(lines)
    else:
        tmp = args.output + ".tmp"
        with open(tmp, "w") as sink:
            sink.writelines(lines)
        os.replace(tmp, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
