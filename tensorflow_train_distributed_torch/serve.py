"""Batch-serve mixed-length requests through the port's serving engine.

The offline CLI of ``serving.ServingEngine`` (counterpart of the JAX
package's ``tools/serve.py``, with the flags this slice implements):
every request is collected up front, the engine runs to completion, and
each result is one JSONL line ``{"id", "prompt", "tokens"}`` (tokens =
prompt + continuation); standard error ends with a ``serve summary`` JSON
line (the kernels' launch counts, the engine's host timings, its
speculative statistics and acceptance rate, its overlap ratio and its
staged-prefill statistics).

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
int8 too.

Weights come from ``--checkpoint-dir`` (the parameters of the newest
checkpoint the port's launcher wrote there, restored without the rest of
the train state), ``--params-npz`` (an ``np.savez`` of the flat flax
parameter dict, ``convert.load_npz``) or, without either, are made at
random from ``--seed`` on the device.  A LoRA checkpoint is served
merged: its ``lora_spec.json`` gives rank, alpha and targets (``--lora-*``
flags that contradict it exit non-zero), the adapters are checked
against it and folded into their kernels (``lora.merge_lora``) before the
engine is built.

  python -m tensorflow_train_distributed_torch.serve --config llama2_7b_sft \\
      --prompt 1,2,3 --prompt 4,5,6,7,8 --max-new 32 --cache-len 1024
  python -m tensorflow_train_distributed_torch.serve --config llama_tiny_sft \\
      --params-npz params.npz --requests reqs.jsonl --device cpu
  python -m tensorflow_train_distributed_torch.serve --config llama_tiny_sft \\
      --checkpoint-dir ck --prompt 1,2,3 --device cpu
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
from tensorflow_train_distributed_torch.ops import kernels as K


def parse_prompt(spec: str) -> list:
    try:
        ids = [int(t) for t in spec.split(",") if t.strip()]
    except ValueError:
        raise SystemExit(f"--prompt must be comma-separated token ids, got "
                         f"{spec!r}")
    if not ids:
        raise SystemExit("--prompt needs at least one token id")
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


def lora_serving_spec(args):
    """The LoRA spec to merge with: the checkpoint's ``lora_spec.json``,
    or the ``--lora-*`` flags, which must agree with it; None for a
    checkpoint without LoRA.  Exits on a contradiction."""
    from tensorflow_train_distributed_torch.models.lora import (
        LoraSpec,
        load_spec,
        validate_targets,
    )

    sidecar = load_spec(args.checkpoint_dir) if args.checkpoint_dir else None
    if (args.lora_alpha is not None or args.lora_targets is not None) \
            and not args.lora_rank:
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


def load_params(args, cfg) -> dict:
    """The served weights (the module docstring), LoRA adapters merged."""
    from tensorflow_train_distributed_torch.models.lora import (
        check_spec_matches,
        merge_lora,
    )
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    if args.checkpoint_dir and args.params_npz:
        raise SystemExit("--checkpoint-dir and --params-npz both name the "
                         "weights; pass one")
    if args.checkpoint_dir:
        params = CheckpointManager(args.checkpoint_dir).restore_params()
        if params is None:
            raise SystemExit(f"no checkpoint in {args.checkpoint_dir}")
    elif args.params_npz:
        params = convert.load_npz(args.params_npz, cfg)
    else:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        params = convert.init_params(cfg, gen, device=args.device)
    spec = lora_serving_spec(args)
    if spec is not None:
        try:
            check_spec_matches(params, spec)
        except ValueError as e:
            raise SystemExit(str(e))
        params = merge_lora(params, spec)
    return params


def main(argv=None) -> int:
    from tensorflow_train_distributed_torch.serving import ServingEngine

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True,
                   help=f"decoder config: {', '.join(registry.available())}")
    p.add_argument("--params-npz", default="",
                   help="np.savez of the flat flax params (default: random "
                        "weights from --seed)")
    p.add_argument("--checkpoint-dir", default="",
                   help="serve the newest checkpoint the launcher wrote "
                        "here (LoRA adapters merged per its lora_spec.json)")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="the rank the checkpoint's adapters were trained "
                        "with (default: its lora_spec.json)")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--lora-targets", default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights without --params-npz")
    p.add_argument("--prompt", action="append", default=[], metavar="IDS",
                   help="comma-separated token ids; repeat per request")
    p.add_argument("--requests", default="",
                   help="JSONL file: {'prompt': [ids], 'max_new': N, "
                        "'seed': S} per line")
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--cache-len", type=int, default=0,
                   help="0 -> config.max_positions")
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--kv-pool-blocks", type=int, default=None,
                   help="physical KV blocks (default: slots * "
                        "ceil(cache_len / block_size))")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache (per-row f32 scales)")
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
    p.add_argument("--output", default="-",
                   help="output JSONL path ('-' = stdout)")
    args = p.parse_args(argv)

    try:
        cfg = registry.get_config(args.config)
    except ValueError as e:
        raise SystemExit(str(e))
    if not isinstance(cfg, LlamaConfig):
        raise SystemExit(f"{args.config}: MoE serving is not ported yet "
                         f"(it comes with the MoE serving slice)")
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    reqs = [{"prompt": parse_prompt(s), "max_new": args.max_new,
             "seed": None} for s in args.prompt]
    if args.requests:
        reqs += read_requests(args.requests, args.max_new)
    if not reqs:
        raise SystemExit("no requests (--prompt or --requests)")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")

    spec_k, spec_depths = parse_spec_depth_arg(args.spec_depth,
                                               args.speculative_k)
    draft_cfg, draft_params = load_draft(args, cfg)
    if spec_depths is not None and draft_cfg is None:
        raise SystemExit("--spec-depth adaptive needs "
                         "--speculative-draft-config")
    params = load_params(args, cfg)
    try:
        eng = ServingEngine(
            cfg, params, slots=args.slots, chunk=args.chunk,
            cache_len=args.cache_len or None, eos_id=args.eos_id,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, prefill_chunk=args.prefill_chunk,
            draft_config=draft_cfg, draft_params=draft_params,
            speculative_k=spec_k if draft_cfg is not None else 0,
            spec_depths=spec_depths, overlap=not args.no_overlap,
            prefill_budget=0 if args.no_interleave else args.prefill_budget,
            kv_block_size=args.kv_block_size,
            kv_pool_blocks=args.kv_pool_blocks, device=args.device)
        ids = [eng.submit(r["prompt"], r["max_new"], seed=r["seed"])
               for r in reqs]
    except ValueError as e:
        raise SystemExit(str(e))
    out = eng.run()
    summary = {"launches": {k: v for k, v in K.launch_counts().items() if v},
               **eng.stats, "overlap_ratio": eng.overlap_ratio(),
               "prefill_stats": eng.prefill_stats}
    if draft_cfg is not None:
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
