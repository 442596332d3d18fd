"""Batch-serve mixed-length requests through the port's serving engine.

The offline CLI of ``serving.ServingEngine`` (counterpart of the JAX
package's ``tools/serve.py``, with the flags this slice implements):
every request is collected up front, the engine runs to completion, and
each result is one JSONL line ``{"id", "prompt", "tokens"}`` (tokens =
prompt + continuation); standard error ends with a ``serve summary`` JSON
line (the kernels' launch counts and the engine's host timings).

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

    params = load_params(args, cfg)
    try:
        eng = ServingEngine(
            cfg, params, slots=args.slots, chunk=args.chunk,
            cache_len=args.cache_len or None, eos_id=args.eos_id,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, prefill_chunk=args.prefill_chunk,
            kv_block_size=args.kv_block_size,
            kv_pool_blocks=args.kv_pool_blocks, device=args.device)
        ids = [eng.submit(r["prompt"], r["max_new"], seed=r["seed"])
               for r in reqs]
    except ValueError as e:
        raise SystemExit(str(e))
    out = eng.run()
    print("serve summary: " + json.dumps({
        "launches": {k: v for k, v in K.launch_counts().items() if v},
        **eng.stats}), file=sys.stderr)
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
