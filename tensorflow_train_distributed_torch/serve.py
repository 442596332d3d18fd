"""Batch-serve mixed-length requests through the port's serving engine.

The offline CLI of ``serving.ServingEngine`` (counterpart of the JAX
package's ``tools/serve.py``, with the flags this slice implements):
every request is collected up front, the engine runs to completion, and
each result is one JSONL line ``{"id", "prompt", "tokens"}`` (tokens =
prompt + continuation).

Weights come from ``--params-npz`` (an ``np.savez`` of the flat flax
parameter dict, ``convert.load_npz``) or, without it, are made at random
from ``--seed`` on the device.

  python -m tensorflow_train_distributed_torch.serve --config llama2_7b_sft \\
      --prompt 1,2,3 --prompt 4,5,6,7,8 --max-new 32 --cache-len 1024
  python -m tensorflow_train_distributed_torch.serve --config llama_tiny_sft \\
      --params-npz params.npz --requests reqs.jsonl --device cpu
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


def main(argv=None) -> int:
    from tensorflow_train_distributed_torch.serving import ServingEngine

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True,
                   help=f"decoder config: {', '.join(registry.available())}")
    p.add_argument("--params-npz", default="",
                   help="np.savez of the flat flax params (default: random "
                        "weights from --seed)")
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

    if args.params_npz:
        params = convert.load_npz(args.params_npz, cfg)
    else:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        params = convert.init_params(cfg, gen, device=args.device)
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
