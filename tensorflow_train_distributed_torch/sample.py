"""Sample from a decoder's weights through ``generate()``.

The counterpart of the JAX package's ``tools/sample.py``: weights from
``--checkpoint-dir`` (the parameters of the newest checkpoint the port's
launcher wrote there, LoRA adapters merged per its ``lora_spec.json`` or
the ``--lora-*`` flags, as ``serve.py`` reads it) or ``--params-npz`` (an
``np.savez`` of the flat flax parameter dict), then the KV-cache decode
of ``models.generate`` (greedy, or ``--temperature`` with ``--top-k`` /
``--top-p``, from the counter streams ``--seed`` names), or with
``--speculative-draft-config`` / ``--speculative-draft-checkpoint`` the
batch-1 ``generate_speculative``.  A sliding-window config decodes over
its rolling ring.  MoE configs sample too: ``--dispatch {dense,gmm}``
overrides the expert dispatch (one parameter tree serves both), and
``--quant int8`` samples with int8 weight-only kernels
(``models.quant``).

Prompts are token ids, ``--prompt 1,15043,29892``, repeatable for a batch
of equal-length rows.  Each row prints one JSON line ``{"prompt": [...],
"completion": [...]}`` (speculation prints ``{"speculative_stats": ...}``
first), as the JAX CLI does.  ``--init-from-hf DIR`` samples a local
HuggingFace checkpoint (``serve.py``'s loader, ``models/import_hf.py``).

  python -m tensorflow_train_distributed_torch.sample \\
      --config llama_tiny_sft --checkpoint-dir ck --prompt 1,2,3 \\
      --max-new 32 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tensorflow_train_distributed_torch.models.moe import MoeConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True,
                   help="registry config name (a llama- or moe-family "
                        "preset)")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--checkpoint-dir", default="",
                     help="the newest checkpoint the launcher wrote here")
    src.add_argument("--params-npz", default="",
                     help="np.savez of the flat flax params")
    src.add_argument("--init-from-hf", default="", metavar="DIR",
                     help="local HuggingFace checkpoint (llama-family or "
                          "sparse-MoE)")
    p.add_argument("--prompt", action="append", required=True,
                   metavar="IDS", help="comma-separated token ids; repeat "
                   "for a batch (rows of one length)")
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="names the sampling streams")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="the rank the checkpoint's adapters were trained "
                        "with (default: its lora_spec.json)")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--lora-targets", default=None)
    p.add_argument("--speculative-draft-config", default=None,
                   help="decode speculatively with this registry config "
                        "as the draft (same vocab, batch-1)")
    p.add_argument("--speculative-draft-checkpoint", default=None,
                   help="the draft's weights: a checkpoint directory of "
                        "the port's launcher")
    p.add_argument("--speculative-k", type=int, default=4,
                   help="draft block length per round")
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="'int8': post-training weight-only quantization "
                        "(models.quant) before sampling")
    p.add_argument("--dispatch", default="", choices=["", "dense", "gmm"],
                   help="MoE expert-dispatch override (MoE configs "
                        "only). 'gmm' is DROPLESS — routing, and "
                        "therefore outputs, legitimately differ from "
                        "capacity-dropped 'dense'. Default: the "
                        "config's own setting")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    return p


def main(argv=None) -> int:
    from tensorflow_train_distributed_torch.models.generate import generate
    from tensorflow_train_distributed_torch.models.speculative import (
        generate_speculative,
    )
    from tensorflow_train_distributed_torch.serve import (
        apply_dispatch_arg,
        decoder_config,
        load_draft,
        load_params,
        lora_serving_spec,
        parse_prompt,
    )

    args = build_parser().parse_args(argv)
    cfg = apply_dispatch_arg(args, decoder_config(args.config, "sampling"))
    if not (args.checkpoint_dir or args.params_npz or args.init_from_hf):
        raise SystemExit("the weights: --checkpoint-dir, --params-npz or "
                         "--init-from-hf")
    rows = [parse_prompt(spec) for spec in args.prompt]
    if len({len(r) for r in rows}) != 1:
        raise SystemExit(
            "all --prompt rows must have equal length (the decode path "
            "has no pad masking; run unequal prompts as separate "
            "invocations)")
    if args.temperature == 0 and (args.top_k is not None
                                  or args.top_p is not None):
        raise SystemExit(
            "--top-k/--top-p filter a sampling distribution; add "
            "--temperature > 0 (they have no effect on greedy argmax)")
    bad = sorted({t for r in rows for t in r
                  if not 0 <= t < cfg.vocab_size})
    if bad:
        raise SystemExit(f"prompt ids outside vocab [0, {cfg.vocab_size}): "
                         f"{bad[:8]}")
    if args.max_new < 1:
        raise SystemExit(f"--max-new must be >= 1, got {args.max_new}")
    if len(rows[0]) + args.max_new > cfg.max_positions:
        raise SystemExit(
            f"prompt {len(rows[0])} + --max-new {args.max_new} exceeds the "
            f"config's max_positions={cfg.max_positions} (the KV cache)")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")
    if args.speculative_draft_config:
        if args.quant or lora_serving_spec(args, cfg) is not None:
            raise SystemExit(
                "--speculative-draft-config does not compose with "
                "--quant or LoRA serving (merge first).  Sampling DOES "
                "compose: with --temperature the draft samples its "
                "proposals and acceptance uses the rejection rule, so "
                "outputs follow the same law as plain sampled decoding")
        if isinstance(cfg, MoeConfig):
            raise SystemExit("speculative decoding needs a llama-family "
                             "TARGET --config")
        if len(rows) != 1:
            raise SystemExit("speculative decoding is batch-1: pass ONE "
                             "--prompt")
    draft_cfg, draft_params = load_draft(args, cfg)
    cfg, params = load_params(args, cfg)     # LoRA adapters merged
    quant_scales = None
    if args.quant:
        from tensorflow_train_distributed_torch.models.quant import (
            quantize_params,
        )

        params, quant_scales = quantize_params(params)
    prompt = np.asarray(rows, np.int64)
    try:
        if draft_cfg is not None:
            out, stats = generate_speculative(
                cfg, params, draft_cfg, draft_params, prompt, args.max_new,
                k=args.speculative_k, temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p, seed=args.seed,
                device=args.device)
            print(json.dumps({"speculative_stats": stats}), flush=True)
        else:
            out = generate(cfg, params, prompt, args.max_new,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, seed=args.seed,
                           quant_scales=quant_scales, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    for row_in, row_out in zip(rows, out.cpu().tolist()):
        print(json.dumps({"prompt": row_in,
                          "completion": row_out[len(row_in):]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
