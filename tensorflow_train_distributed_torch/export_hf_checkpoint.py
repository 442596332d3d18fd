"""Export a trained decoder config as a HuggingFace checkpoint.

The counterpart of the JAX package's ``tools/export_hf_checkpoint.py`` and
the inverse of ``--init-from-hf``: the newest checkpoint the port's
launcher wrote in ``--checkpoint-dir`` (its parameters only, LoRA
adapters merged) becomes a directory that
``AutoModelForCausalLM.from_pretrained`` loads (``config.json`` and the
f32 weights, written a layer at a time: one ``pytorch_model.bin`` up to
5 GB, else 5-GB shards and their index; sliding-window configs export as
Mistral, MoE configs as Mixtral or Qwen2-MoE).  Without ``--checkpoint-dir`` it
exports random weights from seed 0 (an interop smoke test).  It runs on
the host: no device is needed.

  python -m tensorflow_train_distributed_torch.export_hf_checkpoint \\
      --config llama_tiny_sft --checkpoint-dir ck --out hf_export
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--lora-alpha", type=float, default=16.0,
                   help="the --lora-alpha the checkpoint was trained with, "
                        "where it has no lora_spec.json (checkpoints "
                        "carrying adapters are merged before export; alpha "
                        "is not recoverable from the weights)")
    args = p.parse_args(argv)
    from tensorflow_train_distributed_torch.models.export_hf import (
        export_hf_from_registry,
    )

    try:
        out = export_hf_from_registry(args.config, args.checkpoint_dir,
                                      args.out, lora_alpha=args.lora_alpha)
    except (ValueError, FileNotFoundError) as e:
        raise SystemExit(str(e))
    print(f"HF checkpoint written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
