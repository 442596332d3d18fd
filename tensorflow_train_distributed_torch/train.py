"""Train a registry decoder config on one device through the port's
trainer (counterpart of the JAX package's ``launch.py``, with the flags
this slice implements and the same names).

The config's registry entry supplies the synthetic dataset, global batch,
peak learning rate, schedule, warmup ratio and global-norm clip unless a
flag overrides them; the optimizer is built as the JAX launcher builds it
(``training.optimizers.make_optimizer``).  Weights come from
``--params-npz`` (an ``np.savez`` of the flat flax parameter dict) or at
random from ``--seed``.  Every ``--log-every`` steps, and after the last,
one JSON line of metrics goes to stdout.

  python -m tensorflow_train_distributed_torch.train --config llama_125m_lm --steps 20
  python -m tensorflow_train_distributed_torch.train --config llama_tiny_sft \\
      --steps 3 --device cpu
  python -m tensorflow_train_distributed_torch.train --config moe_tiny_lm_gmm \\
      --steps 3 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from tensorflow_train_distributed_torch.models import registry
from tensorflow_train_distributed_torch.training.optimizers import OPTIMIZERS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True,
                   help=f"decoder config: {', '.join(registry.available())}")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch-size", "--batch-size", dest="batch_size",
                   type=int, default=None,
                   help="global batch size (default: the config's)")
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--lr-schedule", default=None,
                   help="constant | warmup_cosine | warmup_linear | noam | "
                        "resnet_steps (default: the config's convention)")
    p.add_argument("--warmup-steps", type=int, default=None,
                   help="linear LR warmup steps (default: the config's "
                        "warmup_ratio x --steps)")
    p.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS)
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="decoupled weight decay (adamw)")
    p.add_argument("--grad-clip-norm", type=float, default=None,
                   help="clip gradients to this global norm first "
                        "(default: the config's; 0 disables)")
    p.add_argument("--precision", "--mixed-precision", dest="precision",
                   default="bfloat16",
                   help="dtype policy: float32 | bfloat16 | float16")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches per optimizer step")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the data order and the random weights")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--log-grad-norm", action="store_true",
                   help="add grad_norm (pre-clip global norm) to the logs")
    p.add_argument("--params-npz", default="",
                   help="np.savez of the flat flax params (default: random "
                        "weights from --seed)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    return p


def make_trainer(args, entry: dict):
    """(task, trainer, batches) for parsed flags and a registry entry."""
    from tensorflow_train_distributed_torch.data.datasets import get_dataset
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models.llama import CausalLmTask
    from tensorflow_train_distributed_torch.models.moe import (
        MoeConfig,
        MoeLmTask,
    )
    from tensorflow_train_distributed_torch.training import schedules
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy,
    )
    from tensorflow_train_distributed_torch.training.optimizers import (
        make_optimizer,
    )
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    peak = (args.learning_rate if args.learning_rate is not None
            else entry["learning_rate"])
    name = args.lr_schedule or entry["lr_schedule"]
    warmup = (args.warmup_steps if args.warmup_steps is not None
              else int(entry["warmup_ratio"] * args.steps))
    lr = schedules.by_name(name, peak, args.steps, warmup_steps=warmup)
    clip = (args.grad_clip_norm if args.grad_clip_norm is not None
            else entry["grad_clip_norm"])
    tx = make_optimizer(args.optimizer, lr, weight_decay=args.weight_decay,
                        grad_clip_norm=clip)
    cfg = entry["config"]
    task_cls = MoeLmTask if isinstance(cfg, MoeConfig) else CausalLmTask
    task = task_cls(cfg, device="meta")
    trainer = Trainer(
        task, tx, policy=Policy.from_name(args.precision),
        config=TrainerConfig(seed=args.seed, grad_accum=args.grad_accum,
                             log_every=args.log_every,
                             log_grad_norm=args.log_grad_norm),
        lr_schedule=lr, device=args.device)
    source = get_dataset(entry["dataset"], **entry["dataset_kwargs"])
    batches = HostBatches(source, args.batch_size or
                          entry["global_batch_size"], seed=args.seed)
    return task, trainer, batches


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        entry = registry.get_entry(args.config)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    try:
        task, trainer, batches = make_trainer(args, entry)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"{args.config}: {e}")
    params = None
    if args.params_npz:
        from tensorflow_train_distributed_torch import convert

        params = convert.load_npz(args.params_npz, entry["config"])
    state = trainer.create_state(params)

    def on_log(step, metrics):
        if step % args.log_every == 0 or step == args.steps:
            print(json.dumps({"step": step, **metrics}), flush=True)

    trainer.fit(batches, steps=args.steps, state=state, on_log=on_log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
