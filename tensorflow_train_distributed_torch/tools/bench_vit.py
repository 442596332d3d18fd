"""ViT image-classification training throughput: images/s, MFU and peak
memory through the port's ``Trainer`` step, on one card.

    python -m tensorflow_train_distributed_torch.tools.bench_vit \\
        [--preset vit_b16] [--batch-per-chip 64] [--device cuda|cpu]

The JAX tool's recipe: the ``mixed_bfloat16`` policy (the registry's
vit_b16_imagenet computes in f32), adamw (1e-3, weight decay 0.05), label
smoothing 0.1, random weights and N(0, 1) images from seed 0.  ViT-B/16's
196 patches miss K2's 128-row gate, so attention runs dense, as it does
through the launcher; the loss is plain PyTorch.  MFU is 3 x
``tools/roofline.py``'s ``vit_forward_flops`` an image over the card's
bf16 peak (the JAX tool's S (6 N + 12 L d S) counts the patch
projection's parameters at every token).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

from tensorflow_train_distributed_torch.tools import bench_lm as B


def bench_vit(preset: str, batch: int, warmup: int, iters: int, *,
              device: str = "cuda", force_hbm: bool = False,
              remat: bool = False) -> dict:
    import numpy as np

    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import vit
    from tensorflow_train_distributed_torch.tools import roofline
    from tensorflow_train_distributed_torch.training import optimizers

    cfg = vit.VIT_PRESETS[preset]
    if remat:
        cfg = dataclasses.replace(cfg, remat=True)
    seq = cfg.num_patches + (1 if cfg.pooling == "cls" else 0)
    dev = B.device_fields(device)
    task = vit.make_task(cfg, device="meta")
    B.check_hbm_budget(
        sum(math.prod(s) for s in convert.expected_shapes(cfg).values()),
        budget_bytes=B.card_budget_bytes(device), force=force_hbm,
        device_kind=dev["device_kind"], task=task, batch=batch, seq=seq)
    trainer = B.trainer_for(task, optimizers.adamw(1e-3, weight_decay=0.05),
                            device)
    rng = np.random.default_rng(0)
    data = {"image": rng.normal(0, 1, (batch, cfg.image_size,
                                       cfg.image_size, 3)).astype(
                np.float32),
            "label": rng.integers(0, cfg.num_classes, (batch,)).astype(
                np.int32)}
    state, timing = B.train_timing(trainer, data, device=device,
                                   warmup=warmup, iters=iters)
    fwd = roofline.vit_forward_flops(cfg)
    rec = {"metric": f"{preset}_train_images_per_sec",
           "unit": "images/sec", "batch_per_chip": batch, "patch_seq": seq,
           "n_chips": 1, "n_params": state.num_params(),
           "forward_gflops_per_image": fwd / 1e9, "policy": "mixed_bfloat16",
           "remat": cfg.remat, "mfu_formula": roofline.FORMULAS["vit"],
           "warmup": warmup, "iters": iters}
    rec.update(B.rate_fields(timing, batch, 3 * fwd * batch, device))
    rec.update(dev)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="vit_b16")
    p.add_argument("--batch-per-chip", type=int, default=64)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--force-hbm", action="store_true",
                   help="skip the memory guard")
    p.add_argument("--remat", action="store_true",
                   help="per-layer activation checkpointing")
    B.add_device_args(p)
    args = p.parse_args(argv)
    return B.run_tool(
        args, f"{args.preset}_train_images_per_sec", "images/sec",
        lambda device: bench_vit(args.preset, args.batch_per_chip,
                                 args.warmup, args.iters, device=device,
                                 force_hbm=args.force_hbm, remat=args.remat))


if __name__ == "__main__":
    sys.exit(main())
