"""BERT MLM pretraining throughput: samples/s, MFU and peak memory
through the port's ``Trainer`` step, on one card.

    python -m tensorflow_train_distributed_torch.tools.bench_bert \\
        [--preset bert_base] [--batch-per-chip 32] [--seq 128] \\
        [--device cuda|cpu]

The JAX tool's recipe, not the registry entry's: the ``mixed_bfloat16``
policy (bert_base_mlm's registry config computes in f32), adamw (1e-4,
weight decay 0.01), 15% of the positions masked, random weights and
tokens from seed 0.  K2 then runs its bf16 body on full attention at
BERT's heads, and K3 the loss.  MFU is ``tools/roofline.py``'s BERT
formula, (6 N_non_embedding + 12 L S d) a token over the card's bf16
peak (the JAX tool counts the embeddings in N).  Device flags, the card
lock, the memory guard and the record's device fields: ``bench_lm``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

from tensorflow_train_distributed_torch.tools import bench_lm as B


def mlm_batch(vocab: int, batch: int, seq: int) -> dict:
    """Random ids and labels with 15% of each row's positions weighted
    (the BERT pretraining convention), from seed 0 as the JAX tool."""
    import numpy as np

    rng = np.random.default_rng(0)
    weights = np.zeros((batch, seq), np.float32)
    for row in weights:
        row[rng.choice(seq, max(1, int(0.15 * seq)), replace=False)] = 1.0
    return {"input_ids": rng.integers(0, vocab, (batch, seq)).astype(
                np.int32),
            "labels": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
            "mask_weights": weights}


def bench_bert(preset: str, batch: int, seq: int, warmup: int, iters: int,
               *, device: str = "cuda", force_hbm: bool = False,
               remat: bool = False) -> dict:
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import bert
    from tensorflow_train_distributed_torch.tools import roofline
    from tensorflow_train_distributed_torch.training import optimizers

    cfg = bert.BERT_PRESETS[preset]
    if remat:
        cfg = dataclasses.replace(cfg, remat=True)
    if seq > cfg.max_positions:
        raise ValueError(f"--seq {seq} > max_positions {cfg.max_positions}")
    dev = B.device_fields(device)
    task = bert.BertMlmTask(cfg, device="meta")
    B.check_hbm_budget(
        sum(math.prod(s) for s in convert.expected_shapes(cfg).values()),
        budget_bytes=B.card_budget_bytes(device), force=force_hbm,
        device_kind=dev["device_kind"], task=task, batch=batch, seq=seq)
    trainer = B.trainer_for(task, optimizers.adamw(1e-4, weight_decay=0.01),
                            device)
    state, timing = B.train_timing(
        trainer, mlm_batch(cfg.vocab_size, batch, seq), device=device,
        warmup=warmup, iters=iters)
    n_ne = roofline.non_embedding_params(cfg)
    flops = roofline.bert_flops_per_token(n_ne, cfg, seq) * batch * seq
    rec = {"metric": f"{preset}_mlm_samples_per_sec",
           "unit": "samples/sec", "batch_per_chip": batch, "seq_len": seq,
           "n_chips": 1, "tokens_per_step": batch * seq,
           "n_params": state.num_params(), "non_embedding_params": n_ne,
           "policy": "mixed_bfloat16", "remat": cfg.remat,
           "mfu_formula": roofline.FORMULAS["bert"].replace("peak",
                                                            "989e12"),
           "warmup": warmup, "iters": iters}
    rec.update(B.rate_fields(timing, batch, flops, device))
    rec.update(dev)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="bert_base")
    p.add_argument("--batch-per-chip", type=int, default=32)
    p.add_argument("--seq", type=int, default=128,
                   help="pretraining phase 1's sequence length")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--force-hbm", action="store_true",
                   help="skip the memory guard")
    p.add_argument("--remat", action="store_true",
                   help="per-layer activation checkpointing")
    B.add_device_args(p)
    args = p.parse_args(argv)
    return B.run_tool(
        args, f"{args.preset}_mlm_samples_per_sec", "samples/sec",
        lambda device: bench_bert(args.preset, args.batch_per_chip,
                                  args.seq, args.warmup, args.iters,
                                  device=device, force_hbm=args.force_hbm,
                                  remat=args.remat))


if __name__ == "__main__":
    sys.exit(main())
