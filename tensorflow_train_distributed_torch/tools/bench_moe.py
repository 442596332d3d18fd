"""MoE decoder training throughput: tokens/s, active-parameter MFU and
peak memory through the port's ``Trainer`` step, on one card.

    python -m tensorflow_train_distributed_torch.tools.bench_moe \\
        [--preset moe_370m] [--dispatch dense|gmm] [--batch-per-chip 8] \\
        [--seq 1024] [--device cuda|cpu]

The JAX tool's recipe: ``MoeLmTask`` (aux losses folded in), the
``mixed_bfloat16`` policy, adamw (1e-4, b2 0.95, weight decay 0.1),
random weights and tokens from seed 0.  ``--dispatch gmm`` routes
dropless through K6's grouped matmuls; ``dense`` is GShard's
capacity-bound einsums.  MFU counts active FLOPs (``tools/roofline.py``:
6 (N_dense + N_expert k / E) + 12 L d S / 2 a token; never all E
experts).  The memory guard adds the JAX tool's dispatch-buffer and
activation terms to the train state.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

from tensorflow_train_distributed_torch.tools import bench_lm as B


def dispatch_bytes(cfg, batch: int, seq: int) -> int:
    """The JAX tool's estimate of the routing buffers and activations:
    gmm's expert-sorted row copies and f32 gate/up activations, or the
    dense dispatch's [G, S, E, C] f32 one-hots; 30 bf16 d-wide tensors a
    layer and token for the rest."""
    n_moe_layers = -(-cfg.num_layers // max(cfg.moe_every, 1))
    if cfg.dispatch == "gmm":
        m = batch * seq * cfg.top_k
        routing = m * (4 * cfg.d_model + 8 * cfg.ffn_size) * n_moe_layers
    else:
        capacity = max(1, int(cfg.capacity_factor * cfg.top_k * seq
                              / cfg.num_experts))
        routing = (2 * batch * seq * cfg.num_experts * capacity * 4
                   * n_moe_layers)
    return routing + 30 * cfg.num_layers * batch * seq * cfg.d_model * 2


def bench_moe(preset: str, batch: int, seq: int, warmup: int, iters: int,
              *, device: str = "cuda", force_hbm: bool = False,
              dispatch: str = "dense") -> dict:
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import moe
    from tensorflow_train_distributed_torch.tools import roofline
    from tensorflow_train_distributed_torch.training import optimizers

    cfg = dataclasses.replace(moe.MOE_PRESETS[preset], dispatch=dispatch)
    if seq > cfg.max_positions:
        raise ValueError(f"--seq {seq} > max_positions {cfg.max_positions}")
    n_params, active = roofline.moe_active_params(
        {k: math.prod(s) for k, s in convert.expected_shapes(cfg).items()},
        cfg)
    dev = B.device_fields(device)
    task = moe.MoeLmTask(cfg, device="meta")
    # The planner refuses MoE (its dispatch has no activation term): the
    # state and the dispatch buffers count, and the record says so.
    B.check_hbm_budget(n_params, budget_bytes=B.card_budget_bytes(device),
                       force=force_hbm, device_kind=dev["device_kind"],
                       extra_bytes=dispatch_bytes(cfg, batch, seq),
                       task=task, batch=batch, seq=seq)
    trainer = B.trainer_for(task, optimizers.adamw(1e-4, b1=0.9, b2=0.95,
                                                   weight_decay=0.1), device)
    state, timing = B.train_timing(
        trainer, B.lm_batch(cfg.vocab_size, batch, seq), device=device,
        warmup=warmup, iters=iters)
    n_params, active = roofline.moe_active_params(
        {k: p.numel() for k, p in state.params.items()}, cfg)
    tokens = batch * seq
    name = preset if dispatch == "dense" else f"{preset}_{dispatch}"
    rec = {"metric": f"{name}_train_tokens_per_sec", "unit": "tokens/sec",
           "batch_per_chip": batch, "seq_len": seq, "n_chips": 1,
           "tokens_per_step": tokens, "n_params": n_params,
           "n_active_params": int(active), "num_experts": cfg.num_experts,
           "top_k": cfg.top_k, "dispatch": dispatch,
           "policy": "mixed_bfloat16", "mfu_formula": roofline.FORMULAS["moe"],
           "warmup": warmup, "iters": iters}
    rec.update(B.rate_fields(
        timing, tokens, roofline.moe_flops_per_token(active, cfg, seq)
        * tokens, device))
    rec.update(dev)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="moe_370m")
    p.add_argument("--batch-per-chip", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dispatch", default="dense", choices=["dense", "gmm"],
                   help="GShard's dense-dispatch einsums, or dropless "
                        "routing through K6's grouped matmuls")
    p.add_argument("--force-hbm", action="store_true",
                   help="skip the memory guard")
    B.add_device_args(p)
    args = p.parse_args(argv)
    name = (args.preset if args.dispatch == "dense"
            else f"{args.preset}_{args.dispatch}")
    return B.run_tool(
        args, f"{name}_train_tokens_per_sec", "tokens/sec",
        lambda device: bench_moe(args.preset, args.batch_per_chip, args.seq,
                                 args.warmup, args.iters, device=device,
                                 force_hbm=args.force_hbm,
                                 dispatch=args.dispatch),
        dispatch=args.dispatch)


if __name__ == "__main__":
    sys.exit(main())
