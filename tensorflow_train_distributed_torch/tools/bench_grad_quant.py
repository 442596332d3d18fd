"""Quantized gradient sync A/B: the port's grad-quant pipeline against
the exact mean, over one seeded batch stream.

    python -m tensorflow_train_distributed_torch.tools.bench_grad_quant \\
        [--world N] [--steps 30] [--batch 32] [--seq 64] [--preset NAME] \\
        [--policy float32] [--overlap [--grad-overlap 4]] \\
        [--device cuda|cpu]

Four legs, each a ``Trainer.fit`` from seed 0 over the same batches on a
``data`` mesh of ``--world`` ranks (one process each: NCCL on the cards,
gloo on the CPU):

- ``none``: the exact f32 mean of the gradients;
- ``f32``: the error-feedback pipeline with the exact f32 wire, which
  isolates the pipeline from the quantization;
- ``int8``: int8 codes and f32 scales on the wire, the residual carried
  in the train state;
- ``int8`` under ``TTD_NO_GRAD_QUANT=1``: the kill switch, which must
  equal ``none`` bit for bit.

Reported per leg: the loss curve (int8 against none within
``LOSS_PARITY_TOL``, the JAX tool's bar), the median ms a step on the
card, ``collectives.grad_sync_wire_bytes`` a rank, and the comm fraction
from the trainer's flight-recorder spans (``train/grad_comm`` over the
grad-quant sub-spans, the first step left out); the trainer's own
``train/*`` span counts; and the restore check: a checkpoint saved
without grad-quant restores into the residual-carrying state, residuals
zero and params equal.  ``--overlap`` runs the bucketed A/B instead:
``seq`` (int8, one sync), ``ovl`` (``--grad-overlap`` buckets) and
``ovl`` under ``TTD_NO_GRAD_OVERLAP=1``, which must equal ``seq`` bit for
bit; ovl against seq within ``OVERLAP_PARITY_TOL``; each leg's blocking
comm fraction beside the other's (a reading: the port's buckets sync one
after another after the backward).

``--preset`` takes a ``LLAMA_PRESETS`` model at its width (the batch
stream's vocabulary is then the preset's); the default is the JAX tool's
d-128 two-layer decoder.  At one rank the trainer resolves every
grad-quant leg to the exact step, as the JAX trainer does on a data=1
mesh (each leg's ``grad_quant`` says what ran): the pipeline's sub-spans
need two ranks or more.  ``--device cuda`` holds the card lock and fails
with a record where there is no card; a ``--device cpu`` run reports no
step time.  The whole record is the line of standard output before the
last; the last is a headline of under 500 bytes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

from tensorflow_train_distributed_torch.tools import bench_allreduce as BA
from tensorflow_train_distributed_torch.tools import bench_lm as B

_MOD = "tensorflow_train_distributed_torch.tools.bench_grad_quant"

LOSS_PARITY_TOL = 0.1       # |loss_int8 - loss_none| a step (the JAX bar)
#: ovl against seq: both int8 with error feedback, different block
#: placement, so an order of magnitude tighter (the JAX bar).
OVERLAP_PARITY_TOL = 1e-3
#: The pipeline's sub-spans (the comm fraction's denominator).
SUB_SPANS = ("train/grad_fwdbwd", "train/grad_comm",
             "train/optimizer_apply", "train/step_barrier")
HEADLINE_BYTES = 500


def model_config(a: dict):
    """The JAX tool's decoder (``--vocab``, ``--d-model``, ``--layers``,
    4 heads, ffn 2 d, f32), or a preset at its own width."""
    import dataclasses

    import torch

    from tensorflow_train_distributed_torch.models import llama

    if a["preset"]:
        cfg = llama.LLAMA_PRESETS[a["preset"]]
        if a["seq"] > cfg.max_positions:
            raise ValueError(f"--seq {a['seq']} > max_positions "
                             f"{cfg.max_positions}")
        return cfg
    return dataclasses.replace(
        llama.LlamaConfig(), vocab_size=a["vocab"], d_model=a["d_model"],
        num_layers=a["layers"], num_heads=4, num_kv_heads=None,
        ffn_size=2 * a["d_model"], max_positions=a["seq"],
        dtype=torch.float32)


def batches(steps: int, batch: int, seq: int, vocab: int, seed: int) -> list:
    """The JAX tool's stream: uniform tokens, targets the tokens rolled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
        out.append({"tokens": toks, "targets": np.roll(toks, -1, axis=1)})
    return out


def _clock():
    """A callback keeping the host time at each step's metric read
    (``log_every`` 1: the read waits for the step) in ``.t``."""
    from tensorflow_train_distributed_torch.training.callbacks import (
        Callback,
    )

    class Clock(Callback):
        def __init__(self):
            self.t = []

        def on_step_end(self, step, metrics):
            self.t.append((time.perf_counter(), time.monotonic()))

    return Clock()


@contextlib.contextmanager
def _env(name: str, on: bool):
    prior = os.environ.get(name)
    if on:
        os.environ[name] = "1"
    try:
        yield
    finally:
        if on:
            if prior is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = prior


def _trainer(cfg, mesh, device, a, callbacks=(), **config):
    from tensorflow_train_distributed_torch.models.llama import CausalLmTask
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy,
    )
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    return Trainer(CausalLmTask(cfg, device="meta"), optimizers.adamw(3e-3),
                   policy=Policy.from_name(a["policy"]), device=device,
                   mesh=mesh, callbacks=callbacks,
                   config=TrainerConfig(seed=a["seed"], log_every=1,
                                        **config))


def run_leg(cfg, mesh, device, a, stream, grad_quant: str, *,
            grad_overlap=0, kill_env: str = "") -> tuple:
    """One leg through ``Trainer.fit``: (record, the final whole params as
    numpy on every rank)."""
    import torch

    from tensorflow_train_distributed_torch.parallel import collectives as C
    from tensorflow_train_distributed_torch.parallel.sharding import (
        shard_batch,
    )
    from tensorflow_train_distributed_torch.runtime import events

    on_card = torch.device(device).type == "cuda"
    clock = _clock()
    with _env(kill_env, bool(kill_env)):
        trainer = _trainer(cfg, mesh, device, a, callbacks=[clock],
                           grad_quant=grad_quant, grad_overlap=grad_overlap)
    state = trainer.create_state()
    rec_ = events.get_recorder()
    t_start = (time.perf_counter(), time.monotonic())
    state, history = trainer.fit([shard_batch(mesh, b) for b in stream],
                                 steps=len(stream), state=state)
    B.sync("cuda" if on_card else "cpu")
    ticks = [t_start] + clock.t
    walls = [b[0] - a_[0] for a_, b in zip(ticks, ticks[1:])]
    evs = [e for e in rec_.events() if e[2] >= t_start[1]
           and e[0].startswith("train/")]
    counts: dict = {}
    for e in evs:
        counts[e[0]] = counts.get(e[0], 0) + 1
    # The first step's spans are left out of the totals, as its wall is.
    after = ticks[1][1] if len(ticks) > 1 else t_start[1]
    totals: dict = {}
    for name, ph, t0, dur, _tid, _attrs in evs:
        if ph == "X" and t0 >= after:
            totals[name] = totals.get(name, 0.0) + dur
    full = trainer.full_state(state)
    params = {k: v.detach().float().cpu().numpy()
              for k, v in full.params.items()}
    losses = [m["loss"] for _, m in history]
    shapes = [tuple(v.shape) for v in full.params.values()]
    wire = "f32" if trainer.grad_quant == "none" else trainer.grad_quant
    leg = {"grad_quant": trainer.grad_quant,
           "grad_overlap": trainer.grad_overlap,
           "kill_switch": bool(kill_env),
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses,
           "wall_per_step_ms": (statistics.median(walls[1:] or walls) * 1e3
                                if on_card else None),
           "wire_bytes_per_step": C.grad_sync_wire_bytes(
               shapes, mesh.shape["data"], wire),
           "span_counts": counts}
    if on_card:
        leg["walls_ms"] = [w * 1e3 for w in walls]
    last = history[-1][1]
    if "grad_buckets" in last:
        leg["grad_buckets"] = int(last["grad_buckets"])
        leg["bucket_wire_mb"] = float(last["grad_comm_mb"])
    comm = totals.get("train/grad_comm")
    if comm is not None:
        # Blocking comm share: the sequential spans end where the device
        # is done; under overlap the comm spans meter dispatch and the
        # device wait is the barrier's.
        span_sum = sum(totals.get(k, 0.0) for k in SUB_SPANS)
        leg["comm_fraction"] = comm / span_sum if span_sum else 0.0
    return leg, params


def _bitwise(a: dict, b: dict) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def restore_compat(cfg, mesh, device, a):
    """A checkpoint saved without grad-quant restores into the
    residual-carrying state: residuals zero, params equal.  None at one
    data rank, where the state carries no residual."""
    import numpy as np

    from tensorflow_train_distributed_torch.parallel import collectives as C
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    if mesh.shape["data"] < 2:
        return None
    # Another seed than the template's: equal params mean restored ones.
    old = _trainer(cfg, mesh, device, dict(a, seed=a["seed"] + 1))
    state = old.create_state()
    d = C.broadcast_from_coordinator(
        tempfile.mkdtemp(prefix="ttd_gq_ckpt_") if mesh.rank == 0 else None,
        mesh.group(("data",)))
    try:
        # Rank 0 writes; another rank's manager opens the directory after
        # the save (opening one sweeps unfinished saves).
        mgr = CheckpointManager(d) if mesh.rank == 0 else None
        old.save_checkpoint(0, state, manager=mgr)
        mgr = mgr or CheckpointManager(d)
        new = _trainer(cfg, mesh, device, a, grad_quant="int8")
        restored = new.restore(mgr, new.create_state())
        ok = restored is not None and restored.grad_residual is not None
        if ok:
            zeros = all(not r.any() for r in restored.grad_residual
                        if r is not None)
            want = old.full_state(state).params
            got = new.full_state(restored).params
            ok = zeros and all(
                np.array_equal(got[k].detach().cpu().numpy(),
                               want[k].detach().cpu().numpy())
                for k in want)
    finally:
        old._barrier()
        if mesh.rank == 0:
            import shutil

            shutil.rmtree(d, ignore_errors=True)
    return bool(ok)


def run_ab(rank: int, **a) -> dict:
    """The whole A/B in one rank (every rank runs it; rank 0's record
    counts)."""
    from tensorflow_train_distributed_torch.runtime.distributed import (
        shutdown_distributed,
    )
    from tensorflow_train_distributed_torch.runtime.mesh import (
        MeshConfig,
        build_mesh,
    )

    device = a["device"]
    joined = a["world"] > 1 or device == "cuda"
    dev = (BA.join_world(rank, a["world"], a["coordinator"], device)
           if joined else device)
    try:
        mesh = (build_mesh(MeshConfig(data=a["world"]), device_type=device)
                if joined else None)
        cfg = model_config(a)
        stream = batches(a["steps"], a["batch"], a["seq"], cfg.vocab_size,
                         a["seed"])
        if mesh is None:
            from tensorflow_train_distributed_torch.runtime.mesh import (
                AXES,
                Mesh,
            )

            mesh = Mesh(dict.fromkeys(AXES, 1))
        return (_overlap_ab if a["overlap"] else _quant_ab)(
            cfg, mesh, dev, a, stream)
    finally:
        if joined:
            shutdown_distributed()


def _quant_ab(cfg, mesh, device, a, stream) -> dict:
    legs, params = {}, {}
    legs["none"], params["none"] = run_leg(cfg, mesh, device, a, stream,
                                           "none")
    for gq in ("f32", "int8"):
        legs[gq], params[gq] = run_leg(cfg, mesh, device, a, stream, gq)
    ks, params["ks"] = run_leg(cfg, mesh, device, a, stream, "int8",
                               kill_env="TTD_NO_GRAD_QUANT")
    diffs = [abs(x - y) for x, y in zip(legs["int8"]["losses"],
                                        legs["none"]["losses"])]
    wire_f32 = legs["none"]["wire_bytes_per_step"]
    wire_int8 = legs["int8"]["wire_bytes_per_step"]
    return {
        "metric": "grad_quant_ab",
        # Nothing crosses a wire at one rank.
        "value": wire_f32 / max(wire_int8, 1) if wire_f32 else None,
        "unit": "x less gradient wire bytes (int8 vs f32)",
        "legs": legs,
        "killswitch": {"resolved_grad_quant": ks["grad_quant"],
                       "bitwise_equal_to_none": _bitwise(params["ks"],
                                                         params["none"]),
                       "losses": ks["losses"],
                       "wall_per_step_ms": ks["wall_per_step_ms"],
                       "span_counts": ks["span_counts"]},
        "loss_parity": {
            "max_abs_diff_int8_vs_none": max(diffs), "tol": LOSS_PARITY_TOL,
            "within_tol": max(diffs) <= LOSS_PARITY_TOL,
            "int8_loss_decreased":
                legs["int8"]["loss_last"] < legs["int8"]["loss_first"]},
        "comm_fraction": {gq: legs[gq].get("comm_fraction")
                          for gq in ("f32", "int8")},
        "comm_bytes_fraction": wire_int8 / max(wire_f32, 1),
        "restore_compat_ok": restore_compat(cfg, mesh, device, a),
    }


def _overlap_ab(cfg, mesh, device, a, stream) -> dict:
    legs, params = {}, {}
    legs["seq"], params["seq"] = run_leg(cfg, mesh, device, a, stream,
                                         "int8", grad_overlap=0)
    legs["ovl"], params["ovl"] = run_leg(cfg, mesh, device, a, stream,
                                         "int8",
                                         grad_overlap=a["grad_overlap"])
    ks, params["ks"] = run_leg(cfg, mesh, device, a, stream, "int8",
                               grad_overlap=a["grad_overlap"],
                               kill_env="TTD_NO_GRAD_OVERLAP")
    diffs = [abs(x - y) for x, y in zip(legs["ovl"]["losses"],
                                        legs["seq"]["losses"])]
    ratios = [x / y for x, y in zip(legs["seq"].get("walls_ms", [])[1:],
                                    legs["ovl"].get("walls_ms", [])[1:])
              if y > 0]
    cf = {k: legs[k].get("comm_fraction") for k in ("seq", "ovl")}
    return {
        "metric": "grad_overlap_ab",
        "value": statistics.median(ratios) if ratios else None,
        "unit": "x wall-clock, sequential/overlap int8 (median of "
                "per-step pairs)",
        "legs": legs,
        "blocking_comm_fraction": dict(
            cf, reduced=(None not in cf.values() and cf["ovl"] < cf["seq"])),
        "loss_parity": {
            "max_abs_diff_ovl_vs_seq": max(diffs), "tol": OVERLAP_PARITY_TOL,
            "within_tol": max(diffs) <= OVERLAP_PARITY_TOL,
            "ovl_loss_decreased":
                legs["ovl"]["loss_last"] < legs["ovl"]["loss_first"]},
        "killswitch": {"resolved_grad_overlap": ks["grad_overlap"],
                       "bitwise_equal_to_seq": _bitwise(params["ks"],
                                                        params["seq"]),
                       "wall_per_step_ms": ks["wall_per_step_ms"]},
    }


def passed(rec: dict) -> bool:
    """Loss parity, the kill switch bit for bit and (the quant A/B) the
    restore check.  The JAX overlap A/B also asks the blocking comm
    fraction to drop; the port's buckets sync one after another after
    the backward (no overlap yet), so ``reduced`` is a reading here."""
    ok = rec["loss_parity"]["within_tol"]
    if rec["metric"] == "grad_quant_ab":
        return (ok and rec["killswitch"]["bitwise_equal_to_none"]
                and rec["restore_compat_ok"] is not False)
    return ok and rec["killswitch"]["bitwise_equal_to_seq"]


def headline(rec: dict) -> dict:
    """The last line: the metric, the verdicts and the legs' step times,
    under ``HEADLINE_BYTES``."""
    keys = ("metric", "value", "unit", "device", "device_kind", "world",
            "card_lock")
    out = {k: rec.get(k) for k in keys}
    out["passed"] = passed(rec)
    out["loss_parity_ok"] = rec["loss_parity"]["within_tol"]
    ks = rec["killswitch"]
    out["killswitch_bitwise"] = ks.get("bitwise_equal_to_none",
                                       ks.get("bitwise_equal_to_seq"))
    if "restore_compat_ok" in rec:
        out["restore_compat_ok"] = rec["restore_compat_ok"]
    out["ms"] = {k: (None if v["wall_per_step_ms"] is None
                     else round(v["wall_per_step_ms"], 2))
                 for k, v in rec["legs"].items()}
    line = json.dumps(out)
    if len(line) >= HEADLINE_BYTES:
        out.pop("unit")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=1,
                   help="data ranks, one process each")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=32,
                   help="the global batch")
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--preset", default="",
                   help="a LLAMA_PRESETS model at its width in place of "
                        "the --vocab/--d-model/--layers decoder")
    p.add_argument("--policy", default="float32",
                   help="the trainer's precision policy (the JAX tool "
                        "computes in f32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--overlap", action="store_true",
                   help="the bucketed A/B (seq, ovl, kill switch)")
    p.add_argument("--grad-overlap", type=int, default=4,
                   help="buckets of the ovl legs")
    B.add_device_args(p)
    args = p.parse_args(argv)
    if args.steps < 2:
        p.error("--steps must be >= 2 (the first step is left out of the "
                "times)")
    metric = "grad_overlap_ab" if args.overlap else "grad_quant_ab"
    box = {}

    def run(device):
        import torch

        if device == "cuda" and args.world > torch.cuda.device_count():
            raise ValueError(f"--world {args.world} needs {args.world} "
                             f"cards; this host has "
                             f"{torch.cuda.device_count()}")
        a = dict(vars(args), device=device,
                 coordinator=BA.free_coordinator())
        a.pop("platform", None)
        rec = (run_ab(0, **a) if args.world == 1 else
               BA.run_ranks(f"{_MOD}:run_ab", args.world, a)[0])
        rec.update(world=args.world, config={
            k: a[k] for k in ("steps", "batch", "seq", "vocab", "d_model",
                              "layers", "preset", "policy", "seed",
                              "grad_overlap")},
            optimizer="adamw(3e-3)")
        rec.update(B.device_fields(device))
        box["rec"] = rec
        return rec

    rc = B.run_tool(args, metric, "", run, headline=headline)
    if rc == 0 and not passed(box["rec"]):
        return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
