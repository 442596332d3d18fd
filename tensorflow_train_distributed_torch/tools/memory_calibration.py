"""Measure a training step's peak memory on the card at the points that
calibrate ``training/memory.py``'s activation model, and fit its three
coefficients.

    python -m tensorflow_train_distributed_torch.tools.memory_calibration

Each point (``POINTS``: a config, its layer count, batch x sequence and
remat) builds the trainer through the CLI's construction
(``train.make_trainer``: adamw, bf16 compute over f32 parameters, random
weights from seed 0) and reads ``torch.cuda.max_memory_allocated`` above
what the process held before: over one forward and backward
(``peak_fwd_bwd``), then over 2 ``Trainer.fit`` steps (``peak_fit``, the
step's peak ``plan_train_memory`` estimates).  One JSON line a point;
the last line holds the least-squares fit of ``HEAD_BYTES_PER_LOGIT``,
``REMAT_INPUT_SCALE`` and ``BLOCK_SCALE`` to the forward-and-backward
peaks over the resident state and the weights' compute copies, each
point's plan against its ``peak_fit``, and the card's name and power
limit.  It runs on the card and holds the card lock; without a card it
prints a failure record and exits 1.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys

#: (config, layers, batch, seq, remat).
POINTS = (
    ("llama_125m_lm", 12, 8, 2048, True),
    ("llama_125m_lm", 12, 16, 2048, True),
    ("llama_125m_lm", 12, 8, 2048, False),
    ("llama_125m_lm", 12, 16, 2048, False),
    ("llama_125m_lm", 12, 4, 2048, False),
    ("llama_125m_lm", 12, 1, 128, True),
    ("mistral_7b_lm", 4, 8, 8192, True),
    ("mistral_7b_lm", 2, 8, 8192, True),
    ("mistral_7b_lm", 4, 1, 1024, True),
    ("mistral_7b_lm", 1, 8, 8192, False),
    ("mistral_7b_lm", 2, 4, 8192, False),
)


def _entry(name, layers, batch, seq, remat) -> dict:
    from tensorflow_train_distributed_torch.models import registry

    entry = registry.get_entry(name)
    return dict(entry, global_batch_size=batch,
                dataset_kwargs=dict(entry["dataset_kwargs"], seq_len=seq),
                config=dataclasses.replace(entry["config"],
                                           num_layers=layers, remat=remat))


def trainer(name, layers, batch, seq, remat, steps: int = 2):
    """``(task, trainer, batches)`` through the CLI's construction for
    ``name`` at ``layers`` layers, ``batch`` x ``seq`` and ``remat``, on
    the card."""
    from tensorflow_train_distributed_torch import train as T

    args = T.build_parser().parse_args(
        ["--config", name, "--steps", str(steps), "--seed", "0",
         "--log-every", "1", "--device", "cuda", "--global-batch-size",
         str(batch), "--dataset-kwarg", f"seq_len={seq}"])
    return T.make_trainer(args, _entry(name, layers, batch, seq, remat))


def measure(name, layers, batch, seq, remat, steps: int = 2, *,
            fwd_bwd: bool = True) -> dict:
    """One point's peaks on the card, in bytes (``peak_fwd_bwd`` None
    without ``fwd_bwd``)."""
    import torch

    from tensorflow_train_distributed_torch.data.pipeline import to_device

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    task, trainer_, batches = trainer(name, layers, batch, seq, remat, steps)
    state = trainer_.create_state()
    peak_fwd_bwd = None
    if fwd_bwd:
        host = next(iter(batches))
        batch_d = trainer_.policy.cast_to_compute(to_device(host, "cuda"))
        params = [p for p in state.params.values() if p.requires_grad]
        torch.cuda.reset_peak_memory_stats()
        loss, _ = task.loss_fn(batch_d)
        grads = torch.autograd.grad(loss.float(), params)
        torch.cuda.synchronize()
        peak_fwd_bwd = torch.cuda.max_memory_allocated() - base
        del loss, grads, batch_d
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, history = trainer_.fit(batches, steps=steps, state=state)
    torch.cuda.synchronize()
    peak_fit = torch.cuda.max_memory_allocated() - base
    return dict(config=name, layers=layers, batch=batch, seq=seq,
                remat=remat, params=state.num_params(),
                peak_fwd_bwd=peak_fwd_bwd, peak_fit=peak_fit,
                losses=[m["loss"] for _, m in history])


def plan(rec, device_name=None) -> dict:
    """``plan_train_memory`` of a point (``rec``: config, layers, batch,
    seq, remat) under adamw and bf16 compute, on the meta device."""
    import numpy as np
    import torch

    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training import memory

    task = registry.make_task(
        _entry(rec["config"], rec["layers"], rec["batch"], rec["seq"],
               rec["remat"]), device="meta")
    return memory.plan_train_memory(
        task, {"tokens": np.zeros((rec["batch"], rec["seq"]), np.int32)},
        "adamw", compute_dtype=torch.bfloat16, device_name=device_name)


def fit(records) -> dict:
    """Least squares of the three coefficients over ``records``' forward
    and backward peaks, less each point's resident state (parameters and
    optimizer state: no gradient exists at the head's backward) and its
    weights' compute copies; and each point's plan, under the module's
    coefficients, against its ``peak_fit``."""
    import numpy as np

    rows, ys, points = [], [], []
    for rec in records:
        p = plan(rec)
        t = p["activation_terms"]
        rows.append([t["head"], t["remat"], t["block"]])
        ys.append(rec["peak_fwd_bwd"] - p["state_bytes_per_device"]
                  + p["grad_bytes_per_device"]
                  - p["weight_copy_bytes_per_device"])
        est = p["step_bytes_per_device"]
        points.append(dict(
            config=rec["config"], layers=rec["layers"], batch=rec["batch"],
            seq=rec["seq"], remat=rec["remat"],
            peak_fit_gib=rec["peak_fit"] / 2 ** 30,
            plan_gib=est / 2 ** 30, phase=p["peak_phase"],
            error=(est - rec["peak_fit"]) / rec["peak_fit"]))
    coef = np.linalg.lstsq(np.asarray(rows, float), np.asarray(ys, float),
                           rcond=None)[0]
    return {"head_bytes_per_logit": float(coef[0]),
            "remat_input_scale": float(coef[1]),
            "block_scale": float(coef[2]), "points": points}


def main(argv=None) -> int:
    import torch

    from tensorflow_train_distributed_torch.runtime.chip_lock import (
        chip_lock,
    )

    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device: the calibration "
                                   "measures the card", "value": None}))
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    records = []
    with chip_lock():
        for point in POINTS:
            rec = measure(*point)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    print(json.dumps(dict(fit(records), card=card,
                          device_kind=torch.cuda.get_device_name(0))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
