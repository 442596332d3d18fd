"""The ``train_distributed`` launcher on one device: flags → data →
trainer → fit / evaluate, with checkpoints and resume (the counterpart
of the JAX package's ``launch.py``, with its flag names, for one GPU).

    python -m tensorflow_train_distributed_torch --config llama_125m_lm \\
        --steps 1000 --checkpoint-dir /ckpt --checkpoint-every 200 \\
        --eval-split 0.001 --eval-steps 4 --eval-every 100
    python -m tensorflow_train_distributed_torch --config llama_tiny_sft \\
        --steps 20 --device cpu
    python -m tensorflow_train_distributed_torch --list-configs

The config's registry entry supplies the dataset, global batch, peak
learning rate, schedule, warmup ratio and global-norm clip unless a flag
overrides them.  Weights come from the newest good checkpoint in
``--checkpoint-dir`` (unless ``--no-resume``), else from ``--params-npz``
(an ``np.savez`` of the flat flax parameter dict), else at random from
``--seed``.  A resumed run takes the data stream up mid-epoch where the
checkpoint left it, so a run that was killed and resumed ends where an
uninterrupted one does.

Standard output carries one JSON line per logged step (every
``--log-every`` steps and the last), one per evaluation event
(``val_*``) and one for the final or ``--eval-only`` evaluation
(``{"step": N, "eval": {...}}``); the log (standard error) ends with a
``launch summary`` JSON line: step time, save and restore seconds and
bytes, evaluation (and BLEU) seconds, the kernels' launch counts and,
on CUDA, the peak of allocated device memory.

The WMT configs also beam-decode ``--bleu-eval N`` evaluation batches
(``--beam-size``, ``--bos-id``, ``--eos-id``) after training, or with
``--eval-only``, and report corpus BLEU beside the evaluation's metrics.

Flags of the JAX launcher that need what the port does not have yet
(more than one device or process, LoRA, HF import, the JPEG image
transforms, the data service, the supervisor, TensorBoard, the profiler,
fused steps) are parsed and refused, each with the ROADMAP item that
brings it, exit 2.  ``--device`` (default ``cuda``) never falls back to
the CPU; on CUDA the launcher pins cuDNN to its deterministic
algorithms, so a resumed run of a convolutional model ends where an
uninterrupted one does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import statistics
import sys
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

_Q1 = "ROADMAP Queue 1"
# Flags of the JAX launcher the port refuses: (dest, what brings it).
# Each defaults to None (or False), so any use of it is refused.
_REFUSED = {
    "strategy": f"{_Q1} item 5 (multi-GPU)",
    "mesh": f"{_Q1} item 5 (multi-GPU)",
    "dcn": f"{_Q1} item 5 (multi-GPU)",
    "zero1": f"{_Q1} item 5 (multi-GPU)",
    "grad_quant": f"{_Q1} item 5 (multi-GPU)",
    "grad_overlap": f"{_Q1} item 5 (multi-GPU)",
    "sharded_update": f"{_Q1} item 5 (multi-GPU)",
    "coordinator_address": f"{_Q1} item 5 (multi-GPU)",
    "num_processes": f"{_Q1} item 5 (multi-GPU)",
    "process_id": f"{_Q1} item 5 (multi-GPU)",
    "platform": f"{_Q1} item 5 (multi-GPU); the port takes --device",
    "cpu_devices": f"{_Q1} item 5 (multi-GPU)",
    "lora_rank": f"{_Q1} item 3 (LoRA)",
    "lora_alpha": f"{_Q1} item 3 (LoRA)",
    "lora_targets": f"{_Q1} item 3 (LoRA)",
    "init_from_hf": f"{_Q1} item 6 (HF import)",
    "data_workers": f"{_Q1} item 3 (the data service)",
    "supervise": f"{_Q1} item 3 (the supervisor)",
    "max_restarts": f"{_Q1} item 3 (the supervisor)",
    "restart_backoff": f"{_Q1} item 3 (the supervisor)",
    "restart_backoff_max": f"{_Q1} item 3 (the supervisor)",
    "restart_window": f"{_Q1} item 3 (the supervisor)",
    "restart_jitter": f"{_Q1} item 3 (the supervisor)",
    "no_elastic": f"{_Q1} item 3 (the supervisor)",
    "max_device_losses": f"{_Q1} item 3 (the supervisor)",
    "no_restart_on_preemption": f"{_Q1} item 3 (the supervisor)",
    "supervisor_journal": f"{_Q1} item 3 (the supervisor)",
    "tensorboard_dir": f"{_Q1} item 3 (TensorBoard)",
    "profile_dir": f"{_Q1} item 3 (the profiler)",
    "profile_steps": f"{_Q1} item 3 (the profiler)",
    "profiler_port": f"{_Q1} item 3 (the profiler)",
}


def build_parser() -> argparse.ArgumentParser:
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training.optimizers import (
        OPTIMIZERS,
    )

    p = argparse.ArgumentParser(
        prog="train_distributed",
        description="Training launcher of the PyTorch port (one device)")
    a = p.add_argument
    a("--config", default=None,
      help=f"model config; one of {registry.available()}")
    a("--list-configs", action="store_true",
      help="print available configs and exit")
    a("--steps", type=int, default=100,
      help="train until the state's step reaches this")
    a("--global-batch-size", "--batch-size", dest="global_batch_size",
      type=int, default=None, help="global batch size (default: the "
      "config's)")
    a("--learning-rate", type=float, default=None)
    a("--optimizer", default="adamw", choices=OPTIMIZERS)
    a("--weight-decay", type=float, default=0.0,
      help="decoupled weight decay (adamw, lamb; adafactor's "
      "weight_decay_rate)")
    a("--grad-clip-norm", type=float, default=None,
      help="clip gradients to this global norm first (default: the "
      "config's; 0 disables)")
    a("--ema-decay", type=float, default=None,
      help="keep an EMA of the params in optimizer state; evaluation "
      "scores it (e.g. 0.999)")
    a("--warmup-steps", type=int, default=None,
      help="linear LR warmup steps (default: the config's warmup_ratio x "
      "--steps)")
    a("--lr-schedule", default=None,
      help="constant | warmup_cosine | warmup_linear | noam | "
      "resnet_steps (default: the config's convention)")
    a("--reduce-lr-factor", type=float, default=None,
      help="ReduceLROnPlateau: multiply the LR by this factor (0<f<1) "
      "when the monitored metric plateaus (val_loss under periodic eval, "
      "else loss); needs a constant LR")
    a("--reduce-lr-patience", type=int, default=10)
    a("--reduce-lr-min", type=float, default=0.0)
    a("--reduce-lr-cooldown", type=int, default=0)
    a("--precision", "--mixed-precision", dest="precision",
      default="bfloat16", help="float32 | bfloat16 | float16")
    a("--steps-per-execution", type=int, default=1,
      help="only 1 is ported")
    a("--grad-accum", type=int, default=1,
      help="microbatches per optimizer step")
    a("--log-every", type=int, default=10)
    a("--log-grad-norm", action="store_true",
      help="add grad_norm (pre-clip global norm) to the logs")
    a("--bleu-eval", type=int, default=0, metavar="N",
      help="beam-decode N evaluation batches and report corpus BLEU "
      "(the wmt configs)")
    a("--beam-size", type=int, default=4,
      help="beam width for --bleu-eval (1 = greedy); WMT convention is 4")
    a("--bos-id", type=int, default=1)
    a("--eos-id", type=int, default=2)
    a("--seed", type=int, default=0,
      help="seed of the data order, the random weights and dropout")
    a("--eval-steps", type=int, default=0,
      help="evaluate N batches after training")
    a("--eval-only", action="store_true",
      help="restore from --checkpoint-dir and evaluate --eval-steps "
      "batches without training")
    a("--eval-every", type=int, default=None,
      help="also evaluate every N training steps (val_* metrics)")
    a("--eval-split", type=float, default=0.0,
      help="fraction of the dataset held out (its tail) for evaluation")
    a("--data-dir", default=None,
      help="train from a corpus on disk: *.tfrecord files (with "
      "features.json) or write_shards part-* directories")
    a("--data-transform", default=None,
      help="named record transform for --data-dir")
    a("--pack-seq", type=int, default=0, metavar="LEN",
      help="pack --data-dir's variable-length TFRecord documents into "
      "LEN-token rows")
    a("--pack-key", default="tokens",
      help="feature holding the document tokens under --pack-seq")
    a("--dataset-kwarg", action="append", default=[], metavar="KEY=VALUE",
      help="override a synthetic-dataset kwarg (VALUE parsed as JSON)")
    a("--checkpoint-dir", default=None)
    a("--checkpoint-every", type=int, default=None)
    a("--max-to-keep", type=int, default=3)
    a("--save-best", action="store_true",
      help="also keep the best-metric checkpoint under "
      "<checkpoint-dir>/best")
    a("--no-resume", action="store_true",
      help="start fresh even if --checkpoint-dir has a checkpoint")
    a("--no-preemption-handler", action="store_true",
      help="disable the SIGTERM save-and-stop (on with "
      "--checkpoint-dir)")
    a("--watch-sigint", action="store_true",
      help="treat SIGINT like a preemption")
    a("--fault-plan", default=None, metavar="SPEC",
      help="arm fault injection (runtime.faults grammar; also "
      "TTD_FAULT_PLAN) — chaos testing only")
    a("--jsonl-log", default=None,
      help="append per-step metrics as JSON lines to this file")
    a("--stall-timeout", type=float, default=0.0,
      help="warn and dump stacks when no step completes in this many "
      "seconds; 0 disables")
    a("--params-npz", default="",
      help="np.savez of the flat flax params (default: random weights "
      "from --seed)")
    a("--device", default="cuda",
      help="torch device (default cuda; 'cpu' runs the kernels' plain "
      "versions)")
    refused = p.add_argument_group(
        "refused", "JAX launcher flags the port does not implement yet")
    r = refused.add_argument
    for flag in ("--strategy", "--mesh", "--dcn", "--grad-quant",
                 "--coordinator-address", "--lora-targets",
                 "--init-from-hf", "--supervisor-journal",
                 "--tensorboard-dir", "--profile-dir", "--profile-steps",
                 "--platform"):
        r(flag, default=None)
    for flag in ("--grad-overlap", "--num-processes", "--process-id",
                 "--cpu-devices", "--lora-rank", "--data-workers",
                 "--max-restarts", "--max-device-losses",
                 "--profiler-port"):
        r(flag, type=int, default=None)
    for flag in ("--lora-alpha", "--restart-backoff",
                 "--restart-backoff-max", "--restart-window",
                 "--restart-jitter"):
        r(flag, type=float, default=None)
    for flag in ("--zero1", "--sharded-update", "--supervise",
                 "--no-elastic", "--no-restart-on-preemption"):
        r(flag, action="store_true")
    return p


def _refuse(flag: str, item: str):
    print(f"train_distributed: {flag} is not ported; {item} brings it",
          file=sys.stderr)
    raise SystemExit(2)


def refuse_unported(args) -> None:
    """Exit 2, with one line on standard error, on the first JAX flag the
    port does not implement."""
    for dest, item in _REFUSED.items():
        v = getattr(args, dest)
        if v is not None and v is not False:
            _refuse("--" + dest.replace("_", "-"), item)
    if args.steps_per_execution != 1:
        _refuse("--steps-per-execution above 1", f"{_Q1} item 3 (fused "
                "steps)")
    if args.data_transform and args.data_transform.startswith("imagenet_"):
        _refuse(f"--data-transform {args.data_transform} (the JPEG image "
                "transforms, data/image.py)", f"{_Q1} item 3 (the image "
                "family of the data path)")


def _resolve_schedule(args, entry):
    """(schedule name, warmup steps) from flags and the config."""
    name = args.lr_schedule or entry.get("lr_schedule", "constant")
    warmup = args.warmup_steps
    if warmup is None:
        warmup = int(entry.get("warmup_ratio", 0.0) * args.steps)
    return name, warmup


def _validate_constant_lr(args, entry) -> None:
    name, warmup = _resolve_schedule(args, entry)
    if name != "constant" or warmup:
        raise SystemExit(
            "--reduce-lr-factor needs a constant LR (no schedule/"
            f"warmup): got schedule={name!r}, warmup={warmup} — a "
            "schedule and metric-driven reduction would fight over "
            "the same knob")


def make_optimizer(args, entry):
    """(optimizer, lr_schedule) as the JAX ``_make_optimizer`` builds
    them; under ``--reduce-lr-factor`` the LR lives in the optimizer
    state and there is no schedule to report."""
    from tensorflow_train_distributed_torch.training import schedules
    from tensorflow_train_distributed_torch.training.optimizers import (
        make_optimizer as build,
    )

    peak = (args.learning_rate if args.learning_rate is not None
            else entry["learning_rate"])
    name, warmup = _resolve_schedule(args, entry)
    # ``run`` has refused a schedule or warm-up beside --reduce-lr-factor.
    inject = args.reduce_lr_factor is not None
    lr = peak if inject else schedules.by_name(
        name, peak, args.steps, warmup_steps=warmup)
    clip = (args.grad_clip_norm if args.grad_clip_norm is not None
            else entry.get("grad_clip_norm"))
    tx = build(args.optimizer, lr, weight_decay=args.weight_decay,
               grad_clip_norm=clip, inject_lr=inject,
               ema_decay=args.ema_decay)
    return tx, (None if inject else lr)


def _dataset_kwargs(entry: dict, args) -> dict:
    """Registry dataset kwargs with ``--dataset-kwarg KEY=VALUE``
    overrides (VALUE parsed as JSON, else kept as a string)."""
    kw = dict(entry["dataset_kwargs"])
    for item in args.dataset_kwarg:
        key, sep, raw = item.partition("=")
        if not sep or not key:
            raise SystemExit(
                f"--dataset-kwarg wants KEY=VALUE, got {item!r}")
        try:
            kw[key] = json.loads(raw)
        except ValueError:
            kw[key] = raw
    return kw


def make_source(args, entry):
    """The training source: the config's synthetic dataset, or
    ``--data-dir`` (TFRecord or mmap shards; packed under
    ``--pack-seq``)."""
    import pathlib

    from tensorflow_train_distributed_torch.data.datasets import get_dataset

    if args.pack_seq and not args.data_dir:
        raise SystemExit("--pack-seq needs --data-dir (a varlen TFRecord "
                         "corpus to pack)")
    if args.dataset_kwarg and args.data_dir:
        raise SystemExit("--dataset-kwarg overrides the config's SYNTHETIC "
                         "dataset; it has no effect with --data-dir")
    if not args.data_dir:
        return get_dataset(entry["dataset"], **_dataset_kwargs(entry, args))
    root = pathlib.Path(args.data_dir)
    records = sorted([*root.glob("*.tfrecord"), *root.glob("*.tfrecord.gz")])
    if not args.pack_seq:
        kind = "tfrecord_dir" if records else "array_dir"
        return get_dataset(kind, root=args.data_dir,
                           transform=args.data_transform)
    from tensorflow_train_distributed_torch.data.packing import (
        PackedLmSource,
    )
    from tensorflow_train_distributed_torch.data.tfrecord import (
        TFRecordSource,
    )

    if args.data_transform:
        raise SystemExit("--data-transform does not apply under --pack-seq "
                         "(packing consumes raw token documents); drop one "
                         "of the two flags")
    if not records:
        raise SystemExit(f"--pack-seq needs *.tfrecord(.gz) files under "
                         f"{root}")
    source = PackedLmSource.from_source(TFRecordSource(records),
                                        args.pack_seq, key=args.pack_key)
    vocab = entry["config"].vocab_size
    if source.max_token_id >= vocab:
        raise SystemExit(
            f"packed corpus has token id {source.max_token_id} but the "
            f"config's vocab is {vocab}; re-tokenize or pick a matching "
            "config (out-of-range ids would train on garbage)")
    return source


def make_trainer(args, entry, *, source=None, callbacks=(),
                 checkpoint_manager=None, eval_state_view=None):
    """(task, trainer, training loader) for parsed flags and a registry
    entry."""
    from tensorflow_train_distributed_torch.data.pipeline import (
        DataConfig,
        HostDataLoader,
    )
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy,
    )
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    tx, lr = make_optimizer(args, entry)
    task = registry.make_task(entry, device="meta")
    trainer = Trainer(
        task, tx, policy=Policy.from_name(args.precision),
        config=TrainerConfig(seed=args.seed, grad_accum=args.grad_accum,
                             log_every=args.log_every,
                             log_grad_norm=args.log_grad_norm,
                             checkpoint_every=args.checkpoint_every,
                             eval_state_view=eval_state_view),
        lr_schedule=lr, device=args.device, callbacks=callbacks,
        checkpoint_manager=checkpoint_manager)
    if source is None:
        source = make_source(args, entry)
    loader = HostDataLoader(source, DataConfig(
        global_batch_size=args.global_batch_size
        or entry["global_batch_size"], seed=args.seed))
    return task, trainer, loader


def _eval_view(args, state):
    """The state evaluation scores: the EMA under ``--ema-decay``."""
    if args.ema_decay is not None:
        from tensorflow_train_distributed_torch.training.ema import (
            swap_ema_params,
        )

        return swap_ema_params(state)
    return state


def _bleu_eval(args, trainer, state, loader) -> float:
    """Beam-decode ``--bleu-eval`` evaluation batches and score corpus
    BLEU (the JAX ``_bleu_eval``): hypotheses and references cut at their
    first EOS, padded rows (``sample_weight`` 0) left out."""
    import numpy as np

    from tensorflow_train_distributed_torch.data.pipeline import to_device
    from tensorflow_train_distributed_torch.models import transformer as tr
    from tensorflow_train_distributed_torch.ops.metrics import (
        corpus_bleu,
        strip_after_eos,
    )

    hyps, refs = [], []
    with trainer.inference(state):
        for _, host in zip(range(args.bleu_eval), loader):
            batch = to_device(host, trainer.device)
            out = tr.beam_translate(
                trainer.task.model, batch["inputs"],
                max_len=host["targets_out"].shape[1],
                beam_size=args.beam_size, bos_id=args.bos_id,
                eos_id=args.eos_id).cpu().numpy()
            keep = (np.asarray(host["sample_weight"]) > 0
                    if "sample_weight" in host else np.ones(len(out), bool))
            hyps += [strip_after_eos(list(r), args.eos_id)
                     for r, k in zip(out, keep) if k]
            refs += [strip_after_eos(list(r), args.eos_id)
                     for r, k in zip(np.asarray(host["targets_out"]), keep)
                     if k]
    return corpus_bleu(hyps, refs)


def _with_bleu(args, trainer, state, loader, eval_metrics):
    """``eval_metrics`` with ``bleu`` added under ``--bleu-eval``."""
    if args.bleu_eval <= 0:
        return eval_metrics
    import time

    t0 = time.perf_counter()
    bleu = _bleu_eval(args, trainer, state, loader)
    trainer.timing["bleu_s"] = time.perf_counter() - t0
    logger.info("BLEU (beam %d, %d batches): %.2f", args.beam_size,
                args.bleu_eval, bleu)
    return dict(eval_metrics or {}, bleu=bleu)


def _stdout_lines(log_every: int, last_step: int):
    """A callback printing one JSON line per logged step (every
    ``log_every`` and the last) and per evaluation event."""
    from tensorflow_train_distributed_torch.training.callbacks import (
        Callback,
    )

    class StdoutLines(Callback):
        def on_step_end(self, step, metrics):
            if (any(k.startswith("val_") for k in metrics)
                    or step % max(1, log_every) == 0 or step == last_step):
                print(json.dumps({"step": step, **metrics}), flush=True)

    return StdoutLines()


@dataclasses.dataclass
class RunResult:
    """What a launch produced (``run``'s return, for tests)."""

    state: object
    history: dict
    eval_metrics: Optional[dict]
    preempted: bool = False
    summary: Optional[dict] = None


def run(args) -> RunResult:
    """Build the stack from parsed flags; train and/or evaluate."""
    import torch

    from tensorflow_train_distributed_torch.data.datasets import (
        train_val_split,
    )
    from tensorflow_train_distributed_torch.data.pipeline import (
        DataConfig,
        HostDataLoader,
    )
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.runtime import faults
    from tensorflow_train_distributed_torch.training.callbacks import (
        BestCheckpoint,
        History,
        JsonlLogger,
        ReduceLROnPlateau,
        StallWatchdog,
    )
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    refuse_unported(args)
    if args.config is None:
        raise SystemExit("--config is required")
    # Arm the fault plan first (the flag wins over TTD_FAULT_PLAN), so a
    # typo'd spec dies before any setup.
    if args.fault_plan:
        faults.arm(args.fault_plan, seed=args.seed)
    elif faults.arm_from_env(seed=args.seed) is None:
        faults.disarm()
    # Flag-vs-flag refusals, before any setup.
    if args.eval_only and args.eval_steps <= 0:
        raise SystemExit("--eval-only needs --eval-steps N (>0)")
    if args.save_best and not args.checkpoint_dir:
        raise SystemExit("--save-best needs --checkpoint-dir")
    if args.eval_every and args.eval_steps <= 0:
        raise SystemExit("--eval-every needs --eval-steps N (>0) to size "
                         "each validation run")
    if args.eval_split and args.eval_steps <= 0:
        raise SystemExit("--eval-split without --eval-steps N (>0) would "
                         "hold out data that is never evaluated; add "
                         "--eval-steps (and optionally --eval-every)")
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    try:
        entry = registry.get_entry(args.config)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.bleu_eval > 0:
        from tensorflow_train_distributed_torch.models.transformer import (
            TransformerConfig,
        )

        # Fail at launch, not after the run.
        if not isinstance(entry["config"], TransformerConfig):
            raise SystemExit(
                "--bleu-eval needs a seq2seq config (wmt family); "
                f"{args.config} does not decode")
        if args.beam_size < 1:
            raise SystemExit(f"--beam-size must be >= 1, got "
                             f"{args.beam_size}")
    if args.reduce_lr_factor is not None:
        if not 0.0 < args.reduce_lr_factor < 1.0:
            raise SystemExit(f"--reduce-lr-factor must be in (0, 1), got "
                             f"{args.reduce_lr_factor}")
        _validate_constant_lr(args, entry)
    if args.ema_decay is not None and not 0.0 < args.ema_decay < 1.0:
        raise SystemExit(f"--ema-decay must be in (0, 1), got "
                         f"{args.ema_decay}")
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda but no CUDA device is "
                             "available")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    global_batch = args.global_batch_size or entry["global_batch_size"]
    source = make_source(args, entry)
    eval_source = source
    if args.eval_split:
        source, eval_source = train_val_split(
            source, args.eval_split, min_val=global_batch,
            min_train=global_batch)
    elif args.eval_steps > 0 or args.bleu_eval > 0:
        logger.warning(
            "evaluation will run on the TRAINING distribution (no "
            "--eval-split): val_* metrics are not held-out numbers")

    def make_eval_loader():
        # A fresh single pass per evaluation, padded (sample_weight 0 on
        # the pad rows) so a finite split counts every example once.
        return HostDataLoader(eval_source, DataConfig(
            global_batch_size=global_batch, seed=args.seed + 1,
            num_epochs=1, drop_remainder=False))

    # val_loss reaches step events only under periodic eval; it is what
    # ReduceLROnPlateau and BestCheckpoint watch then.
    monitor = "val_loss" if args.eval_every and args.eval_steps > 0 \
        else "loss"
    history = History()
    callbacks = [history, _stdout_lines(args.log_every, args.steps)]
    if args.reduce_lr_factor is not None:
        callbacks.append(ReduceLROnPlateau(
            monitor=monitor, factor=args.reduce_lr_factor,
            patience=args.reduce_lr_patience, min_lr=args.reduce_lr_min,
            cooldown=args.reduce_lr_cooldown))
    if args.jsonl_log:
        callbacks.append(JsonlLogger(args.jsonl_log))
    if args.stall_timeout > 0:
        callbacks.append(StallWatchdog(args.stall_timeout))
    ckpt = watcher = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir,
                                 max_to_keep=args.max_to_keep)
        if args.save_best:
            callbacks.append(BestCheckpoint(
                os.path.join(args.checkpoint_dir, "best"), monitor=monitor))
        if not args.no_preemption_handler:
            from tensorflow_train_distributed_torch.runtime.preemption \
                import PreemptionCheckpointCallback, PreemptionWatcher

            try:
                watcher = PreemptionWatcher(
                    watch_sigint=args.watch_sigint).install()
            except RuntimeError:    # not on the main thread
                watcher = None
            if watcher is not None:
                callbacks.append(PreemptionCheckpointCallback(watcher))
    try:
        task, trainer, loader = make_trainer(
            args, entry, source=source, callbacks=callbacks,
            checkpoint_manager=ckpt,
            eval_state_view=((lambda s: _eval_view(args, s))
                             if args.ema_decay is not None else None))
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"{args.config}: {e}")

    eval_metrics = None
    preempted = False
    try:
        params = None
        if args.params_npz:
            from tensorflow_train_distributed_torch import convert

            params = convert.load_npz(args.params_npz, entry["config"])
        state = trainer.create_state(params)
        if (ckpt is not None and not args.no_resume
                and ckpt.latest_step() is not None):
            # The manager checks a step before it writes into the
            # template, so a failed restore leaves the fresh state whole.
            restored = ckpt.restore(state)
            if restored is None:
                logger.error("no restorable checkpoint in %s (every "
                             "retained step quarantined); starting fresh",
                             args.checkpoint_dir)
            else:
                state = restored
                logger.info("resumed from step %d", state.step)
        if args.eval_only:
            if ckpt is None or ckpt.last_restore is None:
                raise SystemExit("--eval-only needs a restorable "
                                 "checkpoint (--checkpoint-dir with a "
                                 "saved state)")
            eval_metrics = _with_bleu(
                args, trainer, _eval_view(args, state), make_eval_loader(),
                _evaluate(trainer, make_eval_loader(),
                          _eval_view(args, state), args))
            print(json.dumps({"step": state.step, "eval": eval_metrics}),
                  flush=True)
            return RunResult(state, history.history, eval_metrics,
                             summary=_summary(trainer, ckpt, state,
                                              eval_metrics))

        remaining = args.steps - state.step
        if remaining > 0:
            if state.step:
                consumed = (ckpt.restored_meta or {}).get(
                    "data_position", {}).get("batches_consumed",
                                             state.step)
                epoch, batch = divmod(consumed, loader.steps_per_epoch())
                logger.info("data stream resumed at epoch %d, batch %d "
                            "(%d batches consumed)", epoch, batch,
                            consumed)
                batches = loader.iter_from(consumed)
            else:
                batches = loader
            eval_kwargs = {}
            if args.eval_every and args.eval_steps > 0:
                eval_kwargs = dict(eval_batches=make_eval_loader,
                                   eval_every=args.eval_every,
                                   eval_steps=args.eval_steps)
            state, _ = trainer.fit(
                batches, steps=remaining, state=state,
                steps_per_epoch=loader.steps_per_epoch(), **eval_kwargs)
        else:
            logger.info("checkpoint already at/past --steps; nothing to "
                        "train")
        preempted = watcher is not None and watcher.preempted
        if (args.eval_steps > 0 or args.bleu_eval > 0) and not preempted:
            if args.eval_steps > 0:
                eval_metrics = _evaluate(trainer, make_eval_loader(),
                                         _eval_view(args, state), args)
            eval_metrics = _with_bleu(args, trainer, _eval_view(args, state),
                                      make_eval_loader(), eval_metrics)
            print(json.dumps({"step": state.step, "eval": eval_metrics}),
                  flush=True)
    finally:
        if watcher is not None:
            watcher.uninstall()
    return RunResult(state, history.history, eval_metrics, preempted,
                     _summary(trainer, ckpt, state, eval_metrics))


def _evaluate(trainer, loader, state, args) -> dict:
    import time

    n = loader.steps_per_epoch()
    if 0 < n < args.eval_steps:
        logger.warning("--eval-steps=%d exceeds the evaluation source's %d "
                       "batches; the evaluation averages over %d",
                       args.eval_steps, n, n)
    t0 = time.perf_counter()
    out = trainer.evaluate(loader, state, steps=args.eval_steps)
    trainer.timing["eval_s"].append(time.perf_counter() - t0)
    logger.info("eval: %s", out)
    return out


def _summary(trainer, ckpt, state, eval_metrics) -> dict:
    """Host timings of the run and the kernels' launch counts."""
    import torch

    from tensorflow_train_distributed_torch.ops import kernels as K

    timing = trainer.timing
    # Each read window's seconds a step, the first (warm-up) left out.
    per_step = [s / n * 1e3 for n, s in timing["windows"][1:] if n]
    return {
        "step": state.step,
        "device": str(trainer.device),
        "window_ms_per_step": per_step,
        "step_ms": statistics.median(per_step) if per_step else None,
        "eval_s": timing["eval_s"],
        "bleu_s": timing.get("bleu_s"),
        "save_s": timing["save_s"],
        "save_bytes": None if ckpt is None or ckpt.last_save is None
        else ckpt.last_save["bytes"],
        "restore": None if ckpt is None else ckpt.last_restore,
        "eval": eval_metrics,
        "launches": {k: v for k, v in K.launch_counts().items() if v},
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(trainer.device)
                           if trainer.device.type == "cuda" else None),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    if args.list_configs:
        from tensorflow_train_distributed_torch.models import registry

        for name in registry.available():
            e = registry.get_entry(name)
            print(f"{name}: dataset={e['dataset']} "
                  f"batch={e['global_batch_size']} lr={e['learning_rate']}")
        return 0
    from tensorflow_train_distributed_torch.runtime.preemption import (
        PREEMPTION_EXIT_CODE,
    )

    result = run(args)
    logger.info("launch summary: %s", json.dumps(result.summary))
    if result.preempted:
        logger.warning("exiting after a preemption checkpoint")
        return PREEMPTION_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(main())
