"""The ``train_distributed`` launcher: flags → cluster → mesh → data →
trainer → fit / evaluate, with checkpoints and resume (the counterpart
of the JAX package's ``launch.py``, with its flag names), on one GPU or
on many, one process a device.

    python -m tensorflow_train_distributed_torch --config llama_125m_lm \\
        --steps 1000 --checkpoint-dir /ckpt --checkpoint-every 200 \\
        --eval-split 0.001 --eval-steps 4 --eval-every 100
    python -m tensorflow_train_distributed_torch --config llama_tiny_sft \\
        --steps 20 --device cpu
    python -m tensorflow_train_distributed_torch --list-configs
    # two ranks on the CPU (gloo), data × tensor:
    python -m tensorflow_train_distributed_torch --config llama_tiny_sft \
        --steps 20 --device cpu --cpu-devices 2 --strategy dp_tp
    # one process of an N-process job (NCCL on CUDA):
    python -m tensorflow_train_distributed_torch --config llama2_7b_sft \
        --num-processes N --process-id I --coordinator-address host:port

The cluster resolves from ``--coordinator-address``/``--num-processes``/
``--process-id``, else the ``TTD_*`` env, ``TF_CONFIG``, Slurm,
Kubernetes or GCE metadata (``runtime/distributed.py``); the mesh from
``--strategy`` (default: the config's registry strategy, shrunk to fit
the world) with ``--mesh`` axis overrides and ``--dcn`` node placement
(``runtime/mesh.py``).  ``--cpu-devices N`` starts N local gloo ranks on
the CPU.  ``--zero1``, ``--sharded-update``, ``--grad-quant`` and
``--grad-overlap`` are the JAX trainer's (``training/trainer.py``).  Each
rank reads its rows of every global batch; rank 0 prints and writes the
checkpoints, which hold the whole state and restore at any world size
(a device-loss relaunch with ``TTD_ELASTIC_DEVICES`` restores onto the
survivors).  A ``seq`` axis shards each row's tokens for a config with
``seq_parallel`` and a ``pipeline`` axis splits the layers into GPipe
stages for one with ``pipeline_microbatches`` (``llama_tiny_pp``); other
configs run whole rows and every layer on each such rank, as the JAX
launcher does.  A mesh with ``tensor`` or ``fsdp`` above 1 logs what
those axes do not split yet (``runtime.mesh.UNSPLIT_COMPUTE``).

The config's registry entry supplies the dataset, global batch, peak
learning rate, schedule, warmup ratio and global-norm clip unless a flag
overrides them.  Weights come from the newest good checkpoint in
``--checkpoint-dir`` (unless ``--no-resume``), else from ``--params-npz``
(an ``np.savez`` of the flat flax parameter dict), else at random from
``--seed``; ``--init-from-hf DIR`` starts from a local HuggingFace
checkpoint instead (``models/import_hf.py``: Llama-family and sparse-MoE
decoders into the config's model, a BERT masked-LM checkpoint into a
task rebuilt around its own config), and a later resume from
``--checkpoint-dir`` takes precedence over the import; ``--eval-only``
evaluates an import too.  A resumed run takes the data stream up
mid-epoch where the checkpoint left it, so a run that was killed and
resumed ends where an uninterrupted one does.

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

``--data-workers N`` feeds training from N input-worker processes
(``data/service.py``, the tf.data service), each building one slice of
every batch, for the config's synthetic dataset or ``--data-dir``
(``--data-transform imagenet_train_224`` and the other ``data/image.py``
names decode and augment JPEG records there).  A worker that dies fails
the run; the stream restarts at epoch 0 on a resume, which the launcher
warns about.  ``--lora-rank R`` (``--lora-alpha``, ``--lora-targets``)
fine-tunes a decoder's adapters over a frozen base (``models/lora.py``)
and writes ``lora_spec.json`` beside the checkpoints.

``--supervise`` runs the launcher (less the supervisor's flags) as a
child process under ``runtime.supervisor.TrainSupervisor``: a crash is
relaunched under jittered exponential backoff within ``--max-restarts``
(in a ``--restart-window``), a preemption (exit 143) is relaunched free
of that budget, and every attempt is journaled to
``--supervisor-journal`` (default ``<checkpoint-dir>/supervisor.jsonl``);
each relaunch resumes from the newest good checkpoint.  A device loss
(``mesh:device_lost`` in the fault plan, or a runtime error that reads
as one) exits 113 after writing the survivors to the elastic sidecar;
the relaunch comes back on the survivors (``--cpu-devices`` shrunk to
``TTD_ELASTIC_DEVICES``, the mesh degraded to fit), restoring the
checkpoint resharded.  ``--steps-per-execution k`` fuses
k optimizer steps into one trainer call (``Trainer.train_steps``); a
resume whose remaining steps are not a multiple of k rounds them up.
``--tensorboard-dir`` writes the logged metrics as TensorBoard scalars,
and ``--profile-dir`` captures a ``torch.profiler`` trace of the
``--profile-steps START,STOP`` window.

``--profiler-port P`` opens a localhost capture listener in rank 0's
process (``runtime/profiling.CaptureServer``; 0 picks a free port, logged):
a request for N steps traces the next N steps into the directory it names
and answers with the trace's path, the on-demand capture the JAX flag's
profiler server gives, without a planned ``--profile-dir`` window.
``--device`` (default ``cuda``) never falls back to the CPU; on CUDA the
launcher pins cuDNN to its deterministic algorithms, so a resumed run of
a convolutional model ends where an uninterrupted one does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import statistics
import sys
import time
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

from tensorflow_train_distributed_torch.runtime.mesh import (  # noqa: E402
    STRATEGY_PRESETS,
)


def build_parser(light: bool = False) -> argparse.ArgumentParser:
    """The launcher's flags.  ``light`` skips what needs torch (the
    config names in the help, the optimizer choices): the supervisor's
    relaunch loop parses with it and imports no torch, and its child
    checks those two flags."""
    configs, optimizers = "see --list-configs", None
    if not light:
        from tensorflow_train_distributed_torch.models import registry
        from tensorflow_train_distributed_torch.training.optimizers import (
            OPTIMIZERS as optimizers,
        )

        configs = f"one of {registry.available()}"
    p = argparse.ArgumentParser(
        prog="train_distributed",
        description="Training launcher of the PyTorch port")
    a = p.add_argument
    a("--config", default=None, help=f"model config; {configs}")
    a("--list-configs", action="store_true",
      help="print available configs and exit")
    a("--steps", type=int, default=100,
      help="train until the state's step reaches this")
    a("--global-batch-size", "--batch-size", dest="global_batch_size",
      type=int, default=None, help="global batch size (default: the "
      "config's)")
    a("--learning-rate", type=float, default=None)
    a("--optimizer", default="adamw", choices=optimizers)
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
      help="optimizer steps fused into one trainer call over a stacked "
      "super-batch (callbacks and saves see every k-th step)")
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
      help="named record transform for --data-dir (e.g. "
      "imagenet_train_224, imagenet_eval_u8_224, u8_image_to_f32)")
    a("--data-workers", type=int, default=0, metavar="N",
      help="serve training batches from N input-worker processes (the "
      "tf.data service): record reads, decode and augmentation run there")
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
    a("--tensorboard-dir", default=None,
      help="write the logged metrics as TensorBoard scalars here")
    a("--profile-dir", default=None,
      help="capture a torch.profiler trace (Chrome JSON) into this "
      "directory (reference: TensorBoard callback profile_batch)")
    a("--profile-steps", default="10,20", metavar="START,STOP",
      help="step window for --profile-dir")
    a("--profiler-port", type=int, default=None, metavar="PORT",
      help="on-demand traces: a localhost listener (0: a free port) that "
      "takes {\"steps\": N, \"logdir\": DIR} and traces the next N steps "
      "(runtime/profiling.request_capture)")
    # Self-healing supervision (runtime.supervisor): the launcher runs as
    # a child process, its exit is classified (clean / preemption /
    # device loss / crash) and relaunched under a restart budget; the
    # relaunch resumes through the normal restore path.
    a("--supervise", action="store_true",
      help="run training under the self-healing supervisor (relaunch on "
      "crash/preemption)")
    a("--max-restarts", type=int, default=3,
      help="crash restart budget under --supervise (preemption exits "
      "never consume it)")
    a("--restart-backoff", type=float, default=1.0,
      help="base crash-relaunch delay; doubles per consecutive crash")
    a("--restart-backoff-max", type=float, default=60.0,
      help="cap on the crash-relaunch delay")
    a("--restart-window", type=float, default=0.0,
      help="rolling window (seconds) for the crash budget: only crashes "
      "within it count against --max-restarts (0 = lifetime accounting)")
    a("--restart-jitter", type=float, default=0.1,
      help="jitter the crash backoff UP by up to this fraction of itself "
      "(0 disables)")
    a("--no-elastic", action="store_true",
      help="treat device-loss exits as plain crashes (TTD_NO_ELASTIC=1 "
      "is the env equivalent)")
    a("--max-device-losses", type=int, default=16,
      help="give up after this many device-loss relaunches")
    a("--no-restart-on-preemption", action="store_true",
      help="hand the preemption exit code to the caller instead of "
      "relaunching")
    a("--supervisor-journal", default=None,
      help="JSON-lines attempt journal (default: "
      "<checkpoint-dir>/supervisor.jsonl)")
    a("--stall-timeout", type=float, default=0.0,
      help="warn and dump stacks when no step completes in this many "
      "seconds; 0 disables")
    a("--params-npz", default="",
      help="np.savez of the flat flax params (default: random weights "
      "from --seed)")
    a("--init-from-hf", default=None, metavar="DIR",
      help="start from a local HuggingFace checkpoint directory "
      "(Llama-family, Mixtral / Qwen2-MoE or BERT masked-LM); a resume "
      "from --checkpoint-dir takes precedence")
    a("--device", default="cuda",
      help="torch device (default cuda; 'cpu' runs the kernels' plain "
      "versions)")
    a("--lora-rank", type=int, default=0,
      help="LoRA: train rank-R adapters on --lora-targets over a frozen "
      "base (decoder configs; 0 = full fine-tuning)")
    a("--lora-alpha", type=float, default=16.0,
      help="LoRA scaling numerator (the delta is alpha/rank x A.B)")
    a("--lora-targets", default="query,value",
      help="comma-separated Dense names to adapt: query, key, value, out, "
      "wi_gate, wi_up, wo, lm_head")
    d = p.add_argument_group(
        "distributed", "the cluster, the mesh and the gradient sync (the "
        "JAX launcher's flags)").add_argument
    d("--strategy", default=None,
      help="mesh preset (default: the config's); one of "
      f"{sorted(STRATEGY_PRESETS)}; the reference names (mirrored, "
      "multi_worker_mirrored, horovod, tpu, dtensor) are accepted, "
      "ps/parameter_server refused")
    d("--mesh", default=None, metavar="AXIS=N,...",
      help="mesh axis sizes overriding the preset, e.g. data=4,tensor=2 "
      "(one axis may be -1)")
    d("--dcn", default=None, metavar="AXIS=N,...",
      help="multi-node placement: how many nodes divide each axis, e.g. "
      "data=4 (ranks numbered node by node)")
    d("--zero1", action="store_true",
      help="ZeRO-1: optimizer state split over the data axis")
    d("--sharded-update", action="store_true",
      help="cross-replica sharded weight update: each data rank updates "
      "its piece, then the params are all-gathered (implies --zero1's "
      "split)")
    d("--grad-quant", default="none", choices=["none", "f32", "int8"],
      help="quantized gradient sync over data (int8 with an error-"
      "feedback residual in the train state; f32 the exact explicit "
      "baseline); TTD_NO_GRAD_QUANT=1 forces none")
    d("--grad-overlap", type=int, default=4, metavar="K",
      help="with --grad-quant: K byte-balanced buckets in reverse-"
      "backward order, each its own sync (0/1: one sync); "
      "TTD_NO_GRAD_OVERLAP=1 forces 0")
    d("--coordinator-address", default=None, metavar="HOST:PORT",
      help="rank 0's TCP store (with --num-processes, --process-id)")
    d("--num-processes", type=int, default=None)
    d("--process-id", type=int, default=None)
    d("--platform", default=None, choices=["cpu", "cuda", "gpu"],
      help="the JAX flag: picks --device (cpu, or cuda for cuda/gpu)")
    d("--cpu-devices", type=int, default=None, metavar="N",
      help="start N local ranks on the CPU (gloo), one process each")
    return p


def _parse_profile_steps(spec: str) -> tuple:
    try:
        start, stop = (int(p) for p in spec.split(","))
        return start, stop
    except ValueError:
        raise SystemExit(
            f"--profile-steps expects START,STOP (two integers), got "
            f"{spec!r}") from None


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
    if args.lora_rank:
        # Adapters-only updates and state, around the clip chain: the
        # global norm is the adapters' (``run`` refuses --ema-decay here).
        from tensorflow_train_distributed_torch.models.lora import (
            freeze_base,
        )

        tx = freeze_base(tx)
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


def _tfrecords(root) -> list:
    import pathlib

    root = pathlib.Path(root)
    return sorted([*root.glob("*.tfrecord"), *root.glob("*.tfrecord.gz")])


def source_spec(args, entry):
    """The ``service.SourceSpec`` the input workers build the training
    source from: ``--data-dir`` (TFRecord or mmap shards, with
    ``--data-transform``) or the config's synthetic dataset."""
    from tensorflow_train_distributed_torch.data.service import SourceSpec

    if args.data_dir:
        kind = "tfrecord_dir" if _tfrecords(args.data_dir) else "array_dir"
        return SourceSpec(kind, {"root": args.data_dir,
                                 "transform": args.data_transform})
    return SourceSpec(entry["dataset"], _dataset_kwargs(entry, args))


def make_source(args, entry):
    """The training source: the config's synthetic dataset, or
    ``--data-dir`` (TFRecord or mmap shards; packed under
    ``--pack-seq``)."""
    if args.pack_seq and not args.data_dir:
        raise SystemExit("--pack-seq needs --data-dir (a varlen TFRecord "
                         "corpus to pack)")
    if args.dataset_kwarg and args.data_dir:
        raise SystemExit("--dataset-kwarg overrides the config's SYNTHETIC "
                         "dataset; it has no effect with --data-dir")
    if not args.pack_seq:
        return source_spec(args, entry).build()
    from tensorflow_train_distributed_torch.data.packing import (
        PackedLmSource,
    )
    from tensorflow_train_distributed_torch.data.tfrecord import (
        TFRecordSource,
    )

    records = _tfrecords(args.data_dir)
    if args.data_transform:
        raise SystemExit("--data-transform does not apply under --pack-seq "
                         "(packing consumes raw token documents); drop one "
                         "of the two flags")
    if not records:
        raise SystemExit(f"--pack-seq needs *.tfrecord(.gz) files under "
                         f"{args.data_dir}")
    source = PackedLmSource.from_source(TFRecordSource(records),
                                        args.pack_seq, key=args.pack_key)
    vocab = entry["config"].vocab_size
    if source.max_token_id >= vocab:
        raise SystemExit(
            f"packed corpus has token id {source.max_token_id} but the "
            f"config's vocab is {vocab}; re-tokenize or pick a matching "
            "config (out-of-range ids would train on garbage)")
    return source


def lora_spec(args):
    """The ``LoraSpec`` of ``--lora-*``, or None without ``--lora-rank``;
    exits on a bad value."""
    if not args.lora_rank:
        return None
    from tensorflow_train_distributed_torch.models.lora import (
        LoraSpec,
        validate_targets,
    )

    try:
        return LoraSpec(rank=args.lora_rank, alpha=args.lora_alpha,
                        targets=validate_targets(
                            args.lora_targets.split(",")))
    except ValueError as e:
        raise SystemExit(str(e))


def make_trainer(args, entry, *, source=None, callbacks=(),
                 checkpoint_manager=None, eval_state_view=None,
                 with_loader=True, mesh=None):
    """(task, trainer, training loader) for parsed flags and a registry
    entry; the loader is None without ``with_loader`` (the data service
    feeds the run).  Under ``--lora-rank`` the config gains the spec.
    On ``mesh`` the trainer trains on it and the loader yields this
    rank's rows (its index along the batch axes)."""
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

    spec = lora_spec(args)
    if spec is not None:
        entry = dict(entry, config=dataclasses.replace(entry["config"],
                                                       lora=spec))
    tx, lr = make_optimizer(args, entry)
    task = registry.make_task(entry, device="meta")
    trainer = Trainer(
        task, tx, policy=Policy.from_name(args.precision),
        config=TrainerConfig(seed=args.seed, grad_accum=args.grad_accum,
                             log_every=args.log_every,
                             log_grad_norm=args.log_grad_norm,
                             checkpoint_every=args.checkpoint_every,
                             eval_state_view=eval_state_view,
                             steps_per_execution=args.steps_per_execution,
                             zero1=args.zero1, grad_quant=args.grad_quant,
                             grad_overlap=args.grad_overlap,
                             sharded_update=args.sharded_update),
        lr_schedule=lr, device=args.device, callbacks=callbacks,
        checkpoint_manager=checkpoint_manager, mesh=mesh)
    if not with_loader:
        return task, trainer, None
    if source is None:
        source = make_source(args, entry)
    loader = HostDataLoader(source, DataConfig(
        global_batch_size=args.global_batch_size
        or entry["global_batch_size"], seed=args.seed),
        **_shard_of(mesh))
    return task, trainer, loader


def _shard_of(mesh) -> dict:
    """The loader's process index and count: this rank's place along the
    batch axes (ranks that differ only along tensor or expert read the
    same rows)."""
    if mesh is None:
        return {}
    axes = ("data", "fsdp")
    return dict(process_index=mesh.index(axes),
                process_count=mesh.group_size(axes))


def _parse_mesh_overrides(spec: str) -> dict:
    from tensorflow_train_distributed_torch.runtime.mesh import AXES

    sizes: dict = {}
    for part in spec.split(","):
        if not part:
            continue
        axis, _, val = part.partition("=")
        axis = axis.strip()
        if axis not in AXES:
            raise SystemExit(f"Unknown mesh axis {axis!r}; axes: {AXES}")
        try:
            sizes[axis] = int(val)
        except ValueError:
            raise SystemExit(f"--mesh/--dcn: {part!r} is not AXIS=N")
    return sizes


def _check_mesh_flags(args) -> None:
    """The mesh flags' refusals, before any setup: an unknown or
    parameter-server strategy, an unknown axis."""
    from tensorflow_train_distributed_torch.runtime.mesh import (
        strategy_preset,
    )

    if args.strategy is not None:
        try:
            strategy_preset(args.strategy)
        except ValueError as e:
            raise SystemExit(str(e))
    if args.mesh:
        _parse_mesh_overrides(args.mesh)


def _build_mesh(args, entry, cluster):
    """The run's mesh: the strategy preset (the flag, else the config's)
    shrunk to the world, ``--mesh`` overrides, the elastic degrade,
    ``--dcn`` placement."""
    from tensorflow_train_distributed_torch.runtime.mesh import (
        UNSPLIT_COMPUTE,
        MeshConfig,
        build_mesh,
        degrade_to_fit,
        strategy_preset,
    )
    from tensorflow_train_distributed_torch.runtime.supervisor import (
        ENV_ELASTIC_DEVICES,
    )

    strategy = args.strategy or entry.get("strategy", "dp")
    n = cluster.num_processes
    cfg = strategy_preset(strategy, n)
    if args.mesh:
        sizes = cfg.axis_sizes()
        overrides = _parse_mesh_overrides(args.mesh)
        sizes.update(overrides)
        if -1 not in sizes.values() and "data" not in overrides:
            sizes["data"] = -1
        cfg = MeshConfig(strategy=strategy, **sizes)
    if os.environ.get(ENV_ELASTIC_DEVICES):
        fitted = degrade_to_fit(cfg, n)
        if fitted.axis_sizes() != cfg.axis_sizes():
            logger.warning("elastic relaunch: mesh %s does not fit %d "
                           "device(s); degraded to %s", cfg.axis_sizes(),
                           n, fitted.axis_sizes())
        cfg = fitted
    dcn = _parse_mesh_overrides(args.dcn) if args.dcn else None
    try:
        cfg.resolve(n)
    except ValueError as e:
        raise SystemExit(f"--strategy {strategy}: {e}")
    try:
        mesh = build_mesh(cfg, world_size=n, rank=cluster.process_id,
                          device_type=("cuda" if args.device.startswith(
                              "cuda") else "cpu"), dcn_axes=dcn)
    except ValueError as e:
        raise SystemExit(f"--strategy {strategy}: {e}")
    logger.info("mesh: %s (strategy=%s, %d process(es))", mesh.shape,
                strategy, n)
    if mesh.shape["tensor"] > 1:
        logger.warning(
            "tensor=%d: every tensor rank runs the whole forward and "
            "backward on the same rows; the axis splits only the optimizer "
            "state and update, as --zero1 over data would, and saves no "
            "parameter or activation memory (%s)", mesh.shape["tensor"],
            UNSPLIT_COMPUTE)
    if mesh.shape["fsdp"] > 1:
        logger.warning(
            "fsdp=%d: the parameters stay whole on every rank between "
            "steps; the optimizer state and gradients are split (%s)",
            mesh.shape["fsdp"], UNSPLIT_COMPUTE)
    return mesh


def _agree(args, mesh) -> None:
    """Every rank runs the same job: its flags' digest and the mesh are
    all-gathered and compared (a collective on the job's group, one
    process included)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    mine = json.dumps({k: v for k, v in sorted(vars(args).items())
                       if k not in ("process_id", "fault_plan")},
                      sort_keys=True, default=str)
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (mine, mesh.shape))
    if any(x != seen[0] for x in seen):
        raise SystemExit("the job's processes disagree on their flags or "
                         "mesh; launch every process with the same flags")


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
    t0 = time.perf_counter()
    bleu = _bleu_eval(args, trainer, state, loader)
    trainer.timing["bleu_s"] = time.perf_counter() - t0
    logger.info("BLEU (beam %d, %d batches): %.2f", args.beam_size,
                args.bleu_eval, bleu)
    return dict(eval_metrics or {}, bleu=bleu)


def _stdout_lines(log_every: int, last_step: int, enabled: bool = True):
    """A callback printing one JSON line per logged step (every
    ``log_every`` and the last) and per evaluation event (rank 0's only:
    ``enabled``)."""
    from tensorflow_train_distributed_torch.training.callbacks import (
        Callback,
    )

    class StdoutLines(Callback):
        def on_step_end(self, step, metrics):
            if enabled and (any(k.startswith("val_") for k in metrics)
                            or step % max(1, log_every) == 0
                            or step == last_step):
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
    """Build the stack from parsed flags; train and/or evaluate.  A
    process group the run joins is left at its end."""
    from tensorflow_train_distributed_torch.runtime import distributed

    joined: list = []
    try:
        return _run(args, joined)
    finally:
        if joined:
            distributed.shutdown_distributed()


def _run(args, joined: list) -> RunResult:
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
        TensorBoardScalars,
    )
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    if args.config is None:
        raise SystemExit("--config is required")
    _check_mesh_flags(args)
    if args.platform:
        args.device = "cpu" if args.platform == "cpu" else "cuda"
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
    if args.init_from_hf is not None:
        if args.params_npz:
            raise SystemExit("--init-from-hf and --params-npz both name "
                             "the weights; pass one")
        if args.lora_rank:
            raise SystemExit("--init-from-hf with --lora-rank is not "
                             "supported: the import carries no adapters")
        if not os.path.isdir(args.init_from_hf):
            raise SystemExit(f"--init-from-hf: no HuggingFace checkpoint "
                             f"directory at {args.init_from_hf}")
    if args.steps_per_execution < 1:
        raise SystemExit(f"--steps-per-execution must be >= 1, got "
                         f"{args.steps_per_execution}")
    profile_window = (_parse_profile_steps(args.profile_steps)
                      if args.profile_dir else None)
    if args.data_workers < 0:
        raise SystemExit(f"--data-workers must be >= 0, got "
                         f"{args.data_workers}")
    if args.data_workers and args.pack_seq:
        raise SystemExit("--data-workers does not compose with --pack-seq "
                         "(packing runs in-process); drop one of the flags")
    if args.data_workers and args.eval_split:
        raise SystemExit("--data-workers does not compose with --eval-split: "
                         "the workers stream the WHOLE dataset, so training "
                         "would consume the held-out examples; drop one of "
                         "the flags")
    try:
        entry = registry.get_entry(args.config)
    except ValueError as e:
        raise SystemExit(str(e))
    global_batch = args.global_batch_size or entry["global_batch_size"]
    if args.data_workers and global_batch % args.data_workers:
        raise SystemExit(f"global batch {global_batch} not divisible by "
                         f"--data-workers={args.data_workers} (each worker "
                         "serves an equal slice of every batch)")
    spec = lora_spec(args)
    if spec is not None:
        from tensorflow_train_distributed_torch.models.llama import (
            LlamaConfig,
        )

        if not isinstance(entry["config"], LlamaConfig):
            raise SystemExit(f"--lora-rank applies to decoder-LM configs; "
                             f"{args.config!r} is not one")
        if args.ema_decay is not None:
            raise SystemExit(
                "--ema-decay with --lora-rank is not supported: the EMA "
                "would keep a full f32 copy of the FROZEN base, defeating "
                "LoRA's memory saving")
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
    # The cluster (flags, then the TTD_*/TF_CONFIG/Slurm/Kubernetes/GCE
    # env) and the mesh.
    import torch.distributed as dist

    from tensorflow_train_distributed_torch.runtime.distributed import (
        initialize_distributed,
        resolve_cluster,
    )

    try:
        cluster = resolve_cluster(args.coordinator_address,
                                  args.num_processes, args.process_id)
    except ValueError as e:
        raise SystemExit(str(e))
    was_up = dist.is_available() and dist.is_initialized()
    try:
        initialize_distributed(cluster, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    if not was_up and dist.is_initialized():
        joined.append(True)
    if cluster.is_multiprocess and args.data_workers:
        raise SystemExit("--data-workers runs in one process; a "
                         "multi-process job reads with the in-process "
                         "loader")
    mesh = _build_mesh(args, entry, cluster)
    _agree(args, mesh)
    writer = mesh.rank == 0
    split = (mesh.shape["fsdp"] > 1 or mesh.shape["tensor"] > 1
             or ((args.zero1 or args.sharded_update)
                 and mesh.shape["data"] > 1))
    if split and (args.optimizer in ("lamb", "adafactor")
                  or args.ema_decay is not None):
        what = ("--ema-decay" if args.ema_decay is not None
                else f"--optimizer {args.optimizer}")
        raise SystemExit(
            f"{what} needs whole parameters in the optimizer: a mesh "
            "that splits the optimizer state (fsdp, tensor, --zero1 or "
            "--sharded-update over data) runs sgd, momentum, adam and "
            "adamw; use --strategy dp")

    if args.checkpoint_dir:
        _check_lora_sidecar(args.checkpoint_dir, spec)
    # With the workers reading every record and no in-process consumer
    # (evaluation, BLEU, the HF import's sample batch), the trainer builds
    # no source at all.
    service_only = (args.data_workers > 0 and args.eval_steps <= 0
                    and args.bleu_eval <= 0 and args.init_from_hf is None)
    source = None if service_only else make_source(args, entry)
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
            num_epochs=1, drop_remainder=False), **_shard_of(mesh))

    # val_loss reaches step events only under periodic eval; it is what
    # ReduceLROnPlateau and BestCheckpoint watch then.
    monitor = "val_loss" if args.eval_every and args.eval_steps > 0 \
        else "loss"
    history = History()
    callbacks = [history, _stdout_lines(args.log_every, args.steps,
                                        enabled=writer)]
    if args.reduce_lr_factor is not None:
        callbacks.append(ReduceLROnPlateau(
            monitor=monitor, factor=args.reduce_lr_factor,
            patience=args.reduce_lr_patience, min_lr=args.reduce_lr_min,
            cooldown=args.reduce_lr_cooldown))
    if args.tensorboard_dir:
        callbacks.append(TensorBoardScalars(args.tensorboard_dir))
    if args.jsonl_log:
        callbacks.append(JsonlLogger(args.jsonl_log))
    if profile_window is not None:
        from tensorflow_train_distributed_torch.runtime.profiling import (
            ProfileCallback,
        )

        callbacks.append(ProfileCallback(
            args.profile_dir, start_step=profile_window[0],
            stop_step=profile_window[1]))
    if args.profiler_port is not None and writer:
        from tensorflow_train_distributed_torch.runtime.profiling import (
            CaptureServer,
        )

        capture = CaptureServer(args.profiler_port)
        logger.warning("profiler capture server listening on %s:%d",
                       capture.host, capture.port)
        callbacks.append(capture)
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
                             if args.ema_decay is not None else None),
            with_loader=not service_only, mesh=mesh)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"{args.config}: {e}")

    eval_metrics = None
    preempted = False
    dispatcher = service_start_s = None
    try:
        params = None
        resuming = (ckpt is not None and not args.no_resume
                    and ckpt.latest_step() is not None)
        if args.params_npz:
            from tensorflow_train_distributed_torch import convert

            params = convert.load_npz(args.params_npz, entry["config"])
        elif args.init_from_hf is not None and not resuming:
            task, params = _init_from_hf(args, trainer, loader)
        state = trainer.create_state(params)
        if resuming:
            # The manager checks a step before it writes into the
            # template, so a failed restore leaves the fresh state whole.
            restored = trainer.restore(ckpt, state)
            if restored is None:
                logger.error("no restorable checkpoint in %s (every "
                             "retained step quarantined); starting fresh",
                             args.checkpoint_dir)
            else:
                state = restored
                logger.info("resumed from step %d", state.step)
        if args.eval_only:
            restored = ckpt is not None and ckpt.last_restore is not None
            if not restored and (args.init_from_hf is None or resuming):
                raise SystemExit("--eval-only needs a restorable "
                                 "checkpoint (--checkpoint-dir with a "
                                 "saved state) or --init-from-hf")
            eval_metrics = _with_bleu(
                args, trainer, _eval_view(args, state), make_eval_loader(),
                _evaluate(trainer, make_eval_loader(),
                          _eval_view(args, state), args))
            if writer:
                print(json.dumps({"step": state.step, "eval": eval_metrics}),
                      flush=True)
            return RunResult(state, history.history, eval_metrics,
                             summary=_summary(trainer, ckpt, state,
                                              eval_metrics))

        remaining = args.steps - state.step
        k = args.steps_per_execution
        if remaining > 0 and remaining % k:
            # An off-cycle resume, or --steps not a multiple of k: round
            # up rather than refuse (the JAX launcher's rule).
            rounded = -(-remaining // k) * k
            logger.warning(
                "remaining steps %d not a multiple of "
                "steps_per_execution=%d; training %d steps",
                remaining, k, rounded)
            remaining = rounded
        if remaining > 0:
            if args.data_workers:
                from tensorflow_train_distributed_torch.data.service import (
                    DataServiceDispatcher,
                )

                if state.step:
                    logger.warning(
                        "--data-workers resume: the worker stream restarts "
                        "from epoch 0 (mid-epoch positioning is the "
                        "in-process loader's); examples may repeat relative "
                        "to an uninterrupted run")
                t0 = time.perf_counter()
                dispatcher = DataServiceDispatcher(
                    source_spec(args, entry),
                    DataConfig(global_batch_size=global_batch,
                               seed=args.seed),
                    num_workers=args.data_workers).start()
                service_start_s = time.perf_counter() - t0
                logger.info("data service: %d input workers up in %.2f s "
                            "(ports %s)", args.data_workers, service_start_s,
                            dispatcher.ports)
                batches = iter(dispatcher.client())
            elif state.step:
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
                steps_per_epoch=(None if loader is None
                                 else loader.steps_per_epoch()),
                **eval_kwargs)
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
            if writer:
                print(json.dumps({"step": state.step, "eval": eval_metrics}),
                      flush=True)
    finally:
        if dispatcher is not None:
            dispatcher.stop()
        if watcher is not None:
            watcher.uninstall()
    summary = _summary(trainer, ckpt, state, eval_metrics)
    summary["data_service_start_s"] = service_start_s
    return RunResult(state, history.history, eval_metrics, preempted,
                     summary)


def _init_from_hf(args, trainer, loader) -> tuple:
    """(task, params) of ``--init-from-hf``: a Llama-family or sparse-MoE
    checkpoint into the config's own model (whose config the importer's
    guards hold to the checkpoint's); a BERT checkpoint with the task
    rebuilt around its HF-compat config, which must still cover the data
    pipeline's vocabulary and sequence length.  Parameters land on the
    device in the policy's parameter dtype."""
    from tensorflow_train_distributed_torch.models import import_hf, registry
    from tensorflow_train_distributed_torch.models.bert import BertConfig
    from tensorflow_train_distributed_torch.models.llama import LlamaConfig
    from tensorflow_train_distributed_torch.models.moe import MoeConfig

    path, task = args.init_from_hf, trainer.task
    cfg = task.config
    kw = dict(device=args.device, dtype=trainer.policy.param_dtype)
    try:
        if isinstance(cfg, MoeConfig):
            # Mixtral or Qwen2-MoE, as the checkpoint's model_type says.
            hf_cfg, params = import_hf.import_moe(path, config=cfg, **kw)
        elif isinstance(cfg, LlamaConfig):
            hf_cfg, params = import_hf.import_llama(path, config=cfg, **kw)
        elif isinstance(cfg, BertConfig):
            hf_cfg, params = import_hf.import_bert(path, **kw)
            seq = next(iter(loader))["input_ids"].shape[1]
            if hf_cfg.vocab_size < cfg.vocab_size:
                raise SystemExit(
                    f"HF checkpoint vocab ({hf_cfg.vocab_size}) is smaller "
                    f"than the config's ({cfg.vocab_size}) — token ids "
                    "would index past the embedding table")
            if hf_cfg.max_positions < seq:
                raise SystemExit(
                    f"HF checkpoint max_positions ({hf_cfg.max_positions}) "
                    f"< the pipeline's sequence length ({seq})")
            task = registry.make_task({"config": hf_cfg}, device="meta")
            trainer.task = task
        else:
            raise SystemExit(
                f"--init-from-hf supports Llama-, Mixtral- and "
                f"BERT-family --config; {args.config!r} is none of these")
    except ValueError as e:
        raise SystemExit(f"--init-from-hf {path}: {e}")
    logger.info("initialized from HF checkpoint %s (%d layers)", path,
                hf_cfg.num_layers)
    return task, params


def _check_lora_sidecar(checkpoint_dir: str, spec) -> None:
    """Write ``spec`` as the directory's ``lora_spec.json``; exit when the
    directory's sidecar disagrees with it, or when it has one and this
    run has no LoRA."""
    from tensorflow_train_distributed_torch.models.lora import (
        load_spec,
        save_spec,
    )

    prior = load_spec(checkpoint_dir)
    if spec is None:
        if prior is not None:
            raise SystemExit(
                f"--checkpoint-dir carries lora_spec.json ({prior}) from a "
                "LoRA run, but this run has no --lora-rank: pass the "
                "matching --lora-* flags to resume it, or use a fresh "
                "checkpoint dir")
        return
    if prior is not None and prior != spec:
        raise SystemExit(
            f"--lora-* flags {spec} disagree with the existing "
            f"lora_spec.json {prior} in --checkpoint-dir: fix the flags to "
            "resume, or use a fresh dir")
    save_spec(checkpoint_dir, spec)


def _evaluate(trainer, loader, state, args) -> dict:
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

    from tensorflow_train_distributed_torch.models.lora import (
        count_lora_params,
    )

    timing = trainer.timing
    # Each read window's seconds a step, the first (warm-up) left out.
    per_step = [s / n * 1e3 for n, s in timing["windows"][1:] if n]
    steps_run = sum(n for n, _ in timing["windows"])
    adapters, total = count_lora_params(state.params)
    return {
        "step": state.step,
        "device": str(trainer.device),
        "params": total,
        "lora_params": adapters,
        "data_wait_ms_per_step": (timing["data_wait_s"] / steps_run * 1e3
                                  if steps_run else None),
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


def _handle_device_loss(args, dl) -> int:
    """Record the surviving device count in the elastic sidecar (the path
    the supervisor exported, else ``<checkpoint-dir>/elastic.json``) and
    return ``DEVICE_LOSS_EXIT_CODE``, so a supervisor relaunches instead
    of spending its crash budget."""
    from tensorflow_train_distributed_torch.runtime.supervisor import (
        DEVICE_LOSS_EXIT_CODE,
        ENV_ELASTIC_STATE,
    )

    path = os.environ.get(ENV_ELASTIC_STATE)
    if not path and args.checkpoint_dir:
        path = os.path.join(args.checkpoint_dir, "elastic.json")
    if path:
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            with open(path, "w") as f:
                json.dump({"survivors": dl.survivors, "time": time.time(),
                           "error": str(dl)[:500]}, f)
        except OSError:
            logger.error("could not write elastic sidecar %s", path,
                         exc_info=True)
    logger.error("DEVICE LOSS: %s — exiting %d (surviving devices: %s)",
                 dl, DEVICE_LOSS_EXIT_CODE,
                 "unknown" if dl.survivors is None else dl.survivors)
    return DEVICE_LOSS_EXIT_CODE


def _without(argv: list, flag: str) -> list:
    """``argv`` less ``flag`` and its value (either spelling)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == flag:
            skip = True
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def _spawn_cpu_ranks(argv: list, n: int) -> int:
    """``--cpu-devices N``: run this launcher as N gloo ranks on the CPU,
    one process each (the JAX flag's N devices on one host), and wait;
    the first rank to fail ends the others, and its exit code is the
    job's."""
    import socket
    import subprocess

    base = _without(_without(argv, "--cpu-devices"), "--platform")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = []
    for rank in range(n):
        cmd = [sys.executable, "-m", "tensorflow_train_distributed_torch",
               *base, "--device", "cpu", "--num-processes", str(n),
               "--process-id", str(rank), "--coordinator-address",
               f"127.0.0.1:{port}"]
        procs.append(subprocess.Popen(cmd))
    rc = 0
    try:
        live = list(procs)
        while live:
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                if code and not rc:
                    rc = code
                    for q in live:
                        q.terminate()
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    # The supervisor and the --cpu-devices parent only start children,
    # which parse the flags in full: neither imports torch.
    light = "--supervise" in argv or any(
        a == "--cpu-devices" or a.startswith("--cpu-devices=")
        for a in argv)
    args = build_parser(light=light).parse_args(argv)
    if args.list_configs:
        from tensorflow_train_distributed_torch.models import registry

        for name in registry.available():
            e = registry.get_entry(name)
            print(f"{name}: dataset={e['dataset']} "
                  f"batch={e['global_batch_size']} lr={e['learning_rate']}")
        return 0
    if args.cpu_devices is not None and not args.supervise:
        from tensorflow_train_distributed_torch.runtime.supervisor import (
            ENV_ELASTIC_DEVICES,
        )

        n = args.cpu_devices
        survivors = os.environ.get(ENV_ELASTIC_DEVICES)
        if survivors and int(survivors) < n:
            logger.warning("elastic relaunch: %d CPU rank(s) of %d (%s)",
                           int(survivors), n, ENV_ELASTIC_DEVICES)
            n = int(survivors)
        if n < 1:
            raise SystemExit(f"--cpu-devices must be >= 1, got {n}")
        if args.num_processes is not None or args.process_id is not None \
                or args.coordinator_address is not None:
            raise SystemExit("--cpu-devices starts its own ranks; drop "
                             "--num-processes/--process-id/"
                             "--coordinator-address")
        return _spawn_cpu_ranks(argv, n)
    if args.supervise:
        # This process becomes the relaunch loop over a child running
        # this CLI minus the supervisor's flags; it builds no kernel and
        # touches no device.
        from tensorflow_train_distributed_torch.runtime.supervisor import (
            supervise_cli,
        )

        return supervise_cli(argv, args)
    from tensorflow_train_distributed_torch.runtime import faults
    from tensorflow_train_distributed_torch.runtime.preemption import (
        PREEMPTION_EXIT_CODE,
    )

    try:
        result = run(args)
    except Exception as e:
        # An injected DeviceLost, or a runtime error that reads as a
        # device failure, exits with the device-loss contract; every
        # other error crashes (the supervisor's crash budget applies).
        dl = faults.as_device_loss(e)
        if dl is None:
            raise
        return _handle_device_loss(args, dl)
    logger.info("launch summary: %s", json.dumps(result.summary))
    if result.preempted:
        logger.warning("exiting after a preemption checkpoint")
        return PREEMPTION_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(main())
