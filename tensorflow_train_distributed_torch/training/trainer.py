"""The trainer (counterpart of the JAX package's ``training/trainer.py``),
on one device or on a mesh of ranks (``mesh=``, ``runtime.mesh``).

One step, as the JAX ``_single_step``: cast the batch's floating entries
to the policy's compute dtype; forward and backward of the task's loss
(the model casts each parameter to the compute dtype on use, inside
autograd, so the gradients land on the f32 masters); with ``grad_accum``
microbatches, the gradients' f32 mean weighted by each microbatch's
``loss_weight``; unscale under a loss scale; the optimizer update, skipped
entirely when a loss-scaled step overflows; the metrics loss, accuracy,
lr and, optionally, the pre-clip grad_norm.  Parameters that require no
gradient (a LoRA base, ``models/lora.py``) get none: autograd skips
their weight gradients, their gradient is None, and the optimizer
(``lora.freeze_base``) leaves them unchanged.

Eager PyTorch replaces ``jit``: a step is a sequence of kernel launches on
the current stream, and metrics stay device scalars until ``fit`` reads a
window of them at once.

``fit`` has the JAX signature (``steps_per_epoch``, ``eval_batches``,
``eval_every``, ``eval_steps``) and drives the callbacks at the JAX
points: ``train_begin``; after each read window ``step_end`` per step;
after an evaluation one ``step_end`` of ``val_`` metrics between
``eval_begin`` and ``eval_end``; ``epoch_end``; ``transform_state``; a
periodic save through the checkpoint manager; ``train_end`` in a
``finally``.  The fault plan's step site runs at each step boundary.
``steps_per_execution = k`` fuses k optimizer steps into one call
(``train_steps``, the JAX ``lax.scan`` over a stacked super-batch): the
loop stacks k host batches into one [k, ...] batch, the k steps run back
to back with no host sync between them, and the call returns the last
step's metrics; callbacks, logging, evaluations, saves and the fault
plan's step site see steps at dispatch boundaries (every k-th step), as
in the JAX trainer, and ``steps`` must be a multiple of k.  The steps
themselves are ``train_step``'s, so k = 4 trains bit for bit as k = 1.
``evaluate`` (weighted ``MetricAccumulator`` means, ``perplexity`` as
exp of the mean loss) and ``predict`` (pad rows dropped) run the forward
alone, with the state's params bound to the model (an EMA view too).

Modes, as the JAX ``train`` flag: the loss of a training step runs with
the model in training mode (dropout on, BatchNorm normalising by the
batch and updating its running statistics, once per microbatch in
order, as the JAX scan threads ``model_state``); ``evaluate`` and
``predict`` switch it to eval mode (dropout off, BatchNorm on its running
averages) and back.  Dropout draws from a ``torch.Generator`` seeded from
(seed, step), and from (seed, step, microbatch) under ``grad_accum``, as
the JAX trainer folds the step (and the microbatch) into its key: a
resumed run draws what the uninterrupted one drew.  The generator is
built at the step's first draw, so a model without dropout builds none.

On a mesh (``Trainer(..., mesh=)``, one process a device over
``torch.distributed``) each rank trains on its rows of the global batch
(its batch-axes index; ``parallel.sharding.shard_batch``) and the
gradient sync GSPMD inserts on JAX is explicit (``parallel.state_plan``):
the mean over ``data``/``fsdp`` (a reduce-scatter along a dim a
parameter splits over ``fsdp``), the optimizer on each rank's piece under
``fsdp``/``tensor``, ``zero1`` and ``sharded_update``, the pieces
gathered back.  ``grad_quant`` ("f32" or "int8") replaces the mean over
``data`` by the error-feedback pipeline of ``parallel.collectives`` with
its residual in the train state, bucketed under ``grad_overlap``; the
kill switches ``TTD_NO_GRAD_QUANT`` and ``TTD_NO_GRAD_OVERLAP`` and the
refusals are the JAX trainer's.  A model that shards sequences over
``seq`` (``LlamaConfig.seq_parallel``) trains each rank on its block of
every row (``_seq_shard``, with the rows' global positions), and ``seq``
joins the gradient mean and the metrics' group, each rank's gradient
weighted by its tokens' share of the loss (``weighted_grad_factor``); a
pipelined model (``pipeline_microbatches``) holds its stage's layers.
The metrics are the batch group's means.  Checkpoints hold the whole state, written by rank 0.  Without a
mesh the trainer runs on one of one rank, through the same step.  A
model with running statistics (ResNet's BatchNorm) computes them over
the batch group's global batch (``ResNet.set_mesh``).

The flight recorder (``runtime.events``) holds the JAX trainer's spans:
``train/data_wait``, ``train/step_dispatch`` (``step=``),
``train/host_callbacks`` (``step=``, ``steps=``), ``train/eval`` and
``train/checkpoint_save`` (``final=`` at the end) in ``fit``; under
``grad_quant`` the pipeline's ``train/grad_fwdbwd``, ``train/grad_comm``
(``wire=``, ``mb=``) and ``train/optimizer_apply``, which end where the
device is done on CUDA, or in the bucketed form one ``grad_comm`` and one
``optimizer_apply`` a bucket (``bucket=``, ``buckets=``) metering the
host and one ``train/step_barrier`` that waits for the device.
``TTD_NO_TRACE=1`` records nothing and waits for nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from tensorflow_train_distributed_torch.data.pipeline import (
    prefetch_to_device,
    to_device,
)
from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.parallel import state_plan as SP
from tensorflow_train_distributed_torch.runtime import events, faults
from tensorflow_train_distributed_torch.runtime.mesh import AXES, Mesh
from tensorflow_train_distributed_torch.training import mixed_precision as mp
from tensorflow_train_distributed_torch.training.callbacks import (
    CallbackList,
)
from tensorflow_train_distributed_torch.training.metrics import (
    MetricAccumulator,
)
from tensorflow_train_distributed_torch.training.mixed_precision import Policy
from tensorflow_train_distributed_torch.training.optimizers import (
    GradientTransformation,
    global_norm,
)
from tensorflow_train_distributed_torch.training.train_state import TrainState

logger = logging.getLogger(__name__)


def _stack_batches(it, k: int):
    """Group k host batches into one super-batch stacked on a new leading
    axis (a short tail is dropped: ``fit`` takes a multiple of k)."""
    while True:
        group = []
        for _ in range(k):
            b = next(it, None)
            if b is None:
                return
            group.append(b)
        yield {n: np.stack([b[n] for b in group]) for n in group[0]}


def _has_model_state(model) -> bool:
    from tensorflow_train_distributed_torch import convert

    return bool(convert.model_state_names(model))


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    seed: int = 0
    # Microbatches per optimizer step; gradients accumulate in f32.
    grad_accum: int = 1
    # Steps between metric reads (each read waits for the device).
    log_every: int = 10
    # Adds ``grad_norm``: the global norm of the unscaled, averaged grads,
    # before any clipping in the optimizer chain.
    log_grad_norm: bool = False
    # Steps between periodic saves (None: only the final save), when the
    # trainer has a checkpoint manager.
    checkpoint_every: Optional[int] = None
    # The state evaluation scores (e.g. ``ema.swap_ema_params``); None
    # scores the training state itself.
    eval_state_view: Optional[Callable] = None
    # Optimizer steps per call over a stacked [k, ...] super-batch.
    steps_per_execution: int = 1
    # On a mesh (the JAX TrainerConfig's fields): ZeRO-1 (optimizer state
    # split over ``data``); the quantized gradient sync ("none", "f32" or
    # "int8"), needing data > 1 and steps_per_execution 1; its buckets
    # (0/1: one sync; TTD_NO_GRAD_OVERLAP=1 forces 0); the cross-replica
    # sharded update (implies zero1's split).
    zero1: bool = False
    grad_quant: str = "none"
    grad_overlap: int = 4
    sharded_update: bool = False


class Trainer:
    """Owns state creation, the step and the fit loop for one task (any
    of ``models.registry.make_task``'s) on ``mesh`` (a
    ``runtime.mesh.Mesh``, one process a device), by default a mesh of
    one rank."""

    def __init__(self, task, optimizer: GradientTransformation, *,
                 policy: Policy = Policy(),
                 config: TrainerConfig = TrainerConfig(),
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 device="cuda", callbacks=(), checkpoint_manager=None,
                 mesh=None):
        self.task = task
        self.mesh = mesh if mesh is not None else Mesh(dict.fromkeys(AXES,
                                                                     1))
        # The state's layout on the mesh (``create_state``).
        self.plan: Optional[SP.StatePlan] = None
        self.grad_quant = self._resolve_grad_quant(config, mesh)
        self.grad_overlap = self._resolve_grad_overlap(config,
                                                       self.grad_quant)
        self.tx = optimizer
        self.policy = policy
        self.config = config
        # Observational: the optimizer owns the schedule; this one only
        # reports ``lr`` beside the loss, as the JAX trainer does.
        self.lr_schedule = lr_schedule
        self.device = torch.device(device)
        self.callbacks = CallbackList(callbacks, trainer=self)
        self.checkpoint_manager = checkpoint_manager
        self.state_poisoned = False
        self._live_state = None
        # Host seconds of the last fit: per read window (steps, seconds,
        # from the end of the previous window's evaluation and save to
        # the read of this one), per evaluation, per save, and in all
        # blocked on the next batch (the input pipeline's share).
        self.timing = {"windows": [], "eval_s": [], "save_s": [],
                       "data_wait_s": 0.0}

    @staticmethod
    def _resolve_grad_overlap(config: TrainerConfig, grad_quant: str) -> int:
        k = int(config.grad_overlap)
        if k < 0:
            raise ValueError(f"grad_overlap must be >= 0, got {k}")
        if grad_quant == "none" or k <= 1:
            return 0
        if os.environ.get("TTD_NO_GRAD_OVERLAP", "0") not in ("", "0"):
            logger.warning(
                "TTD_NO_GRAD_OVERLAP=1: bucketed gradient sync disabled — "
                "one sequential grad-quant sync (set before Trainer "
                "construction)")
            return 0
        return k

    @staticmethod
    def _resolve_grad_quant(config: TrainerConfig, mesh) -> str:
        gq = config.grad_quant
        if gq not in ("none", "f32", "int8"):
            raise ValueError(f"grad_quant must be none|f32|int8, got {gq!r}")
        if gq == "none":
            return gq
        if os.environ.get("TTD_NO_GRAD_QUANT", "0") not in ("", "0"):
            logger.warning(
                "TTD_NO_GRAD_QUANT=1: quantized gradient collectives "
                "disabled — exact gradient mean (set before Trainer "
                "construction)")
            return "none"
        if mesh is None or mesh.shape["data"] <= 1:
            logger.warning(
                "grad_quant=%r is a no-op on a data=1 mesh; using the "
                "exact single-program step", gq)
            return "none"
        if config.steps_per_execution > 1:
            raise ValueError(
                "grad_quant does not compose with steps_per_execution>1 "
                "(the comm program is dispatched separately per step); "
                "drop one of the two")
        return gq

    def create_state(self, params: Optional[dict] = None) -> TrainState:
        """Load ``params`` (``{name: tensor}`` as ``convert`` makes them),
        or random weights from ``config.seed``, into the task's model as
        f32 (the policy's param dtype) masters on the device.  On a mesh
        the params are the whole model's (the same on every rank): an
        expert-parallel MoE keeps its rank's experts, and the optimizer
        state covers this rank's pieces."""
        from tensorflow_train_distributed_torch import convert

        model = self.task.model
        dtype = self.policy.param_dtype
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.config.seed)
            params = convert.init_params(self.task.config, gen,
                                         device=self.device, dtype=dtype)
        params = self._plan_for(model, params)
        model.load_state_dict(
            {k: v.to(device=self.device, dtype=dtype)
             for k, v in params.items()}, strict=True, assign=True)
        L.set_compute_dtype(model, self.policy.compute_dtype)
        model.train()
        named = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        plist = list(named.values())
        residual = None
        if self.grad_quant != "none":
            residual = [torch.zeros_like(p, dtype=torch.float32)
                        if p.requires_grad else None for p in plist]
        return TrainState(
            step=0, params=named,
            opt_state=self.tx.init(self.plan.pieces(plist)),
            loss_scale=mp.LossScaleState.create(self.policy, self.device),
            model_state={k: buffers[b] for k, b in
                         convert.model_state_names(model).items()},
            grad_residual=residual)

    def _plan_for(self, model, params: dict) -> dict:
        """Lay the model out on the mesh: shard its MoE blocks over
        ``expert``, make the state plan, and return this rank's params."""
        from tensorflow_train_distributed_torch.models import moe

        mesh = self.mesh
        if self.grad_quant != "none" and _has_model_state(model):
            raise ValueError(
                "grad_quant requires a task with no mutable model "
                "collections (e.g. BatchNorm batch_stats): the "
                "implicit GSPMD path reduces them across the batch "
                "axis, which the per-shard gradient pipeline does "
                "not reproduce — drop grad-quant for this task")
        if hasattr(model, "set_mesh"):
            model.set_mesh(mesh)
        names = [k for k, _ in model.named_parameters()]
        shapes = {k: tuple(params[k].shape) for k in names}
        moe.set_expert_parallel(model, mesh)
        self.plan = SP.StatePlan(
            mesh, shapes, zero1=self.config.zero1,
            sharded_update=self.config.sharded_update,
            pipelined=getattr(model, "pipeline", None) is not None,
            seq_sharded=getattr(model, "seq_sharded", False))
        if self.plan.pipelined:
            # Other stages' layers stay with their stages.
            held = set(names)
            params = {k: v for k, v in params.items()
                      if k in held or not SP.stage_layer(k)}
        return {**params, **self.plan.local_params(
            {k: params[k] for k in names})}

    def _generator(self, step: int, micro: Optional[int] = None):
        """The dropout generator of a step (and microbatch): seeded from
        (seed, step[, micro]) alone."""
        key = [self.config.seed, step] + ([] if micro is None else [micro])
        hi, lo = np.random.SeedSequence(key).generate_state(2, np.uint32)
        return torch.Generator(device=self.device).manual_seed(
            (int(hi) << 31) ^ int(lo))

    # -- the step --------------------------------------------------------

    def _microbatch_grads(self, params: list, batch: dict, loss_scale):
        """Loss, metrics and unscaled f32 grads of one (micro)batch; a
        frozen parameter (``requires_grad`` False: a LoRA base) gets None
        and autograd computes no gradient for it."""
        loss, metrics = self.task.loss_fn(batch)
        loss = loss.float()
        idx = [i for i, p in enumerate(params) if p.requires_grad]
        sub = torch.autograd.grad(mp.scale_loss(loss, loss_scale),
                                  [params[i] for i in idx])
        grads = [None] * len(params)
        for i, g in zip(idx, sub):
            grads[i] = g
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        return mp.unscale_grads(grads, loss_scale), loss.detach(), metrics

    def _accumulated_grads(self, params: list, batch: dict, loss_scale,
                           step: int = 0):
        """``grad_accum`` microbatches (rows split in order), their grads
        averaged in f32, weighted by ``loss_weight`` where the task
        reports one; microbatch i draws its dropout from (seed, step,
        i)."""
        a = self.config.grad_accum
        bsz = next(iter(batch.values())).shape[0]
        if bsz % a:
            raise ValueError(f"batch size {bsz} not divisible by "
                             f"grad_accum={a}")
        m = bsz // a
        acc = [torch.zeros_like(p, dtype=torch.float32) if p.requires_grad
               else None for p in params]
        losses, ws, stacked = [], [], []
        for i in range(a):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            with L.dropout_generator(functools.partial(self._generator,
                                                       step, i)):
                grads, loss, metrics = self._microbatch_grads(params, mb,
                                                              loss_scale)
            w = metrics.get("loss_weight",
                            torch.ones((), device=loss.device))
            acc = [None if g is None else s + g.float() * w
                   for s, g in zip(acc, grads)]
            losses.append(loss)
            ws.append(w)
            stacked.append(metrics)
        ws_t = torch.stack(ws)
        w_total = torch.clamp(ws_t.sum(), min=1e-6)
        grads = [None if g is None else (g / w_total).to(p.dtype)
                 for g, p in zip(acc, params)]
        metrics = {k: (torch.stack([mm[k] for mm in stacked]) * ws_t).sum()
                   / w_total for k in stacked[0]}
        if "loss_weight" in metrics:
            metrics["loss_weight"] = w_total
        loss = (torch.stack(losses) * ws_t).sum() / w_total
        return grads, loss, metrics

    def _apply_grads(self, state: TrainState, params: list,
                     grads: list, finite=None) -> dict:
        """The optimizer update (skipped on a loss-scaled overflow, by every
        rank together) and the lr / grad_norm / loss-scale metrics.
        ``grads`` are this rank's pieces of the mean gradients and
        ``finite`` the data group's flag where the sync took one."""
        metrics = {}
        ls = state.loss_scale
        plan = self.plan
        apply = True
        if ls is not None:
            finite = plan.all_finite(mp.grads_finite(grads)
                                     if finite is None else finite)
            state.loss_scale = mp.update_loss_scale(ls, finite, self.policy)
            metrics.update(loss_scale=state.loss_scale.scale,
                           grads_finite=finite.float())
            # The skip reads ``finite`` on the host: only float16 runs
            # scale their loss.
            apply = bool(finite)
        if apply:
            state.opt_state = plan.apply(
                self.tx, state.opt_state, params, grads,
                buckets=plan.buckets if self.grad_overlap else None)
        if self.config.log_grad_norm:
            with plan.norm_context(grads):
                metrics["grad_norm"] = global_norm(grads)
        if self.lr_schedule is not None:
            metrics["lr"] = torch.tensor(float(self.lr_schedule(state.step)),
                                         dtype=torch.float32)
        return metrics

    def train_step(self, state: TrainState, batch: dict) -> dict:
        """One optimizer step on a batch of device tensors; returns the
        step's metrics as device scalars and advances ``state``."""
        params = list(state.params.values())
        batch = self._seq_shard(self.policy.cast_to_compute(batch))
        self.task.model.train()
        # The grad-quant pipeline's sub-spans, as the JAX trainer's three
        # programs: the sequential form's end where its results are ready;
        # the bucketed form's meter the host, and its one device wait is
        # the step barrier.
        quant, overlap = self.grad_quant != "none", self.grad_overlap
        with (contextlib.nullcontext() if not quant
              else events.span("train/grad_fwdbwd", overlap=1) if overlap
              else events.device_span("train/grad_fwdbwd", self.device)):
            if self.config.grad_accum > 1:
                grads, loss, metrics = self._accumulated_grads(
                    params, batch, state.loss_scale, state.step)
            else:
                with L.dropout_generator(functools.partial(self._generator,
                                                           state.step)):
                    grads, loss, metrics = self._microbatch_grads(
                        params, batch, state.loss_scale)
        grads, loss, metrics, finite = self._sync(state, grads, loss,
                                                  metrics)
        with (events.span("train/optimizer_apply") if quant and not overlap
              else contextlib.nullcontext()):
            extra = self._apply_grads(state, params, grads, finite)
        if quant and overlap:
            with events.device_span("train/step_barrier", self.device,
                                    buckets=len(self.plan.buckets)):
                pass
        state.step += 1
        return dict(metrics, loss=loss, **extra)

    def _seq_shard(self, batch: dict) -> dict:
        """This rank's block of every [B, S] leaf of ``batch`` when the
        model shards sequences over ``seq`` (the JAX rules shard
        ``length`` over it), with the global RoPE positions computed on
        the whole rows first: a packed row's positions restart at its
        segments, which may span the cut."""
        if self.plan.seq_group is None:
            return batch
        from tensorflow_train_distributed_torch.models.llama import (
            segment_relative_positions,
        )

        n, i = self.mesh.shape["seq"], self.mesh.index("seq")
        b, s = batch["tokens"].shape[:2]
        if s % n:
            raise ValueError(f"sequence length {s} does not split over "
                             f"seq={n}")
        batch = dict(batch)
        if "positions" not in batch:
            seg = batch.get("segment_ids")
            batch["positions"] = (
                segment_relative_positions(seg) if seg is not None
                else torch.arange(s, device=batch["tokens"].device).expand(
                    b, s))
        w = s // n
        return {k: (v[:, i * w:(i + 1) * w] if v.dim() >= 2
                    and tuple(v.shape[:2]) == (b, s) else v)
                for k, v in batch.items()}

    def _batch_group(self):
        """The ranks whose batches differ: the batch axes and ``seq``."""
        return self.mesh.group(("data", "fsdp", "seq"))

    def _sync(self, state: TrainState, grads: list, loss, metrics: dict):
        """The mesh's gradient sync and the batch group's mean metrics."""
        group = self._batch_group()
        factor = SP.weighted_grad_factor(metrics.get("loss_weight"), group)
        if factor is not None:
            grads = [None if g is None else g * factor for g in grads]
        grads, state.grad_residual, finite, wire_mb = self.plan.sync_grads(
            grads, residual=state.grad_residual, wire=self.grad_quant,
            overlap=self.grad_overlap, device=self.device)
        metrics = SP.mean_metrics(dict(metrics, loss=loss), group)
        loss = metrics.pop("loss")
        if self.grad_quant != "none":
            metrics["grad_comm_mb"] = torch.tensor(wire_mb)
            if self.grad_overlap:
                metrics["grad_buckets"] = torch.tensor(
                    float(len(self.plan.buckets)))
        return grads, loss, metrics, finite

    def train_steps(self, state: TrainState, batch: dict) -> dict:
        """``steps_per_execution`` optimizer steps over a super-batch of
        device tensors stacked on a leading axis of k, back to back with
        no host sync between them; returns the last step's metrics (the
        JAX scan's ``m[-1]``)."""
        k = next(iter(batch.values())).shape[0]
        for i in range(k):
            metrics = self.train_step(state, {n: v[i]
                                              for n, v in batch.items()})
        return metrics

    # -- the loop --------------------------------------------------------

    def fit(self, batches: Iterable[dict], *, steps: int,
            state: Optional[TrainState] = None,
            steps_per_epoch: Optional[int] = None, eval_batches=None,
            eval_every: Optional[int] = None,
            eval_steps: Optional[int] = None):
        """Run ``steps`` optimizer steps over host (numpy) batches, from
        ``state.step`` on.  Metrics are read every ``log_every`` steps,
        before a save or an evaluation, and at the end; each step's reach
        the callbacks' ``on_step_end`` in order.
        ``eval_batches`` (a re-iterable or a zero-argument factory) is
        evaluated for ``eval_steps`` batches every ``eval_every`` steps
        (default: each epoch of ``steps_per_epoch``, else at the end).
        Returns ``(state, history)``, history a list of (step, metrics)."""
        k = self.config.steps_per_execution
        if steps % k:
            raise ValueError(
                f"steps={steps} must be a multiple of "
                f"steps_per_execution={k} (each dispatch runs exactly k "
                "optimizer steps)")
        self.state_poisoned = False
        if state is None:
            state = self.create_state()
        self.timing = {"windows": [], "eval_s": [], "save_s": [],
                       "data_wait_s": 0.0}
        history = []
        self.callbacks.train_begin(state)
        box = [state]
        it = iter(batches)
        if k > 1:
            it = _stack_batches(it, k)
        device_iter = prefetch_to_device(it, self.device)
        try:
            self._fit_loop(device_iter, box, history, steps,
                           steps_per_epoch, eval_batches, eval_every,
                           eval_steps)
        finally:
            device_iter.close()
            self.callbacks.train_end(box[0])
        return box[0], history

    def _fit_loop(self, device_iter, box, history, steps,
                  steps_per_epoch, eval_batches, eval_every, eval_steps):
        state = box[0]
        k = self.config.steps_per_execution
        ckpt = self.checkpoint_manager
        every = self.config.checkpoint_every
        start = state.step
        done = epoch = 0
        last_metrics: dict = {}
        pending: list = []
        stop = False
        t_mark = time.perf_counter()
        while True:
            # The flight recorder's step anatomy (``runtime.events``, the
            # JAX trainer's spans): the wait for a batch, the step's
            # dispatch, the metric read and callbacks, evaluations and
            # saves.
            t0 = time.perf_counter()
            with events.span("train/data_wait"):
                batch = next(device_iter, None)
            self.timing["data_wait_s"] += time.perf_counter() - t0
            if batch is None:
                break
            with events.span("train/step_dispatch", step=state.step + k):
                metrics = (self.train_step(state, batch) if k == 1
                           else self.train_steps(state, batch))
            cur = state.step
            # Callbacks that save (the preemption handler) read the live
            # state from here.
            self._live_state = state
            done += k
            if faults.ARMED:
                faults.step_boundary(cur)
            pending.append((cur, metrics))
            stop = done >= steps
            # A dispatch boundary stands for the k steps it closes: an
            # event due at any of them happens here.
            will_ckpt = ckpt is not None and bool(every) and cur % every < k
            eval_due = eval_batches is not None and bool(
                (eval_every and cur % eval_every < k)
                or (not eval_every and steps_per_epoch
                    and done % steps_per_epoch < k)
                or (not eval_every and not steps_per_epoch and stop))
            # Read before a save (a guard callback must see the window
            # first) and before an evaluation (val_* events follow the
            # train metrics of their step).
            drained = (len(pending) * k >= self.config.log_every or stop
                       or will_ckpt or eval_due)
            if drained:
                with events.span("train/host_callbacks", step=cur,
                                 steps=len(pending) * k):
                    for s, m in pending:
                        host = {k: float(v) for k, v in m.items()}
                        history.append((s, host))
                        stop |= self.callbacks.step_end(s, host)
                        last_metrics = host
                self.timing["windows"].append(
                    (len(pending) * k, time.perf_counter() - t_mark))
                pending.clear()
            if eval_due:
                src = eval_batches() if callable(eval_batches) \
                    else eval_batches
                view = self.config.eval_state_view
                t0 = time.perf_counter()
                self.callbacks.eval_begin()
                try:
                    with events.span("train/eval", step=cur):
                        val = {f"val_{k}": v for k, v in self.evaluate(
                            src, view(state) if view else state,
                            steps=eval_steps).items()}
                finally:
                    self.callbacks.eval_end()
                self.timing["eval_s"].append(time.perf_counter() - t0)
                last_metrics = dict(last_metrics, **val)
                stop |= self.callbacks.step_end(cur, val)
            while steps_per_epoch and done >= (epoch + 1) * steps_per_epoch:
                epoch += 1
                stop |= self.callbacks.epoch_end(epoch, last_metrics)
            state = self.callbacks.apply_state_transforms(state)
            box[0] = state
            if will_ckpt and not stop and not self.state_poisoned:
                with events.span("train/checkpoint_save", step=cur):
                    self._save(cur, state)
            if drained:
                t_mark = time.perf_counter()
            if stop:
                break
        if ckpt is not None and not self.state_poisoned \
                and state.step > start:
            with events.span("train/checkpoint_save", step=int(state.step),
                             final=True):
                self._save(state.step, state)

    def _save(self, step: int, state: TrainState) -> None:
        t0 = time.perf_counter()
        # One batch a step: the data position is the step.
        self.save_checkpoint(
            step, state,
            meta={"data_position": {"batches_consumed": int(step)}})
        self.timing["save_s"].append(time.perf_counter() - t0)

    def save_checkpoint(self, step: int, state: TrainState, manager=None,
                        meta: Optional[dict] = None) -> None:
        """Save the whole state through ``manager`` (the trainer's by
        default): on a mesh every rank gathers, rank 0 writes, and every
        rank waits until the step is committed."""
        manager = manager or self.checkpoint_manager
        full = self.full_state(state)
        if self._is_writer():
            manager.save(step, full, meta=meta)
        self._barrier()

    # -- the state across ranks ------------------------------------------

    def _live(self, state: TrainState) -> list:
        return [i for i, p in enumerate(state.params.values())
                if p.requires_grad]

    def full_state(self, state: TrainState) -> TrainState:
        """The whole state (what a checkpoint holds) from every rank's:
        collective on a mesh (every rank calls it), ``state`` itself on
        a mesh of one rank."""
        return self.plan.full_state(state, self._live(state))

    def restore(self, manager, state: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """``manager.restore`` of the whole state into this rank's
        ``state``: every rank reads the step, then keeps its own pieces
        (another world size's checkpoint included).  None when no step
        restores."""
        template = self.full_state(state)
        # Rank 0 reads first: a torn step is quarantined once, and the
        # others then read the step it restored.
        full = manager.restore(template, step=step) \
            if self._is_writer() else None
        self._barrier()
        if not self._is_writer():
            full = manager.restore(template, step=step)
        if full is None:
            return None
        return self.plan.load_full_state(full, state)

    def _is_writer(self) -> bool:
        return self.mesh.rank == 0

    def _barrier(self) -> None:
        import torch.distributed as dist

        if self.mesh.size > 1:
            dist.barrier()

    # -- evaluation and prediction ---------------------------------------

    @contextlib.contextmanager
    def inference(self, state: TrainState):
        """The model runs on ``state.params``, in eval mode (dropout off,
        BatchNorm on its running averages) and without autograd inside;
        its params that are not the model's own (an EMA view) are swapped
        in without copies, and its mode restored after."""
        model = self.task.model
        named = dict(model.named_parameters())
        swap = {k: v for k, v in state.params.items()
                if v is not named[k]}
        old = {k: named[k].data for k in swap}
        was_training = model.training
        try:
            for k, v in swap.items():
                named[k].data = v.detach()
            model.eval()
            with torch.no_grad():
                yield
        finally:
            model.train(was_training)
            for k, d in old.items():
                named[k].data = d

    def evaluate(self, batches: Iterable[dict], state: TrainState, *,
                 steps: Optional[int] = None) -> dict:
        """Mean metrics of the forward over ``steps`` batches (all, when
        None), weighted by each batch's ``loss_weight`` where the task
        reports one (padded rows weigh 0), plus ``perplexity``."""
        device_metrics = []
        it = prefetch_to_device(iter(batches), self.device)
        try:
            with self.inference(state):
                for batch in it:
                    loss, metrics = self.task.loss_fn(self._seq_shard(
                        self.policy.cast_to_compute(batch)))
                    device_metrics.append(dict(metrics, loss=loss.float()))
                    if steps is not None and len(device_metrics) >= steps:
                        break
        finally:
            it.close()
        host = [{k: float(v) for k, v in m.items()}
                for m in device_metrics]
        group = self._batch_group()
        if group is not None:
            import torch.distributed as dist

            ranks = [None] * SP.C.group_size(group)
            dist.all_gather_object(ranks, host, group=group)
            host = [m for r in ranks for m in r]
        acc = MetricAccumulator()
        for m in host:
            acc.update(m)
        out = acc.result()
        if getattr(self.task, "report_perplexity", False) and "loss" in out:
            # exp of the mean loss, not the mean of per-batch exps.
            out["perplexity"] = float(np.exp(min(out["loss"], 30.0)))
        return out

    def predict(self, batches: Iterable[dict], state: TrainState, *,
                steps: Optional[int] = None) -> torch.Tensor:
        """The task's ``predict_fn`` over the batches, concatenated along
        the batch on the host; rows with ``sample_weight`` 0 (the padding
        of an evaluation loader) are dropped.  A sequence-sharded model
        runs on this rank's block of the rows and gathers every position
        over ``seq``, so each rank returns the whole rows."""
        outs, keeps = [], []
        with self.inference(state):
            for host in batches:
                batch = self._seq_shard(self.policy.cast_to_compute(
                    to_device(host, self.device)))
                out = self.task.predict_fn(batch)
                if self.plan.seq_group is not None:
                    out = SP.C.all_gather(out, self.plan.seq_group,
                                          gather_dim=1)
                out = out.cpu()
                outs.append(out)
                w = host.get("sample_weight")
                keeps.append(torch.ones(out.shape[0], dtype=torch.bool)
                             if w is None else torch.from_numpy(
                                 np.asarray(w) > 0))
                if steps is not None and len(outs) >= steps:
                    break
        if not outs:
            raise ValueError("predict got an empty batch iterator")
        return torch.cat(outs)[torch.cat(keeps)]
