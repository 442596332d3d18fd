"""Single-device trainer (counterpart of the JAX package's
``training/trainer.py`` on a one-device mesh).

One step, as the JAX ``_single_step``: cast the batch's floating entries
to the policy's compute dtype; forward and backward of the task's loss
(the model casts each parameter to the compute dtype on use, inside
autograd, so the gradients land on the f32 masters); with ``grad_accum``
microbatches, the gradients' f32 mean weighted by each microbatch's
``loss_weight``; unscale under a loss scale; the optimizer update, skipped
entirely when a loss-scaled step overflows; the metrics loss, accuracy,
lr and, optionally, the pre-clip grad_norm.

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
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from tensorflow_train_distributed_torch.data.pipeline import (
    prefetch_to_device,
    to_device,
)
from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.runtime import faults
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


class Trainer:
    """Owns state creation, the step and the fit loop for one task (any
    of ``models.registry.make_task``'s) on one device."""

    def __init__(self, task, optimizer: GradientTransformation, *,
                 policy: Policy = Policy(),
                 config: TrainerConfig = TrainerConfig(),
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 device="cuda", callbacks=(), checkpoint_manager=None):
        self.task = task
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
        # the read of this one), per evaluation and per save.
        self.timing = {"windows": [], "eval_s": [], "save_s": []}

    def create_state(self, params: Optional[dict] = None) -> TrainState:
        """Load ``params`` (``{name: tensor}`` as ``convert`` makes them),
        or random weights from ``config.seed``, into the task's model as
        f32 (the policy's param dtype) masters on the device."""
        from tensorflow_train_distributed_torch import convert

        model = self.task.model
        dtype = self.policy.param_dtype
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.config.seed)
            params = convert.init_params(self.task.config, gen,
                                         device=self.device, dtype=dtype)
        model.load_state_dict(
            {k: v.to(device=self.device, dtype=dtype)
             for k, v in params.items()}, strict=True, assign=True)
        L.set_compute_dtype(model, self.policy.compute_dtype)
        model.train()
        named = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        return TrainState(
            step=0, params=named,
            opt_state=self.tx.init(list(named.values())),
            loss_scale=mp.LossScaleState.create(self.policy, self.device),
            model_state={k: buffers[b] for k, b in
                         convert.model_state_names(model).items()})

    def _generator(self, step: int, micro: Optional[int] = None):
        """The dropout generator of a step (and microbatch): seeded from
        (seed, step[, micro]) alone."""
        key = [self.config.seed, step] + ([] if micro is None else [micro])
        hi, lo = np.random.SeedSequence(key).generate_state(2, np.uint32)
        return torch.Generator(device=self.device).manual_seed(
            (int(hi) << 31) ^ int(lo))

    # -- the step --------------------------------------------------------

    def _microbatch_grads(self, params: list, batch: dict, loss_scale):
        """Loss, metrics and unscaled f32 grads of one (micro)batch."""
        loss, metrics = self.task.loss_fn(batch)
        loss = loss.float()
        grads = torch.autograd.grad(mp.scale_loss(loss, loss_scale), params)
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        return mp.unscale_grads(list(grads), loss_scale), loss.detach(), \
            metrics

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
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        losses, ws, stacked = [], [], []
        for i in range(a):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            with L.dropout_generator(functools.partial(self._generator,
                                                       step, i)):
                grads, loss, metrics = self._microbatch_grads(params, mb,
                                                              loss_scale)
            w = metrics.get("loss_weight",
                            torch.ones((), device=loss.device))
            acc = [s + g.float() * w for s, g in zip(acc, grads)]
            losses.append(loss)
            ws.append(w)
            stacked.append(metrics)
        ws_t = torch.stack(ws)
        w_total = torch.clamp(ws_t.sum(), min=1e-6)
        grads = [(g / w_total).to(p.dtype) for g, p in zip(acc, params)]
        metrics = {k: (torch.stack([mm[k] for mm in stacked]) * ws_t).sum()
                   / w_total for k in stacked[0]}
        if "loss_weight" in metrics:
            metrics["loss_weight"] = w_total
        loss = (torch.stack(losses) * ws_t).sum() / w_total
        return grads, loss, metrics

    def _apply_grads(self, state: TrainState, params: list,
                     grads: list) -> dict:
        """The optimizer update (skipped on a loss-scaled overflow) and
        the lr / grad_norm / loss-scale metrics."""
        metrics = {}
        ls = state.loss_scale
        apply = True
        if ls is not None:
            finite = mp.grads_finite(grads)
            state.loss_scale = mp.update_loss_scale(ls, finite, self.policy)
            metrics.update(loss_scale=state.loss_scale.scale,
                           grads_finite=finite.float())
            # The skip reads ``finite`` on the host: only float16 runs
            # scale their loss.
            apply = bool(finite)
        if apply:
            updates, state.opt_state = self.tx.update(grads, state.opt_state,
                                                      params)
            with torch.no_grad():
                for p, u in zip(params, updates):
                    p.add_(u)
        if self.config.log_grad_norm:
            metrics["grad_norm"] = global_norm(grads)
        if self.lr_schedule is not None:
            metrics["lr"] = torch.tensor(float(self.lr_schedule(state.step)),
                                         dtype=torch.float32)
        return metrics

    def train_step(self, state: TrainState, batch: dict) -> dict:
        """One optimizer step on a batch of device tensors; returns the
        step's metrics as device scalars and advances ``state``."""
        params = list(state.params.values())
        batch = self.policy.cast_to_compute(batch)
        self.task.model.train()
        if self.config.grad_accum > 1:
            grads, loss, metrics = self._accumulated_grads(
                params, batch, state.loss_scale, state.step)
        else:
            with L.dropout_generator(functools.partial(self._generator,
                                                       state.step)):
                grads, loss, metrics = self._microbatch_grads(
                    params, batch, state.loss_scale)
        extra = self._apply_grads(state, params, grads)
        state.step += 1
        return dict(metrics, loss=loss, **extra)

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
        self.state_poisoned = False
        if state is None:
            state = self.create_state()
        self.timing = {"windows": [], "eval_s": [], "save_s": []}
        history = []
        self.callbacks.train_begin(state)
        box = [state]
        device_iter = prefetch_to_device(iter(batches), self.device)
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
        ckpt = self.checkpoint_manager
        every = self.config.checkpoint_every
        start = state.step
        done = epoch = 0
        last_metrics: dict = {}
        pending: list = []
        stop = False
        t_mark = time.perf_counter()
        for batch in device_iter:
            metrics = self.train_step(state, batch)
            cur = state.step
            # Callbacks that save (the preemption handler) read the live
            # state from here.
            self._live_state = state
            done += 1
            if faults.ARMED:
                faults.step_boundary(cur)
            pending.append((cur, metrics))
            stop = done >= steps
            will_ckpt = ckpt is not None and bool(every) and cur % every == 0
            eval_due = eval_batches is not None and bool(
                (eval_every and cur % eval_every == 0)
                or (not eval_every and steps_per_epoch
                    and done % steps_per_epoch == 0)
                or (not eval_every and not steps_per_epoch and stop))
            # Read before a save (a guard callback must see the window
            # first) and before an evaluation (val_* events follow the
            # train metrics of their step).
            drained = (len(pending) >= self.config.log_every or stop
                       or will_ckpt or eval_due)
            if drained:
                for s, m in pending:
                    host = {k: float(v) for k, v in m.items()}
                    history.append((s, host))
                    stop |= self.callbacks.step_end(s, host)
                    last_metrics = host
                self.timing["windows"].append(
                    (len(pending), time.perf_counter() - t_mark))
                pending.clear()
            if eval_due:
                src = eval_batches() if callable(eval_batches) \
                    else eval_batches
                view = self.config.eval_state_view
                t0 = time.perf_counter()
                self.callbacks.eval_begin()
                try:
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
                self._save(cur, state)
            if drained:
                t_mark = time.perf_counter()
            if stop:
                break
        if ckpt is not None and not self.state_poisoned \
                and state.step > start:
            self._save(state.step, state)

    def _save(self, step: int, state: TrainState) -> None:
        t0 = time.perf_counter()
        # One batch a step: the data position is the step.
        self.checkpoint_manager.save(
            step, state,
            meta={"data_position": {"batches_consumed": int(step)}})
        self.timing["save_s"].append(time.perf_counter() - t0)

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
                    loss, metrics = self.task.loss_fn(
                        self.policy.cast_to_compute(batch))
                    device_metrics.append(dict(metrics, loss=loss.float()))
                    if steps is not None and len(device_metrics) >= steps:
                        break
        finally:
            it.close()
        acc = MetricAccumulator()
        for m in device_metrics:
            acc.update({k: float(v) for k, v in m.items()})
        out = acc.result()
        if getattr(self.task, "report_perplexity", False) and "loss" in out:
            # exp of the mean loss, not the mean of per-batch exps.
            out["perplexity"] = float(np.exp(min(out["loss"], 30.0)))
        return out

    def predict(self, batches: Iterable[dict], state: TrainState, *,
                steps: Optional[int] = None) -> torch.Tensor:
        """The task's ``predict_fn`` over the batches, concatenated along
        the batch on the host; rows with ``sample_weight`` 0 (the padding
        of an evaluation loader) are dropped."""
        outs, keeps = [], []
        with self.inference(state):
            for host in batches:
                batch = self.policy.cast_to_compute(
                    to_device(host, self.device))
                out = self.task.predict_fn(batch).cpu()
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
