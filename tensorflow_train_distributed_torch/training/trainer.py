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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from tensorflow_train_distributed_torch.data.pipeline import to_device
from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.training import mixed_precision as mp
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


class Trainer:
    """Owns state creation, the step and the fit loop for one task (a
    ``models.llama.CausalLmTask`` or ``models.moe.MoeLmTask``) on one
    device."""

    def __init__(self, task, optimizer: GradientTransformation, *,
                 policy: Policy = Policy(),
                 config: TrainerConfig = TrainerConfig(),
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 device="cuda"):
        self.task = task
        self.tx = optimizer
        self.policy = policy
        self.config = config
        # Observational: the optimizer owns the schedule; this one only
        # reports ``lr`` beside the loss, as the JAX trainer does.
        self.lr_schedule = lr_schedule
        self.device = torch.device(device)

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
        return TrainState(
            step=0, params=named,
            opt_state=self.tx.init(list(named.values())),
            loss_scale=mp.LossScaleState.create(self.policy, self.device))

    # -- the step --------------------------------------------------------

    def _microbatch_grads(self, params: list, batch: dict, loss_scale):
        """Loss, metrics and unscaled f32 grads of one (micro)batch."""
        loss, metrics = self.task.loss_fn(batch)
        loss = loss.float()
        grads = torch.autograd.grad(mp.scale_loss(loss, loss_scale), params)
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        return mp.unscale_grads(list(grads), loss_scale), loss.detach(), \
            metrics

    def _accumulated_grads(self, params: list, batch: dict, loss_scale):
        """``grad_accum`` microbatches (rows split in order), their grads
        averaged in f32, weighted by ``loss_weight`` where the task
        reports one."""
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
        if self.config.grad_accum > 1:
            grads, loss, metrics = self._accumulated_grads(
                params, batch, state.loss_scale)
        else:
            grads, loss, metrics = self._microbatch_grads(
                params, batch, state.loss_scale)
        extra = self._apply_grads(state, params, grads)
        state.step += 1
        return dict(metrics, loss=loss, **extra)

    # -- the loop --------------------------------------------------------

    def fit(self, batches: Iterable[dict], *, steps: int,
            state: Optional[TrainState] = None,
            on_log: Optional[Callable[[int, dict], None]] = None):
        """Run ``steps`` optimizer steps over host (numpy) batches.
        Metrics are read every ``log_every`` steps and at the end; each
        step's reach ``on_log(step, metrics)`` in order.  Returns
        ``(state, history)``, history a list of (step, metrics)."""
        if state is None:
            state = self.create_state()
        it = iter(batches)
        history, pending = [], []
        for i in range(steps):
            batch = to_device(next(it), self.device)
            metrics = self.train_step(state, batch)
            pending.append((state.step, metrics))
            if len(pending) >= self.config.log_every or i == steps - 1:
                for s, m in pending:
                    host = {k: float(v) for k, v in m.items()}
                    history.append((s, host))
                    if on_log is not None:
                        on_log(s, host)
                pending.clear()
        return state, history
