"""The port's callbacks, metric accumulator and parameter EMA against the
JAX package's, on the CPU.

Callbacks are host code, so the two packages' instances are driven with
the same scripted metric streams and must decide alike: EarlyStopping
stops at the same event, ReduceLROnPlateau lowers the learning rate at
the same events to the same values (the JAX one inside an
``optax.inject_hyperparams`` state, the port's inside
``inject_learning_rate``'s), TerminateOnNaN stops on the same step.  The
EMA is held to one optax step of the JAX ``ema_of_params`` at the
optimizer tests' tolerance (f32, rtol 1e-6, atol 1e-7).
"""

import dataclasses
import json
import math
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflow_train_distributed_tpu.training import callbacks as jcb
from tensorflow_train_distributed_tpu.training import ema as jema
from tensorflow_train_distributed_tpu.training.metrics import (
    MetricAccumulator as JaxAccumulator,
)
from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
from tensorflow_train_distributed_torch.data.pipeline import (
    DataConfig,
    HostBatches,
    HostDataLoader,
)
from tensorflow_train_distributed_torch.models import llama as TLL
from tensorflow_train_distributed_torch.training import callbacks as tcb
from tensorflow_train_distributed_torch.training import ema as tema
from tensorflow_train_distributed_torch.training import optimizers as topt
from tensorflow_train_distributed_torch.training.checkpoint import (
    CheckpointManager,
)
from tensorflow_train_distributed_torch.training.metrics import (
    MetricAccumulator,
)
from tensorflow_train_distributed_torch.training.mixed_precision import (
    Policy,
)
from tensorflow_train_distributed_torch.training.train_state import (
    TrainState,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

# A scripted validation-loss stream: falls, plateaus, falls, plateaus.
STREAM = [5.0, 4.0, 3.9, 3.95, 3.9, 3.91, 3.92, 3.5, 3.5, 3.6, 3.6, 3.6,
          3.7, 3.55, 3.8]


def _stop_event(cb, key="val_loss", stream=STREAM):
    for i, v in enumerate(stream):
        if cb.on_step_end(i + 1, {key: v, "other": 1.0}):
            return i + 1
    return None


@pytest.mark.parametrize("kw", [
    dict(monitor="val_loss", patience=2),
    dict(monitor="val_loss", patience=3, min_delta=0.05),
    dict(monitor="val_loss", patience=2, mode="max"),
    dict(monitor="loss", patience=1)])
def test_early_stopping_matches_jax(kw):
    got = _stop_event(tcb.EarlyStopping(**kw))
    assert got == _stop_event(jcb.EarlyStopping(**kw))
    if kw["monitor"] == "val_loss":
        assert got is not None


def test_early_stopping_refuses_bad_mode():
    with pytest.raises(ValueError, match="mode"):
        tcb.EarlyStopping(mode="median")


@pytest.mark.parametrize("kw", [
    dict(factor=0.5, patience=2),
    dict(factor=0.1, patience=1, cooldown=2),
    dict(factor=0.5, patience=1, min_lr=3e-4),
    dict(factor=0.2, patience=2, min_delta=0.2)])
def test_reduce_lr_on_plateau_matches_jax(kw):
    """The LR after each event (one transform_state per event, as under
    log_every 1), JAX in an optax state, the port in its own."""
    params = [torch.ones(3)]
    jstate = optax.inject_hyperparams(optax.adam)(
        learning_rate=1e-3).init({"w": jnp.ones(3)})
    tstate = TrainState(step=0, params={"w": params[0]},
                        opt_state=topt.make_optimizer(
                            "adam", 1e-3, inject_lr=True).init(params))

    @dataclasses.dataclass
    class JState:               # what the JAX callback rewrites
        opt_state: object

        def replace(self, **kw):
            return dataclasses.replace(self, **kw)

    j, t = jcb.ReduceLROnPlateau(**kw), tcb.ReduceLROnPlateau(**kw)
    js = JState(jstate)
    j.on_train_begin(js)
    t.on_train_begin(tstate)
    jl, tl = [], []
    for i, v in enumerate(STREAM):
        j.on_step_end(i + 1, {"val_loss": v})
        t.on_step_end(i + 1, {"val_loss": v})
        js = j.transform_state(js) or js
        tstate = t.transform_state(tstate) or tstate
        jl.append(float(jcb.get_injected_hyperparam(js.opt_state,
                                                    "learning_rate")))
        tl.append(float(topt.get_injected_hyperparam(tstate.opt_state,
                                                     "learning_rate")))
    assert tl == jl
    assert tl[-1] < tl[0]


def test_reduce_lr_needs_an_injected_lr():
    params = [torch.ones(2)]
    state = TrainState(step=0, params={"w": params[0]},
                       opt_state=topt.make_optimizer("adam", 1e-3).init(
                           params))
    with pytest.raises(ValueError, match="inject_learning_rate"):
        tcb.ReduceLROnPlateau().on_train_begin(state)
    with pytest.raises(ValueError, match="factor"):
        tcb.ReduceLROnPlateau(factor=1.5)


def test_terminate_on_nan_matches_jax():
    stream = [3.0, 2.5, float("nan"), 2.0]
    trainer = type("T", (), {"state_poisoned": False})()
    t = tcb.TerminateOnNaN()
    t.set_trainer(trainer)
    assert _stop_event(t, "loss", stream) == 3
    assert trainer.state_poisoned
    assert _stop_event(jcb.TerminateOnNaN(), "loss", stream) == 3
    assert _stop_event(tcb.TerminateOnNaN(), "loss",
                       [1.0, float("inf")]) == 2


def test_history_jsonl_and_progress(tmp_path, capsys):
    h = tcb.History()
    path = tmp_path / "m.jsonl"
    jl = tcb.JsonlLogger(str(path))
    p = tcb.ProgressLogger(examples_per_step=8)
    cbs = tcb.CallbackList([h, jl, p])
    cbs.train_begin(None)
    for s in (1, 2, 3):
        cbs.step_end(s, {"loss": 4.0 - s})
    cbs.train_end(None)
    assert h.steps == [1, 2, 3] and h.history["loss"] == [3.0, 2.0, 1.0]
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert recs[0]["loss"] == 3.0 and "ts" in recs[0]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "step 1 | loss=3.0000"


def test_stall_watchdog_barks_and_pauses_in_eval(monkeypatch):
    w = tcb.StallWatchdog(timeout_s=0.2)
    monkeypatch.setattr(w, "_dump_stacks", lambda: None)
    w.on_train_begin(None)
    try:
        deadline = time.monotonic() + 10
        while w.stall_count < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert w.stall_count >= 1
        w.on_step_end(1, {})        # petted, so no bark is in flight
        w.on_eval_begin()
        n = w.stall_count
        time.sleep(0.5)
        assert w.stall_count == n
        w.on_eval_end()
    finally:
        w.on_train_end(None)
    assert w._stop is None          # the thread was joined
    with pytest.raises(ValueError):
        tcb.StallWatchdog(timeout_s=0)


@pytest.mark.parametrize("stream", [
    [{"loss": 2.0, "accuracy": 0.5}, {"loss": 1.0, "accuracy": 0.75}],
    [{"loss": 2.0, "loss_weight": 3.0}, {"loss": 1.0, "loss_weight": 1.0},
     {"loss": float("nan"), "loss_weight": 0.0}]])
def test_metric_accumulator_matches_jax(stream):
    t, j = MetricAccumulator(), JaxAccumulator()
    for m in stream:
        t.update(m)
        j.update(m)
    assert t.result() == j.result()


# -- the parameter EMA ---------------------------------------------------------


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("base", ["sgd", "adamw"])
def test_ema_steps_match_jax(base):
    shapes = [(4, 3), (5,)]
    params = [_rand(s, i) for i, s in enumerate(shapes)]
    jtx = jema.wrap_with_ema(
        optax.sgd(0.1) if base == "sgd" else optax.adamw(0.1,
                                                         weight_decay=0.01),
        decay=0.9)
    ttx = topt.make_optimizer(base, 0.1, weight_decay=0.01, ema_decay=0.9)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        grads = [_rand(s, 10 * step + i) for i, s in enumerate(shapes)]
        ju, js = jtx.update([jnp.asarray(g) for g in grads], js, jp)
        tu, ts = ttx.update([torch.from_numpy(g) for g in grads], ts, tp)
        for u, g in zip(tu, grads):       # the identity on the updates
            assert u.shape == g.shape
        jp = optax.apply_updates(jp, ju)
        tp = [p + u for p, u in zip(tp, tu)]
        for a, b in zip(tema.find_ema_params(ts),
                        jema.find_ema_params(js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_ema_refusals():
    for decay in (0.0, 1.0):
        with pytest.raises(ValueError, match="decay"):
            tema.ema_of_params(decay)
    params = [torch.ones(2)]
    state = TrainState(step=0, params={"w": params[0]},
                       opt_state=topt.make_optimizer("sgd", 0.1).init(
                           params))
    with pytest.raises(ValueError, match="wrap_with_ema"):
        tema.swap_ema_params(state)


def test_eval_scores_the_ema_view_and_training_continues():
    """Mid-training evaluation through ``eval_state_view`` scores the
    averages; the trained parameters are untouched by the swap."""
    cfg = dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny"])
    tr = Trainer(TLL.CausalLmTask(cfg, device="meta"),
                 topt.make_optimizer("adamw", 3e-3, ema_decay=0.5),
                 policy=Policy.from_name("float32"), device="cpu",
                 config=TrainerConfig(log_every=2,
                                      eval_state_view=tema.swap_ema_params))
    src = SyntheticLM(num_examples=64, seq_len=16, vocab_size=256)

    def evals():
        return HostDataLoader(src, DataConfig(global_batch_size=8,
                                              num_epochs=1))

    seen = []

    class Spy(tcb.Callback):
        def on_step_end(self, step, metrics):
            if "val_loss" in metrics:
                seen.append(metrics["val_loss"])

    tr.callbacks.callbacks.append(Spy())
    state, _ = tr.fit(HostBatches(src, 8), steps=4, eval_batches=evals,
                      eval_every=4, eval_steps=2)
    live = {k: v.detach().clone() for k, v in state.params.items()}
    want = tr.evaluate(evals(), tema.swap_ema_params(state), steps=2)
    assert seen == [want["loss"]]
    assert want["loss"] != tr.evaluate(evals(), state, steps=2)["loss"]
    for k, v in state.params.items():
        assert torch.equal(v, live[k])
    assert math.isclose(want["perplexity"], math.exp(want["loss"]))


@dataclasses.dataclass
class _Saved:
    step: int
    params: dict


def test_best_checkpoint_keeps_the_best(tmp_path):
    """Saves at the window's last event when the monitor improves, in its
    own directory; a poisoned state is never saved."""
    best = tcb.BestCheckpoint(str(tmp_path / "best"), monitor="val_loss")
    best.set_trainer(type("T", (), {"state_poisoned": False})())
    for step, v in ((2, 3.0), (4, 2.0), (6, 2.5)):
        best.on_step_end(step, {"val_loss": v})
        assert best.transform_state(
            _Saved(step, {"w": np.full(2, step, np.float32)})) is None
    assert (best.best, best.best_step) == (2.0, 4)
    best.trainer.state_poisoned = True
    best.on_step_end(8, {"val_loss": 1.0})
    best.transform_state(_Saved(8, {"w": np.zeros(2, np.float32)}))
    mgr = CheckpointManager(str(tmp_path / "best"))
    assert mgr.all_steps() == [4]
    assert mgr.restore_params()["w"].tolist() == [4.0, 4.0]


def test_callback_list_hooks_are_duck_typed():
    calls = []

    class Bare:                 # no eval hooks, no transform_state
        def set_trainer(self, trainer):
            calls.append("set")

        def on_train_begin(self, state):
            calls.append("begin")

    cbs = tcb.CallbackList([Bare()], trainer=object())
    cbs.train_begin(None)
    cbs.eval_begin()
    cbs.eval_end()
    assert cbs.apply_state_transforms("s") == "s"
    assert calls == ["set", "begin"]
