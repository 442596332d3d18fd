"""The port's checkpoint manager, preemption handler and fault sites, on
the CPU.

The cases of the JAX package's ``tests/test_restore_fallback.py`` (torn
saves quarantined, fallback to the newest good step, systemic failures
raise and move nothing) and ``tests/test_checkpoint.py`` (round trip,
keep-N, a resumed run continuing the uninterrupted curve) run here on the
port's manager; then what the port's format adds: the whole train state
(Adam and lamb moments, the injected learning rate, the EMA, a float16
loss scale) restored bit for bit into a fresh template, the
``ckpt:save:partial`` fault, a SIGTERM that saves at the step boundary
and stops, and the step-site fault plan; BatchNorm's running statistics
as the state's ``model_state`` (a checkpoint without them refused for a
BatchNorm model), and a resumed BERT run with dropout 0.1 drawing the
uninterrupted run's masks (the (seed, step) generator).
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
from tensorflow_train_distributed_torch.data.pipeline import HostBatches
from tensorflow_train_distributed_torch.models import llama as TLL
from tensorflow_train_distributed_torch.runtime import faults
from tensorflow_train_distributed_torch.runtime.preemption import (
    PreemptionCheckpointCallback,
    PreemptionWatcher,
    sync_preemption_flag,
)
from tensorflow_train_distributed_torch.training import optimizers as topt
from tensorflow_train_distributed_torch.training.callbacks import Callback
from tensorflow_train_distributed_torch.training.checkpoint import (
    COMMIT_MARKER,
    QUARANTINE_DIR,
    TENSORS,
    CheckpointManager,
)
from tensorflow_train_distributed_torch.training.mixed_precision import (
    Policy,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)


def _state(v: float) -> dict:
    return {"params": {"w": np.full((8,), v, np.float32),
                       "b": np.full((3,), -v, np.float32)},
            "step": np.asarray(int(v))}


@pytest.fixture()
def mgr3(tmp_path):
    """A manager with steps 1..3 saved (values = step number)."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    for s in (1, 2, 3):
        assert mgr.save(s, _state(s))
    yield mgr, tmp_path / "ck"


def _drop_marker(ck, step):
    os.remove(ck / str(step) / COMMIT_MARKER)


def _truncate_arrays(ck, step):
    """Torn tensor bytes under an INTACT commit marker (a flaky disk, not
    a crashed writer)."""
    path = ck / str(step) / TENSORS
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


class TestRestoreFallback:
    def test_missing_commit_marker_falls_back(self, mgr3):
        mgr, ck = mgr3
        _drop_marker(ck, 3)
        restored = mgr.restore(_state(0))
        assert int(restored["step"]) == 2
        np.testing.assert_array_equal(restored["params"]["w"],
                                      np.full((8,), 2.0, np.float32))
        assert (ck / QUARANTINE_DIR / "3").is_dir()
        assert not (ck / "3").exists()
        assert mgr.latest_step() == 2

    def test_truncated_arrays_fall_back(self, mgr3):
        mgr, ck = mgr3
        _truncate_arrays(ck, 3)
        assert int(mgr.restore(_state(0))["step"]) == 2
        assert (ck / QUARANTINE_DIR / "3").is_dir()

    def test_cascading_corruption_reaches_oldest_good(self, mgr3):
        mgr, ck = mgr3
        _drop_marker(ck, 3)
        _truncate_arrays(ck, 2)
        assert int(mgr.restore(_state(0))["step"]) == 1
        assert (ck / QUARANTINE_DIR / "3").is_dir()
        assert (ck / QUARANTINE_DIR / "2").is_dir()

    def test_all_corrupt_returns_none(self, mgr3):
        mgr, ck = mgr3
        for s in (1, 2, 3):
            _drop_marker(ck, s)
        assert mgr.restore(_state(0)) is None
        assert mgr.latest_step() is None

    def test_explicit_step_fails_hard(self, mgr3):
        mgr, ck = mgr3
        _drop_marker(ck, 3)
        with pytest.raises(ValueError, match="commit marker"):
            mgr.restore(_state(0), step=3)
        assert (ck / "3").exists()        # no quarantine on explicit asks

    def test_save_continues_after_quarantine(self, mgr3):
        mgr, ck = mgr3
        _drop_marker(ck, 3)
        assert int(mgr.restore(_state(0))["step"]) == 2
        assert mgr.save(4, _state(4))
        assert mgr.latest_step() == 4
        assert int(mgr.restore(_state(0))["step"]) == 4

    def test_systemic_failure_raises_and_quarantines_nothing(self, mgr3):
        mgr, ck = mgr3
        for s in (1, 2, 3):
            _truncate_arrays(ck, s)
        with pytest.raises(ValueError, match="short"):
            mgr.restore(_state(0))
        assert not (ck / QUARANTINE_DIR).exists()
        for s in (1, 2, 3):
            assert (ck / str(s)).is_dir()
        assert mgr.latest_step() == 3

    def test_changed_state_is_systemic_too(self, mgr3):
        """A template whose shapes differ from every save (a changed
        config) fails loudly and moves nothing."""
        mgr, ck = mgr3
        other = _state(0)
        other["params"]["w"] = np.zeros((9,), np.float32)
        with pytest.raises(ValueError, match="params/w"):
            mgr.restore(other)
        assert not (ck / QUARANTINE_DIR).exists()

    def test_clean_restore_untouched(self, mgr3):
        mgr, ck = mgr3
        assert int(mgr.restore(_state(0))["step"]) == 3
        assert not (ck / QUARANTINE_DIR).exists()


def test_keep_n_empty_dir_and_stale_temporaries(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "keep"), max_to_keep=2)
    assert mgr.restore(_state(0)) is None and mgr.latest_step() is None
    for s in (1, 2, 3):
        assert mgr.save(s, _state(s))
    assert not mgr.save(3, _state(3))          # that step exists
    assert mgr.all_steps() == [2, 3]
    # A writer killed before its rename leaves only a temporary, which
    # the next manager removes and never lists.
    os.makedirs(tmp_path / "keep" / ".tmp-4-123")
    mgr = CheckpointManager(str(tmp_path / "keep"), max_to_keep=2)
    assert not (tmp_path / "keep" / ".tmp-4-123").exists()
    assert mgr.latest_step() == 3
    assert mgr.restore_params()["w"].tolist() == [3.0] * 8


def _task(remat=False):
    cfg = dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny"], remat=remat)
    return TLL.CausalLmTask(cfg, device="meta")


def _batches(seed=0):
    return HostBatches(SyntheticLM(num_examples=64, seq_len=16,
                                   vocab_size=256), 8, seed=seed)


def _trainer(tx, *, policy=Policy.from_name("float32"), mgr=None,
             callbacks=(), every=None, log_every=5):
    return Trainer(_task(), tx, policy=policy, device="cpu",
                   config=TrainerConfig(log_every=log_every,
                                        checkpoint_every=every),
                   callbacks=callbacks, checkpoint_manager=mgr)


def _assert_states_equal(a, b):
    from tensorflow_train_distributed_torch.training.checkpoint import (
        flatten,
    )

    (ta, va), (tb, vb) = flatten(a), flatten(b)
    assert ta.keys() == tb.keys() and va == vb
    for k in ta:
        assert torch.equal(torch.as_tensor(ta[k]), torch.as_tensor(tb[k])), k


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(ema_decay=0.9)),
    ("lamb", dict(inject_lr=True, weight_decay=0.01)),
    ("adafactor", {}),
    ("momentum", dict(grad_clip_norm=1.0)),
])
def test_train_state_round_trip_is_bitwise(tmp_path, name, kw):
    """Two steps, save, restore into a fresh state from another seed:
    every tensor and plain value of the state comes back equal, on the
    template's own tensors (the model's parameters stay bound)."""
    lr = 1e-3 if kw.get("inject_lr") else (lambda c: 1e-3)
    policy = Policy.from_name("float16")            # a loss-scale state
    tr = _trainer(topt.make_optimizer(name, lr, **kw), policy=policy)
    state, _ = tr.fit(_batches(), steps=2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(state.step, state)
    tr2 = _trainer(topt.make_optimizer(name, lr, **kw), policy=policy)
    tr2.config = dataclasses.replace(tr2.config, seed=7)
    template = tr2.create_state()
    restored = mgr.restore(template)
    _assert_states_equal(restored, state)
    assert restored.step == 2
    for k, p in tr2.task.model.named_parameters():
        assert p is restored.params[k]
    if kw.get("inject_lr"):
        assert float(topt.get_injected_hyperparam(
            restored.opt_state, "learning_rate")) == np.float32(1e-3)


def test_resume_continues_the_uninterrupted_curve(tmp_path):
    """Train 6 steps straight; or 3, save, restore into a new trainer
    and take 3 more from the loader's ``iter_from(3)``: the losses and
    the final state agree bit for bit."""
    def tx():
        return topt.make_optimizer("adamw", lambda c: 3e-3,
                                   weight_decay=0.01, grad_clip_norm=1.0)

    ref, ref_hist = _trainer(tx(), log_every=1).fit(_batches(), steps=6)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _, first = _trainer(tx(), mgr=mgr, log_every=1).fit(_batches(),
                                                        steps=3)
    assert mgr.latest_step() == 3
    assert mgr.restored_meta is None
    tr = _trainer(tx(), log_every=1)
    state = mgr.restore(tr.create_state())
    assert mgr.restored_meta == {"data_position": {"batches_consumed": 3}}
    state, second = tr.fit(_batches().iter_from(3), steps=3, state=state)
    assert [m["loss"] for _, m in first + second] == \
        [m["loss"] for _, m in ref_hist]
    _assert_states_equal(state, ref)


def _family_trainer(name, tx, mgr=None, **cfg_knobs):
    """A trainer on a registry entry (its config with ``cfg_knobs``)."""
    from tensorflow_train_distributed_torch.models import registry

    entry = registry.get_entry(name)
    entry = dict(entry, config=dataclasses.replace(entry["config"],
                                                   **cfg_knobs))
    return Trainer(registry.make_task(entry, device="meta"), tx,
                   policy=Policy.from_name("float32"), device="cpu",
                   config=TrainerConfig(log_every=1),
                   checkpoint_manager=mgr), entry


def _family_batches(entry, seed=0):
    from tensorflow_train_distributed_torch.data.datasets import get_dataset

    kw = dict(entry["dataset_kwargs"], num_examples=64)
    return HostBatches(get_dataset(entry["dataset"], **kw), 8, seed=seed)


@pytest.mark.parametrize("name,knobs", [
    ("bert_tiny_mlm", dict(dropout_rate=0.1)),
    ("resnet_tiny", {}),
])
def test_family_resume_is_bitwise(tmp_path, name, knobs):
    """6 steps straight, or 3, save, restore into a new trainer and 3
    more: the losses and the final state (BatchNorm's running statistics,
    and under dropout 0.1 what each step's (seed, step) masks made of the
    weights) agree bit for bit."""
    def tx():
        return topt.make_optimizer("adamw", 1e-3)

    tr, entry = _family_trainer(name, tx(), **knobs)
    ref, ref_hist = tr.fit(_family_batches(entry), steps=6)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tr, _ = _family_trainer(name, tx(), mgr, **knobs)
    _, first = tr.fit(_family_batches(entry), steps=3)
    tr, _ = _family_trainer(name, tx(), **knobs)
    state = mgr.restore(tr.create_state())
    assert state.step == 3
    state, second = tr.fit(_family_batches(entry).iter_from(3), steps=3,
                           state=state)
    assert [m["loss"] for _, m in first + second] == \
        [m["loss"] for _, m in ref_hist]
    _assert_states_equal(state, ref)
    if name == "resnet_tiny":
        assert "model_state/batch_stats/stem_bn/var" in \
            CheckpointManager(str(tmp_path / "ck"))._read(3)[0]["tensors"]
        names = dict(tr.task.model.named_buffers())
        assert state.model_state["batch_stats/stem_bn/mean"] is \
            names["stem_bn.mean"]


def test_dropout_changes_the_run():
    """The bitwise resume above is not vacuous: dropout 0.1 moves the
    losses off the rate-0 run's."""
    def losses(rate):
        tr, entry = _family_trainer("bert_tiny_mlm",
                                    topt.make_optimizer("adamw", 1e-3),
                                    dropout_rate=rate)
        return [m["loss"] for _, m in tr.fit(_family_batches(entry),
                                             steps=2)[1]]

    assert losses(0.1) != losses(0.0)


def test_checkpoint_without_model_state_is_refused(tmp_path):
    """A BatchNorm model's checkpoint that lacks the running statistics is
    refused before anything is written, not half-restored."""
    from tensorflow_train_distributed_torch.training.train_state import (
        TrainState,
    )

    tr, entry = _family_trainer("resnet_tiny",
                                topt.make_optimizer("sgd", 1e-2))
    state, _ = tr.fit(_family_batches(entry), steps=1)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    bare = TrainState(step=state.step, params=state.params,
                      opt_state=state.opt_state,
                      loss_scale=state.loss_scale)
    assert mgr.save(1, bare)
    tr2, _ = _family_trainer("resnet_tiny",
                             topt.make_optimizer("sgd", 1e-2))
    template = tr2.create_state()
    before = {k: v.clone() for k, v in template.params.items()}
    with pytest.raises(ValueError, match="model state"):
        mgr.restore(template)
    for k, v in template.params.items():
        assert torch.equal(v, before[k]), k
    assert mgr.all_steps() == [1]                 # nothing quarantined


def test_checkpoint_every_and_the_final_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
    tr = _trainer(topt.make_optimizer("sgd", 1e-2), mgr=mgr, every=2)
    tr.fit(_batches(), steps=5)
    assert mgr.all_steps() == [2, 4, 5]
    assert len(tr.timing["save_s"]) == 3


def test_partial_save_fault_tears_the_step(tmp_path):
    """``ckpt:save:partial:step=2`` drops the step-2 marker and halves
    its files after the save; the next restore quarantines it and
    returns step 1."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    try:
        faults.arm("ckpt:save:partial:step=2", seed=0)
        for s in (1, 2):
            assert mgr.save(s, _state(s))
    finally:
        faults.disarm()
    assert not (tmp_path / "ck" / "2" / COMMIT_MARKER).exists()
    assert int(mgr.restore(_state(0))["step"]) == 1
    assert (tmp_path / "ck" / QUARANTINE_DIR / "2").is_dir()


def test_step_fault_raises_at_the_boundary():
    tr = _trainer(topt.make_optimizer("sgd", 1e-2))
    try:
        faults.arm("step:3:raise")
        with pytest.raises(faults.InjectedFault, match="step 3"):
            tr.fit(_batches(), steps=10)
    finally:
        faults.disarm()
    assert tr._live_state.step == 3


class _SignalAt(Callback):
    """Delivers a real SIGTERM to this process at a given step."""

    def __init__(self, step: int):
        self.step = step

    def on_step_end(self, step, metrics):
        if step == self.step:
            os.kill(os.getpid(), signal.SIGTERM)


def test_watcher_flags_and_chains_sigterm():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        w = PreemptionWatcher().install()
        assert not w.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert w.preempted and hits == [signal.SIGTERM]
        w.uninstall()
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert sync_preemption_flag(True) is True
    assert sync_preemption_flag(False) is False


def test_preemption_saves_and_stops(tmp_path):
    watcher = PreemptionWatcher().install()
    cb = PreemptionCheckpointCallback(watcher)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    try:
        tr = _trainer(topt.make_optimizer("adam", 1e-3), mgr=mgr,
                      callbacks=[_SignalAt(3), cb], log_every=1)
        state, _ = tr.fit(_batches(), steps=50)
    finally:
        watcher.uninstall()
    assert cb.saved_step == 3 == state.step == mgr.latest_step()
    tr2 = _trainer(topt.make_optimizer("adam", 1e-3))
    restored = mgr.restore(tr2.create_state())
    assert restored.step == 3
    final, _ = tr2.fit(_batches().iter_from(3), steps=2, state=restored)
    assert final.step == 5
