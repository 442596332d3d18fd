"""Cross-rank BatchNorm (``models/resnet.py`` ``BatchNorm`` under a mesh's
batch group) against one process at the global batch and against the
JAX ``Trainer`` on two virtual CPU devices, whose BatchNorm covers the
global batch because its arrays are global.

resnet_tiny and its ``stats_stride`` 2 variant, 5 steps at a global batch
of 16 (8 a rank over gloo), adamw 1e-3 in f32, from the JAX model's own
initial weights and statistics.  Tolerances, f32: the dp-2 loss curve
within 1e-5 of one process's (the statistics are sums over the ranks'
halves in another order) and 1e-4 of JAX's (the decoders' curve bar,
``tests/test_torch_vision.py``); the running ``mean``/``var`` after the
run within 1e-5 relative (1e-6 absolute) of both, as
``test_torch_vision.py`` holds them at one device.
"""

import dataclasses

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

import _torch_dist_workers as W
from tensorflow_train_distributed_tpu.data import DataConfig, HostDataLoader
from tensorflow_train_distributed_tpu.data import datasets as jds
from tensorflow_train_distributed_tpu.models import resnet as JRN
from tensorflow_train_distributed_tpu.models import registry as jreg
from tensorflow_train_distributed_tpu.runtime.mesh import (
    MeshConfig,
    build_mesh,
)
from tensorflow_train_distributed_tpu.training import mixed_precision as jmp
from tensorflow_train_distributed_tpu.training.callbacks import History
from tensorflow_train_distributed_tpu.training.trainer import (
    Trainer as JaxTrainer,
    TrainerConfig as JaxTrainerConfig,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.runtime import mesh as tmesh
from tensorflow_train_distributed_torch.testing import MultiProcessRunner

STEPS, BATCH = 5, 16
STRIDES = (1, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(tree), sep="/").items()}


def _jax_run(stride: int, devices: int):
    """The JAX Trainer on ``devices`` virtual CPU devices: (its initial
    variables as port tensors, the losses, the final batch_stats)."""
    mesh = build_mesh(MeshConfig(data=devices),
                      devices=jax.devices()[:devices])
    entry = jreg.get_entry("resnet_tiny")
    cfg = dataclasses.replace(JRN.RESNET_PRESETS["resnet_tiny"],
                              bn_stats_stride=stride)
    hist = History()
    jtr = JaxTrainer(JRN.make_task(cfg, label_smoothing=0.0,
                                   weight_decay=0.0),
                     optax.adamw(1e-3), mesh,
                     policy=jmp.Policy.from_name("float32"),
                     config=JaxTrainerConfig(log_every=1), callbacks=[hist])
    loader = HostDataLoader(
        jds.get_dataset(entry["dataset"], **dict(entry["dataset_kwargs"],
                                                 num_examples=64)),
        DataConfig(global_batch_size=BATCH, seed=0))
    jstate = jtr.create_state(next(iter(loader)))
    flat = _flat(jstate.params)
    for k, v in _flat(jstate.model_state["batch_stats"]).items():
        flat[f"batch_stats/{k}"] = v
    init = convert.params_from_flax(flat, W.resnet_entry(stride)["config"])
    jstate = jtr.fit(loader, steps=STEPS, state=jstate)
    stats = {f"batch_stats/{k}": v for k, v in
             _flat(jstate.model_state["batch_stats"]).items()}
    return init, np.asarray(hist.history["loss"]), stats


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each stride: the JAX run on 2 devices, the port in one process
    at the global batch, and the port at dp 2 over gloo (one cluster
    runs both strides)."""
    root = tmp_path_factory.mktemp("sync_bn")
    out = {}
    for s in STRIDES:
        init, jloss, jstats = _jax_run(s, 2)
        path = str(root / f"init{s}.npz")
        np.savez(path, **{k: v.numpy() for k, v in init.items()})
        entry = W.resnet_entry(s)
        trainer = W.resnet_trainer(entry)
        state = trainer.create_state({k: v.clone() for k, v in init.items()})
        state, history = trainer.fit(W.resnet_batches(entry, STEPS, BATCH),
                                     steps=STEPS, state=state)
        out[s] = dict(path=path, jloss=jloss, jstats=jstats,
                      loss=np.asarray([m["loss"] for _, m in history]),
                      stats={k: v.detach().numpy()
                             for k, v in state.model_state.items()})
    res = MultiProcessRunner(
        "_torch_dist_workers:sync_bn", 2, payload=dict(
            runs={s: [out[s]["path"], str(root / f"dp{s}.npz")]
                  for s in STRIDES}, steps=STEPS, batch=BATCH),
        timeout=240).run()
    for s in STRIDES:
        with np.load(root / f"dp{s}.npz") as f:
            out[s]["dp_stats"] = {k: f[k] for k in f.files}
        out[s]["dp_loss"] = np.asarray(
            [h["loss"] for _, h in res[0].value[str(s)]["history"]])
        out[s]["digests"] = [r.value[str(s)]["digest"] for r in res]
    return out


def _close_stats(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("stride", STRIDES)
def test_dp2_matches_one_process_at_the_global_batch(runs, stride):
    r = runs[stride]
    assert np.max(np.abs(r["dp_loss"] - r["loss"])) <= 1e-5, (
        r["dp_loss"] - r["loss"])
    _close_stats(r["dp_stats"], r["stats"])
    # Every rank holds the same global statistics.
    assert r["digests"][0] == r["digests"][1]


@pytest.mark.parametrize("stride", STRIDES)
def test_dp2_matches_the_jax_trainer_on_two_devices(runs, stride):
    r = runs[stride]
    assert np.max(np.abs(r["dp_loss"] - r["jloss"])) <= 1e-4, (
        r["dp_loss"] - r["jloss"])
    _close_stats(r["dp_stats"], r["jstats"])


def test_one_batch_rank_runs_the_plain_batch_norm():
    """At one batch rank the layers keep no group: the forward is the
    ``F.batch_norm`` path phase 15's bit-for-bit resume holds."""
    m = tmesh.Mesh(dict.fromkeys(tmesh.AXES, 1))
    trainer = W.resnet_trainer(W.resnet_entry(1), m)
    trainer.create_state()
    from tensorflow_train_distributed_torch.models.resnet import BatchNorm

    bns = [b for b in trainer.task.model.modules()
           if isinstance(b, BatchNorm)]
    assert bns and all(b.group is None for b in bns)


def test_grad_quant_with_batch_norm_still_raises_jax_text():
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    entry = W.resnet_entry(1)
    m = tmesh.Mesh({**dict.fromkeys(tmesh.AXES, 1), "data": 2})
    trainer = Trainer(registry.make_task(entry, device="meta"),
                      optimizers.make_optimizer("adamw", 1e-3),
                      device="cpu", mesh=m,
                      config=TrainerConfig(grad_quant="int8"))
    with pytest.raises(ValueError, match="grad_quant requires a task with "
                       "no mutable model collections .e.g. BatchNorm "
                       "batch_stats.: the implicit GSPMD path reduces"):
        trainer.create_state()
