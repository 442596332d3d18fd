"""The port's ViT (``models/vit.py``) against the JAX package's, on the CPU,
case by case with the JAX ``tests/test_vit.py``.

Weights come from the JAX model's own init (its zero head replaced by a
random one, so the logits are not identically 0), carried over by
``convert.params_from_flax``.  Tolerances, each at f32:

- logits: 1e-5 relative and 1e-5 of the largest logit's magnitude
  absolute (the same math in other convolution, matmul and reduction
  orders through two blocks; the random head puts logits near 10, where
  f32 rounding is ~1e-6 absolute); the loss: 1e-5 relative;
- one step's gradients: rtol 1e-4, atol 1e-6 per leaf;
- 10 ``Trainer`` steps against the JAX ``Trainer``: the loss, accuracy
  and grad-norm curves within 1e-4 (the other families' bar);
- remat against no remat: bitwise in the forward and the gradients (the
  same ops, recomputed).
"""

import dataclasses
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.data import DataConfig, HostDataLoader
from tensorflow_train_distributed_tpu.data import datasets as jds
from tensorflow_train_distributed_tpu.models import registry as jreg
from tensorflow_train_distributed_tpu.models import vit as JV
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
from tensorflow_train_distributed_torch.data import datasets as tds
from tensorflow_train_distributed_torch.data.pipeline import (
    HostBatches,
    to_device,
)
from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.models import vit as TV
from tensorflow_train_distributed_torch.training import optimizers as topt
from tensorflow_train_distributed_torch.training.mixed_precision import (
    Policy,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_J, TINY_T = JV.VIT_PRESETS["vit_tiny"], TV.VIT_PRESETS["vit_tiny"]
BATCH, STEPS = 16, 10


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(tree), sep="/").items()}


def _jax_params(jcfg, seed=0):
    """The JAX init with a random head (its zero init would hide the
    rest of the network behind identically-0 logits)."""
    params = fnn.unbox(JV.VisionTransformer(jcfg).init(
        jax.random.key(seed), jnp.zeros((1, jcfg.image_size,
                                         jcfg.image_size, 3)))["params"])
    params["head"]["kernel"] = jax.random.normal(
        jax.random.key(9), params["head"]["kernel"].shape)
    return params


def _port(tcfg, params):
    model = TV.VisionTransformer(tcfg, device="meta")
    model.load_state_dict(convert.params_from_flax(_flat(params), tcfg),
                          strict=True, assign=True)
    return model


def _param_count_jax(jcfg) -> int:
    shapes = jax.eval_shape(lambda: JV.VisionTransformer(jcfg).init(
        jax.random.key(0), jnp.zeros((1, jcfg.image_size, jcfg.image_size,
                                      3))))
    return int(sum(np.prod(x.shape) for x in jax.tree.leaves(shapes)))


def _param_count_port(tcfg) -> int:
    return sum(int(np.prod(s)) for s in convert.expected_shapes(
        tcfg).values())


# -- architecture -------------------------------------------------------------


@pytest.mark.parametrize("pooling", ["gap", "cls"])
def test_vit_b16_param_count_equals_jax(pooling):
    jcfg = dataclasses.replace(JV.VIT_PRESETS["vit_b16"], pooling=pooling)
    tcfg = dataclasses.replace(TV.VIT_PRESETS["vit_b16"], pooling=pooling)
    n = _param_count_port(tcfg)
    assert n == _param_count_jax(jcfg)
    # ViT-B/16 at 224, 1000 classes: ~86M (the paper's Table 1).
    assert abs(n - 86.4e6) < 1.5e6, n


@pytest.mark.parametrize("pooling", ["gap", "cls"])
def test_logits_match_jax_both_poolings(pooling):
    jcfg = dataclasses.replace(TINY_J, pooling=pooling)
    tcfg = dataclasses.replace(TINY_T, pooling=pooling)
    params = _jax_params(jcfg)
    x = _images((3, 32, 32, 3), seed=1)
    want = JV.VisionTransformer(jcfg).apply({"params": params}, x)
    got = _port(tcfg, params).eval()(torch.from_numpy(x))
    assert got.shape == (3, 10)
    _close(got, want, atol=1e-5 * float(np.max(np.abs(want))))


def test_cls_token_changes_param_set():
    gap = _param_count_port(TINY_T)
    cls = _param_count_port(dataclasses.replace(TINY_T, pooling="cls"))
    # The cls token (H) and one more position row (H).
    assert cls - gap == 2 * TINY_T.hidden_size
    assert cls == _param_count_jax(dataclasses.replace(TINY_J,
                                                       pooling="cls"))


def test_wrong_image_size_raises():
    model = TV.VisionTransformer(TINY_T)       # expects 32px
    with pytest.raises(ValueError, match="patches"):
        model(torch.zeros(1, 64, 64, 3))


def test_indivisible_patch_grid_raises():
    with pytest.raises(ValueError, match="not divisible"):
        dataclasses.replace(TINY_T, image_size=30).num_patches


def test_dropout_only_in_training_mode():
    cfg = dataclasses.replace(TINY_T, dropout_rate=0.1)
    model = _port(cfg, _jax_params(dataclasses.replace(TINY_J,
                                                       dropout_rate=0.1)))
    x = torch.ones(2, 32, 32, 3)
    model.eval()
    np.testing.assert_array_equal(model(x).detach().numpy(),
                                  model(x).detach().numpy())
    model.train()
    outs = []
    for seed in (1, 2):
        with L.dropout_generator(torch.Generator().manual_seed(seed)):
            outs.append(model(x).detach().numpy())
    assert not np.allclose(*outs)
    with pytest.raises(RuntimeError, match="dropout_generator"):
        model(x)


def test_remat_matches_exact():
    """Remat recomputes each block in the backward (its dropout masks
    redrawn from the forward's generator state): forward and gradients
    equal no remat bit for bit."""
    jcfg = dataclasses.replace(TINY_J, dropout_rate=0.1)
    params = _jax_params(jcfg)
    x = torch.from_numpy(_images((2, 32, 32, 3)))
    outs = []
    for remat in (False, True):
        model = _port(dataclasses.replace(TINY_T, dropout_rate=0.1,
                                          remat=remat), params).train()
        with L.dropout_generator(torch.Generator().manual_seed(5)):
            y = model(x)
        grads = torch.autograd.grad(y.square().sum(),
                                    list(model.parameters()))
        outs.append((y.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


# -- the task -----------------------------------------------------------------


def test_task_loss_and_grads_match_jax():
    """``make_task`` with label smoothing 0.1 (vit_b16_imagenet's): the
    loss, metrics and every parameter's gradient against the JAX task's
    on the same weights."""
    jtask = JV.make_task(TINY_J)                      # smoothing 0.1
    ttask = TV.make_task(TINY_T, device="meta")
    params = _jax_params(TINY_J)
    batch = {"image": _images((4, 32, 32, 3), seed=3),
             "label": np.array([1, 2, 3, 9], np.int32)}

    def jloss(p):
        return jtask.loss_fn(p, {}, batch, None, False)

    (loss, (metrics, _)), grads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    ttask.model.load_state_dict(convert.params_from_flax(_flat(params),
                                                         TINY_T),
                                strict=True, assign=True)
    ttask.model.eval()
    tloss, tmetrics = ttask.loss_fn(to_device(batch, "cpu"))
    _close(tloss.item(), float(loss))
    for k in ("accuracy", "top5_accuracy"):
        _close(tmetrics[k].item(), float(metrics[k]), msg=k)
    names = [n for n, _ in ttask.model.named_parameters()]
    tgrads = torch.autograd.grad(tloss, list(ttask.model.parameters()))
    want = convert.params_from_flax(_flat(grads), TINY_T)
    for name, g in zip(names, tgrads):
        _close(g, want[name], rtol=1e-4, atol=1e-6, msg=name)


def test_task_dropout_redraws_with_the_generator():
    cfg = dataclasses.replace(TINY_T, dropout_rate=0.1)
    task = TV.make_task(cfg, label_smoothing=0.0, device="meta")
    task.model.load_state_dict(convert.params_from_flax(
        _flat(_jax_params(dataclasses.replace(TINY_J, dropout_rate=0.1))),
        cfg), assign=True)
    task.model.train()
    batch = {"image": torch.ones(4, 32, 32, 3),
             "label": torch.zeros(4, dtype=torch.int64)}
    losses = []
    for seed in (1, 2):
        with L.dropout_generator(torch.Generator().manual_seed(seed)):
            loss, metrics = task.loss_fn(batch)
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[0] != losses[1]
    assert "accuracy" in metrics


def test_uint8_batch_path_matches_jax():
    """Raw uint8 batches normalise on the device with the ImageNet
    statistics, as the JAX task does."""
    jtask = JV.make_task(TINY_J)
    ttask = TV.make_task(TINY_T, device="meta")
    params = _jax_params(TINY_J)
    u8 = np.random.default_rng(4).integers(0, 256, (2, 32, 32, 3)).astype(
        np.uint8)
    batch = {"image": u8, "label": np.zeros((2,), np.int32)}
    loss, _ = jtask.loss_fn(params, {}, batch, None, False)
    ttask.model.load_state_dict(convert.params_from_flax(_flat(params),
                                                         TINY_T),
                                assign=True)
    ttask.model.eval()
    tloss, _ = ttask.loss_fn(to_device(batch, "cpu"))
    assert np.isfinite(tloss.item())
    _close(tloss.item(), float(loss))


def test_registry_entries_match_jax():
    for name in ("vit_b16_imagenet", "vit_tiny"):
        j, t = jreg.get_entry(name), treg.get_entry(name)
        for key in ("dataset", "dataset_kwargs", "global_batch_size",
                    "learning_rate", "lr_schedule", "warmup_ratio",
                    "grad_clip_norm"):
            assert t[key] == j[key], (name, key)
        jtask, ttask = j["task_factory"](), treg.make_task(t, device="meta")
        assert ttask.label_smoothing == jtask.label_smoothing
        assert ttask.weight_decay == jtask.weight_decay
        assert isinstance(ttask.model, TV.VisionTransformer)


# -- the trainer against the JAX Trainer --------------------------------------


@pytest.fixture(scope="module")
def trained():
    """vit_tiny: both trainers from the JAX init, adamw, the same batches,
    10 steps (module-scoped: one JAX compile)."""
    jentry, tentry = jreg.get_entry("vit_tiny"), treg.get_entry("vit_tiny")
    kw = dict(tentry["dataset_kwargs"], num_examples=64)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    hist = History()
    jtr = JaxTrainer(jentry["task_factory"](), optax.adamw(1e-3), mesh,
                     policy=jmp.Policy.from_name("float32"),
                     config=JaxTrainerConfig(log_every=5,
                                             log_grad_norm=True),
                     callbacks=[hist])
    loader = HostDataLoader(jds.get_dataset(jentry["dataset"], **kw),
                            DataConfig(global_batch_size=BATCH, seed=0))
    jstate = jtr.create_state(next(iter(loader)))
    # A random head, so that the first steps move every layer.
    params = fnn.unbox(jstate.params)
    params["head"]["kernel"] = jax.random.normal(
        jax.random.key(9), params["head"]["kernel"].shape) * 0.1
    jstate = jtr.create_state(next(iter(loader)), params=params)
    ttr = Trainer(treg.make_task(tentry, device="meta"),
                  topt.make_optimizer("adamw", 1e-3),
                  policy=Policy.from_name("float32"),
                  config=TrainerConfig(log_every=5, log_grad_norm=True),
                  device="cpu")
    tstate = ttr.create_state(convert.params_from_flax(
        _flat(jstate.params), tentry["config"]))
    batches = HostBatches(tds.get_dataset(tentry["dataset"], **kw), BATCH,
                          seed=0)
    jstate = jtr.fit(loader, steps=STEPS, state=jstate)
    tstate, history = ttr.fit(batches, steps=STEPS, state=tstate)
    return hist, history


def test_ten_step_curve_matches_jax_trainer(trained):
    hist, history = trained
    assert [s for s, _ in history] == list(range(1, STEPS + 1))
    for key in ("loss", "accuracy", "grad_norm"):
        got = np.array([m[key] for _, m in history])
        want = np.array(hist.history[key])
        assert np.max(np.abs(got - want)) <= 1e-4, (key, got - want)
    assert history[-1][1]["loss"] < history[0][1]["loss"]


@pytest.mark.parametrize("config,flags", [
    ("vit_tiny", ["--steps", "3", "--global-batch-size", "8"]),
    # ViT-B/16 at full width and depth: two 224-px images, one step.
    ("vit_b16_imagenet", ["--steps", "1", "--global-batch-size", "2",
                          "--dataset-kwarg", "num_examples=4"]),
])
def test_launcher_trains_vit(config, flags, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch",
         "--config", config, "--device", "cpu", "--precision", "float32",
         "--log-every", "1", *flags], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    losses = [json.loads(x)["loss"] for x in proc.stdout.splitlines()
              if x.startswith("{") and "loss" in x]
    assert losses and np.isfinite(losses).all()
