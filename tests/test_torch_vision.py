"""The port's vision family (LeNet, ResNet with ``VisionTask``) against
the JAX package's, on the CPU.

Weights and BatchNorm statistics come from the JAX model's own init,
carried over by ``convert.params_from_flax`` (conv kernels HWIO → OIHW,
``batch_stats`` → buffers); batches from the same synthetic records in
the same loader order.  Tolerances, each at f32:

- logits and loss: 1e-5 relative (+ 1e-6 absolute on logits, whose
  zero-initialised ResNet head starts them near 0): the same math in
  other convolution and reduction orders through a few layers;
- one step's gradients: rtol 1e-4, atol 1e-6 per leaf (a backward
  through BatchNorm's batch statistics);
- 10 ``Trainer`` steps against the JAX ``Trainer``: the loss curve max
  |delta| <= 1e-4 (the decoders' curve tolerance), BatchNorm's running
  statistics after them within 1e-5 (relative, 1e-6 absolute);
- the padding pins (a stride-2 conv and the max pool on even inputs, the
  s2d stem, the subsampled-statistics BatchNorm): 1e-5.
"""

import dataclasses

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
from tensorflow_train_distributed_tpu.models import lenet as JLN
from tensorflow_train_distributed_tpu.models import registry as jreg
from tensorflow_train_distributed_tpu.models import resnet as JRN
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
from tensorflow_train_distributed_torch.models import lenet as TLN
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.models import resnet as TRN
from tensorflow_train_distributed_torch.training import optimizers as topt
from tensorflow_train_distributed_torch.training.mixed_precision import (
    Policy,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

BATCH, STEPS = 16, 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(tree), sep="/").items()}


def _flat_vars(params, model_state) -> dict:
    """Flat params plus ``batch_stats/…`` keys, as ``convert`` takes
    them."""
    flat = _flat(params)
    for k, v in _flat(model_state.get("batch_stats", {})).items():
        flat[f"batch_stats/{k}"] = v
    return flat


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port(model_cls, cfg, variables):
    """The port's model with the JAX variables loaded."""
    model = model_cls(cfg, device="meta")
    flat = _flat_vars(variables["params"],
                      {k: v for k, v in variables.items() if k != "params"})
    model.load_state_dict(convert.params_from_flax(flat, cfg), strict=True,
                          assign=True)
    return model


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# -- building blocks ----------------------------------------------------------


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (7, 2), (3, 1), (1, 2)])
def test_same_padded_conv_matches_flax(size, kernel, stride):
    """XLA's SAME splits the padding (lo, hi) with the extra row at the
    end: a stride-2 conv on an even input pads (0, 1) (3x3) or (2, 3)
    (7x7), which torch's symmetric padding would shift."""
    x = _images((2, size, size, 3))
    conv = fnn.Conv(4, (kernel, kernel), strides=(stride, stride),
                    padding="SAME")
    params = conv.init(jax.random.key(0), x)["params"]
    want = conv.apply({"params": params}, x)
    port = L.Conv(3, 4, kernel, stride=stride, padding="SAME")
    port.load_state_dict({
        "kernel": _t(np.asarray(params["kernel"]).transpose(3, 2, 0, 1)),
        "bias": _t(params["bias"])})
    got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.detach(), want)


def test_same_padding_split():
    assert L.same_padding(224, 7, 2) == (2, 3)
    assert L.same_padding(56, 3, 2) == (0, 1)
    assert L.same_padding(112, 3, 2) == (0, 1)
    assert L.same_padding(57, 3, 2) == (1, 1)
    assert L.same_padding(28, 5, 1) == (2, 2)


@pytest.mark.parametrize("size", [8, 9])
def test_max_pool_same_matches_flax(size):
    x = _images((2, size, size, 3))
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    got = TRN._max_pool_same(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want, rtol=0, atol=0)


def test_space_to_depth_and_stem_kernel_match_jax():
    x = _images((2, 8, 8, 3))
    np.testing.assert_array_equal(TRN.space_to_depth(_t(x)).numpy(),
                                  np.asarray(JRN.space_to_depth(x)))
    w = _images((7, 7, 3, 5), seed=1)                         # HWIO
    want = np.asarray(JRN.stem_kernel_to_s2d(jnp.asarray(w)))  # [4,4,12,5]
    got = TRN.stem_kernel_to_s2d(_t(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy(),
                                  want.transpose(3, 2, 0, 1))


def test_s2d_stem_equals_plain_stem():
    """The 4x4 stride-1 stem on space-to-depth input with
    ``stem_kernel_to_s2d``'s kernel and the (2, 1) padding equals the 7x7
    stride-2 stem padded 3 on each side, in both packages.  (XLA's SAME
    pads an even input (2, 3), so the s2d variant is the plain stem
    shifted by one input pixel; the JAX derivation assumes pad 3.)"""
    x = _images((2, 16, 16, 3))
    w = _images((5, 3, 7, 7), seed=2)
    plain = L.Conv(3, 5, 7, stride=2, padding=((3, 3), (3, 3)),
                   use_bias=False)
    s2d = L.Conv(12, 5, 4, stride=1, padding=((2, 1), (2, 1)),
                 use_bias=False)
    plain.load_state_dict({"kernel": _t(w)})
    s2d.load_state_dict({"kernel": TRN.stem_kernel_to_s2d(_t(w))})
    want = plain(_t(x).permute(0, 3, 1, 2))
    got = s2d(TRN.space_to_depth(_t(x)).permute(0, 3, 1, 2))
    _close(got.detach(), want.detach())
    jconv = fnn.Conv(5, (4, 4), padding=((2, 1), (2, 1)), use_bias=False)
    jwant = jconv.apply(
        {"params": {"kernel": JRN.stem_kernel_to_s2d(
            jnp.asarray(w.transpose(2, 3, 1, 0)))}},
        JRN.space_to_depth(jnp.asarray(x)))
    _close(got.detach().permute(0, 2, 3, 1), jwant)


@pytest.mark.parametrize("train", [True, False])
def test_subsampled_stats_bn_matches_jax(train):
    """Stride-2 statistics over ``x[:, ::2, ::2]``, the whole tensor
    normalised; running statistics updated in training mode."""
    x = _images((4, 6, 6, 8), seed=3) * 2.0 + 0.5
    bn = JRN.SubsampledStatsBN(use_running_average=not train, momentum=0.9,
                               epsilon=1e-5, dtype=jnp.float32,
                               stats_stride=2)
    variables = bn.init(jax.random.key(0), x)
    scale = np.linspace(0.5, 1.5, 8).astype(np.float32)
    bias = np.linspace(-0.2, 0.3, 8).astype(np.float32)
    mean = np.linspace(0.0, 0.4, 8).astype(np.float32)
    var = np.linspace(0.8, 1.6, 8).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, upd = bn.apply(variables, x, mutable=["batch_stats"])
    port = TRN.BatchNorm(8, stats_stride=2)
    port.load_state_dict({"scale": _t(scale), "bias": _t(bias),
                          "mean": _t(mean), "var": _t(var)})
    port.train(train)
    got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.detach(), want)
    _close(port.mean, upd["batch_stats"]["mean"])
    _close(port.var, upd["batch_stats"]["var"])


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax(train):
    """flax's conventions: the biased batch variance, and the update
    ``0.9 old + 0.1 new`` (torch would keep the unbiased variance)."""
    x = _images((4, 5, 5, 6), seed=4) * 3.0 - 1.0
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.key(0), x)
    want, upd = bn.apply(variables, x, mutable=["batch_stats"])
    port = TRN.BatchNorm(6)
    port.load_state_dict({"scale": torch.ones(6), "bias": torch.zeros(6),
                          "mean": torch.zeros(6), "var": torch.ones(6)})
    port.train(train)
    got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.detach(), want)
    _close(port.mean, upd["batch_stats"]["mean"])
    _close(port.var, upd["batch_stats"]["var"])


# -- the models ---------------------------------------------------------------


def _resnet_cfgs(**knobs):
    return (dataclasses.replace(JRN.RESNET_PRESETS["resnet_tiny"], **knobs),
            dataclasses.replace(TRN.RESNET_PRESETS["resnet_tiny"], **knobs))


VARIANTS = {"resnet_tiny": {}, "s2d": dict(space_to_depth=True),
            "s2d_bnsub": dict(space_to_depth=True, bn_stats_stride=2)}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("train", [True, False])
def test_resnet_logits_match_jax(variant, train):
    jcfg, tcfg = _resnet_cfgs(**VARIANTS[variant])
    x = _images((4, 32, 32, 3), seed=5)
    jmodel = JRN.ResNet(jcfg)
    variables = jmodel.init(jax.random.key(1), x, train=False)
    # Move the zero-initialised head and scales so the logits carry
    # every layer's contribution.
    variables = jax.tree_util.tree_map(
        lambda v: v + 0.05 if v.ndim == 1 else v, dict(variables))
    variables["params"]["Dense_0"]["kernel"] = jnp.asarray(
        _images((64, 10), seed=6) * 0.1)
    if train:
        want, upd = jmodel.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
    else:
        want = jmodel.apply(variables, x, train=False)
    model = _port(TRN.ResNet, tcfg, variables)
    model.train(train)
    got = model(_t(x))
    _close(got.detach(), want)
    if train:
        flat = _flat(upd["batch_stats"])
        for name, buf in model.named_buffers():
            _close(buf, flat[name.replace(".", "/")], msg=name)


def test_lenet_logits_match_jax():
    x = _images((4, 28, 28, 1), seed=7)
    jmodel = JLN.LeNet()
    variables = jmodel.init(jax.random.key(2), x)
    want = jmodel.apply(variables, x)
    model = _port(TLN.LeNet, TLN.LeNetConfig(), variables)
    _close(model(_t(x)).detach(), want)


def test_vision_task_loss_matches_jax_with_smoothing_and_decay():
    """``make_task``'s defaults: label smoothing 0.1, weight decay 1e-4
    on every kernel, top-5 accuracy, a padded row (sample_weight 0)."""
    jcfg, tcfg = _resnet_cfgs()
    jtask = JRN.make_task(jcfg)
    ttask = TRN.make_task(tcfg, device="meta")
    x = _images((4, 32, 32, 3), seed=8)
    batch = {"image": x, "label": np.array([1, 2, 3, 4], np.int32),
             "sample_weight": np.array([1, 1, 1, 0], np.float32)}
    variables = jtask.init_variables(jax.random.key(3), batch)
    params = jax.tree_util.tree_map(lambda v: v + 0.05 if v.ndim == 1
                                    else v, fnn.unbox(variables["params"]))
    ms = {"batch_stats": variables["batch_stats"]}
    loss, (metrics, _) = jtask.loss_fn(params, ms, batch, None, True)
    ttask.model.load_state_dict(convert.params_from_flax(
        _flat_vars(params, ms), tcfg), strict=True, assign=True)
    tloss, tmetrics = ttask.loss_fn(to_device(batch, "cpu"))
    _close(tloss.item(), float(loss))
    for k in ("accuracy", "top5_accuracy", "loss_weight"):
        _close(tmetrics[k].item(), float(metrics[k]), msg=k)


def test_uint8_images_normalise_on_the_device():
    _, tcfg = _resnet_cfgs()
    task = TRN.make_task(tcfg)
    u8 = np.random.default_rng(0).integers(0, 256, (2, 4, 4, 3)).astype(
        np.uint8)
    want = ((u8.astype(np.float32) - np.array(TRN.MEAN_RGB) * 255.0)
            / (np.array(TRN.STDDEV_RGB) * 255.0)).astype(np.float32)
    _close(task._prep_image(_t(u8)), want)
    with pytest.raises(ValueError, match="uint8"):
        TLN.make_task()._prep_image(_t(u8))


# -- the trainer against the JAX Trainer ---------------------------------------


def _pair(name, *, grad_accum=1):
    """The JAX Trainer (one-device CPU mesh) and the port's on a registry
    entry, with the same init, adamw and batches."""
    jentry, tentry = jreg.get_entry(name), treg.get_entry(name)
    kw = dict(tentry["dataset_kwargs"], num_examples=64)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    hist = History()
    jtr = JaxTrainer(jentry["task_factory"](), optax.adamw(1e-3), mesh,
                     policy=jmp.Policy.from_name("float32"),
                     config=JaxTrainerConfig(log_every=5,
                                             log_grad_norm=True,
                                             grad_accum=grad_accum),
                     callbacks=[hist])
    loader = HostDataLoader(jds.get_dataset(jentry["dataset"], **kw),
                            DataConfig(global_batch_size=BATCH, seed=0))
    jstate = jtr.create_state(next(iter(loader)))
    ttr = Trainer(treg.make_task(tentry, device="meta"),
                  topt.make_optimizer("adamw", 1e-3),
                  policy=Policy.from_name("float32"),
                  config=TrainerConfig(log_every=5, log_grad_norm=True,
                                       grad_accum=grad_accum),
                  device="cpu")
    tstate = ttr.create_state(convert.params_from_flax(
        _flat_vars(jstate.params, jstate.model_state), tentry["config"]))
    batches = HostBatches(tds.get_dataset(tentry["dataset"], **kw), BATCH,
                          seed=0)
    return (jtr, jstate, loader, hist), (ttr, tstate, batches), tentry


@pytest.fixture(scope="module", params=["resnet_tiny", "mnist"])
def trained(request):
    """Both trainers after STEPS steps (module-scoped: one JAX compile)."""
    (jtr, jstate, loader, hist), (ttr, tstate, batches), entry = _pair(
        request.param)
    jbatch = next(iter(loader))
    grads, loss, _, _ = jtr._microbatch_grads(
        jstate.params, jstate.model_state, jbatch, jax.random.key(0),
        jstate.loss_scale)
    tgrads, tloss, _ = ttr._microbatch_grads(
        list(tstate.params.values()), to_device(next(iter(batches)), "cpu"),
        None)
    step1 = (grads, loss, tgrads, tloss)
    # The gradient probe ran a training-mode forward: reload the BN
    # statistics it moved.
    tstate = ttr.create_state(convert.params_from_flax(
        _flat_vars(jstate.params, jstate.model_state), entry["config"]))
    jstate = jtr.fit(loader, steps=STEPS, state=jstate)
    tstate, history = ttr.fit(batches, steps=STEPS, state=tstate)
    return dict(name=request.param, entry=entry, step1=step1, hist=hist,
                history=history, jstate=jstate, tstate=tstate, ttr=ttr,
                jtr=jtr)


def test_step1_loss_and_grads_match_jax_trainer(trained):
    grads, loss, tgrads, tloss = trained["step1"]
    _close(tloss.item(), float(loss))
    # The buffers' entries only fill the names params_from_flax checks.
    want = convert.params_from_flax(
        _flat_vars(grads, trained["jstate"].model_state),
        trained["entry"]["config"])
    names = list(trained["tstate"].params)
    assert len(tgrads) == len(names)
    for name, g in zip(names, tgrads):
        _close(g, want[name], rtol=1e-4, atol=1e-6, msg=name)


def test_loss_curve_and_bn_stats_match_jax_trainer(trained):
    history, hist = trained["history"], trained["hist"]
    assert [s for s, _ in history] == list(range(1, STEPS + 1))
    for key in ("loss", "accuracy", "grad_norm"):
        got = np.array([m[key] for _, m in history])
        want = np.array(hist.history[key])
        assert np.max(np.abs(got - want)) <= 1e-4, (key, got - want)
    ms = trained["jstate"].model_state
    flat = _flat(ms.get("batch_stats", {}))
    got = trained["tstate"].model_state
    assert sorted(got) == sorted(f"batch_stats/{k}" for k in flat)
    for name, buf in got.items():
        _close(buf, flat[name[len("batch_stats/"):]], msg=name)


def test_evaluate_runs_eval_mode_like_jax(trained):
    """``evaluate`` reads the running statistics (eval mode) and leaves
    them, and the model's training mode, as they were."""
    ttr, tstate, jtr = trained["ttr"], trained["tstate"], trained["jtr"]
    entry = trained["entry"]
    kw = dict(entry["dataset_kwargs"], num_examples=48)
    jsrc = jds.get_dataset(entry["dataset"], **kw)
    tsrc = tds.get_dataset(entry["dataset"], **kw)
    before = {k: v.clone() for k, v in tstate.model_state.items()}
    want = jtr.evaluate(HostDataLoader(jsrc, DataConfig(
        global_batch_size=BATCH, seed=1, num_epochs=1)), trained["jstate"],
        steps=2)
    got = ttr.evaluate(HostBatches(tsrc, BATCH, seed=1), tstate, steps=2)
    for k in ("loss", "accuracy"):
        _close(got[k], want[k], msg=k)
    for k, v in tstate.model_state.items():
        assert torch.equal(v, before[k]), k
    assert ttr.task.model.training


def test_grad_accum_threads_bn_stats_like_jax():
    """Under ``grad_accum`` 2 BatchNorm updates once per microbatch, in
    order, as the JAX scan threads ``model_state``: 3 steps of
    resnet_tiny, the loss curve (1e-4) and the running statistics (1e-5)
    against the JAX ``Trainer``."""
    (jtr, jstate, loader, hist), (ttr, tstate, batches), _ = _pair(
        "resnet_tiny", grad_accum=2)
    jstate = jtr.fit(loader, steps=3, state=jstate)
    tstate, history = ttr.fit(batches, steps=3, state=tstate)
    got = np.array([m["loss"] for _, m in history])
    assert np.max(np.abs(got - np.array(hist.history["loss"]))) <= 1e-4
    flat = _flat(jstate.model_state["batch_stats"])
    for name, buf in tstate.model_state.items():
        _close(buf, flat[name[len("batch_stats/"):]], msg=name)
