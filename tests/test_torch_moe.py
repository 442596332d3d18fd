"""The port's MoE training path against the JAX package's, on the CPU.

Weights come from the JAX modules' own init (carried over by
``convert.params_from_flax``), inputs from numpy seeds, so both sides see
identical data; the port's kernels take their plain versions here (CPU
tensors).  Oracles:

- the dense (GShard) dispatch of both sides, capacity binding or not;
- the port's dropless ``dispatch="gmm"`` against JAX's gmm (megablox in
  interpret mode, slow: one config) and, for the other configs and the
  trainer, against JAX's dense dispatch with ample capacity, which
  ``tests/test_moe_gmm.py`` holds equal to JAX's gmm.

Tolerances, each at f32 (``tests/test_moe_gmm.py``'s): outputs within
1e-5; gradients within 1e-4 abs / 1e-3 rel; losses and metrics of one
batch 1e-6 relative (1e-5 for the aux terms, sums of a few small
products in other orders); the 10-step trainer curves within 1e-4 (f32
rounding carried through adamw).
"""

import dataclasses
import json
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.data import DataConfig, HostDataLoader
from tensorflow_train_distributed_tpu.data.datasets import (
    SyntheticLM as JaxSyntheticLM,
)
from tensorflow_train_distributed_tpu.models import moe as JM
from tensorflow_train_distributed_tpu.runtime.mesh import (
    MeshConfig,
    build_mesh,
)
from tensorflow_train_distributed_tpu.training import (
    mixed_precision as jmp,
)
from tensorflow_train_distributed_tpu.training.callbacks import History
from tensorflow_train_distributed_tpu.training.trainer import (
    Trainer as JaxTrainer,
    TrainerConfig as JaxTrainerConfig,
)
from tensorflow_train_distributed_torch import convert, train as tcli
from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
from tensorflow_train_distributed_torch.data.pipeline import HostBatches
from tensorflow_train_distributed_torch.models import moe as TM
from tensorflow_train_distributed_torch.training import (
    mixed_precision as tmp,
    optimizers as topt,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

BLOCK_CONFIGS = ("moe_tiny", "moe_tiny_shared", "qwen_moe_tiny")
AMPLE = 100.0      # a capacity factor under which the dense path drops nothing


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


def _to_flax(named: dict) -> dict:
    """The port's ``{name: tensor}`` as a nested flax param dict (the
    inverse of ``convert.params_from_flax`` for the unrolled layout)."""
    flat = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer_{parts[1]}"] + parts[2:]
        flat[tuple(parts)] = jnp.asarray(t.detach().numpy())
    return traverse_util.unflatten_dict(flat)


def _configs(name, **knobs):
    return (dataclasses.replace(JM.MOE_PRESETS[name], **knobs),
            dataclasses.replace(TM.MOE_PRESETS[name], **knobs))


@pytest.fixture(scope="module")
def blocks():
    """{config: (JAX params of a MoEMlpBlock, x [2, 16, d])}."""
    out = {}
    for i, name in enumerate(BLOCK_CONFIGS):
        cfg = TM.MOE_PRESETS[name]
        rng = np.random.default_rng(i)
        x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
        block = TM.MoEMlpBlock(cfg, device="meta")
        params = {k: torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32) / math.sqrt(p.shape[-2]))
            for k, p in block.named_parameters()}
        out[name] = (_to_flax(params), x)
    return out


def _jax_block(cfg, params, x):
    """(y, aux {name: value}, dropped_frac, expert_load, grads) of the
    JAX block; grads of sum(y²) + aux over (params, x)."""
    def run(p, xx):
        y, col = JM.MoEMlpBlock(cfg).apply(
            {"params": p}, xx, mutable=["aux_loss", "router_stats"])
        aux = sum(v[0] for v in col["aux_loss"].values())
        return jnp.sum(y ** 2) + aux, (y, col)

    (_, (y, col)), grads = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True))(params, x)
    aux = {k: float(v[0]) for k, v in col["aux_loss"].items()}
    stats = col["router_stats"]
    return (np.asarray(y), aux, float(stats["dropped_frac"][0]),
            np.asarray(stats["expert_load"][0]),
            (_flat(grads[0]), np.asarray(grads[1])))


def _port_block(cfg, params, x):
    block = TM.MoEMlpBlock(cfg, device="meta")
    block.load_state_dict({k.replace("/", "."): _t(v) for k, v in
                           _flat(params).items()}, strict=True, assign=True)
    tx = _t(x).requires_grad_(True)
    y, (lb, z), (dropped, load) = block(tx)
    (torch.sum(y ** 2) + lb + z).backward()
    grads = {k.replace(".", "/"): p.grad.numpy()
             for k, p in block.named_parameters()}
    return (y.detach().numpy(), {"load_balance": lb.item(),
                                 "router_z": z.item()},
            dropped.item(), load.detach().numpy(), (grads, tx.grad.numpy()))


def _assert_blocks_match(got, want):
    y, aux, dropped, load, (gp, gx) = got
    wy, waux, wdropped, wload, (wgp, wgx) = want
    np.testing.assert_allclose(y, wy, rtol=1e-5, atol=1e-5)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(aux[k], waux[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(dropped, wdropped, atol=1e-7)
    np.testing.assert_allclose(load, wload, rtol=1e-6, atol=1e-7)
    assert gp.keys() == wgp.keys()
    for k in wgp:
        np.testing.assert_allclose(gp[k], wgp[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(gx, wgx, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("capacity", ["preset", "ample"])
@pytest.mark.parametrize("name", BLOCK_CONFIGS)
def test_dense_block_matches_jax(blocks, name, capacity):
    """GShard dispatch on both sides; at the preset capacity moe_tiny
    drops tokens, and the port drops the same ones."""
    knobs = {} if capacity == "preset" else dict(capacity_factor=AMPLE)
    jcfg, tcfg = _configs(name, **knobs)
    params, x = blocks[name]
    want = _jax_block(jcfg, params, x)
    got = _port_block(tcfg, params, x)
    _assert_blocks_match(got, want)
    if name == "moe_tiny" and capacity == "preset":
        assert got[2] > 0.01          # the capacity really binds


@pytest.mark.parametrize("name", BLOCK_CONFIGS)
def test_gmm_block_matches_jax_dense_with_ample_capacity(blocks, name):
    jcfg, _ = _configs(name, capacity_factor=AMPLE)
    _, tcfg = _configs(name, dispatch="gmm")
    params, x = blocks[name]
    got = _port_block(tcfg, params, x)
    _assert_blocks_match(got, _jax_block(jcfg, params, x))
    assert got[2] == 0.0


def test_gmm_block_matches_jax_gmm(blocks):
    """Both sides dropless: the JAX block runs megablox in interpret
    mode (the JAX package's own CPU path)."""
    jcfg, tcfg = _configs("moe_tiny", dispatch="gmm")
    params, x = blocks["moe_tiny"]
    _assert_blocks_match(_port_block(tcfg, params, x),
                         _jax_block(jcfg, params, x))


def test_port_gmm_equals_dense_with_ample_capacity(blocks):
    params, x = blocks["moe_tiny_shared"]
    _, dense = _configs("moe_tiny_shared", capacity_factor=AMPLE)
    _, gmm = _configs("moe_tiny_shared", dispatch="gmm")
    _assert_blocks_match(_port_block(gmm, params, x),
                         _port_block(dense, params, x))


def test_unknown_dispatch_is_refused():
    with pytest.raises(ValueError, match="dispatch"):
        TM.MoEMlpBlock(dataclasses.replace(TM.MOE_PRESETS["moe_tiny"],
                                           dispatch="scatter"))


# -- the model and the task ---------------------------------------------------


def _batch(packed=False):
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 256, (2, 16)).astype(np.int32),
             "targets": rng.integers(0, 256, (2, 16)).astype(np.int32),
             "loss_weights": (rng.random((2, 16)) > 0.2).astype(np.float32)}
    if packed:
        batch["segment_ids"] = np.array([[1] * 6 + [2] * 10, [1] * 16],
                                        np.int32)
    return batch


@pytest.fixture(scope="module")
def task_case():
    """moe_tiny at its preset (binding) capacity under remat, packed rows
    and loss weights: the JAX params and ``MoeLmTask.loss_fn``'s (loss,
    metrics) in training and in evaluation."""
    jcfg = dataclasses.replace(JM.MOE_PRESETS["moe_tiny"], remat=True)
    batch = _batch(packed=True)
    task = JM.MoeLmTask(jcfg)
    params = _to_flax(convert.init_params(
        TM.MOE_PRESETS["moe_tiny"], torch.Generator().manual_seed(0),
        device="cpu", dtype=torch.float32))
    loss_fn = jax.jit(lambda p, b, train: task.loss_fn(p, {}, b, None,
                                                       train)[:2],
                      static_argnums=2)
    out = {}
    for train in (True, False):
        loss, (metrics, _) = loss_fn(params, batch, train)
        out[train] = (float(loss), {k: float(v) for k, v in metrics.items()})
    return params, batch, out


@pytest.mark.parametrize("train", [True, False])
def test_task_loss_and_metrics_match_jax(task_case, train):
    params, batch, want = task_case
    loss, metrics = want[train]
    tcfg = dataclasses.replace(TM.MOE_PRESETS["moe_tiny"], remat=True)
    task = TM.MoeLmTask(tcfg, device="meta")
    task.model.load_state_dict(convert.params_from_flax(_flat(params), tcfg),
                               strict=True, assign=True)
    tloss, tmetrics = task.loss_fn({k: _t(v) for k, v in batch.items()},
                                   train=train)
    np.testing.assert_allclose(tloss.item(), loss, rtol=1e-6)
    assert tmetrics.keys() == metrics.keys()
    for k in metrics:
        tol = 1e-5 if k == "aux_loss" else 1e-6
        np.testing.assert_allclose(tmetrics[k].item(), metrics[k],
                                   rtol=tol, atol=1e-7, err_msg=k)
    assert metrics["dropped_frac"] > 0


def test_remat_records_each_aux_term_once():
    """Under remat each block runs its forward again in the backward;
    the aux terms come back as block outputs, so the loss and the
    gradients equal the unrematerialised model's."""
    base = dataclasses.replace(TM.MOE_PRESETS["moe_tiny_shared"],
                               dispatch="gmm")
    params = convert.init_params(base, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32)
    batch = {k: _t(v) for k, v in _batch().items()}
    results = []
    for remat in (True, False):
        task = TM.MoeLmTask(dataclasses.replace(base, remat=remat),
                            device="meta")
        task.model.load_state_dict({k: v.clone().requires_grad_(True)
                                    for k, v in params.items()},
                                   strict=True, assign=True)
        loss, metrics = task.loss_fn(batch)
        loss.backward()
        results.append((loss.item(), metrics["aux_loss"].item(),
                        [p.grad.clone() for p in task.model.parameters()]))
    (l1, a1, g1), (l2, a2, g2) = results
    assert l1 == pytest.approx(l2, rel=1e-7) and a1 == pytest.approx(a2)
    for x, y in zip(g1, g2):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)


# -- weights ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["moe_tiny", "qwen_moe_tiny"])
def test_flax_tree_maps_onto_the_port(name):
    jcfg, tcfg = _configs(name, moe_every=2)
    shapes = jax.eval_shape(lambda: JM.MoeLmModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    flat = {k: np.zeros(v.shape, v.dtype) for k, v in
            traverse_util.flatten_dict(fnn.unbox(shapes), sep="/").items()}
    got = convert.params_from_flax(flat, tcfg)
    assert "layers.0.moe.experts.wi_gate.kernel" in got
    assert "layers.1.mlp.wi_gate.kernel" in got          # moe_every = 2
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        convert.expected_shapes(tcfg)


def test_init_params_expert_kernels_take_their_own_fan_in():
    """A stacked [E, in, out] kernel has fan-in ``in`` (flax's
    ``lecun_normal(batch_axis=(0,))``): each expert's std is 1/sqrt(d),
    not 1/sqrt(E)."""
    cfg = dataclasses.replace(TM.MOE_PRESETS["moe_tiny"], d_model=256,
                              ffn_size=512, num_experts=4)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32)
    for name, fan_in in (("layers.0.moe.experts.wi_gate.kernel", 256),
                         ("layers.0.moe.experts.wo.kernel", 512),
                         ("layers.0.moe.router.kernel", 256)):
        w = params[name]
        stds = w.reshape(-1, *w.shape[-2:]).std(dim=(1, 2))
        want = 1 / math.sqrt(fan_in)
        # 65k-131k draws an expert: the std is within 1% of its value.
        assert torch.allclose(stds, torch.full_like(stds, want),
                              rtol=0.01), (name, stds, want)


# -- the trainer against the JAX Trainer --------------------------------------


def test_trainer_matches_jax_trainer_for_ten_steps():
    """moe_tiny_lm_gmm (dropless) through the port's trainer against the
    JAX ``Trainer`` on the same entry with dense dispatch at ample
    capacity (equal to JAX's gmm, ``tests/test_moe_gmm.py``): adamw at
    the entry's constant 1e-3, batch 16 x seq 32, 10 steps."""
    from tensorflow_train_distributed_torch.models import registry

    steps = 10
    entry = registry.get_entry("moe_tiny_lm_gmm")
    tcfg = entry["config"]
    jcfg = dataclasses.replace(JM.MOE_PRESETS["moe_tiny"],
                               capacity_factor=AMPLE)
    src = dict(num_examples=64, **entry["dataset_kwargs"])
    bsz = entry["global_batch_size"]
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    hist = History()
    jtr = JaxTrainer(JM.MoeLmTask(jcfg), optax.adamw(1e-3, weight_decay=0.01),
                     mesh, policy=jmp.Policy.from_name("float32"),
                     config=JaxTrainerConfig(log_every=5, log_grad_norm=True),
                     callbacks=[hist])
    loader = HostDataLoader(JaxSyntheticLM(**src),
                            DataConfig(global_batch_size=bsz, seed=0))
    jstate = jtr.create_state(next(iter(loader)))
    ttr = Trainer(TM.MoeLmTask(tcfg, device="meta"),
                  topt.adamw(1e-3, weight_decay=0.01),
                  policy=tmp.Policy.from_name("float32"),
                  config=TrainerConfig(log_every=5, log_grad_norm=True),
                  device="cpu")
    tstate = ttr.create_state(convert.params_from_flax(_flat(jstate.params),
                                                       tcfg))
    jtr.fit(loader, steps=steps, state=jstate)
    _, history = ttr.fit(HostBatches(SyntheticLM(**src), bsz, seed=0),
                         steps=steps, state=tstate)
    for key in ("loss", "ce_loss", "aux_loss", "grad_norm",
                "expert_load_max", "expert_load_min"):
        want = np.array(hist.history[key])
        got = np.array([m[key] for _, m in history])
        assert want.shape == (steps,), key
        assert np.max(np.abs(got - want)) <= 1e-4, (key, got - want)
    assert all(m["dropped_frac"] == 0.0 for _, m in history)


def test_train_cli_moe_tiny_lm_gmm_on_cpu(capsys):
    assert tcli.main(["--config", "moe_tiny_lm_gmm", "--steps", "3",
                      "--device", "cpu", "--log-every", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3]
    for x in lines:
        assert np.isfinite(x["loss"]) and x["dropped_frac"] == 0.0
        assert {"ce_loss", "aux_loss", "expert_load_max",
                "expert_load_min"} <= x.keys()


def test_serve_cli_refuses_moe_configs():
    """MoE configs serve (``tests/test_torch_moe_serving.py``); what the
    JAX CLI refuses them is refused here too, in its words: an int8 KV
    cache, and a prefix under the dense dispatch's exact-length
    prefill."""
    from tensorflow_train_distributed_torch import serve

    base = ["--config", "moe_tiny_lm", "--prompt", "1,2", "--device", "cpu"]
    with pytest.raises(SystemExit, match="MoeConfig has no kv_cache_int8"):
        serve.main(base + ["--kv-int8"])
    with pytest.raises(SystemExit, match="length-independent routing"):
        serve.main(base + ["--prefix", "1"])
