"""The port's BERT masked-LM against the JAX package's, on the CPU.

Weights come from the JAX model's own init (``convert.params_from_flax``),
batches from the same ``SyntheticMLM`` records in the same loader order.
Tolerances, each at f32:

- logits and loss: 1e-5 relative (1e-5 absolute on logits of std ~6:
  the same math in other summation orders through two layers);
- one step's gradients: rtol 1e-4, atol 1e-6 per leaf;
- 10 ``Trainer`` steps against the JAX ``Trainer``: the loss curve max
  |delta| <= 1e-4 (the decoders' curve tolerance).

Dropout draws other masks than JAX's, so the parity cases run with the
tiny preset's rate 0; dropout is held on its own: its rate, its scaling,
the same mask from the same (seed, step), none in eval mode, and the
same masks again in a rematerialised backward.
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
from tensorflow_train_distributed_tpu.models import bert as JB
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
from tensorflow_train_distributed_torch.data import datasets as tds
from tensorflow_train_distributed_torch.data.pipeline import (
    HostBatches,
    to_device,
)
from tensorflow_train_distributed_torch.models import bert as TB
from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.training import optimizers as topt
from tensorflow_train_distributed_torch.training.mixed_precision import (
    Policy,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

BATCH, STEPS = 8, 10
# The HF-compatibility knobs, on together.
_HF = dict(attention_bias=True, type_vocab_size=2, embed_layer_norm=True,
           layer_norm_eps=1e-12, exact_gelu=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(tree), sep="/").items()}


def _cfgs(**knobs):
    return (dataclasses.replace(JB.BERT_PRESETS["bert_tiny"], **knobs),
            dataclasses.replace(TB.BERT_PRESETS["bert_tiny"], **knobs))


def _batch(seed=0, b=4, s=16, vocab=256, types=False):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "mask_weights": (rng.random((b, s)) < 0.3).astype(np.float32),
             "sample_weight": np.array([1.0] * (b - 1) + [0.0], np.float32)}
    if types:
        batch["token_type_ids"] = rng.integers(0, 2, (b, s)).astype(
            np.int32)
    return batch


@pytest.fixture(scope="module", params=["bert_tiny", "hf_knobs"])
def pair(request):
    """The JAX task with its init and the port's task on those weights."""
    jcfg, tcfg = _cfgs(**(_HF if request.param == "hf_knobs" else {}))
    jtask = JB.BertMlmTask(jcfg)
    batch = _batch(types=request.param == "hf_knobs")
    params = fnn.unbox(jtask.init_variables(jax.random.key(0),
                                            batch)["params"])
    ttask = TB.BertMlmTask(tcfg, device="meta")
    ttask.model.load_state_dict(convert.params_from_flax(_flat(params),
                                                         tcfg),
                                strict=True, assign=True)
    ttask.model.eval()
    return jtask, params, ttask, batch, tcfg


def test_logits_match_jax(pair):
    jtask, params, ttask, batch, _ = pair
    want = jtask.model.apply({"params": params}, batch["input_ids"],
                             token_type_ids=batch.get("token_type_ids"))
    got = ttask.predict_fn(to_device(batch, "cpu"))
    assert got.shape == (4, 16, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_loss_and_grads_match_jax(pair):
    """The masked, sample-weighted loss, mlm_accuracy, loss_weight and
    one backward."""
    jtask, params, ttask, batch, tcfg = pair

    def jloss(p):
        loss, (metrics, _) = jtask.loss_fn(p, {}, batch, None, False)
        return loss, metrics

    (loss, metrics), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    tloss, tmetrics = ttask.loss_fn(to_device(batch, "cpu"))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    for k in ("mlm_accuracy", "loss_weight"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-6, err_msg=k)
    named = dict(ttask.model.named_parameters())
    tgrads = torch.autograd.grad(tloss, list(named.values()))
    want = convert.params_from_flax(_flat(grads), tcfg)
    for name, g in zip(named, tgrads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_registry_tiny_trains_like_the_jax_trainer():
    """bert_tiny_mlm: step-1 gradients and a 10-step adamw curve against
    the JAX ``Trainer`` from the same init and batches."""
    jentry, tentry = jreg.get_entry("bert_tiny_mlm"), \
        treg.get_entry("bert_tiny_mlm")
    kw = dict(tentry["dataset_kwargs"], num_examples=64)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    hist = History()
    jtr = JaxTrainer(jentry["task_factory"](), optax.adamw(1e-3), mesh,
                     policy=jmp.Policy.from_name("float32"),
                     config=JaxTrainerConfig(log_every=5,
                                             log_grad_norm=True),
                     callbacks=[hist])
    loader = HostDataLoader(jds.get_dataset("mlm", **kw),
                            DataConfig(global_batch_size=BATCH, seed=0))
    jstate = jtr.create_state(next(iter(loader)))
    ttr = Trainer(treg.make_task(tentry, device="meta"),
                  topt.make_optimizer("adamw", 1e-3),
                  policy=Policy.from_name("float32"),
                  config=TrainerConfig(log_every=5, log_grad_norm=True),
                  device="cpu")
    init = convert.params_from_flax(_flat(jstate.params), tentry["config"])
    tstate = ttr.create_state(init)
    batches = HostBatches(tds.get_dataset("mlm", **kw), BATCH, seed=0)
    grads, loss, _, _ = jtr._microbatch_grads(
        jstate.params, jstate.model_state, next(iter(loader)),
        jax.random.key(0), jstate.loss_scale)
    tgrads, tloss, _ = ttr._microbatch_grads(
        list(tstate.params.values()), to_device(next(iter(batches)), "cpu"),
        None)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    want = convert.params_from_flax(_flat(grads), tentry["config"])
    for name, g in zip(tstate.params, tgrads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    jstate = jtr.fit(loader, steps=STEPS, state=jstate)
    tstate, history = ttr.fit(batches, steps=STEPS, state=tstate)
    for key in ("loss", "mlm_accuracy", "grad_norm"):
        got = np.array([m[key] for _, m in history])
        want = np.array(hist.history[key])
        assert got.shape == (STEPS,)
        assert np.max(np.abs(got - want)) <= 1e-4, (key, got - want)


# -- dropout ------------------------------------------------------------------


def test_dropout_rate_scaling_and_generator():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(3)
    with L.dropout_generator(gen):
        y = L.dropout(x, 0.1, True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    assert torch.all(y[kept] == torch.tensor(1 / 0.9))
    with L.dropout_generator(torch.Generator().manual_seed(3)):
        assert torch.equal(L.dropout(x, 0.1, True), y)
    with L.dropout_generator(torch.Generator().manual_seed(4)):
        assert not torch.equal(L.dropout(x, 0.1, True), y)
    assert L.dropout(x, 0.1, False) is x            # eval mode
    with pytest.raises(RuntimeError, match="generator"):
        L.dropout(x, 0.1, True)


def test_dropout_generator_is_built_at_the_first_draw():
    """A callable installed by ``dropout_generator`` runs once, at the
    first draw, and not at all where nothing drops."""
    made = []

    def make():
        made.append(1)
        return torch.Generator().manual_seed(3)

    x = torch.ones(20, 30)
    with L.dropout_generator(make):
        L.dropout(x, 0.1, False)
        L.dropout(x, 0.0, True)
        assert made == []
        a = L.dropout(x, 0.1, True)
        b = L.dropout(x, 0.1, True)
    assert made == [1]
    with L.dropout_generator(torch.Generator().manual_seed(3)):
        assert torch.equal(L.dropout(x, 0.1, True), a)
        assert torch.equal(L.dropout(x, 0.1, True), b)


def _dropout_task(remat=False):
    _, tcfg = _cfgs(dropout_rate=0.1, remat=remat)
    task = TB.BertMlmTask(tcfg, device="meta")
    task.model.load_state_dict(convert.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"), assign=True)
    return task


def test_trainer_dropout_follows_seed_and_step():
    """The trainer's generator depends on (seed, step) alone: the same
    step's loss repeats, another step's differs, and eval mode drops
    nothing."""
    task = _dropout_task()
    tr = Trainer(task, topt.make_optimizer("sgd", 0.0), device="cpu",
                 policy=Policy.from_name("float32"))
    state = tr.create_state(convert.init_params(
        task.config, torch.Generator().manual_seed(0), device="cpu"))
    batch = to_device(_batch(s=16), "cpu")

    def loss_at(step):
        with L.dropout_generator(tr._generator(step)):
            return task.loss_fn(batch)[0].item()

    assert loss_at(5) == loss_at(5) != loss_at(6)
    with tr.inference(state):
        a = task.loss_fn(batch)[0].item()
        b = task.loss_fn(batch)[0].item()
    assert a == b != loss_at(5)
    assert task.model.training


def test_remat_backward_redraws_the_forward_masks():
    """``remat`` recomputes each layer in the backward; the recompute
    draws the forward's masks again, so the gradients equal the
    un-rematerialised ones."""
    batch = to_device(_batch(s=16), "cpu")
    grads = []
    for remat in (False, True):
        task = _dropout_task(remat)
        task.model.train()
        with L.dropout_generator(torch.Generator().manual_seed(9)):
            loss, _ = task.loss_fn(batch)
        grads.append(torch.autograd.grad(
            loss, list(task.model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
