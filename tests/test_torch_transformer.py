"""The port's Transformer encoder-decoder, its decoders and BLEU against
the JAX package's, on the CPU.

Weights come from the JAX model's own init (``convert.params_from_flax``),
batches from the same ``SyntheticWMT`` records in the same loader order.
Tolerances, each at f32:

- logits and the label-smoothed loss: 1e-5 relative (1e-5 absolute on
  logits: the same math in other summation orders through 2 + 2
  layers);
- one step's gradients: rtol 1e-4, atol 1e-6 per leaf;
- 10 ``Trainer`` steps against the JAX ``Trainer``: the loss curve max
  |delta| <= 1e-4 (the decoders' curve tolerance);
- greedy and beam tokens: equal; ``corpus_bleu``: equal.
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
from tensorflow_train_distributed_tpu.models import layers as JL
from tensorflow_train_distributed_tpu.models import registry as jreg
from tensorflow_train_distributed_tpu.models import transformer as JT
from tensorflow_train_distributed_tpu.ops import metrics as JM
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
from tensorflow_train_distributed_torch.models import transformer as TT
from tensorflow_train_distributed_torch.ops import metrics as TM
from tensorflow_train_distributed_torch.training import optimizers as topt
from tensorflow_train_distributed_torch.training.mixed_precision import (
    Policy,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

BATCH, STEPS, SEQ = 8, 10, 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(tree), sep="/").items()}


def _batch(seed=0, b=4, s=SEQ, vocab=256):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(3, vocab, (b, s)).astype(np.int32),
            "targets_in": rng.integers(3, vocab, (b, s)).astype(np.int32),
            "targets_out": rng.integers(3, vocab, (b, s)).astype(np.int32),
            "sample_weight": np.array([1.0] * (b - 1) + [0.0], np.float32)}


@pytest.fixture(scope="module")
def pair():
    """JAX's transformer_tiny with its init, the port's on those weights
    (eval mode), and the JAX decoders' outputs (one compile each)."""
    jcfg = JT.TRANSFORMER_PRESETS["transformer_tiny"]
    tcfg = TT.TRANSFORMER_PRESETS["transformer_tiny"]
    jtask = JT.Seq2SeqTask(jcfg)
    batch = _batch()
    params = fnn.unbox(jtask.init_variables(jax.random.key(0),
                                            batch)["params"])
    ttask = TT.Seq2SeqTask(tcfg, device="meta")
    ttask.model.load_state_dict(convert.params_from_flax(_flat(params),
                                                         tcfg),
                                strict=True, assign=True)
    ttask.model.eval()
    return jtask, params, ttask, batch, tcfg


def test_sinusoidal_positions_match_jax():
    np.testing.assert_array_equal(L.sinusoidal_positions(50, 32),
                                  JL.sinusoidal_positions(50, 32))


def test_logits_match_jax(pair):
    jtask, params, ttask, batch, _ = pair
    want = jtask.model.apply({"params": params}, batch["inputs"],
                             batch["targets_in"])
    got = ttask.model(_t(batch["inputs"]), _t(batch["targets_in"]))
    assert got.shape == (4, SEQ, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_cross_attention_at_another_source_length(pair):
    """Sources longer than targets: cross-attention over S_kv != S_q."""
    jtask, params, ttask, _, _ = pair
    rng = np.random.default_rng(5)
    src = rng.integers(3, 256, (2, 20)).astype(np.int32)
    tgt = rng.integers(3, 256, (2, 7)).astype(np.int32)
    want = jtask.model.apply({"params": params}, src, tgt)
    got = ttask.model(_t(src), _t(tgt))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_smoothed_loss_and_grads_match_jax(pair):
    jtask, params, ttask, batch, tcfg = pair

    def jloss(p):
        loss, (metrics, _) = jtask.loss_fn(p, {}, batch, None, False)
        return loss, metrics

    (loss, metrics), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    tloss, tmetrics = ttask.loss_fn(to_device(batch, "cpu"))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    for k in ("accuracy", "loss_weight"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-6, err_msg=k)
    named = dict(ttask.model.named_parameters())
    tgrads = torch.autograd.grad(tloss, list(named.values()))
    want = convert.params_from_flax(_flat(grads), tcfg)
    for name, g in zip(named, tgrads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_greedy_tokens_match_jax(pair):
    jtask, params, ttask, batch, tcfg = pair
    kw = dict(max_len=10, bos_id=1, eos_id=2)
    want = JT.greedy_translate(jtask.config, params, batch["inputs"], **kw)
    got = TT.greedy_translate(ttask.model, _t(batch["inputs"]), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("beam", [1, 2, 3])
def test_beam_tokens_match_jax(pair, beam):
    jtask, params, ttask, batch, tcfg = pair
    kw = dict(max_len=10, bos_id=1, eos_id=2, beam_size=beam)
    want = JT.beam_translate(jtask.config, params, batch["inputs"], **kw)
    got = TT.beam_translate(ttask.model, _t(batch["inputs"]), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_beam_ties_break_toward_the_lower_index():
    """All-zero weights make every logit equal: ``lax.top_k`` keeps the
    lowest indices, and the stable sort must pick the same beams and
    tokens (here the EOS beam, id 2, finishes first and wins on the
    length penalty)."""
    jcfg = dataclasses.replace(JT.TRANSFORMER_PRESETS["transformer_tiny"],
                               vocab_size=8)
    tcfg = dataclasses.replace(TT.TRANSFORMER_PRESETS["transformer_tiny"],
                               vocab_size=8)
    src = np.array([[3, 4, 5], [6, 7, 3]], np.int32)
    params = jax.tree_util.tree_map(jnp.zeros_like, fnn.unbox(
        JT.Seq2SeqTransformer(jcfg).init(jax.random.key(0), src,
                                         src)["params"]))
    model = TT.Seq2SeqTransformer(tcfg, device="meta")
    model.load_state_dict(convert.params_from_flax(_flat(params), tcfg),
                          assign=True)
    model.eval()
    kw = dict(max_len=4, beam_size=3, bos_id=1, eos_id=2)
    want = JT.beam_translate(jcfg, params, src, **kw)
    got = TT.beam_translate(model, _t(src), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[2, 0, 0, 0]] * 2


def test_corpus_bleu_and_strip_match_jax():
    rng = np.random.default_rng(2)
    refs = [list(rng.integers(3, 12, n)) for n in (9, 14, 6, 11)]
    hyps = [r[:-2] + [4, 5] if i % 2 else r[1:] for i, r in enumerate(refs)]
    for smooth in (False, True):
        for order in (2, 4):
            assert TM.corpus_bleu(hyps, refs, max_order=order,
                                  smooth=smooth) == JM.corpus_bleu(
                hyps, refs, max_order=order, smooth=smooth)
    assert TM.corpus_bleu(refs, refs) == 100.0 == JM.corpus_bleu(refs, refs)
    ids = [5, 0, 7, 2, 9, 2]
    assert TM.strip_after_eos(ids, 2) == JM.strip_after_eos(ids, 2) == \
        [5, 0, 7]


def test_registry_tiny_trains_like_the_jax_trainer():
    """transformer_tiny_wmt: step-1 gradients and a 10-step adamw curve
    against the JAX ``Trainer`` from the same init and batches."""
    jentry = jreg.get_entry("transformer_tiny_wmt")
    tentry = treg.get_entry("transformer_tiny_wmt")
    kw = dict(tentry["dataset_kwargs"], num_examples=64)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    hist = History()
    jtr = JaxTrainer(jentry["task_factory"](), optax.adamw(1e-3), mesh,
                     policy=jmp.Policy.from_name("float32"),
                     config=JaxTrainerConfig(log_every=5,
                                             log_grad_norm=True),
                     callbacks=[hist])
    loader = HostDataLoader(jds.get_dataset("wmt", **kw),
                            DataConfig(global_batch_size=BATCH, seed=0))
    jstate = jtr.create_state(next(iter(loader)))
    ttr = Trainer(treg.make_task(tentry, device="meta"),
                  topt.make_optimizer("adamw", 1e-3),
                  policy=Policy.from_name("float32"),
                  config=TrainerConfig(log_every=5, log_grad_norm=True),
                  device="cpu")
    tstate = ttr.create_state(convert.params_from_flax(
        _flat(jstate.params), tentry["config"]))
    batches = HostBatches(tds.get_dataset("wmt", **kw), BATCH, seed=0)
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
    for key in ("loss", "accuracy", "grad_norm"):
        got = np.array([m[key] for _, m in history])
        want = np.array(hist.history[key])
        assert got.shape == (STEPS,)
        assert np.max(np.abs(got - want)) <= 1e-4, (key, got - want)
    # The trained weights decode as the JAX ones do.
    src = next(iter(loader))["inputs"][:4]
    kw = dict(max_len=tentry["dataset_kwargs"]["seq_len"], bos_id=1,
              eos_id=2, beam_size=2)
    want = JT.beam_translate(jentry["task_factory"]().config,
                             jstate.params, src, **kw)
    with ttr.inference(tstate):
        got = TT.beam_translate(ttr.task.model, _t(src), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
