"""The port's training path against the JAX package's, on the CPU.

Weights come from the JAX model's own init (converted with
``convert.params_from_flax``), batches from the same ``SyntheticLM``
records in the same loader order, so both sides see identical inputs;
the port's kernels take their plain versions here (CPU tensors).

Tolerances, each at f32:

- training-forward logits 1e-5 (same math in other kernels and
  summation orders, through a few layers);
- losses of one batch 1e-6 relative;
- one optimizer step against optax 1e-6 relative (element-wise math;
  the schedule's cosine is taken in f64 here and f32 in optax);
- step-1 gradients against the JAX ``Trainer`` rtol 1e-4, atol 1e-6 per
  leaf (a backward through the whole model, summed over 256 tokens);
- the 20-step loss curve max |delta| <= 1e-4 (the two trainers' f32
  rounding differences, carried through adamw for 20 steps).
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
from tensorflow_train_distributed_tpu.data.datasets import (
    SyntheticLM as JaxSyntheticLM,
)
from tensorflow_train_distributed_tpu.models import llama as JLL
from tensorflow_train_distributed_tpu.ops import losses as JLoss
from tensorflow_train_distributed_tpu.runtime.mesh import (
    MeshConfig,
    build_mesh,
)
from tensorflow_train_distributed_tpu.training import (
    mixed_precision as jmp,
    schedules as jsched,
)
from tensorflow_train_distributed_tpu.training.callbacks import History
from tensorflow_train_distributed_tpu.training.trainer import (
    Trainer as JaxTrainer,
    TrainerConfig as JaxTrainerConfig,
)
from tensorflow_train_distributed_torch import convert, train as tcli
from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
from tensorflow_train_distributed_torch.data.pipeline import (
    HostBatches,
    to_device,
)
from tensorflow_train_distributed_torch.models import llama as TLL
from tensorflow_train_distributed_torch.ops import losses as TLoss
from tensorflow_train_distributed_torch.training import (
    mixed_precision as tmp,
    optimizers as topt,
    schedules as tsched,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


# Each case: (JAX config, the port's config with the same knobs).
_GEMMA = dict(head_dim=32, num_kv_heads=1, embed_scale=True,
              mlp_activation="gelu", norm_zero_centered=True)
_QWEN = dict(qkv_bias=True, fused_qkv=True)
CONFIGS = {
    "llama_tiny": ({}, {}),
    "llama_tiny_scan": ({}, {}),
    "gqa_bias_fused": (_QWEN, _QWEN),
    "gemma_knobs": (_GEMMA, _GEMMA),
}


def _configs(name):
    base = "llama_tiny_scan" if name == "llama_tiny_scan" else "llama_tiny"
    jknobs, tknobs = CONFIGS[name]
    return (dataclasses.replace(JLL.LLAMA_PRESETS[base], **jknobs),
            dataclasses.replace(TLL.LLAMA_PRESETS[base], **tknobs))


def _jax_params(jcfg, seed=0):
    params = JLL.LlamaModel(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    if jcfg.norm_zero_centered:
        # The init leaves zero-centered scales at 0; move them so the +1
        # and the scale's gradient path are both exercised.
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: x + 0.1 if "scale" in jax.tree_util.keystr(p)
            else x, params)
    return params


def _port_model(tcfg, params):
    model = TLL.LlamaModel(tcfg, device="meta")
    model.load_state_dict(convert.params_from_flax(_flat(params), tcfg),
                          strict=True, assign=True)
    return model


# -- losses ------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_cross_entropy_matches_jax(smoothing, weighted):
    logits = _rand((3, 5, 40), scale=3.0)
    labels = np.random.default_rng(1).integers(0, 40, (3, 5)).astype(
        np.int32)
    labels[0, :3] = np.argmax(logits[0, :3], -1)     # some hits
    weights = (np.random.default_rng(2).random((3, 5)) > 0.3).astype(
        np.float32) if weighted else None
    batch = {"sample_weight": np.array([1.0, 0.0, 1.0], np.float32)}
    jw = JLoss.fold_sample_weight(batch, labels.shape, weights)
    tw = TLoss.fold_sample_weight({k: _t(v) for k, v in batch.items()},
                                  labels.shape,
                                  None if weights is None else _t(weights))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    want = JLoss.softmax_cross_entropy(jnp.asarray(logits), labels,
                                       label_smoothing=smoothing, weights=jw)
    got = TLoss.softmax_cross_entropy(_t(logits), _t(labels),
                                      label_smoothing=smoothing, weights=tw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


def test_fold_sample_weight_without_either_is_none():
    assert TLoss.fold_sample_weight({}, (2, 3)) is None


# -- the training forward -----------------------------------------------------


def test_segment_relative_positions_match_jax():
    seg = np.array([[1, 1, 1, 2, 2, 3, 3, 3, 3, 0],
                    [5, 5, 5, 5, 5, 5, 5, 5, 5, 5]], np.int32)
    want = JLL.segment_relative_positions(jnp.asarray(seg))
    got = TLL.segment_relative_positions(_t(seg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_training_forward_logits_match_jax(name):
    jcfg, tcfg = _configs(name)
    params = _jax_params(jcfg)
    tokens = np.random.default_rng(4).integers(0, 256, (2, 24)).astype(
        np.int32)
    want = JLL.LlamaModel(jcfg).apply({"params": params}, tokens)
    model = _port_model(tcfg, params)
    got = model(_t(tokens))
    assert got.requires_grad          # the parameters are trainable
    # Same f32 math in other kernels and summation orders: 1e-5.
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_packed_segments_forward_matches_jax():
    jcfg, tcfg = _configs("llama_tiny")
    params = _jax_params(jcfg)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 16)).astype(
        np.int32)
    seg = np.array([[1] * 5 + [2] * 7 + [3] * 4, [1] * 16], np.int32)
    want = JLL.LlamaModel(jcfg).apply({"params": params}, tokens,
                                      segment_ids=seg)
    got = _port_model(tcfg, params)(_t(tokens), segment_ids=_t(seg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_causal_lm_task_loss_matches_jax():
    jcfg, tcfg = _configs("llama_tiny_scan")
    params = _jax_params(jcfg)
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, 256, (2, 16)).astype(np.int32),
             "targets": rng.integers(0, 256, (2, 16)).astype(np.int32),
             "loss_weights": (rng.random((2, 16)) > 0.2).astype(np.float32)}
    loss, (metrics, _) = JLL.CausalLmTask(jcfg).loss_fn(
        params, {}, batch, None, True)
    task = TLL.CausalLmTask(tcfg, device="meta")
    task.model = _port_model(tcfg, params)
    tloss, tmetrics = task.loss_fn({k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-6)
    for k in ("accuracy", "loss_weight"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-6)
    np.testing.assert_allclose(
        task.predict_fn({"tokens": _t(batch["tokens"])}).detach().numpy(),
        np.asarray(JLL.CausalLmTask(jcfg).predict_fn(params, {}, batch)),
        rtol=1e-5, atol=1e-5)


def test_unported_remat_policies_raise():
    """"full", "dots" and "no_ffn" are ported (tests/test_torch_launch.py
    holds their gradients); a policy the JAX package does not know
    either is refused, as JAX's ``_checkpoint_policy`` refuses it."""
    with pytest.raises(ValueError, match="remat_policy"):
        dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny_scan"],
                            remat_policy="offload")
    for policy in TLL.REMAT_POLICIES:
        dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny_scan"],
                            remat_policy=policy)


def test_remat_recomputes_each_block_in_the_backward():
    """Full remat: the backward runs each block's forward again, so the
    norm kernels' forward count doubles inside the blocks."""
    from tensorflow_train_distributed_torch.models import layers as TLy

    _, tcfg = _configs("llama_tiny_scan")
    model = _port_model(tcfg, _jax_params(_configs("llama_tiny_scan")[0]))
    calls = []
    orig = TLy.RMSNorm.forward

    def counting(self, x):
        calls.append(1)
        return orig(self, x)

    TLy.RMSNorm.forward = counting
    try:
        model(torch.zeros(1, 8, dtype=torch.long)).sum().backward()
    finally:
        TLy.RMSNorm.forward = orig
    n = tcfg.num_layers
    assert len(calls) == 2 * 2 * n + 1


# -- schedules and optimizers -------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("constant", dict(warmup_steps=0)), ("constant", dict(warmup_steps=3)),
    ("warmup_cosine", dict(warmup_steps=3)),
    ("warmup_cosine", dict(warmup_steps=0, end_lr_ratio=0.1)),
    ("warmup_linear", dict(warmup_steps=4)),
    ("noam", dict(warmup_steps=5, d_model=64)),
    ("resnet_steps", dict(warmup_steps=2)),
    ("resnet_steps", dict(warmup_steps=0))])
def test_schedules_match_jax(name, kw):
    want = jsched.by_name(name, 0.5, 30, **kw)
    got = tsched.by_name(name, 0.5, 30, **kw)
    for step in range(0, 35):
        # optax evaluates in f32, the port in f64: a few f32 ulps of the
        # 0.5 peak (the cosine's argument rounds near its end).
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-7, err_msg=f"step {step}")


def _optax(name, lr, wd, clip):
    """The optimizer as the JAX launcher builds it (``_make_optimizer``)."""
    if name == "sgd":
        tx = optax.sgd(lr)
    elif name == "momentum":
        tx = optax.sgd(lr, momentum=0.9, nesterov=True)
    elif name == "adam":
        tx = optax.adam(lr)
    elif name == "lamb":
        tx = optax.lamb(lr, weight_decay=wd)
    elif name == "adafactor":
        tx = optax.adafactor(lr, weight_decay_rate=wd or None)
    else:
        tx = optax.adamw(lr, weight_decay=wd)
    return optax.chain(optax.clip_by_global_norm(clip), tx) if clip else tx


@pytest.mark.parametrize("name", topt.OPTIMIZERS)
@pytest.mark.parametrize("clip", [0.0, 0.5, 100.0])
def test_optimizer_steps_match_optax(name, clip):
    """Three steps (moments, bias corrections, the schedule's count) of
    the port's optimizer against optax's on the same grads; clip 0.5
    triggers, 100 does not."""
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [_rand(s, seed=i) for i, s in enumerate(shapes)]
    jlr = jsched.by_name("warmup_cosine", 0.1, 10, warmup_steps=2)
    tlr = tsched.by_name("warmup_cosine", 0.1, 10, warmup_steps=2)
    jtx = _optax(name, jlr, 0.01, clip)
    ttx = topt.make_optimizer(name, tlr, weight_decay=0.01,
                              grad_clip_norm=clip)
    jp = [jnp.asarray(p) for p in params]
    tp = [_t(p) for p in params]
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        grads = [_rand(s, seed=10 * step + i) for i, s in enumerate(shapes)]
        ju, js = jtx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update([_t(g) for g in grads], ts, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step}")


def test_make_optimizer_rejects_unported_and_negative_clip():
    with pytest.raises(ValueError, match="lion"):
        topt.make_optimizer("lion", 1e-3)
    with pytest.raises(ValueError, match="grad_clip_norm"):
        topt.make_optimizer("adamw", 1e-3, grad_clip_norm=-1.0)


# -- mixed precision ----------------------------------------------------------


def test_loss_scale_updates_match_jax():
    jpol = jmp.Policy.from_name("float16")
    tpol = tmp.Policy.from_name("float16")
    jpol = dataclasses.replace(jpol, growth_interval=3)
    tpol = dataclasses.replace(tpol, growth_interval=3)
    js = jmp.LossScaleState.create(jpol)
    ts = tmp.LossScaleState.create(tpol)
    for finite in (True, True, True, False, True, False, False):
        js = jmp.update_loss_scale(js, jnp.asarray(finite), jpol)
        ts = tmp.update_loss_scale(ts, torch.tensor(finite), tpol)
        assert ts.scale.item() == float(js.scale)
        assert ts.good_steps.item() == int(js.good_steps)
    assert tmp.LossScaleState.create(tmp.Policy.from_name("bf16")) is None
    with pytest.raises(ValueError):
        tmp.Policy.from_name("int4")


# -- data ---------------------------------------------------------------------


def test_synthetic_lm_and_batch_order_match_jax():
    kw = dict(num_examples=40, seq_len=16, vocab_size=256, seed=7)
    jit = iter(HostDataLoader(JaxSyntheticLM(**kw),
                              DataConfig(global_batch_size=8, seed=3)))
    tit = iter(HostBatches(SyntheticLM(**kw), 8, seed=3))
    for _ in range(7):             # crosses the epoch boundary (5 a epoch)
        a, b = next(jit), next(tit)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])
    batch = to_device(b, "cpu")
    assert batch["tokens"].dtype == torch.int32


# -- the trainer against the JAX Trainer --------------------------------------


SEQ, BATCH, STEPS = 16, 16, 20


def _source():
    return dict(num_examples=64, seq_len=SEQ, vocab_size=256)


def _pair(precision="float32", *, grad_accum=1, clip=1.0, loss_scale=None,
          cfg_name="llama_tiny"):
    """The JAX Trainer (one-device CPU mesh) and the port's, with the same
    converted init, optimizer, schedule and batches."""
    jcfg, tcfg = _configs(cfg_name)
    jpol = jmp.Policy.from_name(precision)
    tpol = tmp.Policy.from_name(precision)
    if loss_scale is not None:
        jpol = dataclasses.replace(jpol, initial_loss_scale=loss_scale)
        tpol = dataclasses.replace(tpol, initial_loss_scale=loss_scale)
    jlr = jsched.by_name("warmup_cosine", 3e-3, STEPS, warmup_steps=2)
    tlr = tsched.by_name("warmup_cosine", 3e-3, STEPS, warmup_steps=2)
    jtx = _optax("adamw", jlr, 0.01, clip)
    ttx = topt.make_optimizer("adamw", tlr, weight_decay=0.01,
                              grad_clip_norm=clip)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    hist = History()
    jtr = JaxTrainer(JLL.CausalLmTask(jcfg), jtx, mesh, policy=jpol,
                     config=JaxTrainerConfig(grad_accum=grad_accum,
                                             log_every=5,
                                             log_grad_norm=True),
                     callbacks=[hist], lr_schedule=jlr)
    loader = HostDataLoader(JaxSyntheticLM(**_source()),
                            DataConfig(global_batch_size=BATCH, seed=0))
    jstate = jtr.create_state(next(iter(loader)))
    ttr = Trainer(TLL.CausalLmTask(tcfg, device="meta"), ttx, policy=tpol,
                  config=TrainerConfig(grad_accum=grad_accum, log_every=5,
                                       log_grad_norm=True),
                  lr_schedule=tlr, device="cpu")
    tstate = ttr.create_state(convert.params_from_flax(
        _flat(jstate.params), tcfg))
    batches = HostBatches(SyntheticLM(**_source()), BATCH, seed=0)
    return (jtr, jstate, loader, hist), (ttr, tstate, batches), tcfg


def test_step1_grads_match_jax_trainer():
    (jtr, jstate, loader, _), (ttr, tstate, batches), tcfg = _pair()
    jbatch = next(iter(loader))
    grads, loss, metrics, _ = jtr._microbatch_grads(
        jstate.params, jstate.model_state, jbatch, jax.random.key(0),
        jstate.loss_scale)
    want = convert.params_from_flax(_flat(grads), tcfg)
    batch = to_device(next(iter(batches)), "cpu")
    params = list(tstate.params.values())
    tgrads, tloss, tmetrics = ttr._microbatch_grads(params, batch, None)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-6)
    np.testing.assert_allclose(tmetrics["accuracy"].item(),
                               float(metrics["accuracy"]), rtol=1e-6)
    assert len(tgrads) == len(want)
    for name, g in zip(tstate.params, tgrads):
        # A backward through the whole model: rtol 1e-4, atol 1e-6.
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def _curves(jside, tside, steps):
    jtr, jstate, loader, hist = jside
    ttr, tstate, batches = tside
    jstate = jtr.fit(loader, steps=steps, state=jstate)
    tstate, history = ttr.fit(batches, steps=steps, state=tstate)
    return hist, history, jstate, tstate


def test_loss_curve_matches_jax_trainer():
    jside, tside, tcfg = _pair()
    hist, history, jstate, tstate = _curves(jside, tside, STEPS)
    assert [s for s, _ in history] == list(range(1, STEPS + 1))
    for key, tol in (("loss", 1e-4), ("grad_norm", 1e-4), ("lr", 1e-9)):
        want = np.array(hist.history[key])
        got = np.array([m[key] for _, m in history])
        assert want.shape == (STEPS,)
        # The two trainers' f32 rounding, carried through 20 adamw steps.
        assert np.max(np.abs(got - want)) <= tol, (key, got - want)
    losses = [m["loss"] for _, m in history]
    assert losses[-1] < losses[0]
    want = convert.params_from_flax(_flat(jstate.params), tcfg)
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_grad_accum_matches_jax_trainer():
    jside, tside, _ = _pair(grad_accum=2)
    hist, history, _, _ = _curves(jside, tside, 3)
    for key in ("loss", "accuracy", "grad_norm"):
        got = np.array([m[key] for _, m in history])
        np.testing.assert_allclose(got, hist.history[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_float16_overflow_skips_the_update_like_jax():
    """A loss scale of 2^40 overflows the f16 cotangents on step 1: both
    trainers leave params and optimizer state alone, halve the scale and
    report grads_finite 0; a scale of 2^10 then trains."""
    jside, tside, tcfg = _pair("float16", loss_scale=2.0 ** 40)
    init = convert.params_from_flax(_flat(jside[1].params), tcfg)
    hist, history, jstate, tstate = _curves(jside, tside, 1)
    m = history[0][1]
    assert m["grads_finite"] == 0.0 == hist.history["grads_finite"][0]
    assert m["loss_scale"] == 2.0 ** 39 == hist.history["loss_scale"][0]
    want = convert.params_from_flax(_flat(jstate.params), tcfg)
    for name, p in tstate.params.items():
        assert torch.equal(p.detach(), init[name]), name
        assert torch.equal(want[name], init[name]), name
    assert tstate.opt_state[1][0].count == 0   # adam's count unchanged
    assert int(jstate.opt_state[1][0].count) == 0

    jside, tside, _ = _pair("float16", loss_scale=2.0 ** 10)
    hist, history, _, _ = _curves(jside, tside, 2)
    got = np.array([m["loss"] for _, m in history])
    assert [m["grads_finite"] for _, m in history] == [1.0, 1.0]
    # f16 parameters and cotangents: the two sides round the same values,
    # summed in other orders.
    np.testing.assert_allclose(got, hist.history["loss"], rtol=1e-4)


# -- the CLI ------------------------------------------------------------------


def test_train_cli_on_cpu(capsys):
    import json

    assert tcli.main(["--config", "llama_tiny_sft", "--steps", "3",
                      "--device", "cpu", "--log-every", "2",
                      "--log-grad-norm"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines] == [2, 3]
    for x in lines:
        assert np.isfinite(x["loss"]) and {"accuracy", "lr",
                                           "grad_norm"} <= x.keys()


def test_train_cli_rejects_bad_flags(monkeypatch):
    with pytest.raises(SystemExit):
        tcli.main(["--config", "no_such_config", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcli.main(["--config", "llama_tiny_sft", "--steps", "0",
                   "--device", "cpu"])
    # A seq axis trains: two gloo ranks take a step of
    # llama_tiny_sft, whole rows on each (no seq_parallel in its config).
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert tcli.main(["--config", "llama_tiny_sft", "--steps", "1",
                      "--device", "cpu", "--strategy", "dp", "--mesh",
                      "seq=2", "--cpu-devices", "2"]) == 0


def test_train_cli_trains_llama_350m_shape_under_no_ffn(capsys,
                                                        monkeypatch):
    """llama_350m_lm's entry (remat no_ffn, its head and ffn ratios) cut
    to a tiny width and depth trains a step through the CLI."""
    import json

    from tensorflow_train_distributed_torch.models import registry

    entry = registry.get_entry("llama_350m_lm")
    cfg = dataclasses.replace(
        entry["config"], vocab_size=256, d_model=64, num_layers=2,
        num_heads=4, ffn_size=176, dtype=torch.float32)
    assert (cfg.remat, cfg.remat_policy) == (True, "no_ffn")
    monkeypatch.setitem(registry._ENTRIES, "llama_350m_tiny", dict(
        entry, config=cfg,
        dataset_kwargs=dict(vocab_size=256, seq_len=32)))
    assert tcli.main(["--config", "llama_350m_tiny", "--steps", "1",
                      "--device", "cpu", "--precision", "float32"]) == 0
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert line["step"] == 1 and np.isfinite(line["loss"])


def test_registry_training_fields_match_jax():
    from tensorflow_train_distributed_tpu.models import registry as jreg
    from tensorflow_train_distributed_torch.models import registry as treg

    for name in treg.available():
        want, got = jreg.get_entry(name), treg.get_entry(name)
        for key in ("dataset", "dataset_kwargs", "global_batch_size",
                    "learning_rate", "lr_schedule", "warmup_ratio",
                    "grad_clip_norm"):
            assert got[key] == want[key], (name, key)
        jtask = want["task_factory"]()
        # The JAX VisionTask keeps its config on the model.
        jcfg = getattr(jtask, "config", None) or jtask.model.config
        for f in dataclasses.fields(got["config"]):
            if f.name != "dtype":
                assert getattr(got["config"], f.name) == getattr(
                    jcfg, f.name), (name, f.name)
        for key in ("label_smoothing", "weight_decay"):
            if hasattr(jtask, key):
                tk = treg.make_task(got, device="meta")
                assert getattr(tk, key) == getattr(jtask, key), (name, key)


# -- the flagship -------------------------------------------------------------


def test_llama_125m_forward_matches_graft_entry():
    """The port's llama_125m against the JAX flagship ``entry()`` (bf16
    compute over f32 params, as the registry entry trains), on its own
    params and the first 64 tokens of its example batch.  Both compute in
    bf16 with f32 norms and softmax; across 12 layers the two round at
    other places: logits (std 1, up to 5.5) differ by up to 0.094
    measured, held to 0.15.  The f32 variant of the same model differs by
    8.8e-6 measured (12 layers, 32,000 logits), held to 2e-5."""
    import __graft_entry__ as ge

    fwd, (params, tokens) = ge.entry()
    tokens = tokens[:, :64]
    flat = _flat(params)
    tcfg = TLL.LLAMA_PRESETS["llama_125m"]
    jcfg = ge._flagship_config()
    for dtype, jdtype, tol in ((torch.bfloat16, jnp.bfloat16, 0.15),
                               (torch.float32, jnp.float32, 2e-5)):
        if dtype == torch.bfloat16:
            want = np.asarray(fwd(params, tokens), np.float32)
        else:
            want = np.asarray(JLL.LlamaModel(dataclasses.replace(
                jcfg, dtype=jdtype)).apply({"params": params}, tokens))
        model = TLL.LlamaModel(dataclasses.replace(tcfg, dtype=dtype),
                               device="meta")
        model.load_state_dict(convert.params_from_flax(flat, tcfg),
                              strict=True, assign=True)
        with torch.no_grad():
            got = model(_t(tokens)).float().numpy()
        assert got.shape == (2, 64, 32_000)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
