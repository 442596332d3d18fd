"""The port's sliding-window training path against the JAX package's, on
the CPU: ``local_attention_chunked``, the splash kernel's plain version
(``ops.kernels.splash_attention_reference``, what the K7 wrapper computes
for CPU tensors), the windowed dispatch, ``mistral_tiny_lm``'s forward
and loss, and ten trainer steps.

Inputs are numpy-seeded and identical on both sides.  The JAX splash
kernel runs as the JAX package's own tests run it here: in Pallas
interpret mode (``splash_window_attention(..., interpret=True)``), at
their shape (b 1, h 2, s 256, d 64, w 64), built once for the module.

Tolerances, all f32:

- attention outputs 2e-6 and gradients 1e-5 where both sides take the
  same masked softmax (chunked against chunked or dense: the same math,
  other summation orders and score layouts);
- the plain splash version against the interpret-mode splash kernel 1e-5
  (an online softmax by 128-key blocks against one softmax; measured
  up to 1e-6);
- model logits 1e-5 and losses 1e-6 relative (as
  ``tests/test_torch_training.py``), the 10-step loss curve 1e-4 (f32
  rounding carried through adamw).
"""

import dataclasses
import json

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
from tensorflow_train_distributed_tpu.ops import attention as JA
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
from tensorflow_train_distributed_torch.data.pipeline import HostBatches
from tensorflow_train_distributed_torch.models import llama as TLL
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.ops import attention as TA
from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.training import (
    mixed_precision as tmp,
    optimizers as topt,
    schedules as tsched,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _segments(b, s, seed=0):
    """Packed rows: four documents of random lengths, ids rising."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    for r in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), 3, replace=False))
        out[r] = np.searchsorted(cuts, np.arange(s), side="right") + 1
    return out


def _jax_vjp(fn, q, k, v, do):
    """(out, dq, dk, dv) of ``fn`` for the cotangent ``do``, jitted."""
    def both(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(do))

    return [np.asarray(t) for t in jax.jit(both)(q, k, v, do)]


def _torch_vjp(fn, q, k, v, do):
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = fn(tq, tk, tv)
    out.backward(_t(do))
    return [t.detach().numpy() for t in (out, tq.grad, tk.grad, tv.grad)]


def _close(got, want, fwd_tol, grad_tol):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        tol = fwd_tol if name == "out" else grad_tol
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


# -- local_attention_chunked --------------------------------------------------


@pytest.mark.parametrize("window,sinks", [(1, 0), (1, 1), (8, 0), (8, 3),
                                          (16, 0), (16, 4), (16, 16)])
@pytest.mark.parametrize("packed", [False, True])
def test_local_attention_chunked_matches_jax(window, sinks, packed):
    """Forward and gradients of the port's chunked path against the JAX
    function (windows 1, 8, 16, with and without sinks, packed rows), and
    its forward against the port's dense masked oracle."""
    b, h, s, d = 2, 2, 32, 16
    q, k, v, do = (_rand((b, h, s, d), seed=i) for i in range(4))
    seg = _segments(b, s) if packed else None
    kw = dict(window=window, sinks=sinks)
    want = _jax_vjp(lambda *t: JA.local_attention_chunked(
        *t, segment_ids=None if seg is None else jnp.asarray(seg), **kw),
        q, k, v, do)
    got = _torch_vjp(lambda *t: TA.local_attention_chunked(
        *t, segment_ids=None if seg is None else _t(seg), **kw), q, k, v, do)
    _close(got, want, 2e-6, 1e-5)
    mask = None if seg is None else _t(seg[:, None, :, None]
                                       == seg[:, None, None, :])
    dense = TA.dot_product_attention(_t(q), _t(k), _t(v), causal=True,
                                     mask=mask, **kw)
    np.testing.assert_allclose(got[0], dense.numpy(), rtol=2e-6, atol=2e-6)


def test_local_attention_chunked_rejects_what_jax_rejects():
    q = torch.zeros(1, 1, 12, 4)
    for kw, match in ((dict(window=0), "window must be >= 1"),
                      (dict(window=4, sinks=5), "sinks must be in"),
                      (dict(window=4, sinks=-1), "sinks must be in"),
                      (dict(window=5), "divisible by window")):
        with pytest.raises(ValueError, match=match):
            TA.local_attention_chunked(q, q, q, **kw)


# -- K7's plain version against the splash kernel -----------------------------

SPLASH = dict(b=1, h=2, s=256, d=64, w=64)


@pytest.fixture(scope="module")
def jax_splash():
    """The interpret-mode splash kernel's output and gradients, without
    and with packed rows (built once: ~2.5 s each)."""
    b, h, s, d, w = (SPLASH[x] for x in "bhsdw")
    q, k, v, do = (_rand((b, h, s, d), seed=30 + i) for i in range(4))
    seg = np.repeat([1, 1, 2, 2], s // 4)[None].astype(np.int32)
    seg[:, 100:] += 1                      # a boundary inside a band
    res = {}
    for packed in (False, True):
        sg = jnp.asarray(seg) if packed else None
        res[packed] = _jax_vjp(lambda *t: JA.splash_window_attention(
            *t, window=w, segment_ids=sg, interpret=True), q, k, v, do)
    return (q, k, v, do, seg), res


@pytest.mark.parametrize("packed", [False, True])
def test_splash_reference_matches_jax_splash(jax_splash, packed):
    (q, k, v, do, seg), res = jax_splash
    w, d = SPLASH["w"], SPLASH["d"]
    got = _torch_vjp(lambda *t: K.splash_attention_reference(
        *t, window=w, segment_ids=_t(seg) if packed else None,
        sm_scale=d ** -0.5), q, k, v, do)
    _close(got, res[packed], 1e-5, 1e-5)


def test_splash_wrapper_on_cpu_is_the_reference():
    q, k, v = (_t(_rand((1, 2, 128, 64), seed=i)) for i in range(3))
    before = K.launch_counts()
    got = K.splash_attention(q, k, v, window=40, sinks=3, sm_scale=0.125)
    assert torch.equal(got, K.splash_attention_reference(
        q, k, v, window=40, sinks=3, sm_scale=0.125))
    assert K.launch_counts() == before          # no kernel launched
    for kw in (dict(window=0), dict(window=8, sinks=9),
               dict(window=8, sinks=-1)):
        with pytest.raises(ValueError, match="window >= 1"):
            K.splash_attention(q, k, v, sm_scale=0.125, **kw)


@pytest.mark.parametrize("window,sinks,packed", [(16, 4, False),
                                                 (8, 8, True),
                                                 (32, 0, True)])
def test_splash_reference_matches_jax_chunked_with_sinks_and_gqa(
        window, sinks, packed):
    """Sinks (which the JAX splash route refuses) and GQA 2:1: the port's
    plain version reads the unrepeated kv heads, the JAX chunked path
    takes them repeated; the repeat's transpose sums the group's dk/dv."""
    b, h, kvh, s, d = 2, 4, 2, 64, 16
    q, do = _rand((b, h, s, d), seed=40), _rand((b, h, s, d), seed=41)
    k, v = _rand((b, kvh, s, d), seed=42), _rand((b, kvh, s, d), seed=43)
    seg = _segments(b, s, seed=5) if packed else None
    want = _jax_vjp(lambda q_, k_, v_: JA.local_attention_chunked(
        q_, jnp.repeat(k_, 2, 1), jnp.repeat(v_, 2, 1), window=window,
        sinks=sinks, segment_ids=None if seg is None else jnp.asarray(seg)),
        q, k, v, do)
    got = _torch_vjp(lambda *t: K.splash_attention_reference(
        *t, window=window, sinks=sinks,
        segment_ids=None if seg is None else _t(seg), sm_scale=d ** -0.5),
        q, k, v, do)
    _close(got, want, 2e-6, 1e-5)


# -- the windowed dispatch ----------------------------------------------------


@pytest.mark.parametrize("s,window,sinks,packed", [
    (32, 8, 2, True),        # chunked
    (24, 10, 3, False),      # S % window != 0: the dense oracle
    (16, 16, 4, True),       # S <= window: dense in JAX and here
    (16, 40, 0, False)])
def test_windowed_dispatch_matches_jax_on_cpu(s, window, sinks, packed):
    b, h, kvh, d = 2, 4, 2, 16
    q = _rand((b, h, s, d))
    k, v = _rand((b, kvh, s, d), seed=1), _rand((b, kvh, s, d), seed=2)
    seg = _segments(b, s, seed=3) if packed else None
    want = JA.multihead_attention_kernel(
        jnp.asarray(q), jnp.asarray(np.repeat(k, 2, 1)),
        jnp.asarray(np.repeat(v, 2, 1)), causal=True, window=window,
        sinks=sinks, segment_ids=None if seg is None else jnp.asarray(seg))
    got = TA.multihead_attention_kernel(
        _t(q), _t(k), _t(v), causal=True, window=window, sinks=sinks,
        segment_ids=None if seg is None else _t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


def test_windowed_dispatch_raises_as_jax_does():
    q = torch.zeros(1, 2, 16, 8)
    for kw, match in ((dict(window=4), "requires causal"),
                      (dict(causal=True, sinks=2), "sinks"),
                      (dict(causal=True, window=0), "window must be >= 1")):
        with pytest.raises(ValueError, match=match):
            TA.multihead_attention_kernel(q, q, q, **kw)
        with pytest.raises(ValueError, match=match):
            JA.multihead_attention_kernel(jnp.zeros((1, 2, 16, 8)),
                                          jnp.zeros((1, 2, 16, 8)),
                                          jnp.zeros((1, 2, 16, 8)), **kw)


# -- mistral_tiny_lm ----------------------------------------------------------


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


def _mistral_tiny():
    """(JAX config, the port's) of mistral_tiny_lm: llama_tiny with window
    16 and 4 sinks."""
    from tensorflow_train_distributed_tpu.models import registry as jreg

    return (jreg.get_entry("mistral_tiny_lm")["task_factory"]().config,
            treg.get_config("mistral_tiny_lm"))


def _jax_params(jcfg):
    return jax.jit(JLL.LlamaModel(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _port_model(tcfg, params):
    model = TLL.LlamaModel(tcfg, device="meta")
    model.load_state_dict(convert.params_from_flax(_flat(params), tcfg),
                          strict=True, assign=True)
    return model


def test_mistral_tiny_logits_and_loss_match_jax():
    """At the registry's seq 64 (window 16, 4 sinks: the chunked path on
    both sides), packed and not; a Mistral tree is a Llama GQA tree."""
    jcfg, tcfg = _mistral_tiny()
    params = _jax_params(jcfg)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 256, (2, 64)).astype(np.int32)
    seg = _segments(2, 64, seed=7)
    model = _port_model(tcfg, params)
    apply = jax.jit(JLL.LlamaModel(jcfg).apply)
    for kw in ({}, {"segment_ids": seg}):
        want = apply({"params": params}, tokens, **kw)
        got = model(_t(tokens), **{k: _t(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    batch = {"tokens": tokens,
             "targets": rng.integers(0, 256, (2, 64)).astype(np.int32)}
    loss = jax.jit(lambda p, bt: JLL.CausalLmTask(jcfg).loss_fn(
        p, {}, bt, None, True)[0])(params, batch)
    task = TLL.CausalLmTask(tcfg, device="meta")
    task.model = model
    tloss, _ = task.loss_fn({k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-6)


def test_mistral_tiny_loss_curve_matches_jax_trainer():
    """Ten adamw steps of mistral_tiny_lm (f32, warmup_cosine, clip 1.0)
    through the port's trainer and the JAX ``Trainer``, from the same
    init and batches."""
    steps, batch = 10, 8
    jcfg, tcfg = _mistral_tiny()
    source = dict(num_examples=64, seq_len=64, vocab_size=256)
    jlr = jsched.by_name("warmup_cosine", 3e-3, steps, warmup_steps=2)
    tlr = tsched.by_name("warmup_cosine", 3e-3, steps, warmup_steps=2)
    jtx = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(jlr, weight_decay=0.01))
    hist = History()
    jtr = JaxTrainer(JLL.CausalLmTask(jcfg), jtx,
                     build_mesh(MeshConfig(data=1),
                                devices=jax.devices()[:1]),
                     policy=jmp.Policy.from_name("float32"),
                     config=JaxTrainerConfig(log_every=5,
                                             log_grad_norm=True),
                     callbacks=[hist], lr_schedule=jlr)
    loader = HostDataLoader(JaxSyntheticLM(**source),
                            DataConfig(global_batch_size=batch, seed=0))
    jstate = jtr.create_state(next(iter(loader)))
    ttr = Trainer(TLL.CausalLmTask(tcfg, device="meta"),
                  topt.make_optimizer("adamw", tlr, weight_decay=0.01,
                                      grad_clip_norm=1.0),
                  policy=tmp.Policy.from_name("float32"),
                  config=TrainerConfig(log_every=5, log_grad_norm=True),
                  lr_schedule=tlr, device="cpu")
    tstate = ttr.create_state(convert.params_from_flax(
        _flat(jstate.params), tcfg))
    jtr.fit(loader, steps=steps, state=jstate)
    _, history = ttr.fit(HostBatches(SyntheticLM(**source), batch, seed=0),
                         steps=steps, state=tstate)
    for key in ("loss", "grad_norm"):
        want = np.array(hist.history[key])
        got = np.array([m[key] for _, m in history])
        assert want.shape == (steps,)
        # f32 rounding of the two trainers, carried through 10 steps.
        assert np.max(np.abs(got - want)) <= 1e-4, (key, got - want)
    assert history[-1][1]["loss"] < history[0][1]["loss"]


def test_train_cli_trains_mistral_tiny(capsys):
    assert tcli.main(["--config", "mistral_tiny_lm", "--steps", "3",
                      "--device", "cpu", "--log-every", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in lines)


def test_windowed_decode_raises_instead_of_ignoring_the_window():
    """The decode modes keep the full context; a windowed model refuses
    them (the rolling cache is not ported), leaving the cache as it was."""
    tcfg = treg.get_config("mistral_tiny_lm")
    for cfg in (tcfg, dataclasses.replace(tcfg, attention_sinks=0),
                dataclasses.replace(tcfg, sliding_window=None)):
        model = TLL.LlamaModel(cfg)
        cache = model.init_cache(1, 32)
        with pytest.raises(NotImplementedError, match="rolling-cache"):
            model(torch.zeros(1, 4, dtype=torch.long), cache)
        assert int(cache.index[0]) == 0
