"""The training kernels' plain versions against the JAX Pallas kernels.

The JAX side runs as the JAX package's own tests run it on the CPU: the
RMSNorm and cross-entropy Pallas kernels in interpret mode
(``tests/test_pallas_kernels.py``), the library flash attention under
``pltpu.force_tpu_interpret_mode()`` (``tests/test_ops.py``).  The port
side is what the wrappers compute for CPU tensors: each kernel's
``*_reference`` with its autograd backward, which is also the plain
version ``chip_smoke.py`` holds the CUDA kernels against on the card.
Gradients come from ``jax.grad`` / ``jax.vjp`` through the custom VJPs
(K1b, K3b, the library's dkv and dq kernels) and from
``torch.autograd`` on the port side, for the same numpy-seeded inputs
and output cotangents.

Tolerances (f32): forward values within 2e-6 (RMSNorm, cross-entropy:
the same f32 math in another summation order); gradients within 1e-5
(a reduction over a row or a vocab feeds every element); flash attention
within 1e-5 in the output and the gradients (the library normalises
block by block with an online softmax, the plain version takes one
softmax; scores reach |q.k| ~ 30 at head_dim 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_train_distributed_tpu.ops import pallas_kernels as pk
from tensorflow_train_distributed_tpu.ops.attention import (
    multihead_attention_kernel as jax_mha,
)
from tensorflow_train_distributed_torch.ops import attention as TA
from tensorflow_train_distributed_torch.ops import kernels as K


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _interpret_flash():
    """The library flash kernel and its interpret-mode switch, or skip."""
    try:
        from jax.experimental.pallas import tpu as pltpu
        from jax.experimental.pallas.ops.tpu import flash_attention as fa
    except ImportError:
        pytest.skip("pallas tpu ops unavailable")
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("force_tpu_interpret_mode unavailable")
    return pltpu, fa


# -- K1b: RMSNorm backward ----------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 256), (300, 128), (2, 9, 64)])
def test_rms_norm_grads_match_pallas(shape):
    # (300, 128): rows not a multiple of the kernel's 256-row block.
    x = _rand(shape)
    s = 1.0 + 0.1 * _rand(shape[-1:], seed=1)
    g = _rand(shape, seed=2)

    def loss(x, s):
        y = pk.rms_norm(x, s, use_pallas=True, interpret=True)
        return jnp.sum(y * g)

    want_y = pk.rms_norm(x, s, use_pallas=True, interpret=True)
    want_dx, want_ds = jax.grad(loss, argnums=(0, 1))(x, s)
    tx, ts = _t(x, True), _t(s, True)
    y = K.rms_norm(tx, ts)
    y.backward(_t(g))
    # Same f32 math, other summation order.
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=2e-6, atol=2e-6)
    # dx sums g*s*x over a row, dscale over all rows: 1e-5.
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_ds),
                               rtol=1e-5, atol=1e-5)


def test_rms_norm_bf16_scale_grad_keeps_the_scale_dtype():
    """The JAX backward returns dscale in the scale's dtype; so does the
    port's (a bf16 scale under the bf16 policy)."""
    x = _t(_rand((4, 64)), True)
    s = _t(np.ones(64, np.float32)).to(torch.bfloat16).requires_grad_(True)
    K.rms_norm(x, s).sum().backward()
    assert s.grad.dtype == torch.bfloat16 and x.grad.dtype == torch.float32


@pytest.mark.parametrize("shape,bf16_scale", [
    ((6, 256), False), ((300, 128), False), ((2, 9, 64), False),
    ((300, 128), True)])
def test_rms_norm_backward_reference_matches_pallas(shape, bf16_scale):
    """K1b's plain (dx, ds), the oracle of the card's kernel, against the
    JAX ``_rms_norm_pallas_bwd`` (the interpret-mode Pallas dx and the
    einsum ds) through ``jax.vjp``; a bf16 scale gives ds in bf16."""
    x = _rand(shape)
    s = 1.0 + 0.1 * _rand(shape[-1:], seed=1)
    g = _rand(shape, seed=2)
    ts = _t(s)
    sj = s
    if bf16_scale:
        ts = ts.to(torch.bfloat16)
        sj = jnp.asarray(s, jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, s: pk.rms_norm(x, s, use_pallas=True,
                                              interpret=True), x, sj)
    want_dx, want_ds = vjp(jnp.asarray(g))
    tx = _t(x)
    r = torch.rsqrt(tx.square().mean(-1) + 1e-5)
    dx, ds = K.rms_norm_backward_reference(tx, ts, r, _t(g))
    assert dx.shape == tx.shape and dx.dtype == torch.float32
    assert ds.shape == ts.shape and ds.dtype == ts.dtype
    # dx sums g*s*x over a row, dscale over all rows: 1e-5.
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ds.float().numpy(),
                               np.asarray(want_ds, np.float32), rtol=1e-5,
                               atol=1e-5)


# -- K3f, K3b: fused cross-entropy --------------------------------------------


@pytest.mark.parametrize("n,v", [(16, 512), (8, 1000), (32, 2048 + 77),
                                 (5, 3000)])
def test_cross_entropy_matches_pallas(n, v):
    # v not a multiple of the 2048-column vocab block: the ragged edge.
    logits = _rand((n, v), scale=4.0)
    labels = np.random.default_rng(1).integers(0, v, n).astype(np.int32)
    w = _rand((n,), seed=3)         # a weighted sum gives a nontrivial g

    def loss(lg):
        per = pk.fused_cross_entropy(lg, labels, use_pallas=True,
                                     interpret=True)
        return jnp.sum(per * w)

    want = pk.fused_cross_entropy(logits, labels, use_pallas=True,
                                  interpret=True)
    want_g = jax.grad(loss)(logits)
    tl = _t(logits, True)
    got = K.cross_entropy(tl, _t(labels))
    (got * _t(w)).sum().backward()
    # Per-row logsumexp in f32, another summation order: 2e-6 relative.
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)


def test_cross_entropy_extreme_logits_and_batch_dims():
    logits = np.array([[1e4, -1e4, 0.0, 50.0]] * 8, np.float32)
    logits = np.pad(logits, ((0, 0), (0, 124))).reshape(2, 4, 128)
    labels = np.arange(8, dtype=np.int32).reshape(2, 4)
    want = pk.fused_cross_entropy(logits, labels, use_pallas=True,
                                  interpret=True)
    tl = _t(logits, True)
    got = K.cross_entropy(tl, _t(labels))
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-6)
    got.sum().backward()
    assert torch.isfinite(tl.grad).all()


def test_cross_entropy_cpu_wrapper_is_the_reference():
    logits = _t(_rand((3, 50)))
    labels = _t(np.array([0, 7, 49], np.int32))
    before = K.launch_counts()
    assert torch.equal(K.cross_entropy(logits, labels),
                       K.cross_entropy_reference(logits, labels))
    assert K.launch_counts() == before     # no kernel launched


# -- K2: flash attention forward and backward ---------------------------------


def _flash_inputs(b, h, s, d, seed=0):
    q, k, v, do = (_rand((b, h, s, d), seed=seed + i) for i in range(4))
    return q, k, v, do


def _jax_flash(q, k, v, do, *, causal, seg):
    pltpu, fa = _interpret_flash()
    d = q.shape[-1]
    segment_ids = (None if seg is None
                   else fa.SegmentIds(q=jnp.asarray(seg),
                                      kv=jnp.asarray(seg)))

    def f(q, k, v):
        return fa.flash_attention(q, k, v, segment_ids=segment_ids,
                                  causal=causal, sm_scale=d ** -0.5)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(do))
    return [np.asarray(t) for t in (out, *grads)]


def _torch_flash(q, k, v, do, *, causal, seg):
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = K.flash_attention(tq, tk, tv, causal=causal,
                            segment_ids=None if seg is None else _t(seg),
                            sm_scale=q.shape[-1] ** -0.5)
    out.backward(_t(do))
    return [t.detach().numpy() for t in (out, tq.grad, tk.grad, tv.grad)]


def _segments(b, s, seed=0):
    """Packed rows: a few documents of random lengths (multiples of 8),
    ids rising along the row."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    for r in range(b):
        cuts = np.sort(rng.choice(np.arange(8, s, 8), 3, replace=False))
        out[r] = np.searchsorted(cuts, np.arange(s), side="right") + 1
    return out


@pytest.mark.parametrize("s,d", [(128, 64), (256, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_flash_attention_matches_library(s, d, causal, packed):
    b, h = 2, 2
    q, k, v, do = _flash_inputs(b, h, s, d)
    seg = _segments(b, s) if packed else None
    want = _jax_flash(q, k, v, do, causal=causal, seg=seg)
    got = _torch_flash(q, k, v, do, causal=causal, seg=seg)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        # Online softmax by blocks against one softmax, f32: 1e-5.
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_flash_attention_gqa_matches_library_on_repeated_heads():
    """GQA: the port reads kv head h // rep; the library (as the JAX model
    feeds it) takes k/v repeated to every query head, and the repeat's
    transpose sums the group's dk/dv."""
    b, h, kvh, s, d = 1, 4, 2, 128, 64
    q, _, _, do = _flash_inputs(b, h, s, d, seed=5)
    k = _rand((b, kvh, s, d), seed=20)
    v = _rand((b, kvh, s, d), seed=21)
    rep = h // kvh
    want = _jax_flash(q, np.repeat(k, rep, 1), np.repeat(v, rep, 1), do,
                      causal=True, seg=None)
    want[2] = want[2].reshape(b, kvh, rep, s, d).sum(2)
    want[3] = want[3].reshape(b, kvh, rep, s, d).sum(2)
    got = _torch_flash(q, k, v, do, causal=True, seg=None)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# -- the dispatch -------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_multihead_attention_kernel_matches_jax_on_cpu(packed):
    """On the CPU both dispatchers take the masked reference (segment ids
    folded into a dense mask); the port's also reads GQA kv heads."""
    b, h, kvh, s, d = 2, 4, 2, 32, 16
    q = _rand((b, h, s, d))
    k = _rand((b, kvh, s, d), seed=1)
    v = _rand((b, kvh, s, d), seed=2)
    seg = _segments(b, s, seed=3) if packed else None
    want = jax_mha(jnp.asarray(q), jnp.asarray(np.repeat(k, 2, 1)),
                   jnp.asarray(np.repeat(v, 2, 1)), causal=True,
                   segment_ids=None if seg is None else jnp.asarray(seg))
    got = TA.multihead_attention_kernel(
        _t(q), _t(k), _t(v), causal=True,
        segment_ids=None if seg is None else _t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_windowed_attention_is_not_ported_yet():
    """Windowed training is ported (the splash kernel, the chunked path);
    decoding a windowed model is not: the decode modes refuse a sliding
    window rather than attend without it."""
    import dataclasses

    from tensorflow_train_distributed_torch.models import llama as TLL

    cfg = dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny"],
                              sliding_window=4, attention_sinks=2)
    TLL.CausalLmTask(cfg, device="meta")
    model = TLL.LlamaModel(cfg)
    tokens = torch.zeros(1, 8, dtype=torch.long)
    assert model(tokens).shape == (1, 8, cfg.vocab_size)
    with pytest.raises(NotImplementedError, match="sliding window"):
        model(tokens, model.init_cache(1, 16))
