"""The grouped-matmul kernels' plain versions (K6) against megablox.

The JAX side runs the megablox Pallas kernels as the JAX package runs
them on the CPU (``models/moe.py`` ``_gmm``): ``ops.gmm`` (the custom
VJP) and its ``tgmm`` in interpret mode.  The port side is what the
wrappers compute for CPU tensors: ``gmm_reference`` /
``tgmm_reference``, and ``_GmmFn`` whose backward is ``_gmm_bwd``'s
two products.  Interpret mode is slow (~0.6 s a gmm, ~2 s with its
gradient), so shapes stay at m <= 256 rows (megablox needs a multiple
of its 128-row tile: the pad of ``moe.py``) and E <= 4 groups.

Tolerances: f32 values within 1e-5 (the same f32 sums over k <= 96 in
another order); bf16 operands are exact in f32, so bf16 x bf16 within
1e-5 too; an output rounded to bf16 within one bf16 step (2^-7
relative) of the other side's rounding of the same f32 value.
Gradients within 1e-4 abs / 1e-3 rel (``tests/test_moe_gmm.py``).
``K.gmm_tolerance``, the bound of the CUDA kernels, is checked here to
accept f32 sums in another order and reject a bf16-rounded cotangent.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_train_distributed_torch.ops import kernels as K

_MB = "jax.experimental.pallas.ops.tpu.megablox"


def _megablox():
    try:
        ops = importlib.import_module(_MB + ".ops")
    except ImportError:
        pytest.skip("megablox unavailable")
    return ops, ops.backend


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).requires_grad_(
        grad)


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# (m, k, n, group sizes): an empty group, groups that are not multiples
# of a tile, the 128-row pad (a last group that holds only pad rows), k
# and n that are not multiples of a tile.
CASES = {
    "ragged_empty": (256, 64, 96, [100, 0, 28, 128]),
    "pad_only_last": (128, 72, 40, [50, 60, 18]),
    "one_group": (128, 48, 130, [128]),
}


def _inputs(m, k, n, e, transpose_rhs, seed=0):
    lhs = _rand((m, k), seed)
    rhs = _rand((e, n, k) if transpose_rhs else (e, k, n), seed + 1)
    return lhs, rhs


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_reference_matches_megablox(case, dtype):
    ops, _ = _megablox()
    m, k, n, sizes = CASES[case]
    transpose = case == "pad_only_last"
    lhs, rhs = _inputs(m, k, n, len(sizes), transpose)
    gs = np.asarray(sizes, np.int32)
    want = ops.gmm(jnp.asarray(lhs, _JDT[dtype]), jnp.asarray(rhs, _JDT[dtype]),
                   jnp.asarray(gs), preferred_element_type=jnp.float32,
                   transpose_rhs=transpose, interpret=True)
    got = K.gmm(_t(lhs, dtype), _t(rhs, dtype), torch.from_numpy(gs),
                transpose_rhs=transpose)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gmm_rounds_once_to_the_preferred_type():
    ops, _ = _megablox()
    m, k, n, sizes = CASES["ragged_empty"]
    lhs, rhs = _inputs(m, k, n, len(sizes), False, seed=3)
    gs = np.asarray(sizes, np.int32)
    want = ops.gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs),
                   preferred_element_type=jnp.bfloat16, interpret=True)
    got = K.gmm(_t(lhs), _t(rhs), torch.from_numpy(gs),
                preferred_element_type=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("lhs_dtype,rhs_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32)])
def test_tgmm_reference_matches_megablox(lhs_dtype, rhs_dtype):
    """grad_rhs as the backward calls it: lhsᵀ [k, m] (the forward's
    input) against the f32 cotangent; the empty group gets zeros."""
    _, backend = _megablox()
    m, k, n, sizes = CASES["ragged_empty"]
    x = _rand((m, k), 5)
    g = _rand((m, n), 6)
    gs = np.asarray(sizes, np.int32)
    want = backend.tgmm(jnp.asarray(x, _JDT[lhs_dtype]).T,
                        jnp.asarray(g, _JDT[rhs_dtype]), jnp.asarray(gs),
                        jnp.float32, interpret=True)
    got = K.tgmm(_t(x, lhs_dtype).t(), _t(g, rhs_dtype), torch.from_numpy(gs))
    assert got.shape == (len(sizes), k, n)
    assert not got[1].any()                       # the empty group
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case,dtype", [
    ("ragged_empty", torch.float32), ("pad_only_last", torch.float32),
    ("ragged_empty", torch.bfloat16)])
def test_gmm_grads_match_megablox_vjp(case, dtype):
    """``_GmmFn``'s backward against megablox's ``_gmm_bwd`` (grad_lhs in
    lhs's dtype, grad_rhs in rhs's, transposed back when the forward
    read rhs transposed)."""
    ops, _ = _megablox()
    m, k, n, sizes = CASES[case]
    transpose = case == "pad_only_last"
    lhs, rhs = _inputs(m, k, n, len(sizes), transpose, seed=7)
    cot = _rand((m, n), 9)
    gs = np.asarray(sizes, np.int32)

    def f(a, b):
        out = ops.gmm(a, b, jnp.asarray(gs), preferred_element_type=jnp.float32,
                      transpose_rhs=transpose, interpret=True)
        return jnp.sum(out * cot)

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(lhs, _JDT[dtype]),
                                       jnp.asarray(rhs, _JDT[dtype]))
    tl, tr = _t(lhs, dtype, True), _t(rhs, dtype, True)
    out = K.gmm(tl, tr, torch.from_numpy(gs), transpose_rhs=transpose)
    out.backward(_t(cot))
    for got, w in ((tl.grad, want[0]), (tr.grad, want[1])):
        assert got.dtype == dtype
        tol = (dict(atol=1e-4, rtol=1e-3) if dtype == torch.float32
               else dict(atol=1e-2, rtol=2 ** -7))     # one bf16 step
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **tol)
    # The empty group's expert gets a zero gradient.
    if 0 in sizes:
        assert not tr.grad[sizes.index(0)].any()


@pytest.mark.parametrize("transpose", [False, True])
def test_gmm_fn_matches_autograd_of_the_plain_version(transpose):
    """On CPU tensors ``_GmmFn`` runs the plain versions of gmm and tgmm;
    its gradients equal autograd through ``gmm_reference`` (f32: 1e-5)."""
    m, k, n, sizes = CASES["ragged_empty"]
    lhs, rhs = _inputs(m, k, n, len(sizes), transpose, seed=11)
    gs = torch.tensor(sizes, dtype=torch.int32)
    cot = _t(_rand((m, n), 12))
    a1, b1 = _t(lhs, grad=True), _t(rhs, grad=True)
    K.gmm(a1, b1, gs, transpose_rhs=transpose).backward(cot)
    a2, b2 = _t(lhs, grad=True), _t(rhs, grad=True)
    K.gmm_reference(a2, b2, gs, transpose_rhs=transpose).backward(cot)
    for x, y in ((a1.grad, a2.grad), (b1.grad, b2.grad)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_rows_past_the_sizes_are_zero_and_no_kernel_runs_on_cpu():
    lhs = _t(_rand((16, 8)))
    rhs = _t(_rand((2, 8, 4), 1))
    before = K.launch_counts()
    out = K.gmm(lhs, rhs, torch.tensor([5, 6], dtype=torch.int32))
    assert K.launch_counts() == before
    assert not out[11:].any() and out[:11].abs().sum() > 0
    tg = K.tgmm(lhs.t(), _t(_rand((16, 3), 2)),
                torch.tensor([0, 16], dtype=torch.int32))
    assert tg.shape == (2, 8, 3) and not tg[0].any()


def test_gmm_rejects_mismatched_shapes_on_the_kernel_path():
    """The argument checks the CUDA path makes (run here on CPU tensors
    through the same helper)."""
    lhs, gs = torch.zeros(8, 4), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="agree on k"):
        K._gmm_checks("gmm", lhs, torch.zeros(2, 5, 3), gs, False)
    with pytest.raises(ValueError, match="len\\(group_sizes\\)"):
        K._gmm_checks("gmm", lhs, torch.zeros(3, 4, 3), gs, False)
    with pytest.raises(TypeError, match="group_sizes"):
        K._gmm_checks("gmm", lhs, torch.zeros(2, 4, 3),
                      gs.to(torch.int64), False)
    assert K._gmm_checks("gmm", lhs, torch.zeros(2, 3, 4), gs, True) == (
        8, 4, 3)


@pytest.mark.parametrize("kind", ["grad_lhs", "tgmm"])
@pytest.mark.parametrize("variant", [
    "other_f32_order", "bf16_cotangent", "dropped_products"])
def test_gmm_tolerance_accepts_f32_math_and_rejects_shortcuts(kind, variant):
    """``K.gmm_tolerance``, the bound the card holds the kernels to, on the
    backward's products (f32 cotangent, bf16 operand, bf16 output): the
    same f32 sums in another order pass; the cotangent rounded to bf16,
    or 32 of one group's products left out, fail."""
    m, k, n, sizes = 256, 64, 512, [100, 0, 28, 128]
    gs = torch.tensor(sizes, dtype=torch.int32)
    cot = _t(_rand((m, n), 21))
    if kind == "grad_lhs":                 # sums over n, per row
        w = _t(_rand((len(sizes), k, n), 22), torch.bfloat16)
        prod = lambda c, o, dt: K.gmm_reference(
            c, o, gs, preferred_element_type=dt, transpose_rhs=True)
        depth, split = n, torch.arange(n) % 2 == 0
    else:                                  # sums over each group's rows
        w = _t(_rand((m, k), 22), torch.bfloat16)
        prod = lambda c, o, dt: K.tgmm_reference(
            o.t(), c, gs, preferred_element_type=dt)
        depth = torch.tensor(sizes, dtype=torch.float32)[:, None, None]
        split = (torch.arange(m) % 2 == 0)[:, None]
    ref32 = prod(cot, w, torch.float32)
    sumsq32 = prod(cot ** 2, w.float() ** 2, torch.float32)
    if variant == "other_f32_order":
        got = (prod(cot * split, w, torch.float32)
               + prod(cot * ~split, w, torch.float32)).to(torch.bfloat16)
    elif variant == "bf16_cotangent":
        got = prod(cot.to(torch.bfloat16), w, torch.bfloat16)
    else:
        cut = cot.clone()
        if kind == "grad_lhs":
            cut[128:, :32] = 0             # the last group's rows
        else:
            cut[128:160] = 0
        got = prod(cut, w, torch.bfloat16)
    allowed = K.gmm_tolerance(got, ref32, sumsq32, depth, False)
    inside = bool(((got.float() - ref32).abs() <= allowed).all())
    assert inside == (variant == "other_f32_order")


@pytest.mark.parametrize("values", ["normal_range", "zeros_and_signs"])
def test_bf16_split3_reconstructs_f32_exactly(values):
    """The wgmma body's split of an f32 operand into three bf16 terms
    (``K.bf16_split3``, the kernel's arithmetic in plain PyTorch): hi +
    mid + lo equals the value bit for bit, and each term is a bf16."""
    rng = np.random.default_rng(31)
    if values == "normal_range":
        t = torch.from_numpy((rng.standard_normal(4096) * 2.0 ** rng.integers(
            -100, 100, 4096)).astype(np.float32))
    else:
        t = torch.tensor([0.0, -0.0, 1.0, -1.0, 3.0, -2.0 ** -60, 2.0 ** 100,
                          -(1 + 2.0 ** -23), 1 - 2.0 ** -24, 2.0 ** 127])
    terms = K.bf16_split3(t)
    assert all(x.dtype == torch.bfloat16 for x in terms)
    hi, mid, lo = (x.float() for x in terms)
    assert torch.equal((hi + mid) + lo, t)
    assert torch.equal(torch.signbit(hi), torch.signbit(t))


def _split_case(kind, seed=41):
    """All-positive operands at depth 2048, the worst case for the split
    and for the tensor core's truncation: grad_lhs (an f32 cotangent
    [256, 2048] times bf16 rhs [2, 64, 2048] read transposed) or tgmm (bf16
    x [2048, 64] against an f32 cotangent [2048, 64], one group).
    Returns (f32 operand, product of an f32 operand, ref32, sumsq32,
    depth)."""
    rng = np.random.default_rng(seed)
    if kind == "grad_lhs":
        gs = torch.tensor([100, 156], dtype=torch.int32)
        cot = _t(np.abs(_rand((256, 2048), seed)))
        w = _t(np.abs(rng.standard_normal((2, 64, 2048))), torch.bfloat16)
        prod = lambda c: K.gmm_reference(c, w, gs, transpose_rhs=True)
        sumsq = K.gmm_reference(cot ** 2, w.float() ** 2, gs,
                                transpose_rhs=True)
        depth = 2048
    else:
        gs = torch.tensor([2048], dtype=torch.int32)
        cot = _t(np.abs(_rand((2048, 64), seed)))
        x = _t(np.abs(rng.standard_normal((2048, 64))), torch.bfloat16)
        prod = lambda c: K.tgmm_reference(x.t(), c, gs)
        sumsq = K.tgmm_reference(x.float().t() ** 2, cot ** 2, gs)
        depth = torch.tensor([2048.0])[:, None, None]
    return cot, prod, prod(cot), sumsq, depth


@pytest.mark.parametrize("kind", ["grad_lhs", "tgmm"])
@pytest.mark.parametrize("terms", [3, 1])
def test_split_products_hold_the_f32_tolerance(kind, terms, record_property):
    """The numeric argument of the wgmma body on the CPU: the product of
    an f32 operand computed as the sum of the products of its three bf16
    terms (each exact against a bf16 operand, summed in f32) stays within
    ``K.gmm_tolerance(..., tensor_cores=False)``; with one term (phase
    7's bf16-cotangent control) it does not.  How close two terms come
    is recorded (``two_term_worst_ratio``: about 0.6 here, level with
    the f32 sums' own rounding, because the dropped third terms have
    random signs; were they all of one sign, two terms would miss the
    bound by far).  Sums compared in f32."""
    cot, prod, ref32, sumsq32, depth = _split_case(kind)
    parts = [prod(p.float()) for p in K.bf16_split3(cot)]
    # In f32: a bf16 output's half step would hide the sums' errors.
    got = sum(parts[:terms])
    allowed = K.gmm_tolerance(got, ref32, sumsq32, depth, False)
    ratio = float(((got - ref32).abs() / allowed).max())
    assert (ratio <= 1) == (terms == 3), ratio
    if terms == 3:
        two = parts[0] + parts[1]
        two_ratio = float(((two - ref32).abs() / allowed).max())
        record_property("two_term_worst_ratio", two_ratio)
