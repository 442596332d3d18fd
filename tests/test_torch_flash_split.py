"""The numerics of K2's and K7's "split" body (f32 at head_dim 64 and 128)
on the CPU.

The body runs every f32 product of attention on the tensor cores: each
f32 operand is split exactly into bf16 terms (``K.bf16_split3``: hi, mid,
lo) and a product a·b is the f32 sum of a chosen set of term products.
The CUDA kernel cannot run here, so this file emulates its arithmetic in
plain PyTorch: the five products (S = QKᵀ, O = PV forward; dP = dO·Vᵀ,
dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K backward, S recomputed) as sums of
bf16 term products, each exact in f32, and the softmax, di and dS in f32.

Two bounds hold the body on the card: the f32 tolerances every f32
attention body meets against the plain version (2e-5 in the output, 1e-4
in the gradients, relative and absolute; ``tests/test_torch_cuda.py``),
and the rule of ``chip_smoke.py`` phase 12, 2^-14 (|ref| + |terms|) +
1e-6 elementwise against f64, where ``terms`` sums the magnitudes an
error in p, dS or o can move (``_reference``).  The tests show that six
products (what the kernel runs: lo·hi + mid·mid + hi·lo + mid·hi + hi·mid
+ hi·hi) meet both with a wide margin on unit-normal inputs and on
all-positive ones (no sign cancels the dropped terms), forward and
backward, against an f64 reference, the plain version and the JAX
package's flash kernel (the Pallas library kernel in interpret mode);
that three products (hi and mid alone) hold the rule but reach a large
share of the f32 tolerances, which the tensor core's truncated sums then
push past; that one product (bf16 alone) misses the rule; and they
record the worst ratios of three products and of one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_train_distributed_torch.ops import kernels as K

# The term products of a·b by count: (term of a, term of b), 0 hi, 1 mid,
# 2 lo; small terms first, as the kernel issues them.
PRODUCTS = {1: [(0, 0)], 3: [(1, 0), (0, 1), (0, 0)],
            6: [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]}
KERNEL_PRODUCTS = 6
NAMES = ("out", "dq", "dk", "dv")


def _mm(a, b, n):
    """a @ b as the f32 sum of n bf16 term products."""
    ta, tb = K.bf16_split3(a), K.bf16_split3(b)
    out = None
    for i, j in PRODUCTS[n]:
        part = ta[i].float() @ tb[j].float()
        out = part if out is None else out + part
    return out


def _mask(s, causal, dtype):
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    return torch.where(keep, 0.0, K.FLASH_MASK_VALUE).to(dtype)


def _split_attention(q, k, v, do, causal, scale, n):
    """The kernel's arithmetic: out, dq, dk, dv from f32 [H, S, D]
    inputs, every product through ``_mm`` with n term products."""
    s = _mm(q, k.transpose(-1, -2), n) * scale + _mask(q.shape[-2], causal,
                                                         torch.float32)
    m = s.amax(-1, keepdim=True)
    pu = torch.exp(s - m)                  # the online softmax's numerator
    l = pu.sum(-1, keepdim=True)
    out = _mm(pu, v, n) / l
    lse = m + torch.log(l)
    di = (do * out).sum(-1, keepdim=True)
    p = torch.exp(s - lse)                 # the backward's recomputation
    ds = p * (_mm(do, v.transpose(-1, -2), n) - di) * scale
    return {"out": out, "dq": _mm(ds, k, n),
            "dk": _mm(ds.transpose(-1, -2), q, n),
            "dv": _mm(p.transpose(-1, -2), do, n)}


def _reference(q, k, v, do, causal, scale):
    """Attention and its gradients in f64, with each output's |terms|
    (``chip_smoke._flash_f32``'s: what a relative error in p, dS or o
    can move)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale
                      + _mask(q.shape[-2], causal, torch.float64), -1)
    out = p @ v
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (do * out).sum(-1, keepdim=True)) * scale
    dio = (do.abs() * out.abs()).sum(-1, keepdim=True)
    pt, dsa = p.transpose(-1, -2), ds.abs()
    return {"out": out, "dq": ds @ k, "dk": ds.transpose(-1, -2) @ q,
            "dv": pt @ do,
            "out_t": p @ v.abs(),
            "dq_t": dsa @ k.abs() + scale * dio * (p @ k.abs()),
            "dk_t": (dsa.transpose(-1, -2) @ q.abs()
                     + scale * pt @ (dio * q.abs())),
            "dv_t": pt @ do.abs()}


def _worst_ratio(got, ref, name, want=None):
    """max |got - want| / (2^-14 (|ref| + |terms|) + 1e-6), want the
    reference's value unless given."""
    want = ref[name] if want is None else want
    allowed = 2.0 ** -14 * (ref[name].abs() + ref[name + "_t"]) + 1e-6
    return float(((got.double() - want.double()).abs() / allowed).max())


def _inputs(s, d, positive, heads=3, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((heads, s, d)).astype(np.float32)
              for _ in range(4)]
    if positive:
        arrays = [np.abs(a) for a in arrays]
    return arrays


CASES = [(s, 64, causal, positive) for s in (128, 256)
         for causal in (False, True) for positive in (False, True)]
CASES.append((256, 128, True, True))


@pytest.mark.parametrize("s,d,causal,positive", CASES)
def test_three_products_hold_the_f32_rule(s, d, causal, positive,
                                          record_property):
    """Three term products (hi and mid alone, one count below the
    kernel's) keep out, dq, dk and dv within 2^-14 (|ref| + |terms|) +
    1e-6 of the f64 values, on unit-normal and all-positive inputs at D 64
    (and one D 128 case), full and causal; one product's worst ratio is
    recorded beside."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(s, d, positive))
    scale = d ** -0.5
    ref = _reference(q, k, v, do, causal, scale)
    got = _split_attention(q, k, v, do, causal, scale, 3)
    ratios = {n: _worst_ratio(got[n], ref, n) for n in NAMES}
    assert max(ratios.values()) <= 1, ratios
    one = _split_attention(q, k, v, do, causal, scale, 1)
    record_property("one_product_worst_ratio",
                    max(_worst_ratio(one[n], ref, n) for n in NAMES))
    record_property("three_product_worst_ratio", max(ratios.values()))


def _plain(q, k, v, do, causal, scale):
    """The plain version's out, dq, dk, dv in f32 (autograd of
    ``K.flash_attention_reference``), what the card's tests compare with."""
    leaves = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
    out = K.flash_attention_reference(*leaves, causal=causal, sm_scale=scale)
    grads = torch.autograd.grad(out, leaves, do[None])
    return dict(zip(NAMES, (t.detach()[0] for t in (out, *grads))))


def _f32_bound_ratio(got, plain):
    """The worst of max |got - want| / (tol + tol |want|) over the outputs,
    tol 2e-5 for out and 1e-4 for the gradients (``assert_close``'s rtol
    and atol in the card's f32 tests)."""
    worst = 0.0
    for name in NAMES:
        tol = 2e-5 if name == "out" else 1e-4
        want = plain[name].double()
        err = (got[name].double() - want).abs() / (tol + tol * want.abs())
        worst = max(worst, float(err.max()))
    return worst


@pytest.mark.parametrize("s,d,causal,positive", CASES)
def test_six_products_hold_the_f32_bounds_and_rule(s, d, causal, positive,
                                                   record_property):
    """Six term products, the kernel's, keep out, dq, dk and dv within a
    fifth of the f32 tolerances of the plain version and of 2^-14 (|ref|
    + |terms|) + 1e-6 of the f64 values, on unit-normal and all-positive
    inputs at D 64 (and one D 128 case), full and causal; three products'
    worst ratio to the f32 tolerances is recorded beside."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(s, d, positive))
    scale = d ** -0.5
    ref = _reference(q, k, v, do, causal, scale)
    plain = _plain(q, k, v, do, causal, scale)
    got = _split_attention(q, k, v, do, causal, scale, KERNEL_PRODUCTS)
    rule = max(_worst_ratio(got[n], ref, n) for n in NAMES)
    bounds = _f32_bound_ratio(got, plain)
    assert rule <= 0.2 and bounds <= 0.2, (rule, bounds)
    three = _split_attention(q, k, v, do, causal, scale, 3)
    record_property("three_product_f32_bound_ratio",
                    _f32_bound_ratio(three, plain))
    record_property("six_product_f32_bound_ratio", bounds)
    record_property("six_product_worst_ratio", rule)


@pytest.mark.parametrize("s,causal,positive", [
    (128, False, False), (256, True, False), (128, False, True),
    (256, True, True)])
def test_one_product_misses_the_f32_rule(s, causal, positive):
    """bf16 alone (hi·hi, the operands rounded to bf16) misses the rule by
    far in every output: the split's middle terms are needed."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(s, 64, positive))
    ref = _reference(q, k, v, do, causal, 0.125)
    got = _split_attention(q, k, v, do, causal, 0.125, 1)
    for name in NAMES:
        assert _worst_ratio(got[name], ref, name) > 4, name


def test_the_split_is_exact_and_six_products_are_f32_close():
    """hi + mid + lo recovers every f32 value exactly, and six products
    (adding hi·lo, mid·mid, lo·hi) come within 2^-20 of f32 products:
    what three drop is the terms of 2^-18 |a||b| and below."""
    a, b = (torch.from_numpy(x[0]) for x in _inputs(256, 64, False)[:2])
    hi, mid, lo = K.bf16_split3(a)
    assert torch.equal(hi.float() + mid.float() + lo.float(), a)
    ref = a.double() @ b.double().t()
    mag = a.double().abs() @ b.double().abs().t()
    six = (_mm(a, b.t(), 6).double() - ref).abs() / mag
    three = (_mm(a, b.t(), 3).double() - ref).abs() / mag
    assert float(six.max()) < 2.0 ** -20
    assert 2.0 ** -20 < float(three.max()) < 2.0 ** -16


def _jax_flash(q, k, v, do, causal):
    """The library flash kernel the JAX package calls, in interpret mode
    (as ``tests/test_torch_train_kernels.py`` runs it), forward and VJP
    over [1, H, S, D]."""
    try:
        from jax.experimental.pallas import tpu as pltpu
        from jax.experimental.pallas.ops.tpu import flash_attention as fa
    except ImportError:
        pytest.skip("pallas tpu ops unavailable")
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("force_tpu_interpret_mode unavailable")
    scale = q.shape[-1] ** -0.5

    def f(q, k, v):
        return fa.flash_attention(q, k, v, causal=causal, sm_scale=scale)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *(jnp.asarray(t[None]) for t in (q, k, v)))
        grads = vjp(jnp.asarray(do[None]))
    return [torch.from_numpy(np.array(t)[0]) for t in (out, *grads)]


@pytest.mark.parametrize("causal", [False, True])
def test_split_holds_the_rule_against_the_library_kernel(causal):
    """The emulated split body against the JAX package's f32 flash kernel
    at BERT's S 128 (full) and a decoder's causal mask: within the same
    rule of the kernel's values, with the f64 |terms| (the library's own
    f32 error is far below it)."""
    arrays = _inputs(128, 64, False, heads=2, seed=3)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    ref = _reference(q, k, v, do, causal, 0.125)
    got = _split_attention(q, k, v, do, causal, 0.125, KERNEL_PRODUCTS)
    want = dict(zip(NAMES, _jax_flash(*arrays, causal)))
    for name in NAMES:
        assert _worst_ratio(got[name], ref, name, want[name]) <= 1, name
