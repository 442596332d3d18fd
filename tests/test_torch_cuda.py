"""The CUDA kernels against their plain versions across the shapes and
types the smoke test does not reach, and the engine on the card against
the engine on the CPU.  Needs an H100; skips elsewhere.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest loads the JAX package, which the
card's machine does not have; this file imports only the port.)

Tolerances: gathers bitwise; f32 RMSNorm 1e-5 (rsqrtf against torch's
rsqrt, other summation order), bf16 one bf16 step, r within 1e-6 of the
f32 value; K1b's dx within 1e-5 of the f32 value and of its two terms
(the row mean of g s x counted in absolute values: its terms may cancel)
plus one bf16 step in bf16, its dscale within 1e-5 of
sum_rows |g x r| (an f32 column sum in another order) plus one bf16
step for a bf16 scale; f32 paged attention 2e-5 (online softmax against one
softmax); bf16 queries 3e-2 against the plain version (it rounds logits
and weights to bf16, the kernel keeps f32), and K4's ring body within
2^-8 |ref32| + 2e-5 of the f32 math on the pools as it reads them (one
rounding of the output).  Training kernels: f32 RMSNorm
and cross-entropy gradients 1e-5 (row sums in another order), at every
offset of a row from a vector boundary; f32 flash attention 2e-5 in the
output and 1e-4 in the gradients (sums over up to 512 keys or queries,
in tiles), on the FMA body (D 256) and on the split body (D 64 and 128:
each f32 product as six bf16 term products on the tensor cores, which
drop 2^-27 |a||b| and less), the split body also within the rule
``chip_smoke.py`` holds it to, 2^-14 (|ref| + |terms|) + 1e-6 of f64
attention (its derivation there and in tests/test_torch_flash_split.py);
bf16 3e-2 (the kernel and the plain
version round p, dS and their outputs to bf16 at other places).  The
splash kernel (K7) to the same tolerances, and bit for bit to the flash
kernel where its window reaches past the sequence.
Grouped matmul (gmm, tgmm): held to ``K.gmm_tolerance`` of the f32
values: 16·sqrt(K)·2^-24·sqrt(Σ(a·b)²) over the K products of each
output (f32 sums in another order), plus K/2 of the same unit on the
tensor cores (each 16-deep step truncates), plus half a bf16 step of the
value when the output is bf16.
"""

import dataclasses
import threading

import pytest
import torch

from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS
from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100): see the module docstring")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("rows,d,x_dtype,s_dtype", [
    (300, 128, torch.float32, torch.float32),
    (7, 1000, torch.float32, torch.bfloat16),
    (5, 4096, torch.bfloat16, torch.float32),
    (1, 64, torch.bfloat16, torch.bfloat16)])
def test_rms_norm_kernel(gen, rows, d, x_dtype, s_dtype):
    x = _randn(gen, rows, d, dtype=x_dtype)
    s = (1 + 0.1 * _randn(gen, d)).to(s_dtype)
    before = K.launch_counts()["rms_norm"]
    got = K.rms_norm(x, s)
    assert K.launch_counts()["rms_norm"] == before + 1
    want = K.rms_norm_reference(x, s)
    tol = 1e-5 if x_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _pool(gen, lanes, q_len, heads, kvh, hd, nb=21, bs=4, n_blk=5,
          dtype=torch.float32, lengths=None):
    q = _randn(gen, lanes, q_len, heads, hd, dtype=dtype)
    kp = _randn(gen, nb, bs, kvh, hd, dtype=dtype)
    vp = _randn(gen, nb, bs, kvh, hd, dtype=dtype)
    table = torch.randint(0, nb, (lanes, n_blk), generator=gen,
                          device="cuda", dtype=torch.int32)
    if lengths is None:
        lengths = torch.randint(0, n_blk * bs - q_len + 1, (lanes,),
                                generator=gen, device="cuda",
                                dtype=torch.int32)
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("heads,kvh,q_len,hd,bs,n_blk", [
    (4, 2, 1, 8, 4, 5), (4, 1, 3, 8, 4, 5), (2, 2, 2, 128, 16, 6),
    (8, 1, 4, 256, 16, 4),         # Gemma-2b-like MQA at hd 256
    (4, 2, 2, 6, 3, 7),            # rows not a whole 16-byte vector
    (32, 32, 1, 128, 16, 40),      # Llama-2-7B decode: up to 10 tiles
    (4, 2, 3, 64, 16, 64)])        # GQA, q_len 3, a 1,024-row lane
def test_paged_attention_kernel_f32(gen, heads, kvh, q_len, hd, bs, n_blk):
    args = _pool(gen, 3, q_len, heads, kvh, hd, nb=3 * n_blk + 1, bs=bs,
                 n_blk=n_blk)
    got = K.paged_attention(*args)
    want = K.paged_attention_reference(*args)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_paged_attention_kernel_cache_len_and_ragged(gen):
    q, kp, vp, table, _ = _pool(gen, 4, 2, 4, 2, 16)
    lengths = torch.tensor([0, 7, 16, 18], dtype=torch.int32, device="cuda")
    for c in (20, 18, 13):
        got = K.paged_attention(q, kp, vp, table, lengths, cache_len=c)
        want = K.paged_attention_reference(q, kp, vp, table, lengths,
                                           cache_len=c)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_paged_attention_kernel_stale_lane_isolated(gen):
    q, kp, vp, table, lengths = _pool(gen, 3, 1, 4, 2, 16)
    clean = K.paged_attention(q, kp, vp, table, lengths)
    dirty_table = table.clone()
    dirty_table[1] = torch.tensor([20, 20, 3, 1, 2], dtype=torch.int32)
    dirty = K.paged_attention(q, kp, vp, dirty_table, lengths)
    assert torch.equal(clean[0], dirty[0]) and torch.equal(clean[2],
                                                           dirty[2])


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,n_blk", [(4, 5), (16, 40)])   # 1 and up to 10 tiles
def test_paged_attention_kernel_int8(gen, q_dtype, bs, n_blk):
    nb, kvh, hd = 3 * n_blk + 1, 2, 32
    q, _, _, table, lengths = _pool(gen, 3, 2, 4, kvh, hd, nb=nb, bs=bs,
                                    n_blk=n_blk, dtype=q_dtype)
    kp = torch.randint(-127, 128, (nb, bs, kvh, hd), generator=gen,
                       device="cuda", dtype=torch.int8)
    vp = torch.randint(-127, 128, (nb, bs, kvh, hd), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand(nb, bs, kvh, generator=gen, device="cuda") / 127 + 1e-3
    vs = torch.rand(nb, bs, kvh, generator=gen, device="cuda") / 127 + 1e-3
    got = K.paged_attention(q, kp, vp, table, lengths, k_scales=ks,
                            v_scales=vs)
    want = K.paged_attention_reference(q, kp, vp, table, lengths,
                                       k_scales=ks, v_scales=vs)
    tol = 2e-5 if q_dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


# -- K4's ring body (bf16 and int8 pools at hd 64/128) ---------------------


def _ring_args(gen, lengths, *, heads=4, kvh=2, q_len=1, hd=128, bs=16,
               n_blk=40, q_dtype=torch.float32, int8=False):
    """Lanes of the given lengths over a shuffled pool; bf16 pools (int8
    with f32 scales when ``int8``).  Returns (args, scale kwargs)."""
    lanes = len(lengths)
    nb = lanes * n_blk + 1
    q = _randn(gen, lanes, q_len, heads, hd, dtype=q_dtype)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    table = perm[:lanes * n_blk].view(lanes, n_blk).to(torch.int32)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if not int8:
        kp = _randn(gen, nb, bs, kvh, hd, dtype=torch.bfloat16)
        vp = _randn(gen, nb, bs, kvh, hd, dtype=torch.bfloat16)
        return (q, kp, vp, table, lengths), {}
    kp, vp = (torch.randint(-127, 128, (nb, bs, kvh, hd), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand(nb, bs, kvh, generator=gen, device="cuda") / 127
              + 1e-3 for _ in range(2))
    return (q, kp, vp, table, lengths), dict(k_scales=ks, v_scales=vs)


def _ring_ref32(args, kw, cache_len=None):
    """The kernel's math in f32: pools as the kernel reads them (int8
    dequantised through q's dtype), the scale rounded to q's dtype."""
    q, kp, vp, table, lengths = args
    hd = q.shape[-1]
    if kw:
        kp = kp.to(q.dtype) * kw["k_scales"][..., None].to(q.dtype)
        vp = vp.to(q.dtype) * kw["v_scales"][..., None].to(q.dtype)
    rescale = (torch.tensor(hd ** -0.5, dtype=q.dtype).item()
               / torch.tensor(hd ** -0.5).item())
    return K.paged_attention_reference(
        q.float() * rescale, kp.float(), vp.float(), table, lengths,
        cache_len=cache_len)


def _assert_ring_close(got, ref32):
    """f32 queries: 2e-5 (another summation order); bf16: one rounding of
    the output (2^-8 of the value) on top."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, ref32, rtol=2e-5, atol=2e-5)
    else:
        assert ((got.float() - ref32).abs()
                <= 2 ** -8 * ref32.abs() + 2e-5).all()


def test_paged_attention_body_choice(gen):
    q = _randn(gen, 2, 1, 32, 128, dtype=torch.bfloat16)
    pool = _randn(gen, 9, 16, 32, 128, dtype=torch.bfloat16)
    assert K.paged_attention_body(q, pool, pool) == "ring"
    assert K.paged_attention_body(q, pool.float(), pool.float()) == "staged"
    assert K.paged_attention_body(q, pool.to(torch.int8)) == "ring"
    q64 = _randn(gen, 2, 3, 8, 64)                   # R = 4 * 3 = 12 > 8
    pool64 = _randn(gen, 9, 16, 2, 64, dtype=torch.bfloat16)
    assert K.paged_attention_body(q64, pool64) == "staged"
    assert K.paged_attention_body(q64[:, :2], pool64) == "ring"   # R 8
    odd = _randn(gen, 2, 1, 2, 32, dtype=torch.bfloat16)
    assert K.paged_attention_body(odd, pool64[..., :32].contiguous()) == \
        "staged"
    flat = torch.empty(9 * 16 * 2 * 64 + 1, dtype=torch.bfloat16,
                       device="cuda")
    misaligned = flat[1:].view(9, 16, 2, 64)
    assert K.paged_attention_body(q64[:, :1], misaligned) == "staged"


def test_paged_attention_chunk_rows_match_the_library(gen):
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    assert K.PAGED_CHUNK_ROWS == library().ttd_paged_attention_chunk_rows()


@pytest.mark.parametrize("heads,kvh,q_len,hd", [
    (32, 32, 1, 128),              # Llama-2-7B decode (R = 1)
    (4, 4, 1, 64), (6, 2, 1, 128),  # R = 1, R = 3
    (4, 2, 3, 64), (8, 2, 2, 128)])  # R = 6, R = 8
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_ring_chunk_boundaries(gen, heads, kvh, q_len, hd,
                                               q_dtype):
    """Lanes whose last visible row falls on each side of one and two
    chunks, a lane of length 0 and lanes at cache_len - 1: every block of
    a lane's chunks, the direct write and the ticket merge."""
    C = K.PAGED_CHUNK_ROWS
    c = 40 * 16
    lengths = [0, C - q_len - 1, C - q_len, C - q_len + 1, 2 * C - q_len,
               2 * C - q_len + 1, c - q_len, c - 1]
    args, kw = _ring_args(gen, lengths, heads=heads, kvh=kvh, q_len=q_len,
                          hd=hd, q_dtype=q_dtype)
    assert K.paged_attention_body(args[0], args[1], args[2]) == "ring"
    before = K.launch_counts()["paged_attention"]
    got = K.paged_attention(*args)
    assert K.launch_counts()["paged_attention"] == before + 1
    _assert_ring_close(got, _ring_ref32(args, kw))


@pytest.mark.parametrize("cache_len", [629, 513, 257, 250])
def test_paged_attention_ring_cache_len_mid_block(gen, cache_len):
    """cache_len cut inside a pool block (and at a chunk's edge): rows at
    or past it do not exist, even where a lane's length reaches them."""
    lengths = [0, 100, 249, 256, 300, 628, 639]
    args, kw = _ring_args(gen, lengths, q_len=2)
    got = K.paged_attention(*args, cache_len=cache_len)
    _assert_ring_close(got, _ring_ref32(args, kw, cache_len))


def test_paged_attention_ring_stale_lane_isolated(gen):
    """A lane whose table holds ids past the pool (and negative ones) reads
    only pool rows and leaves the other lanes bit for bit as they were."""
    args, _ = _ring_args(gen, [300, 20, 600])
    q, kp, vp, table, lengths = args
    clean = K.paged_attention(*args)
    dirty_table = table.clone()
    dirty_table[1] = torch.arange(40, device="cuda", dtype=torch.int32) * \
        7919 - 1000
    dirty = K.paged_attention(q, kp, vp, dirty_table, lengths)
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean[0], dirty[0]) and torch.equal(clean[2],
                                                           dirty[2])


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_paged_attention_ring_int8(gen, q_dtype, hd):
    args, kw = _ring_args(gen, [0, 255, 256, 600], q_len=2, hd=hd,
                          q_dtype=q_dtype, int8=True)
    assert K.paged_attention_body(args[0], args[1], args[2]) == "ring"
    got = K.paged_attention(*args, **kw)
    _assert_ring_close(got, _ring_ref32(args, kw))
    want = K.paged_attention_reference(*args, **kw)
    tol = 2e-5 if q_dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_ring_is_deterministic(gen, int8):
    """Lanes over one to three chunks: the same call twice, bit for bit
    (the last block merges the chunks in chunk order)."""
    args, kw = _ring_args(gen, [639, 300, 511, 5, 600, 257], heads=32,
                          kvh=32, q_dtype=torch.bfloat16, int8=int8)
    first = K.paged_attention(*args, **kw)
    for _ in range(3):
        assert torch.equal(K.paged_attention(*args, **kw), first)


def test_paged_attention_bodies_agree(gen):
    """The staged body forced on the ring body's inputs: both within the
    f32 reference's tolerance; a forced ring body where it does not apply
    raises."""
    args, kw = _ring_args(gen, [0, 40, 300, 639], heads=8, kvh=4, q_len=2)
    ref32 = _ring_ref32(args, kw)
    for body in ("ring", "staged"):
        _assert_ring_close(K.paged_attention(*args, body=body), ref32)
    q, kp, vp, table, lengths = args
    with pytest.raises(ValueError, match="body"):
        K.paged_attention(q, kp.float(), vp.float(), table, lengths,
                          body="ring")


# -- K1f's warp body ----------------------------------------------------------


def _rms_checks(x, s, y, r):
    ref = K.rms_norm_reference(x, s)
    if x.dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    else:   # f32 math rounded once to bf16: one bf16 step
        assert ((y.float() - ref.float()).abs()
                <= 2 ** -7 * ref.float().abs() + 1e-6).all()
    r32 = torch.rsqrt(x.float().square().mean(-1) + 1e-5)
    assert ((r - r32).abs() <= 1e-6 * r32).all()


@pytest.mark.parametrize("rows", [64, 67, 4101, 20001])
@pytest.mark.parametrize("d", [768, 4096])
@pytest.mark.parametrize("x_dtype,s_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
def test_rms_norm_warp_body(gen, rows, d, x_dtype, s_dtype):
    """Row counts from the body's 64 up, off the block's 4 rows and past
    one row per resident warp (the grid stride), d 768 (scale held in registers) and 4096
    (staged in shared memory); y within the plain version's tolerance, r within
    1e-6 of the f32 value."""
    x = (3 * _randn(gen, rows, d)).to(x_dtype)
    s = (1 + 0.1 * _randn(gen, d)).to(s_dtype)
    assert K.rms_norm_body(x, s) == "warp"
    before = K.launch_counts()["rms_norm"]
    y, r = K.rms_norm_forward(x, s, 1e-5, with_r=True)
    assert K.launch_counts()["rms_norm"] == before + 1
    _rms_checks(x, s, y, r)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_block_body_cases(gen, x_dtype):
    """d 1000 (not whole 16-byte vectors a lane), a misaligned view and a
    decode step's 8 rows take the block body; all still match, and a
    forced warp body raises where it does not apply."""
    few = _randn(gen, 8, 4096, dtype=x_dtype)
    s = (1 + 0.1 * _randn(gen, 4096)).to(x_dtype)
    assert K.rms_norm_body(few, s) == "block"
    _rms_checks(few, s, *K.rms_norm_forward(few, s, 1e-5, with_r=True))
    x = _randn(gen, 33, 1000, dtype=x_dtype)
    s = (1 + 0.1 * _randn(gen, 1000)).to(x_dtype)
    assert K.rms_norm_body(x, s) == "block"
    _rms_checks(x, s, *K.rms_norm_forward(x, s, 1e-5, with_r=True))
    flat = _randn(gen, 65 * 768 + 1, dtype=x_dtype)
    view = flat[1:].view(65, 768)
    s = (1 + 0.1 * _randn(gen, 768)).to(x_dtype)
    assert view.is_contiguous() and K.rms_norm_body(view, s) == "block"
    _rms_checks(view, s, *K.rms_norm_forward(view, s, 1e-5, with_r=True))
    with pytest.raises(ValueError, match="body"):
        K.rms_norm_forward(view, s, 1e-5, with_r=True, body="warp")


@pytest.mark.parametrize("rows", [8, 515])
def test_rms_norm_bodies_agree(gen, rows):
    """Both bodies forced on the same rows (the warp body also below the
    64 rows from which the library takes it)."""
    x = _randn(gen, rows, 4096, dtype=torch.bfloat16)
    s = (1 + 0.1 * _randn(gen, 4096)).to(torch.bfloat16)
    for body in ("warp", "block"):
        _rms_checks(x, s, *K.rms_norm_forward(x, s, 1e-5, with_r=True,
                                              body=body))


@pytest.mark.parametrize("shape,dtype", [
    ((9, 4, 2, 8), torch.float32), ((9, 4, 3, 1), torch.float32),
    ((7, 3, 5, 7), torch.int8), ((6, 16, 32, 128), torch.bfloat16)])
def test_paged_kv_gather_kernel_bitwise(gen, shape, dtype):
    pool = _randn(gen, *shape).mul(40).to(dtype)
    table = torch.randint(0, shape[0], (3, 4), generator=gen, device="cuda",
                          dtype=torch.int32)
    for c in (4 * shape[1], 4 * shape[1] - 1, 1):
        got = K.paged_kv_gather(pool, table, c)
        assert torch.equal(got, K.paged_kv_gather_reference(pool, table, c))


def _gather_ref(pool, table, c):
    """The reference on the clamped table (the kernels clamp a physical id
    into the pool; the reference would index past it)."""
    return K.paged_kv_gather_reference(pool, table.clamp(0, pool.shape[0] - 1),
                                       c)


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("shape,dtype", [
    ((129, 16, 32, 128), torch.bfloat16),    # Llama-2-7B's pool rows
    ((129, 16, 32, 1), torch.float32),       # the int8 engine's scale pool
    ((129, 16, 8, 64), torch.int8),
    ((40, 4, 2, 8), torch.float32)])
def test_paged_kv_gather_bodies_bitwise(gen, lanes, shape, dtype):
    """Both bodies on an aligned pool of whole 16-byte rows (the
    library's choice first) are bitwise equal to the reference: whole
    tables, cache_len off the block size, one row."""
    nb, bs = shape[0], shape[1]
    pool = _randn(gen, *shape).mul(40).to(dtype)
    n_blk = 16
    table = torch.randint(1, nb, (lanes, n_blk), generator=gen,
                          device="cuda", dtype=torch.int32)
    assert K.paged_kv_gather_body(pool) != "block"
    for body in (None,) + K.PAGED_KV_GATHER_BODIES:
        for c in (n_blk * bs, n_blk * bs - 3, bs + 1, 1):
            got = K.paged_kv_gather(pool, table, c, body=body)
            assert torch.equal(got, _gather_ref(pool, table, c)), (body, c)


def test_paged_kv_gather_clamps_repeated_and_out_of_range_ids(gen):
    pool = _randn(gen, 20, 16, 4, 32).to(torch.bfloat16)
    table = torch.tensor([[3, 3, -5, 19, 20, 400, 0, 3],
                          [7, -1, 2, 2, 2, 55, 19, 1]], dtype=torch.int32,
                         device="cuda")
    for body in K.PAGED_KV_GATHER_BODIES:
        for c in (128, 77):
            got = K.paged_kv_gather(pool, table, c, body=body)
            assert torch.equal(got, _gather_ref(pool, table, c)), (body, c)


def test_paged_kv_gather_odd_rows_and_misaligned_views_take_the_block_body(
        gen):
    """Rows that are not whole 16-byte vectors (int8 kvh*hd 35, f32 rows
    of 3 values) and a pool view at an odd offset take the block body,
    bitwise; forcing the bulk body on them raises."""
    table = torch.randint(0, 7, (3, 4), generator=gen, device="cuda",
                          dtype=torch.int32)
    odd = _randn(gen, 7, 3, 5, 7).mul(40).to(torch.int8)
    f3 = _randn(gen, 7, 3, 3, 1)
    flat = _randn(gen, 7 * 3 * 4 * 8 + 1)
    view = flat[1:].view(7, 3, 4, 8)
    for pool in (odd, f3, view):
        assert pool.is_contiguous()
        assert K.paged_kv_gather_body(pool) == "block"
        assert torch.equal(K.paged_kv_gather(pool, table, 10),
                           _gather_ref(pool, table, 10))
        with pytest.raises(ValueError, match="body"):
            K.paged_kv_gather(pool, table, 10, body="bulk")


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    x = _randn(gen, 4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        K.rms_norm(x.t(), torch.ones(4, device="cuda"))
    with pytest.raises(TypeError, match="dtype"):
        K.rms_norm(x.half(), torch.ones(8, device="cuda"))


@pytest.mark.parametrize("kv_int8", [False, True])
def test_engine_on_card_matches_engine_on_cpu(gen, kv_int8):
    """llama_tiny at f32: greedy tokens on the card (all three kernels)
    equal the CPU engine's (their plain versions)."""
    cfg = dataclasses.replace(LLAMA_PRESETS["llama_tiny"],
                              kv_cache_int8=kv_int8)
    params = convert.init_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    pre = list(range(1, 9))
    reqs = [(pre + [20], 6), ([5, 6, 7, 8, 9], 5), (pre + [30, 31], 4),
            (list(range(40, 52)), 7), ([70, 71, 72], 1)]
    outs = []
    for device in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params, slots=2, cache_len=64, chunk=2,
                            prompt_buckets=(8, 16), kv_block_size=4,
                            device=device)
        K.reset_launch_counts()
        ids = [eng.submit(p, m) for p, m in reqs]
        out = eng.run()
        outs.append([out[i] for i in ids])
        if device == "cuda":
            counts = K.launch_counts()
            assert min(counts[k] for k in ("rms_norm", "paged_attention",
                                           "paged_kv_gather")) > 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("draft,kw", [
    ("self", dict(speculative_k=3)),
    ("scan", dict(speculative_k=3)),
    ("scan", dict(speculative_k=4, spec_depths=(0, 2, 4))),
    ("scan", dict(speculative_k=3, overlap=False, prefill_budget=0))])
def test_spec_engine_on_card_matches_engine_on_cpu(gen, draft, kw):
    """llama_tiny with a draft (itself, or llama_tiny_scan from another
    seed) at f32: greedy tokens and spec_stats on the card (K4 at q_len
    k+1 and on the draft's pool, K5 on both pools, the pipelined
    scheduler's pinned copies and events) equal the CPU engine's."""
    cfg = LLAMA_PRESETS["llama_tiny"]
    dcfg = LLAMA_PRESETS["llama_tiny" if draft == "self" else
                         "llama_tiny_scan"]
    params = convert.init_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    dparams = (params if draft == "self" else convert.init_params(
        dcfg, torch.Generator().manual_seed(4), device="cpu"))
    pre = list(range(1, 9))
    reqs = [(pre + [20], 6), ([5, 6, 7, 8, 9], 9), (pre + [30, 31], 7),
            (list(range(40, 52)), 8), ([70, 71, 72], 1)]
    outs, stats = [], []
    for device in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params, slots=2, cache_len=64, chunk=2,
                            prompt_buckets=(8, 16), kv_block_size=4,
                            draft_config=dcfg, draft_params=dparams,
                            device=device, **kw)
        K.reset_launch_counts()
        ids = [eng.submit(p, m) for p, m in reqs]
        out = eng.run()
        outs.append([out[i] for i in ids])
        stats.append(dict(eng.spec_stats))
        if device == "cuda":
            counts = K.launch_counts()
            assert min(counts[k] for k in ("rms_norm", "paged_attention",
                                           "paged_kv_gather")) > 0
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]


def test_stream_uniforms_on_card_equal_cpu(gen):
    from tensorflow_train_distributed_torch.serving import stream_uniforms

    seeds = torch.randint(0, 2 ** 32, (64,), generator=torch.Generator()
                          .manual_seed(0))
    counts = torch.arange(64) * 37
    for draw in (-1, 0, 5):
        cpu = stream_uniforms(seeds, counts, draw, 1000)
        card = stream_uniforms(seeds.cuda(), counts.cuda(), draw, 1000)
        assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("q_len", range(2, 9))
@pytest.mark.parametrize("hd,q_dtype", [(128, torch.bfloat16),
                                        (64, torch.float32)])
def test_paged_attention_verify_q_len_on_ring(gen, q_len, hd, q_dtype):
    """The speculative verify's shape at Llama-2-7B's one head a kv group:
    q_len k+1 up to 8 rows a group stays on the ring body; lanes across
    chunk edges and at the cache's end."""
    C = K.PAGED_CHUNK_ROWS
    lengths = [0, C - q_len, C + 3, 2 * C - 1, 40 * 16 - q_len]
    args, kw = _ring_args(gen, lengths, heads=8, kvh=8, q_len=q_len, hd=hd,
                          q_dtype=q_dtype)
    assert K.paged_attention_body(*args[:3]) == "ring"
    got = K.paged_attention(*args)
    _assert_ring_close(got, _ring_ref32(args, kw))
    if q_dtype == torch.bfloat16:   # the plain version's own types
        want = K.paged_attention_reference(*args)
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                   atol=3e-2)


@pytest.mark.parametrize("heads,kvh,q_len", [(32, 8, 5), (8, 8, 9),
                                             (32, 8, 2)])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_verify_past_eight_rows_on_staged(gen, heads, kvh,
                                                          q_len, int8):
    """More than 8 query rows a kv group (a GQA target's verify, or depth
    8 and above): the staged body serves them, int8 pools too."""
    args, kw = _ring_args(gen, [0, 100, 300, 639 - q_len], heads=heads,
                          kvh=kvh, q_len=q_len, q_dtype=torch.bfloat16,
                          int8=int8)
    body = K.paged_attention_body(*args[:3])
    assert body == ("ring" if heads // kvh * q_len <= 8 else "staged")
    got = K.paged_attention(*args, **kw)
    if body == "ring":
        _assert_ring_close(got, _ring_ref32(args, kw))
    want = K.paged_attention_reference(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


def test_paged_attention_refuses_a_shape_no_body_serves(gen):
    """Rows a kv group past the staged body's shared memory raise; no
    plain fallback runs on the card."""
    args, _ = _ring_args(gen, [10, 20], heads=64, kvh=1, q_len=16, hd=256,
                         q_dtype=torch.bfloat16)
    before = K.launch_counts()["paged_attention"]
    with pytest.raises(ValueError, match="shared memory"):
        K.paged_attention(*args)
    assert K.launch_counts()["paged_attention"] == before


# -- training kernels ---------------------------------------------------------


def _grads(fn, inputs, cotangent):
    """(output, grads of ``inputs``) of ``fn`` under autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, cotangent)
    return out.detach(), grads


@pytest.mark.parametrize("rows,d,dtype", [
    (300, 128, torch.float32), (7, 768, torch.bfloat16),
    (1, 4096, torch.float32), (513, 1000, torch.bfloat16)])
def test_rms_norm_autograd_matches_plain(gen, rows, d, dtype):
    """K1f with r and K1b through the autograd Function against autograd
    of the plain version: dx from the kernel, dscale from the kernel (the
    warp body) or the column sum (the block body), in the scale's
    dtype."""
    x = _randn(gen, rows, d, dtype=dtype)
    s = (1 + 0.1 * _randn(gen, d)).to(dtype)
    g = _randn(gen, rows, d, dtype=dtype)
    before = K.launch_counts()
    y, (dx, ds) = _grads(K.rms_norm, (x, s), g)
    after = K.launch_counts()
    assert after["rms_norm"] == before["rms_norm"] + 1
    assert after["rms_norm_bwd"] == before["rms_norm_bwd"] + 1
    y_ref, (dx_ref, ds_ref) = _grads(K.rms_norm_reference, (x, s), g)
    assert dx.dtype == dtype and ds.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for got, want in ((y, y_ref), (dx, dx_ref)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    # dscale sums over every row: 1e-4 of the column sums in f32.
    torch.testing.assert_close(ds.float(), ds_ref.float(),
                               rtol=max(tol, 1e-4), atol=max(tol, 1e-4))


def _rms_bwd_inputs(gen, rows, d, x_dtype, s_dtype):
    x = (3 * _randn(gen, rows, d)).to(x_dtype)
    s = (1 + 0.1 * _randn(gen, d)).to(s_dtype)
    g = _randn(gen, rows, d).to(x_dtype)
    _, r = K.rms_norm_forward(x, s, 1e-5, with_r=True)
    return x, s, r, g


def _rms_bwd_checks(x, s, r, g, dx, ds):
    """dx and ds against ``rms_norm_backward_reference`` on the same r.
    dx: 1e-5 of the f32 value and of the two terms of r g s - x r^3 c,
    with c = mean(g s x) counted as mean |g s x| (a row sum in another
    order, whose terms may cancel), plus one bf16 step of the value in
    bf16.  ds: 1e-5 of sum_rows |g x r| (an f32 column sum in another
    order), plus one bf16 step in bf16."""
    dx_ref, ds_ref = K.rms_norm_backward_reference(x, s, r, g)
    x32, g32, s32, r32 = x.float(), g.float(), s.float(), r[:, None]
    dx32 = K.rms_norm_backward_reference(x32, s32, r, g32)[0]
    c_mass = (g32 * s32 * x32).abs().mean(-1, keepdim=True)
    terms = (r32 * g32 * s32).abs() + (x32 * r32 ** 3).abs() * c_mass
    step = 2 ** -7 if x.dtype == torch.bfloat16 else 0.0
    assert dx.dtype == x.dtype and ds.dtype == s.dtype
    assert ((dx.float() - dx32).abs()
            <= step * dx32.abs() + 1e-5 * (dx32.abs() + terms)).all()
    assert ((dx.float() - dx_ref.float()).abs()
            <= (dx_ref.float() - dx32).abs() + step * dx32.abs()
            + 1e-5 * (dx32.abs() + terms)).all()
    ds32 = torch.einsum("nd,nd->d", g32, x32 * r32)
    mass = torch.einsum("nd,nd->d", g32.abs(), (x32 * r32).abs())
    sstep = 2 ** -7 if s.dtype == torch.bfloat16 else 0.0
    assert ((ds.float() - ds32).abs()
            <= sstep * ds32.abs() + 1e-5 * mass).all()
    assert ((ds.float() - ds_ref.float()).abs()
            <= sstep * ds32.abs() + 1e-5 * mass).all()


@pytest.mark.parametrize("rows", [1, 7, 64, 300, 16384])
@pytest.mark.parametrize("d", [768, 4096])
@pytest.mark.parametrize("x_dtype,s_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_rms_norm_backward_kernel(gen, rows, d, x_dtype, s_dtype):
    """K1b's dx and ds from the kernel (the warp body from 64 rows, d 768
    with the sums in registers and 4096 in shared memory; f32 rows of 4096
    read x and g again for the write) against the plain version."""
    x, s, r, g = _rms_bwd_inputs(gen, rows, d, x_dtype, s_dtype)
    body = K.rms_norm_bwd_body(x, s, g)
    assert body == ("warp" if rows >= 64 else "block")
    before = K.launch_counts()["rms_norm_bwd"]
    dx, ds = K.rms_norm_backward(x, s, r, g)
    assert K.launch_counts()["rms_norm_bwd"] == before + 1
    _rms_bwd_checks(x, s, r, g, dx, ds)


@pytest.mark.parametrize("d,x_dtype", [(768, torch.bfloat16),
                                       (4096, torch.bfloat16),
                                       (4096, torch.float32)])
def test_rms_norm_backward_is_repeatable_and_ds_optional(gen, d, x_dtype):
    """The warp body's dx and ds are bitwise repeatable (no atomics), and
    with no ds it writes the same dx."""
    x, s, r, g = _rms_bwd_inputs(gen, 5000, d, x_dtype, torch.bfloat16)
    dx, ds = K.rms_norm_backward(x, s, r, g)
    dx2, ds2 = K.rms_norm_backward(x, s, r, g)
    dx3, none = K.rms_norm_backward(x, s, r, g, with_ds=False)
    assert none is None
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    assert torch.equal(dx, dx3)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_backward_body_choice(gen, x_dtype):
    """d 1000 and a view at an odd offset take the block body (dscale
    from the column sum); both bodies forced on the same rows agree; a
    forced warp body raises where it does not apply."""
    x, s, r, g = _rms_bwd_inputs(gen, 300, 1000, x_dtype, x_dtype)
    assert K.rms_norm_bwd_body(x, s, g) == "block"
    _rms_bwd_checks(x, s, r, g, *K.rms_norm_backward(x, s, r, g))
    with pytest.raises(ValueError, match="body"):
        K.rms_norm_backward(x, s, r, g, body="warp")
    flat = _randn(gen, 300 * 768 + 1, dtype=x_dtype)
    view = flat[1:].view(300, 768)
    s = (1 + 0.1 * _randn(gen, 768)).to(x_dtype)
    g = _randn(gen, 300, 768, dtype=x_dtype)
    _, r = K.rms_norm_forward(view, s, 1e-5, with_r=True)
    assert view.is_contiguous() and K.rms_norm_bwd_body(view, s, g) == "block"
    _rms_bwd_checks(view, s, r, g, *K.rms_norm_backward(view, s, r, g))
    with pytest.raises(ValueError, match="body"):
        K.rms_norm_backward(view, s, r, g, body="warp")
    x, s, r, g = _rms_bwd_inputs(gen, 300, 768, x_dtype, x_dtype)
    for body in ("warp", "block"):
        _rms_bwd_checks(x, s, r, g, *K.rms_norm_backward(x, s, r, g,
                                                         body=body))


@pytest.mark.parametrize("n,v,dtype", [
    (300, 3000, torch.float32), (5, 3000, torch.bfloat16),
    (64, 32000, torch.float32), (3, 4099, torch.float32)])
def test_cross_entropy_autograd_matches_plain(gen, n, v, dtype):
    """K3f and K3b against autograd of the plain version, at V = 3000 (not
    a multiple of the TPU kernel's 2048-column block), an odd V (the
    scalar path) and bf16 logits."""
    logits = (4 * _randn(gen, n, v)).to(dtype)
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda",
                           dtype=torch.int32)
    w = torch.rand(n, generator=gen, device="cuda")
    before = K.launch_counts()
    loss, (dl,) = _grads(lambda lg: K.cross_entropy(lg, labels), (logits,),
                         w)
    after = K.launch_counts()
    assert after["cross_entropy"] == before["cross_entropy"] + 1
    assert after["cross_entropy_bwd"] == before["cross_entropy_bwd"] + 1
    ref, (dl_ref,) = _grads(lambda lg: K.cross_entropy_reference(lg, labels),
                            (logits,), w)
    assert loss.dtype == torch.float32 and dl.dtype == dtype
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-5)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(dl.float(), dl_ref.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("n,v", [(257, 30522), (64, 30521), (5, 1001)])
def test_cross_entropy_at_odd_vocabularies(gen, n, v):
    """BERT's vocab 30,522 (V % 4 = 2) and odd ones take the scalar loads:
    K3f and K3b against the plain version, f32 and bf16 logits."""
    for dtype in (torch.float32, torch.bfloat16):
        logits = (4 * _randn(gen, n, v)).to(dtype)
        labels = torch.randint(0, v, (n,), generator=gen, device="cuda",
                               dtype=torch.int32)
        labels[0] = v - 1                   # the last column is visited
        w = torch.rand(n, generator=gen, device="cuda")
        loss, (dl,) = _grads(lambda lg: K.cross_entropy(lg, labels),
                             (logits,), w)
        ref, (dl_ref,) = _grads(
            lambda lg: K.cross_entropy_reference(lg, labels), (logits,), w)
        torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-5)
        tol = 1e-5 if dtype == torch.float32 else 3e-2
        torch.testing.assert_close(dl.float(), dl_ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("v", [10, 30521, 30522, 30523, 32000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_cross_entropy_at_every_row_offset(gen, v, dtype, offset):
    """K3 splits each row where it lies: a scalar prologue to its first
    16-byte (f32) or 8-byte (bf16) boundary, the vector loop, a scalar
    tail.  Logits as a contiguous view ``offset`` elements into a larger
    buffer put the rows at every offset (with V odd, at all four in one
    call); K3f and K3b against the plain version, every column visited
    (labels at the first and last), dlogits at logits' offset."""
    n = 33
    buf = (4 * _randn(gen, n * v + offset)).to(dtype)
    logits = buf[offset:].view(n, v)
    assert logits.is_contiguous()
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[0], labels[1] = 0, v - 1
    w = torch.rand(n, generator=gen, device="cuda")
    loss, (dl,) = _grads(lambda lg: K.cross_entropy(lg, labels), (logits,),
                         w)
    ref, (dl_ref,) = _grads(lambda lg: K.cross_entropy_reference(lg, labels),
                            (logits,), w)
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-5)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(dl.float(), dl_ref.float(), rtol=tol,
                               atol=tol)
    # The kernel's own dlogits (not autograd's copy) lie at logits' offset.
    _, lse = K.cross_entropy_forward(logits, labels)
    dk = K.cross_entropy_backward(logits, labels, lse, w)
    vec = 4 * logits.element_size()
    assert dk.data_ptr() % vec == logits.data_ptr() % vec
    torch.testing.assert_close(dk.float(), dl_ref.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s", [(4, 12, 128), (2, 16, 256)])
def test_flash_attention_full_at_the_encoders_heads(gen, dtype, b, h, s):
    """K2 without the causal mask at head_dim 64: BERT-base's S 128 and
    Transformer-big's S 256 (cut in batch), and through the dispatch the
    encoders call (``multihead_attention_kernel``, causal=False)."""
    from tensorflow_train_distributed_torch.ops.attention import (
        multihead_attention_kernel,
    )

    q, k, v, do = (_randn(gen, b, s, h, 64, dtype=dtype).transpose(1, 2)
                   for _ in range(4))
    kw = dict(causal=False, sm_scale=64 ** -0.5)
    before = K.launch_counts()["flash_attention"]
    out, grads = _grads(
        lambda *t: multihead_attention_kernel(*t, causal=False), (q, k, v),
        do)
    assert K.launch_counts()["flash_attention"] == before + 1
    ref, ref_grads = _grads(
        lambda *t: K.flash_attention_reference(*t, **kw), (q, k, v), do)
    f32 = dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=2e-5 if f32 else 3e-2,
                               atol=2e-5 if f32 else 3e-2)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=1e-4 if f32 else 3e-2,
                                   atol=1e-4 if f32 else 3e-2)
    if f32:                                   # the split body
        _assert_split_rule(q, k, v, do, (out, *grads),
                           _keep(s, causal=False), kw["sm_scale"])


def _segments(gen, b, s):
    cuts = torch.sort(torch.randint(1, s, (b, 3), generator=gen,
                                    device="cuda"), dim=1).values
    pos = torch.arange(s, device="cuda")
    return (pos[None, :, None] >= cuts[:, None, :]).sum(-1).to(torch.int32)


def _keep(s, *, causal=True, seg=None, window=None, sinks=0):
    """[B or 1, 1, S, S] bool: the pairs K2 (causal or full) or K7 (the
    band) lets a query see."""
    keep = torch.ones(s, s, dtype=torch.bool, device="cuda")
    if causal:
        keep = keep.tril()
    if window is not None:
        keep = keep & K.splash_mask(s, window, sinks, "cuda")
    keep = keep[None, None]
    if seg is not None:
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    return keep


def _assert_split_rule(q, k, v, do, got, keep, scale, dq_scale=1.0):
    """The split body's outputs ``got`` (out, dq, dk, dv) within 2^-14
    (|ref| + |terms|) + 1e-6 of f64 attention over ``keep`` (terms:
    ``chip_smoke._flash_f32``'s).  ``q`` is what the kernel attends with
    and ``dq_scale`` turns its gradient into the caller's (K7's q is
    pre-scaled)."""
    rep = q.shape[1] // k.shape[1]
    q, k, v, do = (t.double() for t in (q, k, v, do))
    kr, vr = (t.repeat_interleave(rep, 1) for t in (k, v))
    p = torch.softmax((q @ kr.transpose(-1, -2) * scale).masked_fill(
        ~keep, float("-inf")), -1)
    out = p @ vr
    ds = p * (do @ vr.transpose(-1, -2)
              - (do * out).sum(-1, keepdim=True)) * scale
    dio = (do.abs() * out.abs()).sum(-1, keepdim=True)
    pt, dsa = p.transpose(-1, -2), ds.abs()

    def group(t):                          # [B, H, S, D] -> [B, KVH, S, D]
        return t.view(t.shape[0], -1, rep, *t.shape[2:]).sum(2)

    ref = {"out": (out, p @ vr.abs()),
           "dq": (dq_scale * ds @ kr,
                  dq_scale * (dsa @ kr.abs() + scale * dio * (p @ kr.abs()))),
           "dk": (group(ds.transpose(-1, -2) @ q),
                  group(dsa.transpose(-1, -2) @ q.abs()
                        + scale * pt @ (dio * q.abs()))),
           "dv": (group(pt @ do), group(pt @ do.abs()))}
    for (name, (want, terms)), g in zip(ref.items(), got):
        allowed = 2.0 ** -14 * (want.abs() + terms) + 1e-6
        worst = float(((g.double() - want).abs() / allowed).max())
        assert worst <= 1, (name, worst)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d", [(4, 4, 64), (4, 2, 128), (4, 1, 256)])
@pytest.mark.parametrize("causal,packed", [(True, False), (False, False),
                                           (True, True), (False, True)])
def test_flash_attention_matches_plain(gen, dtype, h, kvh, d, causal,
                                       packed):
    """Forward and backward of the flash kernels against autograd of the
    plain version: f32 and bf16, head_dim 64/128/256, MHA, GQA and MQA,
    causal and full, with and without packed segment ids; q/k/v are
    [B, H, S, D] views of [B, S, H, D] storage, as the model passes them."""
    b, s = 2, 256

    def bshd(heads):
        return _randn(gen, b, s, heads, d, dtype=dtype).transpose(1, 2)

    q, k, v, do = bshd(h), bshd(kvh), bshd(kvh), bshd(h)
    seg = _segments(gen, b, s) if packed else None
    kw = dict(causal=causal, segment_ids=seg, sm_scale=d ** -0.5)
    before = K.launch_counts()
    out, grads = _grads(lambda *t: K.flash_attention(*t, **kw), (q, k, v),
                        do)
    after = K.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    ref, ref_grads = _grads(
        lambda *t: K.flash_attention_reference(*t, **kw), (q, k, v), do)
    for got, want in zip(grads, ref_grads):
        assert got.shape == want.shape and got.dtype == dtype
    f32 = dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=2e-5 if f32 else 3e-2,
                               atol=2e-5 if f32 else 3e-2)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=1e-4 if f32 else 3e-2,
                                   atol=1e-4 if f32 else 3e-2)
    if K.flash_attention_body(dtype, d) == "split":
        _assert_split_rule(q, k, v, do, (out, *grads),
                           _keep(s, causal=causal, seg=seg), d ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,causal,d", [
    (192, True, 64), (64, True, 64), (320, True, 128), (192, False, 128),
    (320, False, 64)])
def test_flash_attention_seq_a_multiple_of_64_only(gen, dtype, s, causal, d):
    """S = 64, 192, 320: multiples of 64 that are not multiples of the
    wgmma body's 128-row q and kv tiles (nor of the 128 the model's gate
    asks for), so the last tiles are ragged and masked; the kernel takes
    them, causal and full."""
    q, k, v, do = (_randn(gen, 1, 2, s, d, dtype=dtype) for _ in range(4))
    kw = dict(causal=causal, sm_scale=d ** -0.5)
    out, grads = _grads(lambda *t: K.flash_attention(*t, **kw), (q, k, v),
                        do)
    ref, ref_grads = _grads(
        lambda *t: K.flash_attention_reference(*t, **kw), (q, k, v), do)
    f32 = dtype == torch.float32
    for got, want, tol in ((out, ref, 2e-5), *zip(grads, ref_grads,
                                                   (1e-4,) * 3)):
        tol = tol if f32 else 3e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    if f32:                                   # the split body
        _assert_split_rule(q, k, v, do, (out, *grads), _keep(s, causal=causal),
                           d ** -0.5)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,packed", [(True, False), (False, False),
                                           (True, True), (False, True)])
def test_flash_split_body_on_positive_inputs(gen, d, causal, packed):
    """The split body (f32 at D 64 and 128) on all-positive inputs, its
    worst case (no sign cancels the dropped term products: see
    tests/test_torch_flash_split.py), GQA 2:1 over S 384 (three 128-row
    tiles): within 2^-14 (|ref| + |terms|) + 1e-6 forward and backward;
    the FMA body, forced, on the same inputs too."""
    b, h, kvh, s = 2, 4, 2, 384
    q, do = (_randn(gen, b, s, h, d).abs().transpose(1, 2) for _ in range(2))
    k, v = (_randn(gen, b, s, kvh, d).abs().transpose(1, 2)
            for _ in range(2))
    seg = _segments(gen, b, s) if packed else None
    keep, scale = _keep(s, causal=causal, seg=seg), d ** -0.5
    for body in (None, "FMA"):
        o, lse = K.flash_attention_forward(q, k, v, seg, causal, scale,
                                           body=body)
        grads = K.flash_attention_backward(q, k, v, o, lse, do, seg, causal,
                                           scale, body=body)
        _assert_split_rule(q, k, v, do, (o, *grads), keep, scale)


@pytest.mark.parametrize("kernel,d,h,kvh", [("flash", 64, 2, 2),
                                             ("splash", 128, 4, 1)])
def test_split_body_over_a_long_sequence(gen, kernel, d, h, kvh):
    """The split body at S 4096 (K2 causal; K7 with a 4096-key window over
    a GQA group of four, so dK and dV sum 256 q tiles): each tile's
    products are summed in a fresh accumulator before a rounded f32 add,
    so the tensor core's truncated sums do not pile up over the tiles;
    within 2^-14 (|ref| + |terms|) + 1e-6 forward and backward."""
    b, s = 1, 4096
    q, do = (_randn(gen, b, s, h, d).transpose(1, 2) for _ in range(2))
    k, v = (_randn(gen, b, s, kvh, d).transpose(1, 2) for _ in range(2))
    if kernel == "flash":
        out, grads = _grads(lambda *t: K.flash_attention(
            *t, causal=True, sm_scale=d ** -0.5), (q, k, v), do)
        _assert_split_rule(q, k, v, do, (out, *grads), _keep(s), d ** -0.5)
        return
    out, grads = _grads(lambda *t: K.splash_attention(
        *t, window=4096, sm_scale=d ** -0.5), (q, k, v), do)
    scale = K.splash_scaled_q(torch.ones(()), d ** -0.5).item()
    _assert_split_rule(K.splash_scaled_q(q, d ** -0.5), k, v, do,
                       (out, *grads), _keep(s, window=4096), 1.0,
                       dq_scale=scale)


def test_flash_attention_body_choice(gen):
    """f32 at D 64 and 128 takes the split body, f32 at D 256 the FMA
    body; bf16 the wgmma (D 64, 128) and mma.sync (D 256) bodies.  A
    caller may force the FMA body where the split one serves (to time
    them side by side), and nothing else."""
    f32, bf = torch.float32, torch.bfloat16
    assert [K.flash_attention_body(f32, d) for d in (64, 128, 256)] == [
        "split", "split", "FMA"]
    assert [K.flash_attention_body(bf, d) for d in (64, 128, 256)] == [
        "wgmma", "wgmma", "mma.sync"]
    assert K.flash_attention_body(torch.float16, 64) == "none"
    q = _randn(gen, 1, 2, 128, 64)
    before = K.launch_counts()["flash_attention"]
    o, _ = K.flash_attention_forward(q, q, q, None, True, 0.125, body="FMA")
    assert K.launch_counts()["flash_attention"] == before + 1
    with pytest.raises(ValueError, match="body"):
        K.flash_attention_forward(q, q, q, None, True, 0.125, body="wgmma")
    with pytest.raises(ValueError, match="body"):
        K.flash_attention_forward(q.to(bf), q.to(bf), q.to(bf), None, True,
                                  0.125, body="FMA")


def test_flash_attention_rejects_what_the_kernel_does_not_take(gen):
    q = _randn(gen, 1, 2, 128, 32)
    with pytest.raises(ValueError, match="head_dim"):
        K.flash_attention(q, q, q)
    q = _randn(gen, 1, 2, 96, 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        K.flash_attention(q, q, q)
    q = _randn(gen, 1, 2, 128, 64)
    with pytest.raises(TypeError, match="dtype"):
        K.flash_attention(q, q.half(), q)


# -- K7: splash attention -----------------------------------------------------


# (H, KVH, S, D, window, sinks, packed), at B 2: window 1 (the diagonal
# tile only), windows off the 64-row tile (100, 4095) and off the wgmma
# body's 128-row kv tile (129; 4096 at S 4224, 33 tiles of 128), sinks =
# window, sinks with packed rows whose boundaries fall inside the band,
# sinks past one 128-row tile (130), GQA 4:1 and 1:1, head_dim 64, 128
# and 256.
SPLASH_CASES = [
    (4, 1, 512, 64, 1, 0, False),
    (4, 4, 512, 128, 100, 0, True),
    (2, 2, 4096, 64, 4095, 0, False),
    (8, 2, 1024, 128, 200, 200, False),
    (4, 1, 768, 64, 128, 4, True),
    (2, 2, 256, 256, 64, 7, False),
    (4, 2, 640, 128, 129, 0, False),
    (2, 1, 4224, 64, 4096, 0, False),
    (4, 1, 1024, 128, 300, 130, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,s,d,window,sinks,packed", SPLASH_CASES)
def test_splash_attention_matches_plain(gen, dtype, h, kvh, s, d, window,
                                        sinks, packed):
    """K7 forward and backward through the autograd Function against
    autograd of the plain version, on [B, H, S, D] views of [B, S, H, D]
    storage.  The f32 kernel differs from the plain version only in its
    summation order (2e-5, 1e-4 in the gradients, as the flash kernel);
    the bf16 kernel rounds p and dS to bf16 where the plain version keeps
    f32 (3e-2, as the flash kernel's bf16 tests)."""
    b = 2

    def bshd(heads):
        return _randn(gen, b, s, heads, d, dtype=dtype).transpose(1, 2)

    q, k, v, do = bshd(h), bshd(kvh), bshd(kvh), bshd(h)
    seg = _segments(gen, b, s) if packed else None
    kw = dict(window=window, sinks=sinks, segment_ids=seg,
              sm_scale=d ** -0.5)
    before = K.launch_counts()
    out, grads = _grads(lambda *t: K.splash_attention(*t, **kw), (q, k, v),
                        do)
    after = K.launch_counts()
    assert after["splash_attention"] == before["splash_attention"] + 1
    assert (after["splash_attention_bwd"]
            == before["splash_attention_bwd"] + 1)
    assert after["flash_attention"] == before["flash_attention"]
    ref, ref_grads = _grads(
        lambda *t: K.splash_attention_reference(*t, **kw), (q, k, v), do)
    for got, want in zip(grads, ref_grads):
        assert got.shape == want.shape and got.dtype == dtype
    f32 = dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=2e-5 if f32 else 3e-2,
                               atol=2e-5 if f32 else 3e-2)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=1e-4 if f32 else 3e-2,
                                   atol=1e-4 if f32 else 3e-2)
    if K.flash_attention_body(dtype, d) == "split":
        scale = K.splash_scaled_q(torch.ones((), dtype=dtype),
                                  d ** -0.5).item()
        _assert_split_rule(K.splash_scaled_q(q, d ** -0.5), k, v, do,
                           (out, *grads), _keep(s, seg=seg, window=window,
                                                sinks=sinks), 1.0,
                           dq_scale=scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splash_attention_window_past_s_is_flash_causal(gen, dtype):
    """A window at or past S masks nothing beyond causality: K7's output,
    row statistics and gradients equal K2's causal ones bit for bit (the
    same tiles in the same order)."""
    b, h, kvh, s, d = 2, 4, 2, 512, 64
    q, do = (_randn(gen, b, h, s, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, b, kvh, s, d, dtype=dtype) for _ in range(2))
    seg = _segments(gen, b, s)
    qs = K.splash_scaled_q(q, d ** -0.5)
    for window in (s, s + 7, 2 ** 31 - 1):
        o7, lse7 = K.splash_attention_forward(qs, k, v, seg, window, 0)
        o2, lse2 = K.flash_attention_forward(qs, k, v, seg, True, 1.0)
        assert torch.equal(o7, o2) and torch.equal(lse7, lse2)
        g7 = K.splash_attention_backward(qs, k, v, o7, lse7, do, seg,
                                         window, 0)
        g2 = K.flash_attention_backward(qs, k, v, o2, lse2, do, seg, True,
                                        1.0)
        for a, b_ in zip(g7, g2):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,d", [("flash", 64), ("flash", 128),
                                      ("splash", 128), ("splash", 64)])
def test_attention_backward_is_deterministic(gen, dtype, kernel, d):
    """The backward has no atomics (dk/dv and dq in separate kernels, each
    sum in one fixed order): two runs on the same inputs give equal
    gradients, bit for bit, at GQA 4:1 over packed rows."""
    b, h, kvh, s = 2, 8, 2, 640
    q, do = (_randn(gen, b, h, s, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, b, kvh, s, d, dtype=dtype) for _ in range(2))
    seg = _segments(gen, b, s)
    if kernel == "flash":
        o, lse = K.flash_attention_forward(q, k, v, seg, True, d ** -0.5)
        runs = [K.flash_attention_backward(q, k, v, o, lse, do, seg, True,
                                           d ** -0.5) for _ in range(2)]
    else:
        o, lse = K.splash_attention_forward(q, k, v, seg, 200, 3)
        runs = [K.splash_attention_backward(q, k, v, o, lse, do, seg, 200, 3)
                for _ in range(2)]
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_on_a_fresh_thread(gen, dtype):
    """The backward on a thread whose first CUDA call it is, as autograd's
    backward thread runs it: the driver encodes the kernels' tensor maps
    only with a context current on the calling thread, which the launch
    binds first.  Equal, bit for bit, to the same call on this thread."""
    q, k, v, do = (_randn(gen, 2, 4, 128, 64, dtype=dtype) for _ in range(4))
    o, lse = K.flash_attention_forward(q, k, v, None, False, 0.125)
    want = K.flash_attention_backward(q, k, v, o, lse, do, None, False,
                                      0.125)
    got, errors = [], []

    def backward():
        try:
            got.append(K.flash_attention_backward(q, k, v, o, lse, do, None,
                                                  False, 0.125))
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=backward)
    t.start()
    t.join()
    assert not errors, errors
    assert all(torch.equal(a, b) for a, b in zip(got[0], want))


def test_splash_attention_at_the_mistral_head(gen):
    """Mistral-7B's attention: H 32, KVH 8, S 8192, D 128, window 4096,
    bf16, B 1; forward and backward against the plain version (3e-2, as
    above)."""
    b, h, kvh, s, d = 1, 32, 8, 8192, 128

    def bshd(heads):
        return _randn(gen, b, s, heads, d, dtype=torch.bfloat16).transpose(
            1, 2)

    q, k, v, do = bshd(h), bshd(kvh), bshd(kvh), bshd(h)
    kw = dict(window=4096, sm_scale=d ** -0.5)
    out, grads = _grads(lambda *t: K.splash_attention(*t, **kw), (q, k, v),
                        do)
    ref, ref_grads = _grads(
        lambda *t: K.splash_attention_reference(*t, **kw), (q, k, v), do)
    for got, want in zip((out, *grads), (ref, *ref_grads)):
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                   atol=3e-2)


def test_splash_attention_rejects_what_the_kernel_does_not_take(gen):
    q = _randn(gen, 1, 2, 128, 64)
    with pytest.raises(ValueError, match="window >= 1"):
        K.splash_attention(q, q, q, window=4, sinks=5, sm_scale=1.0)
    q = _randn(gen, 1, 2, 96, 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        K.splash_attention(q, q, q, window=8, sm_scale=1.0)


# -- K6: grouped matmul -------------------------------------------------------


def _assert_within(got, ref32, sumsq32, depth, operands):
    tensor_cores = all(t.dtype == torch.bfloat16 for t in operands)
    allowed = K.gmm_tolerance(got, ref32, sumsq32, depth, tensor_cores)
    err = (got.float() - ref32).abs()
    assert bool((err <= allowed).all()), float((err / allowed).max())


def _group_rows(sizes, m):
    """Each group's row count (the tgmm depth), [E, 1, 1]."""
    gs = torch.tensor(sizes, dtype=torch.int32)
    rows = [end - start for _, start, end in K._group_spans(gs, m)]
    return torch.tensor(rows, dtype=torch.float32,
                        device="cuda")[:, None, None]


_GMM_CASES = [
    # m, k, n, sizes: ragged and empty groups, k and n off the tiles,
    # rows past the sizes' sum (zeros), one group, the 128-row pad.
    (300, 72, 100, [0, 37, 0, 200, 40]),
    (256, 64, 128, [256]),
    (128, 768, 2048 + 8, [50, 0, 78]),
    (1, 16, 8, [1, 0]),
]


@pytest.mark.parametrize("case", range(len(_GMM_CASES)))
@pytest.mark.parametrize("types", [
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.float32)])
@pytest.mark.parametrize("transpose", [False, True])
def test_gmm_kernel(gen, case, types, transpose):
    m, k, n, sizes = _GMM_CASES[case]
    lt, rt, ot = types
    e = len(sizes)
    lhs = _randn(gen, m, k, dtype=lt)
    rhs = _randn(gen, *((e, n, k) if transpose else (e, k, n)), dtype=rt)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    before = K.launch_counts()["gmm"]
    got = K.gmm(lhs, rhs, gs, preferred_element_type=ot,
                transpose_rhs=transpose)
    assert K.launch_counts()["gmm"] == before + 1
    assert got.dtype == ot and got.shape == (m, n)
    ref32 = K.gmm_reference(lhs, rhs, gs, transpose_rhs=transpose)
    sumsq32 = K.gmm_reference(lhs.float() ** 2, rhs.float() ** 2, gs,
                              transpose_rhs=transpose)
    _assert_within(got, ref32, sumsq32, k, (lhs, rhs))
    assert not got[sum(sizes):].any()


@pytest.mark.parametrize("case", range(len(_GMM_CASES)))
@pytest.mark.parametrize("types", [
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float32, torch.float32, torch.float32)])
def test_tgmm_kernel(gen, case, types):
    m, k, n, sizes = _GMM_CASES[case]
    lt, rt, ot = types
    x = _randn(gen, m, k, dtype=lt)
    g = _randn(gen, m, n, dtype=rt)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    before = K.launch_counts()["tgmm"]
    got = K.tgmm(x.t(), g, gs, preferred_element_type=ot)
    assert K.launch_counts()["tgmm"] == before + 1
    assert got.dtype == ot and got.shape == (len(sizes), k, n)
    ref32 = K.tgmm_reference(x.t(), g, gs)
    sumsq32 = K.tgmm_reference(x.float().t() ** 2, g.float() ** 2, gs)
    _assert_within(got, ref32, sumsq32, _group_rows(sizes, m), (x, g))
    for i, s in enumerate(sizes):
        if s == 0:
            assert not got[i].any()          # an empty group writes zeros


_BF, _F32 = torch.bfloat16, torch.float32


def _k6(gen, kind, m, k, n, sizes, types, *, transpose=False, positive=False,
        out_dtype=None):
    """One K6 product as the MoE step runs it: ``kind`` "gmm" (lhs [m, k]
    x rhs [E, k, n], or [E, n, k] with ``transpose``) or "tgmm" (x [m, k]
    read transposed x rhs [m, n]), operands of ``types``, all positive
    with ``positive`` (the worst case for the f32 products' rounding).
    Returns (operands, run, body, plain f32 value, its squared-operand
    twin, depth, check) where check(got) asserts ``K.gmm_tolerance``."""
    lt, rt = types
    e = len(sizes)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")

    def rnd(*shape, dtype):
        t = _randn(gen, *shape)
        return (t.abs() if positive else t).to(dtype)

    if kind == "gmm":
        a = rnd(m, k, dtype=lt)
        b = rnd(*((e, n, k) if transpose else (e, k, n)), dtype=rt)
        ot = out_dtype or (_F32 if lt == rt == _BF else _BF)
        run = lambda: K.gmm_forward(a, b, gs, ot, transpose)
        body = K.gmm_body(a, b, transpose)
        plain = lambda x, y: K.gmm_reference(x, y, gs, transpose_rhs=transpose)
        depth = k
    else:
        a, b = rnd(m, k, dtype=lt), rnd(m, n, dtype=rt)
        ot = out_dtype or _BF
        run = lambda: K.tgmm_forward(a, b, gs, ot)
        body = K.tgmm_body(a, b)
        plain = lambda x, y: K.tgmm_reference(x.t(), y, gs)
        depth = _group_rows(sizes, m)
    ref32 = plain(a, b)
    sumsq32 = plain(a.float() ** 2, b.float() ** 2)

    def check(got, select=lambda t: t):
        allowed = K.gmm_tolerance(got, ref32, sumsq32, depth,
                                  lt == rt == _BF)
        got, want, allowed = (select(t) for t in (got, ref32, allowed))
        assert bool(torch.isfinite(got).all())
        err = (got.float() - want).abs()
        assert bool((err <= allowed).all()), float(
            (err / allowed.clamp_min(1e-30)).max())

    return (a, b, gs), run, body, check


_RAGGED = [1, 63, 65, 127, 129, 0]     # a boundary at every offset mod 64, 128


@pytest.mark.parametrize("kind,types,k,transpose,want", [
    ("gmm", (_BF, _BF), 768, False, "wgmma"),
    ("gmm", (_BF, _BF), 768, True, "wgmma"),
    ("gmm", (_F32, _BF), 768, True, "wgmma"),
    ("gmm", (_F32, _BF), 768, False, "wgmma"),
    ("gmm", (_BF, _BF), 36, False, "mma.sync"),
    ("gmm", (_F32, _F32), 768, False, "FMA"),
    ("gmm", (_BF, _F32), 768, False, "FMA"),
    ("tgmm", (_BF, _F32), 768, False, "wgmma"),
    ("tgmm", (_BF, _BF), 768, False, "wgmma"),
    ("tgmm", (_BF, _BF), 36, False, "mma.sync"),
    ("tgmm", (_F32, _F32), 768, False, "FMA"),
])
def test_gmm_bodies_chosen_by_the_operands(gen, kind, types, k, transpose,
                                           want):
    """The body each input reaches (``K.gmm_body`` / ``K.tgmm_body``):
    "wgmma" where TMA takes the operands (bf16 x bf16, an f32 cotangent
    against bf16), the older bodies elsewhere (bf16 rows of 72 bytes,
    f32 x f32, a bf16 lhs against f32 in gmm); each within its bound,
    over groups with a boundary at every offset mod 64 and 128."""
    _, run, body, check = _k6(gen, kind, 448, k, 320, _RAGGED, types,
                              transpose=transpose)
    assert body == want
    check(run())


@pytest.mark.parametrize("kind,transpose", [("gmm", True), ("tgmm", False)])
@pytest.mark.parametrize("out_dtype", [_F32, _BF])
def test_gmm_f32_products_same_sign_at_depth_2048(gen, kind, transpose,
                                                  out_dtype):
    """grad_lhs and tgmm with every operand positive at depth 2048: the
    worst case for the three-way split and for the tensor cores'
    truncated running sums, held to the f32 rule of ``K.gmm_tolerance``
    (an f32 output leaves no rounding slack)."""
    if kind == "gmm":
        args = (512, 256, 2048, [200, 312])
    else:
        args = (2048, 256, 256, [2048])
    _, run, body, check = _k6(gen, kind, *args, (_BF, _F32) if kind == "tgmm"
                              else (_F32, _BF), transpose=transpose,
                              positive=True, out_dtype=out_dtype)
    assert body == "wgmma"
    check(run())


@pytest.mark.parametrize("kind,types,transpose", [
    ("gmm", (_BF, _BF), False), ("gmm", (_F32, _BF), True),
    ("tgmm", (_BF, _F32), False), ("tgmm", (_BF, _BF), False)])
def test_gmm_other_groups_nan_and_inf_stay_out(gen, kind, types, transpose):
    """Rows of the other groups filled with Inf (lhs) and NaN (rhs or the
    cotangent): the checked group's outputs stay finite and within their
    bound (tgmm zeros the depth rows past its group on both operands
    before the tensor cores read them: 0 x Inf would be NaN)."""
    sizes, g = [63, 129, 65, 127], 1
    (a, b, gs), run, _, check = _k6(gen, kind, 448, 192, 320, sizes, types,
                                    transpose=transpose)
    _, lo, hi = K._group_spans(gs, 448)[g]
    outside = torch.ones(448, dtype=torch.bool, device="cuda")
    outside[lo:hi] = False
    a[outside] = float("inf")
    if kind == "tgmm":
        b[outside] = float("nan")
    else:
        b[torch.arange(len(sizes), device="cuda") != g] = float("nan")
    # check() holds the result to the plain values of the clean operands.
    check(run(), lambda t: t[lo:hi] if kind == "gmm" else t[g])


@pytest.mark.parametrize("kind,types,transpose", [
    ("gmm", (_BF, _BF), False), ("gmm", (_F32, _BF), True),
    ("tgmm", (_BF, _F32), False)])
def test_gmm_wgmma_is_bitwise_repeatable(gen, kind, types, transpose):
    """Two launches on the same inputs give the same bits: no atomics,
    a fixed order of every sum."""
    _, run, body, _ = _k6(gen, kind, 1024, 768, 512, [300, 0, 277, 447],
                          types, transpose=transpose)
    assert body == "wgmma"
    assert torch.equal(run(), run())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transpose", [False, True])
def test_gmm_fn_matches_autograd_of_the_plain_version(gen, dtype, transpose):
    m, k, n, sizes = 384, 96, 160, [100, 0, 120, 164]
    e = len(sizes)
    lhs = _randn(gen, m, k, dtype=dtype)
    rhs = _randn(gen, *((e, n, k) if transpose else (e, k, n)), dtype=dtype)
    cot = _randn(gen, m, n)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    grads = []
    # The kernels on the operands; the plain version on f32 copies, so
    # its gradients are the f32 values, unrounded.
    for fn, ops in ((K.gmm, (lhs, rhs)),
                    (K.gmm_reference, (lhs.float(), rhs.float()))):
        a, b = (t.clone().requires_grad_(True) for t in ops)
        fn(a, b, gs, transpose_rhs=transpose).backward(cot)
        grads.append((a.grad, b.grad))
    (ga, gb), (ra, rb) = grads
    assert ga.dtype == dtype and gb.dtype == dtype
    assert not gb[1].any()
    # _gmm_bwd's products run in f32 (the cotangent is f32): grad_lhs
    # sums n products, grad_rhs each group's rows; both are rounded once
    # to the operand's dtype.
    sq = rhs.float() ** 2
    sumsq_a = K.gmm_reference(cot ** 2, sq, gs,
                              transpose_rhs=not transpose)
    sumsq_b = K.tgmm_reference(lhs.float().t() ** 2, cot ** 2, gs)
    if transpose:
        sumsq_b = sumsq_b.transpose(1, 2)
    _assert_within(ga, ra, sumsq_a, n, (cot,))
    _assert_within(gb, rb, sumsq_b, _group_rows(sizes, m), (cot,))


@pytest.mark.parametrize("policy", ["dots", "no_ffn"])
def test_remat_policies_on_the_card(gen, policy):
    """llama_125m's block at f32, 2 layers, b 2 x s 256: the selective
    ("dots") and FFN-only ("no_ffn") checkpoints around the card's
    kernels give the gradients of no remat (the same kernels run again,
    or their saved outputs are reused: 1e-5)."""
    from tensorflow_train_distributed_torch.models.llama import LlamaModel

    base = dataclasses.replace(LLAMA_PRESETS["llama_125m"], num_layers=2,
                               dtype=torch.float32, remat=False)
    params = convert.init_params(base, gen, device="cuda",
                                 dtype=torch.float32)
    tokens = torch.randint(0, base.vocab_size, (2, 256), device="cuda",
                           generator=gen)
    grads = {}
    for cfg in (base, dataclasses.replace(base, remat=True,
                                          remat_policy=policy)):
        model = LlamaModel(cfg, device="meta")
        model.load_state_dict({k: v.clone() for k, v in params.items()},
                              strict=True, assign=True)
        K.reset_launch_counts()
        model(tokens).float().square().mean().backward()
        grads[cfg.remat] = ({k: p.grad for k, p in model.named_parameters()},
                            K.launch_counts())
    (want, plain), (got, remat) = grads[False], grads[True]
    assert remat["flash_attention_bwd"] == plain["flash_attention_bwd"] == 2
    # "dots" reruns each block's forward (its flash attention too);
    # "no_ffn" reruns only the FFN.
    assert remat["flash_attention"] == (4 if policy == "dots" else 2)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


def test_lora_step_on_the_card_matches_the_cpu(gen):
    """One f32 LoRA step of llama_tiny_sft (rank 4 on query and value,
    adamw + clip under ``freeze_base``) on the card against the same step
    on the CPU: the card tolerances of chip_smoke's card-vs-CPU check
    (loss within 1e-4, params relative L2 1e-4); the base bitwise
    unchanged on both, and the card's RMSNorm and cross-entropy kernels
    launched (the 16-wide heads take the plain attention)."""
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models.llama import CausalLmTask
    from tensorflow_train_distributed_torch.models.lora import (
        LoraSpec,
        freeze_base,
        is_lora_param,
    )
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy,
    )
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    cfg = dataclasses.replace(LLAMA_PRESETS["llama_tiny"],
                              lora=LoraSpec(rank=4))
    params = convert.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32)
    params = {k: (torch.randn(v.shape, generator=torch.Generator()
                              .manual_seed(1)) * 0.02
                  if k.endswith("lora_b") else v) for k, v in params.items()}
    runs = {}
    for device in ("cpu", "cuda"):
        tx = freeze_base(optimizers.make_optimizer(
            "adamw", 1e-2, weight_decay=0.01, grad_clip_norm=1.0))
        trainer = Trainer(CausalLmTask(cfg, device="meta"), tx,
                          policy=Policy.from_name("float32"),
                          config=TrainerConfig(log_every=1), device=device)
        state = trainer.create_state({k: v.clone() for k, v in
                                      params.items()})
        K.reset_launch_counts()
        src = SyntheticLM(num_examples=32, seq_len=32, vocab_size=256)
        state, history = trainer.fit(HostBatches(src, 8, seed=0), steps=1,
                                     state=state)
        runs[device] = (history[0][1]["loss"],
                        {k: p.detach().cpu() for k, p in
                         state.params.items()}, K.launch_counts())
    (cpu_loss, cpu_p, _), (card_loss, card_p, counts) = (runs["cpu"],
                                                          runs["cuda"])
    assert abs(cpu_loss - card_loss) <= 1e-4
    for k, p in cpu_p.items():
        if is_lora_param(k):
            assert ((card_p[k] - p).norm() / p.norm()).item() <= 1e-4, k
            assert not torch.equal(p, params[k]), k
        else:
            assert torch.equal(card_p[k], params[k]), k
            assert torch.equal(p, params[k]), k
    for k in ("rms_norm", "rms_norm_bwd", "cross_entropy",
              "cross_entropy_bwd"):
        assert counts[k] > 0, counts
