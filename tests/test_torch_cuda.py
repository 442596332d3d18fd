"""The CUDA kernels against their plain versions across the shapes and
types the smoke test does not reach, and the engine on the card against
the engine on the CPU.  Needs an H100; skips elsewhere.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest loads the JAX package, which the
card's machine does not have; this file imports only the port.)

Tolerances: gathers bitwise; f32 RMSNorm 1e-5 (rsqrtf against torch's
rsqrt, other summation order); f32 paged attention 2e-5 (online softmax
against one softmax); bf16 queries 3e-2 (the reference rounds logits and
weights to bf16, the kernel keeps f32).
"""

import dataclasses

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
            assert min(K.launch_counts().values()) > 0
    assert outs[0] == outs[1]
