"""The port's plain kernel versions against the JAX Pallas kernels.

The JAX side runs as ``tests/test_pallas_kernels.py`` runs it on the CPU:
the Pallas kernels in interpret mode.  The port side is each kernel's
``*_reference``, which is also what the wrappers compute for CPU tensors
(and what ``chip_smoke.py`` holds the CUDA kernels against on the card).
Tolerances: the gather is a copy and must be bitwise; f32 RMSNorm within
1e-6 (same f32 math, other summation order); bf16 RMSNorm within one
bf16 ulp (the f32 results may straddle a rounding boundary); f32 paged
attention within 2e-5 (the kernel's online softmax against one softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_train_distributed_tpu.ops import pallas_kernels as pk
from tensorflow_train_distributed_torch.ops import kernels as K


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- RMSNorm ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 256), (2, 17, 384), (1, 128),
                                   (300, 128)])
def test_rms_norm_f32_matches_pallas(shape):
    # (300, 128): a row count that is not a multiple of the 256-row block.
    x = _rand(shape)
    s = 1.0 + 0.1 * _rand(shape[-1:], seed=1)
    want = np.asarray(pk.rms_norm(x, s, use_pallas=True, interpret=True))
    got = K.rms_norm_reference(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_rms_norm_bf16_matches_pallas():
    x = _rand((8, 256))
    s = 1.0 + 0.1 * _rand((256,), seed=1)
    want = pk.rms_norm(jnp.asarray(x, jnp.bfloat16), s, use_pallas=True,
                       interpret=True)
    got = K.rms_norm_reference(torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -8, atol=1e-6)


def test_rms_norm_cpu_wrapper_is_the_reference():
    x = torch.from_numpy(_rand((5, 64)))
    s = torch.from_numpy(_rand((64,), seed=2))
    before = K.launch_counts()["rms_norm"]
    assert torch.equal(K.rms_norm(x, s), K.rms_norm_reference(x, s))
    assert K.launch_counts()["rms_norm"] == before   # no kernel launched


# -- paged attention ----------------------------------------------------------


def _paged(lanes, q_len, heads, kvh, hd=8, nb=9, bs=4, n_blk=5, seed=0,
           lengths=None):
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    table = rng.integers(0, nb, (lanes, n_blk)).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(0, n_blk * bs - q_len + 1, lanes)
    lengths = np.asarray(lengths, np.int32)
    q = rng.normal(size=(lanes, q_len, heads, hd)).astype(np.float32)
    return q, kp, vp, table, lengths


def _both(q, kp, vp, table, lengths, ks=None, vs=None, cache_len=None):
    want = np.asarray(pk.paged_attention(
        q, kp, vp, table, lengths,
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs),
        cache_len=cache_len, use_pallas=True, interpret=True))
    t = torch.from_numpy
    got = K.paged_attention_reference(
        t(q), t(kp), t(vp), t(table), t(lengths),
        k_scales=None if ks is None else t(ks),
        v_scales=None if vs is None else t(vs), cache_len=cache_len)
    return got.numpy(), want


@pytest.mark.parametrize("heads,kvh,q_len", [
    (4, 2, 1), (4, 1, 3), (2, 2, 2), (4, 4, 1), (4, 2, 2), (4, 1, 1)])
def test_paged_attention_matches_pallas(heads, kvh, q_len):
    got, want = _both(*_paged(3, q_len, heads, kvh))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_paged_attention_ragged_lengths():
    got, want = _both(*_paged(3, 2, 4, 2, lengths=[0, 7, 16]))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_paged_attention_cache_len_cut():
    """cache_len 18 < n_blk * bs = 20: rows past it do not exist.  The
    JAX oracle here is ``paged_attention_reference``: the Pallas kernel
    loops over every table block and does not apply the cut (it differs
    from its own reference once a lane's length + qi reaches cache_len,
    which the engine's live lanes never do)."""
    q, kp, vp, table, lengths = _paged(3, 2, 4, 2, lengths=[3, 16, 17])
    want = np.asarray(pk.paged_attention_reference(
        q, kp, vp, table, lengths, cache_len=18))
    t = torch.from_numpy
    got = K.paged_attention_reference(t(q), t(kp), t(vp), t(table),
                                      t(lengths), cache_len=18)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_paged_attention_scratch_block_lane():
    q, kp, vp, table, lengths = _paged(3, 2, 4, 2)
    table[1] = 0
    lengths[1] = 0
    got, want = _both(q, kp, vp, table, lengths)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_paged_attention_stale_table_lane_isolated():
    q, kp, vp, table, lengths = _paged(3, 1, 4, 2)
    t = torch.from_numpy
    clean = K.paged_attention_reference(t(q), t(kp), t(vp), t(table),
                                        t(lengths))
    garbage = table.copy()
    garbage[1] = [8, 8, 3, 1, 2]
    dirty = K.paged_attention_reference(t(q), t(kp), t(vp), t(garbage),
                                        t(lengths))
    assert torch.equal(clean[0], dirty[0]) and torch.equal(clean[2],
                                                           dirty[2])


def test_paged_attention_int8_matches_pallas():
    rng = np.random.default_rng(3)
    nb, bs, kvh, hd = 7, 4, 2, 8
    q, _, _, table, lengths = _paged(3, 2, 4, kvh, hd=hd, nb=nb, bs=bs,
                                     seed=3)
    kp = rng.integers(-127, 128, (nb, bs, kvh, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (nb, bs, kvh, hd)).astype(np.int8)
    ks = (np.abs(rng.normal(size=(nb, bs, kvh))).astype(np.float32)
          / 127.0 + 1e-3)
    vs = (np.abs(rng.normal(size=(nb, bs, kvh))).astype(np.float32)
          / 127.0 + 1e-3)
    got, want = _both(q, kp, vp, table, lengths, ks, vs)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_paged_attention_cpu_wrapper_is_the_reference():
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in
                                 _paged(2, 1, 2, 2))
    before = K.launch_counts()["paged_attention"]
    assert torch.equal(
        K.paged_attention(q, kp, vp, table, lengths),
        K.paged_attention_reference(q, kp, vp, table, lengths))
    assert K.launch_counts()["paged_attention"] == before


# -- paged KV gather ----------------------------------------------------------


@pytest.mark.parametrize("cache_len", [16, 14, 9, 1])
def test_paged_kv_gather_bitwise(cache_len):
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(9, 4, 2, 8)).astype(np.float32)
    table = rng.integers(0, 9, (3, 4)).astype(np.int32)
    want = np.asarray(pk.paged_kv_gather(pool, table, cache_len,
                                         interpret=True))
    got = K.paged_kv_gather(torch.from_numpy(pool), torch.from_numpy(table),
                            cache_len)
    assert got.shape == (3, cache_len, 2, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_kv_gather_scale_pool_rows_bitwise():
    # The int8 engine's f32 scale pool, viewed [nb, bs, kvh, 1].
    rng = np.random.default_rng(1)
    pool = rng.random((6, 4, 3, 1)).astype(np.float32)
    table = rng.integers(0, 6, (2, 3)).astype(np.int32)
    want = np.asarray(pk.paged_kv_gather(pool, table, 11, interpret=True))
    got = K.paged_kv_gather(torch.from_numpy(pool), torch.from_numpy(table),
                            11)
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_kv_gather_row_semantics():
    pool = torch.arange(12, dtype=torch.float32).reshape(6, 2, 1, 1)
    table = torch.tensor([[3, 1, 0]], dtype=torch.int32)
    out = K.paged_kv_gather(pool, table, 6)[0, :, 0, 0]
    assert out.tolist() == [6.0, 7.0, 2.0, 3.0, 0.0, 1.0]


def test_wrappers_refuse_mixed_devices():
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        K.rms_norm(torch.zeros(2, 4), torch.zeros(4, device="meta"))
