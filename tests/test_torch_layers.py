"""The port's layers against the flax modules they mirror, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both.
Tolerances: f32 within 1e-5 (same math, other kernels and summation
orders; RoPE angles reach a few hundred radians, where the two sin/cos
implementations differ in the last bits); the int8 KV recipe bitwise.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.models import layers as JL
from tensorflow_train_distributed_tpu.models.llama import (
    DecoderBlock as JaxBlock,
    LLAMA_PRESETS as JAX_PRESETS,
)
from tensorflow_train_distributed_torch.models import layers as TL
from tensorflow_train_distributed_torch.models.llama import (
    DecoderBlock as TorchBlock,
    LLAMA_PRESETS as TORCH_PRESETS,
)


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- RoPE ---------------------------------------------------------------------


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 64)])
def test_apply_rope_matches_jax(scaling):
    x = _rand((2, 7, 3, 16))
    pos = np.random.default_rng(1).integers(0, 300, (2, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), base=500.0,
                         scaling=scaling)
    got = TL.apply_rope(_t(x), _t(pos), base=500.0, scaling=scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_llama3_scaled_freqs_matches_jax():
    freqs = 1.0 / 500_000.0 ** (np.arange(0, 128, 2, dtype=np.float32)
                                / 128)
    scaling = (8.0, 1.0, 4.0, 8192)
    want = JL.llama3_scaled_freqs(jnp.asarray(freqs), scaling)
    got = TL.llama3_scaled_freqs(_t(freqs), scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- int8 KV recipe -----------------------------------------------------------


def test_quantize_kv_rows_bitwise():
    t = _rand((3, 5, 2, 16), scale=2.0)
    # Exact half-way quotients (amax 127 -> scale 1): round half to even.
    t[0, 0, 0, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]
    t[0, 1, 1] = 0.0                                   # amax 0 -> scale 1
    jq, js = JL._quantize_kv_rows(jnp.asarray(t))
    tq, ts = TL._quantize_kv_rows(_t(t))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, 0, :5].tolist() == [127, 0, 2, 2, 0]


# -- RMSNorm and MLP ----------------------------------------------------------


@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm_module_matches_flax(zero_centered):
    x = _rand((2, 5, 32))
    scale = _rand((32,), seed=1, scale=0.3)
    want = JL.RMSNorm(zero_centered=zero_centered).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    mod = TL.RMSNorm(32, zero_centered=zero_centered)
    mod.scale.data = _t(scale)
    np.testing.assert_allclose(mod(_t(x)).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_mlp_block_matches_flax(activation):
    x = _rand((2, 3, 16))
    p = {name: _rand(shape, seed=i, scale=0.4) for i, (name, shape) in
         enumerate([("wi_gate", (16, 24)), ("wi_up", (16, 24)),
                    ("wo", (24, 16))])}
    want = JL.MlpBlock(hidden=24, gated=True,
                       activation={"silu": fnn.silu,
                                   "gelu": fnn.gelu}[activation]).apply(
        {"params": {k: {"kernel": jnp.asarray(v)} for k, v in p.items()}},
        jnp.asarray(x))
    mod = TL.MlpBlock(16, 24, activation=activation)
    mod.load_state_dict({f"{k}.kernel": _t(v) for k, v in p.items()})
    np.testing.assert_allclose(mod(_t(x)).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# -- DecoderBlock -------------------------------------------------------------

BASE = JAX_PRESETS["llama_tiny"]
BLOCK_CONFIGS = {
    "gqa": {},
    "kv_int8": dict(kv_cache_int8=True),
    "fused_qkv_bias": dict(fused_qkv=True, qkv_bias=True),
    "gemma_knobs": dict(head_dim=32, mlp_activation="gelu",
                        norm_zero_centered=True, embed_scale=True,
                        rope_scaling=(8.0, 1.0, 4.0, 32)),
}
C = 32


def _configs(knobs):
    return (dataclasses.replace(BASE, **knobs),
            dataclasses.replace(TORCH_PRESETS["llama_tiny"], **knobs))


def _block_pair(knobs, jax_block_kw, seed=0):
    """(jax block, its random params, torch block with the same)."""
    jcfg, tcfg = _configs(knobs)
    jblk = JaxBlock(jcfg, decode=True, cache_len=C, slot_decode=True,
                    **jax_block_kw)
    shapes = fnn.unbox(jax.eval_shape(
        jblk.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 1, jcfg.d_model)))["params"])
    # Kernels at lecun scale (1/sqrt(fan_in)), vectors at 0.3: activations
    # stay O(1), where an f32 tolerance of 1e-5 is meaningful.
    flat = {k: _rand(v.shape, seed=seed + i,
                     scale=v.shape[0] ** -0.5 if len(v.shape) == 2 else 0.3)
            for i, (k, v) in enumerate(sorted(traverse_util.flatten_dict(
                shapes, sep="/").items()))}
    tblk = TorchBlock(tcfg, device="meta")
    tblk.load_state_dict({k.replace("/", "."): _t(v)
                          for k, v in flat.items()}, assign=True)
    return jblk, traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"), tblk, tcfg


def _torch_step(tblk, tcfg, x, cache):
    positions = cache.index[:, None] + torch.arange(x.shape[1])
    rope = TL.rope_sin_cos(positions, tcfg.attn_head_dim,
                           base=tcfg.rope_base, scaling=tcfg.rope_scaling)
    with torch.no_grad():
        y = tblk(_t(x), cache.layers[0], cache, positions=positions,
                 rope=rope)
    cache.index += x.shape[1]
    return y.numpy()


@pytest.mark.parametrize("knobs", list(BLOCK_CONFIGS))
def test_decoder_block_prefill_then_decode_matches_flax(knobs):
    """Batch-1 linear cache: a 6-token prefill, then one decode step."""
    jblk, params, tblk, tcfg = _block_pair(BLOCK_CONFIGS[knobs], {})
    x0, x1 = _rand((1, 6, 64), seed=10), _rand((1, 1, 64), seed=11)
    y0, vs = jblk.apply({"params": params}, jnp.asarray(x0),
                        mutable=["cache"])
    y1, _ = jblk.apply({"params": params, "cache": vs["cache"]},
                       jnp.asarray(x1), mutable=["cache"])
    kvh, hd = tcfg.kv_heads, tcfg.attn_head_dim
    int8 = tcfg.kv_cache_int8
    dt = torch.int8 if int8 else torch.float32
    lc = {"key_cache": torch.zeros(1, C, kvh, hd, dtype=dt),
          "value_cache": torch.zeros(1, C, kvh, hd, dtype=dt)}
    if int8:
        lc["kv_scales"] = torch.zeros(2, 1, C, kvh)
    cache = TL.KVCache(layers=[lc], index=torch.zeros(1, dtype=torch.int32),
                       cache_len=C)
    np.testing.assert_allclose(_torch_step(tblk, tcfg, x0, cache),
                               np.asarray(y0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_torch_step(tblk, tcfg, x1, cache),
                               np.asarray(y1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("knobs", ["gqa", "kv_int8"])
def test_decoder_block_paged_decode_step_matches_flax(knobs):
    """Slot-grid paged pool: three lanes (two live on distinct blocks at
    ragged lengths, one reset lane on the scratch block) take one decode
    step; outputs and the rows written to the pool match."""
    nb, bs = 12, 4
    n_blk = C // bs
    jblk, params, tblk, tcfg = _block_pair(
        BLOCK_CONFIGS[knobs], dict(paged_kv_blocks=nb, kv_block_size=bs))
    kvh, hd = tcfg.kv_heads, tcfg.attn_head_dim
    rng = np.random.default_rng(7)
    int8 = tcfg.kv_cache_int8
    if int8:
        kp = rng.integers(-127, 128, (nb, bs, kvh, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (nb, bs, kvh, hd)).astype(np.int8)
        sc = (rng.random((2, nb, bs, kvh)) / 50 + 1e-3).astype(np.float32)
    else:
        kp = _rand((nb, bs, kvh, hd), seed=8)
        vp = _rand((nb, bs, kvh, hd), seed=9)
    perm = rng.permutation(np.arange(1, nb))
    table = np.zeros((3, n_blk), np.int32)
    table[0, :5], table[2, :5] = perm[:5], perm[5:10]
    index = np.array([13, 0, 6], np.int32)
    x = _rand((3, 1, 64), seed=12)
    jcache = {"key_pool": kp, "value_pool": vp, "block_table": table,
              "index": index}
    lc = {"key_pool": _t(kp), "value_pool": _t(vp)}
    if int8:
        jcache["kv_pool_scales"] = sc
        lc["kv_pool_scales"] = _t(sc)
    y, vs = jblk.apply(
        {"params": params,
         "cache": {"attention": {k: jnp.asarray(v)
                                 for k, v in jcache.items()}}},
        jnp.asarray(x), mutable=["cache"])
    cache = TL.KVCache(layers=[lc], index=_t(index), cache_len=C,
                       block_table=_t(table))
    got = _torch_step(tblk, tcfg, x, cache)
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-5, atol=1e-5)
    jpool = vs["cache"]["attention"]
    for lane in (0, 2):       # the rows this step wrote
        blk, row = table[lane, index[lane] // bs], index[lane] % bs
        for name in ("key_pool", "value_pool"):
            want = np.asarray(jpool[name])[blk, row]
            have = lc[name][blk, row].numpy()
            if int8:          # the quantisation recipe is bitwise
                np.testing.assert_array_equal(have, want)
            else:
                np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5)
        if int8:
            np.testing.assert_allclose(
                lc["kv_pool_scales"][:, blk, row].numpy(),
                np.asarray(jpool["kv_pool_scales"])[:, blk, row], rtol=1e-5)
    assert cache.index.tolist() == [14, 1, 7]
