"""The port's collectives (``parallel/collectives.py``) against the JAX
package's: the int8 recipe, the bucket plan and the wire-byte counters
bit for bit; the error-feedback syncs over 2 and 4 gloo ranks against
JAX's ``shard_map`` over a 2- or 4-device slice of the virtual mesh; the
named collectives over gloo against their meaning."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tensorflow_train_distributed_tpu.parallel import collectives as jcoll
from tensorflow_train_distributed_tpu.runtime import mesh as jmesh
from tensorflow_train_distributed_tpu.runtime.compat import shard_map
from tensorflow_train_distributed_torch.parallel import collectives as tcoll
from tensorflow_train_distributed_torch.testing import MultiProcessRunner


def _vectors():
    rng = np.random.default_rng(0)
    out = []
    for n in (1, 5, 511, 512, 513, 2048, 3000):
        out.append((rng.standard_normal(n)
                    * rng.choice([1e-4, 1.0, 1e3], n)).astype(np.float32))
    edge = rng.standard_normal(1500).astype(np.float32)
    edge[3], edge[700], edge[701], edge[1200] = np.inf, np.nan, -np.inf, 0.0
    edge[1024:1536] = 0.0                 # an all-zero block: scale 1
    edge[512:520] = 1e-42                 # subnormals
    out.append(edge)
    return out


@pytest.mark.parametrize("i", range(8))
def test_quantize_q8_matches_jax_bit_for_bit(i):
    """Against JAX's ``quantize_q8`` op by op and the numpy recipe
    (``ringcoll.quantize_q8_np``, the native ring's): equal bit for bit.
    (A jitted XLA CPU fusion rounds amax/127 one ulp off the recipe for
    one block of the 3,000-element vector; the codes agree.)"""
    from tensorflow_train_distributed_tpu.native import ringcoll

    x = _vectors()[i]
    qj, sj = jcoll.quantize_q8(jnp.asarray(x))
    qn, sn = ringcoll.quantize_q8_np(x)
    qt, st = tcoll.quantize_q8(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), qn)
    np.testing.assert_array_equal(st.numpy(), sn)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tcoll.dequantize_q8(qt, st).numpy(),
        np.asarray(jcoll.dequantize_q8(qj, sj)))


SHAPES = [(40, 33), (7,), (1100,), (3, 700)]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 9])
def test_plan_grad_buckets_matches_jax(k):
    leaves = [np.zeros(s, np.float32) for s in SHAPES]
    leaves.append(np.zeros((5, 5), np.float16))
    tleaves = [torch.zeros(s) for s in SHAPES] + [
        torch.zeros((5, 5), dtype=torch.float16)]
    assert tcoll.plan_grad_buckets(tleaves, k) == \
        jcoll.plan_grad_buckets(leaves, k)
    assert tcoll.plan_grad_buckets([], k) == []


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_wire_byte_counters_match_jax(world):
    leaves = [np.zeros(s, np.float32) for s in SHAPES]
    for n in (1, 511, 4096, 100_003):
        assert tcoll.q8_wire_bytes(n, world) == jcoll.q8_wire_bytes(n, world)
        assert tcoll._leaf_rank_chunk(n, world) == \
            jcoll._leaf_rank_chunk(n, world)
    for wire in ("int8", "f32"):
        for mq in (0, 512, 5000):
            assert tcoll.grad_sync_wire_bytes(SHAPES, world, wire, mq) == \
                jcoll.grad_sync_wire_bytes(leaves, world, wire, mq)
            assert tcoll.bucket_sync_wire_bytes(SHAPES, world, wire, mq) == \
                jcoll.bucket_sync_wire_bytes(leaves, world, wire, mq)


def test_syncs_on_one_rank_are_the_local_mean_and_keep_the_residual():
    """A group of one (None): the exact path, residual zero, finite."""
    g = [torch.randn(s) for s in SHAPES]
    r = [torch.randn(s) for s in SHAPES]
    for fn in (tcoll.ef_grad_sync, tcoll.ef_bucket_sync):
        mean, new_r, fin = fn(g, r, None)
        assert bool(fin)
        for a, b in zip(mean, g):
            assert torch.equal(a, b)
        assert all(not x.any() for x in new_r)
    x = torch.randn(9)
    assert torch.equal(tcoll.all_reduce(x, None), x)
    assert torch.equal(tcoll.all_gather(x, None), x)


def _jax_rounds(world, seed, rounds, fn, bucketed):
    """The JAX sync over a ``world``-device slice of the virtual mesh,
    on each rank's seeded leaves (as ``_torch_dist_workers.ef_syncs``
    draws them)."""
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=world),
                            devices=jax.devices()[:world])
    residual = [jnp.zeros((world,) + s, jnp.float32) for s in SHAPES]

    def per_shard(g, r):
        return fn(g, r, "data")

    sync = jax.jit(shard_map(per_shard, mesh=mesh,
                             in_specs=(P("data"), P("data")),
                             out_specs=(P(), P("data"), P()),
                             check_vma=False))
    sums = []
    for step in range(rounds):
        per_rank = []
        for r in range(world):
            rng = np.random.default_rng([seed, step, r])
            per_rank.append([rng.standard_normal(s).astype(np.float32)
                             for s in SHAPES])
        grads = [jnp.asarray(np.stack([per_rank[r][j]
                                       for r in range(world)]))
                 for j in range(len(SHAPES))]
        if bucketed:
            buckets = jcoll.plan_grad_buckets(
                [np.zeros(s, np.float32) for s in SHAPES], 2)
            mean = [None] * len(SHAPES)
            for b in buckets:
                bm, br, bf = sync([grads[j] for j in b],
                                  [residual[j] for j in b])
                assert bool(bf)
                for j, a, rr in zip(b, bm, br):
                    mean[j], residual[j] = a, rr
        else:
            mean, residual, fin = sync(grads, residual)
            assert bool(fin)
        sums.append([np.asarray(m) for m in mean])
    return sums, [np.asarray(r) for r in residual]


@pytest.mark.parametrize("world", [2, 4])
def test_ef_syncs_over_gloo_match_jax_shard_map(world, tmp_path):
    """3 rounds of ``ef_grad_sync`` and of ``ef_bucket_sync`` (2 buckets)
    on ``world`` gloo ranks against JAX's on ``world`` devices: the mean
    gradients and every rank's residual.  Tolerance: an f32 sum of W
    dequantized rows may round once apart (XLA's reduction order against
    torch's), which can move an element's re-quantization (and, through
    its residual, a later step's send quantization) by one int8 step:
    |diff| <= 2.01 x the leaf's largest |mean| / 127 in the mean, and
    one step (twice the largest |residual|) in the residual; the median
    element agrees to 1e-6."""
    out = str(tmp_path / "ef")
    MultiProcessRunner("_torch_dist_workers:ef_syncs", world,
                       payload=dict(world=world, seed=7, rounds=3, out=out),
                       timeout=90).run()
    got = [np.load(f"{out}.{r}.npz") for r in range(world)]
    for kind, fn, bucketed in (("grad", jcoll.ef_grad_sync, False),
                               ("bucket", jcoll.ef_bucket_sync, True)):
        sums, residual = _jax_rounds(world, 7, 3, fn, bucketed)
        for step in range(3):
            for j in range(len(SHAPES)):
                want = sums[step][j]
                tol = 2.01 * np.abs(want).max() / 127 + 1e-6
                for r in range(world):
                    np.testing.assert_allclose(
                        got[r][f"{kind}_sum_{step}_{j}"], want, rtol=0,
                        atol=tol, err_msg=f"{kind} step {step} leaf {j}")
                    assert np.median(np.abs(
                        got[r][f"{kind}_sum_{step}_{j}"] - want)) <= 1e-6
        for j in range(len(SHAPES)):
            for r in range(world):
                tol = 2.02 * np.abs(residual[j][r]).max() + 1e-6
                np.testing.assert_allclose(
                    got[r][f"{kind}_res_{j}"], residual[j][r], rtol=0,
                    atol=tol, err_msg=f"{kind} residual {j}")
                # Far tighter where no element moved a step: the median.
                assert np.median(np.abs(got[r][f"{kind}_res_{j}"]
                                        - residual[j][r])) <= 1e-6


def test_named_collectives_over_two_gloo_ranks():
    res = MultiProcessRunner("_torch_dist_workers:named_collectives", 2,
                             payload=dict(world=2), timeout=60).run()
    xs = [np.arange(8, dtype=np.float32).reshape(4, 2) + 100 * r
          for r in range(2)]
    for r, out in enumerate(v.value for v in res):
        np.testing.assert_array_equal(out["sum"], xs[0] + xs[1])
        np.testing.assert_array_equal(out["mean"], (xs[0] + xs[1]) / 2)
        np.testing.assert_array_equal(out["max"], np.maximum(*xs))
        np.testing.assert_array_equal(out["gather1"],
                                      np.concatenate(xs, axis=1))
        np.testing.assert_array_equal(out["scatter"],
                                      (xs[0] + xs[1])[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            out["a2a"], np.concatenate([x[2 * r:2 * r + 2] for x in xs],
                                       axis=1))
        np.testing.assert_array_equal(out["ring"], xs[1 - r])
        want = (xs[0] + xs[1]).reshape(-1) / 7.0
        # Two int8 roundings of one block (scale = amax/127 each).
        np.testing.assert_allclose(out["q8"], want, rtol=0,
                                   atol=2.01 * np.abs(want).max() / 127)
        assert out["bcast"] == {"r": 0}
        assert out["mean_metrics"] == {"loss": 0.5}
        assert out["bus"]["devices"] == 2 and out["bus"]["wire"] == "f32"
    assert res[0].value["q8"] == res[1].value["q8"]
