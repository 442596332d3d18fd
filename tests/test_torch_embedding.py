"""Row-sharded embeddings (``ops/embedding.py``) on 2 gloo ranks of a
tensor axis against the JAX ``ops/embedding.py`` on a tensor=2 mesh of
the virtual CPU devices: the cases of the JAX ``tests/test_embedding.py``
(the lookup against the dense take, zero rows for padding and
out-of-range ids, the unsharded path, the sparse-scatter gradient, the
refusals, the collection's shapes, table sharing, combiners, mesh
against no mesh) and the duplicate-table refusal, in one spawn.  f32;
lookups are exact (one owner a row, zeros elsewhere), the combiners
within rtol 1e-5 as the JAX test holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import flax.linen as fnn

from tensorflow_train_distributed_tpu.ops import embedding as jemb
from tensorflow_train_distributed_tpu.runtime import compat
from tensorflow_train_distributed_tpu.runtime import mesh as jmesh
from tensorflow_train_distributed_torch.ops import embedding as temb
from tensorflow_train_distributed_torch.testing import MultiProcessRunner


def _dense_oracle(table, ids):
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = np.asarray(table)[np.clip(np.asarray(ids), 0, table.shape[0] - 1)]
    return np.where(np.asarray(valid)[..., None], rows, 0)


JAX_TABLES = (jemb.TableSpec("ids", vocab_size=64, dim=8),
              jemb.TableSpec("cats", vocab_size=32, dim=4))
JAX_FEATURES = (jemb.FeatureSpec("user", table="ids"),
                jemb.FeatureSpec("item", table="ids"),
                jemb.FeatureSpec("tags", table="cats", combiner="sum"),
                jemb.FeatureSpec("hist", table="cats", combiner="sqrtn"))


@pytest.fixture(scope="module")
def mesh():
    return jmesh.build_mesh(jmesh.MeshConfig(data=1, tensor=2),
                            devices=jax.devices()[:2])


@pytest.fixture(scope="module")
def case(tmp_path_factory, mesh):
    rng = np.random.default_rng(0)
    feats = {
        "user": rng.integers(0, 64, (4,)).astype(np.int32),
        "item": rng.integers(0, 64, (4,)).astype(np.int32),
        "tags": np.array([[1, 2, -1], [3, -1, -1], [4, 5, 6],
                          [-1, -1, -1]], np.int32),
        "hist": rng.integers(0, 32, (4, 2)).astype(np.int32),
    }
    module = jemb.EmbeddingCollection(tables=JAX_TABLES,
                                      features=JAX_FEATURES)
    with compat.set_mesh(mesh):
        params = fnn.unbox(module.init(jax.random.key(0), feats))
        jax_out = module.apply(params, feats)
    arr = {
        "table": rng.standard_normal((64, 16)).astype(np.float32),
        "ids": rng.integers(0, 64, (8, 5)).astype(np.int64),
        "pad_ids": np.array([[0, -1], [31, 32]], np.int64),
        "small": np.arange(20, dtype=np.float32).reshape(10, 2),
        "small_ids": np.array([3, -1, 9], np.int64),
        "grad_ids": np.array([[2, 2], [5, -1]], np.int64),
        "t.ids": np.asarray(params["params"]["ids"]),
        "t.cats": np.asarray(params["params"]["cats"]),
        **{f"f.{k}": v.astype(np.int64) for k, v in feats.items()},
    }
    path = str(tmp_path_factory.mktemp("emb") / "in.npz")
    np.savez(path, **arr)
    out = path.replace("in.npz", "out.npz")
    res = MultiProcessRunner("_torch_mesh_workers:embedding_cases", 2,
                             payload=dict(inp=path, out=out),
                             timeout=180).run()
    with np.load(out) as f:
        port = {k: f[k] for k in f.files}
    return dict(arr=arr, feats=feats, params=params,
                jax={k: np.asarray(v) for k, v in jax_out.items()},
                port=port, texts=res[0].value)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_matches_dense_take(case, mesh):
    arr = case["arr"]
    want = _dense_oracle(arr["table"], arr["ids"])
    jax_got = np.asarray(jemb.sharded_lookup(
        jnp.asarray(arr["table"]), jnp.asarray(arr["ids"], jnp.int32),
        mesh=mesh))
    np.testing.assert_array_equal(case["port"]["lookup"], want)
    np.testing.assert_array_equal(case["port"]["lookup"], jax_got)
    # This rank's row block with ``vocab_size``: the same rows.
    np.testing.assert_array_equal(case["port"]["block"], want)


def test_negative_padding_gives_zero_rows(case):
    got = case["port"]["ones"]
    assert np.all(got[0, 1] == 0) and np.all(got[1, 1] == 0)
    assert np.all(got[0, 0] == 1) and np.all(got[1, 0] == 1)


def test_unsharded_fallback(case):
    arr = case["arr"]
    np.testing.assert_array_equal(
        case["port"]["unsharded"], _dense_oracle(arr["small"],
                                                 arr["small_ids"]))


def test_gradient_is_sparse_scatter(case):
    """d(sum of the looked-up rows)/d(table): 2 on the row hit twice, 1 on
    the row hit once, 0 elsewhere (the padding id hits nothing), each
    rank's cotangent counted once."""
    expect = np.zeros((16, 4), np.float32)
    expect[2] = 2.0
    expect[5] = 1.0
    np.testing.assert_array_equal(case["port"]["grad"], expect)


def test_indivisible_vocab_raises_the_jax_text(case, mesh):
    want = _raises(lambda: jemb.sharded_lookup(
        jnp.zeros((31, 4)), jnp.zeros((2,), jnp.int32), mesh=mesh))
    assert case["texts"]["vocab"] == want and "not divisible" in want


def test_unknown_table_raises_the_jax_text(case):
    want = _raises(lambda: jemb.EmbeddingCollection(
        tables=JAX_TABLES, features=(jemb.FeatureSpec("x", table="nope"),),
    ).init(jax.random.key(0), {"x": np.zeros((2,), np.int32)}))
    assert case["texts"]["unknown"] == want and "unknown table" in want


def test_duplicate_tables_raise_the_jax_text(case):
    want = _raises(lambda: jemb.EmbeddingCollection(
        tables=JAX_TABLES + (jemb.TableSpec("ids", 64, 8),),
        features=JAX_FEATURES,
    ).init(jax.random.key(0), {"user": np.zeros((2,), np.int32)}))
    assert case["texts"]["duplicate"] == want == "Duplicate table names"


def test_shapes_and_table_sharing(case):
    """Two table parameters (user and item share one), each rank holding
    half the rows; the outputs' shapes are the JAX module's."""
    assert case["texts"]["shapes"] == {"tables.ids": [32, 8],
                                       "tables.cats": [16, 4]}
    for k in ("user", "item", "tags", "hist"):
        assert case["port"][f"coll.{k}"].shape == case["jax"][k].shape
    assert case["port"]["coll.user"].shape == (4, 8)
    assert case["port"]["coll.tags"].shape == (4, 4)


def test_combiners(case):
    table = case["arr"]["t.cats"]
    feats = case["feats"]
    port = case["port"]
    np.testing.assert_allclose(port["coll.tags"],
                               _dense_oracle(table, feats["tags"]).sum(1),
                               rtol=1e-5)
    assert np.all(port["coll.tags"][3] == 0)
    np.testing.assert_allclose(
        port["coll.hist"],
        _dense_oracle(table, feats["hist"]).sum(1) / np.sqrt(2), rtol=1e-5)


def test_mesh_vs_no_mesh_and_jax_match(case):
    """The sharded collection against the whole-table one (no mesh) and
    the JAX module's outputs."""
    import torch

    coll = temb.EmbeddingCollection(
        tuple(temb.TableSpec(t.name, t.vocab_size, t.dim)
              for t in JAX_TABLES),
        tuple(temb.FeatureSpec(f.name, f.table, f.combiner)
              for f in JAX_FEATURES))
    coll.load_tables({k: torch.from_numpy(case["arr"][f"t.{k}"].copy())
                      for k in ("ids", "cats")})
    plain = coll({k: torch.from_numpy(v.astype(np.int64))
                  for k, v in case["feats"].items()})
    for k, v in plain.items():
        np.testing.assert_allclose(case["port"][f"coll.{k}"],
                                   v.detach().numpy(), rtol=1e-5)
        np.testing.assert_allclose(case["port"][f"coll.{k}"],
                                   case["jax"][k], rtol=1e-5, atol=1e-7)


def test_init_tables_draws_whole_tables_and_keeps_its_rows():
    """Without a mesh each table is whole and drawn from N(0, stddev²) in
    spec order; the returned whole tables are what the module holds."""
    import torch

    coll = temb.EmbeddingCollection(
        (temb.TableSpec("ids", 64, 8, initializer_stddev=0.5),
         temb.TableSpec("cats", 32, 4)),
        (temb.FeatureSpec("user", "ids"),))
    whole = coll.init_tables(torch.Generator().manual_seed(0))
    assert [tuple(whole[k].shape) for k in ("ids", "cats")] == [(64, 8),
                                                                 (32, 4)]
    for k, t in whole.items():
        assert torch.equal(coll.tables[k].detach(), t)
    assert 0.35 < float(whole["ids"].std()) < 0.65
