"""``ServingEngine(mesh=)`` on 2 gloo ranks against the JAX sharded
engine on a 2-device mesh of the virtual CPU devices: the greedy tokens
of the three cases of the JAX ``tests/test_serving.py`` (tensor-parallel
serving, expert-parallel MoE serving, prefix caching under a tensor
split, whose request prefills must be suffix-sized), each rank holding
only its heads' weights and kv heads' pool rows; and the autosized pool,
whose block count is the minimum over the ranks' memory reports.  One
spawn runs every case; f32 weights (llama_tiny, moe_tiny) from the JAX
models' own init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util
import flax.linen as fnn

from tensorflow_train_distributed_tpu.models import moe as jmoe
from tensorflow_train_distributed_tpu.models.llama import (
    LLAMA_PRESETS as JLLAMA,
    LlamaModel as JLlamaModel,
)
from tensorflow_train_distributed_tpu.runtime import mesh as jmesh
from tensorflow_train_distributed_tpu.serving import (
    ServingEngine as JaxEngine,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS
from tensorflow_train_distributed_torch.models.moe import MOE_PRESETS
from tensorflow_train_distributed_torch.testing import MultiProcessRunner

TP_REQS = [([3, 1, 4, 1, 5], 6), ([2, 7, 1], 8)]
EP_REQS = [([5, 6, 7], 5), ([9, 8, 7, 6], 4)]
SYSTEM = [3, 1, 4, 1, 5, 9]
PREFIX_REQS = [(SYSTEM + [9, 2, 7], 6), (SYSTEM + [8, 2, 6, 4, 1], 5)]
TP_KW = dict(slots=2, cache_len=32, chunk=4, prompt_buckets=(8,))
EP_KW = dict(slots=2, cache_len=32, chunk=3)
PREFIX_KW = dict(slots=2, cache_len=64, chunk=4, prompt_buckets=(8, 16))
MIB = 1 << 20


def _port_npz(params, cfg, path):
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}
    np.savez(path, **{k: v.numpy() for k, v in convert.params_from_flax(
        flat, cfg).items()})
    return str(path)


def _serve(cfg, params, reqs, mesh, kw, prefix=None):
    eng = JaxEngine(cfg, params, mesh=mesh, **kw)
    if prefix:
        eng.preload_prefix(prefix)
    ids = [eng.submit(p, n) for p, n in reqs]
    out = eng.run()
    return [out[i] for i in ids]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_serving")
    cfg = JLLAMA["llama_tiny"]
    params = JLlamaModel(cfg).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8), jnp.int32))["params"]
    mcfg = jmoe.MOE_PRESETS["moe_tiny"]
    mparams = jmoe.MoeLmModel(mcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    devs = jax.devices()[:2]
    tp = jmesh.build_mesh(jmesh.MeshConfig(data=1, tensor=2), devices=devs)
    ep = jmesh.build_mesh(jmesh.MeshConfig(data=1, expert=2), devices=devs)
    want = {"tensor": _serve(cfg, params, TP_REQS, tp, TP_KW),
            "expert": _serve(mcfg, mparams, EP_REQS, ep, EP_KW),
            "prefix": _serve(cfg, params, PREFIX_REQS, tp, PREFIX_KW,
                             SYSTEM)}
    lp = _port_npz(params, LLAMA_PRESETS["llama_tiny"], root / "llama.npz")
    mp = _port_npz(mparams, MOE_PRESETS["moe_tiny"], root / "moe.npz")
    t2 = {"data": 1, "tensor": 2}
    auto = dict(TP_KW, kv_pool_blocks="auto", hbm_headroom=0.0)
    cases = {
        "tensor": dict(preset="llama_tiny", params_npz=lp, mesh=t2,
                       engine=TP_KW, requests=TP_REQS),
        "expert": dict(preset="moe_tiny", params_npz=mp,
                       mesh={"data": 1, "expert": 2}, engine=EP_KW,
                       requests=EP_REQS),
        "prefix": dict(preset="llama_tiny", params_npz=lp, mesh=t2,
                       engine=PREFIX_KW, requests=PREFIX_REQS,
                       prefix=SYSTEM),
        "auto_hi": dict(preset="llama_tiny", params_npz=lp, mesh=t2,
                        engine=auto, requests=TP_REQS,
                        hbm_bytes=[MIB, MIB]),
        "auto_lo": dict(preset="llama_tiny", params_npz=lp, mesh=t2,
                        engine=auto, requests=TP_REQS,
                        hbm_bytes=[MIB // 2, MIB // 2]),
        "auto_mixed": dict(preset="llama_tiny", params_npz=lp, mesh=t2,
                           engine=auto, requests=TP_REQS,
                           hbm_bytes=[MIB, MIB // 2]),
    }
    res = MultiProcessRunner("_torch_mesh_workers:sharded_serving", 2,
                             payload=dict(cases=cases), timeout=240).run()
    return want, [r.value for r in res]


@pytest.mark.parametrize("case", ["tensor", "expert", "prefix"])
def test_tokens_equal_the_jax_sharded_engine(runs, case):
    want, ranks = runs
    for r in ranks:
        assert r[case]["tokens"] == want[case], case


def test_each_tensor_rank_holds_its_heads_only(runs):
    """llama_tiny (4 heads, 2 kv heads, hd 16, ffn 128, vocab 256) at
    tensor 2: 2 heads, 1 kv head, ffn 64 and 128 embedding rows a rank;
    the LM head whole; each rank's pool holds its one kv head."""
    _, ranks = runs
    for r in ranks:
        s = r["tensor"]["shapes"]
        assert s["layers.0.attention.query.kernel"] == [64, 32]
        assert s["layers.0.attention.key.kernel"] == [64, 16]
        assert s["layers.0.attention.out.kernel"] == [32, 64]
        assert s["layers.0.mlp.wi_gate.kernel"] == [64, 64]
        assert s["layers.0.mlp.wo.kernel"] == [64, 64]
        assert s["token_embed.embedding"] == [128, 64]
        assert s["lm_head.kernel"] == [64, 256]
        assert r["tensor"]["pool_shape"][2:] == [1, 16]
        e = r["expert"]["shapes"]
        assert e["layers.0.moe.experts.wi_gate.kernel"][0] == \
            MOE_PRESETS["moe_tiny"].num_experts // 2


def test_prefix_engages_under_the_tensor_split(runs):
    _, ranks = runs
    for r in ranks:
        assert r["prefix"]["pieces"] == [8, 8]


def test_autosized_pool_is_the_minimum_over_ranks(runs):
    _, ranks = runs
    hi, lo = ranks[0]["auto_hi"], ranks[0]["auto_lo"]
    assert hi["pool_blocks"] > lo["pool_blocks"] >= 1
    for r in ranks:
        assert r["auto_mixed"]["pool_blocks"] == lo["pool_blocks"]
        assert r["auto_mixed"]["budget"] == lo["budget"]
        assert r["auto_mixed"]["tokens"] == r["tensor"]["tokens"]
