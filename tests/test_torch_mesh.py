"""The port's mesh arithmetic, cluster resolution and sharding rules
against the JAX package's (``runtime/mesh.py``, ``runtime/distributed.py``,
``parallel/sharding.py``): equal, case for case.  No process group here;
the gloo ranks are ``test_torch_collectives.py``'s and
``test_torch_parallel_train.py``'s."""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.models import registry as jreg
from tensorflow_train_distributed_tpu.parallel import sharding as jshard
from tensorflow_train_distributed_tpu.runtime import distributed as jdist
from tensorflow_train_distributed_tpu.runtime import mesh as jmesh
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.parallel import sharding as tshard
from tensorflow_train_distributed_torch.runtime import distributed as tdist
from tensorflow_train_distributed_torch.runtime import mesh as tmesh

PRESETS = sorted(jmesh.STRATEGY_PRESETS)


def test_axes_and_presets_are_the_jax_packages():
    assert tmesh.AXES == jmesh.AXES
    assert sorted(tmesh.STRATEGY_PRESETS) == PRESETS
    for name in PRESETS:
        assert (tmesh.STRATEGY_PRESETS[name].axis_sizes()
                == jmesh.STRATEGY_PRESETS[name].axis_sizes()), name


@pytest.mark.parametrize("name", PRESETS)
def test_strategy_preset_and_shrink_match_jax_for_1_to_8_devices(name):
    for n in range(1, 9):
        want = jmesh.strategy_preset(name, n)
        got = tmesh.strategy_preset(name, n)
        assert got.axis_sizes() == want.axis_sizes(), (name, n)
        assert got.strategy == want.strategy
        sizes = jmesh.STRATEGY_PRESETS[name].axis_sizes()
        assert tmesh._shrink_sizes(sizes, n) == jmesh._shrink_sizes(sizes, n)
        try:
            jres = want.resolve(n)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                got.resolve(n)
        else:
            assert got.resolve(n) == jres


@pytest.mark.parametrize("sizes", [
    dict(data=8), dict(data=4, tensor=2), dict(data=2, fsdp=2, tensor=2),
    dict(data=3, tensor=4), dict(fsdp=8, tensor=4), dict(data=6),
    dict(data=-1, expert=4), dict(data=2, expert=3, tensor=2)])
def test_degrade_to_fit_matches_jax(sizes):
    for n in range(1, 9):
        jcfg = jmesh.MeshConfig(strategy="x", **sizes)
        tcfg = tmesh.MeshConfig(strategy="x", **sizes)
        try:
            want = jmesh.degrade_to_fit(jcfg, n).axis_sizes()
        except ValueError:
            with pytest.raises(ValueError):
                tmesh.degrade_to_fit(tcfg, n)
            continue
        assert tmesh.degrade_to_fit(tcfg, n).axis_sizes() == want, (sizes, n)


@pytest.mark.parametrize("case", [
    (dict(data=8), None, 2), (dict(data=4, tensor=2), {"data": 2}, 2),
    (dict(pipeline=2, data=2, tensor=2), None, 2),
    (dict(data=2, fsdp=4), {"data": 2, "fsdp": 2}, 4),
    (dict(data=1, tensor=8), None, 2), (dict(data=4), {"data": 3}, 3),
    (dict(data=4), {"tensor": 1, "data": 2}, 2),
    (dict(data=4), {"data": 8}, 8), (dict(data=4), {"bogus": 2}, 2)])
def test_hybrid_shapes_match_jax(case):
    sizes, dcn, slices = case
    full = {a: 1 for a in jmesh.AXES}
    full.update(sizes)
    try:
        want = jmesh.hybrid_shapes(full, dcn, slices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.hybrid_shapes(full, dcn, slices)
        assert str(got.value) == str(e)
        return
    assert tmesh.hybrid_shapes(full, dcn, slices) == want


def test_parameter_server_is_refused_with_the_jax_text():
    for name in ("ps", "parameter_server"):
        with pytest.raises(ValueError) as want:
            jmesh.strategy_preset(name, 2)
        with pytest.raises(ValueError) as got:
            tmesh.strategy_preset(name, 2)
        assert str(got.value) == str(want.value)


def test_mesh_coords_groups_and_batch_slices_without_a_process_group():
    """A mesh of one rank builds with no group (every collective the
    identity); ``Mesh`` indexing over a 2×2 grid matches the row-major
    JAX device order, and ``shard_batch`` gives each rank its contiguous
    block along data × fsdp (tensor ranks the same rows)."""
    one = tmesh.build_mesh(tmesh.MeshConfig(strategy="dp_tp"))
    assert one.shape == {a: 1 for a in tmesh.AXES} and one.group("data") is None
    devices = np.arange(8).reshape(1, 2, 2, 1, 1, 2)        # AXES order
    batch = {"x": np.arange(16)}
    for rank in range(8):
        m = tmesh.Mesh(dict(pipeline=1, data=2, fsdp=2, expert=1, seq=1,
                            tensor=2), rank)
        pos = np.argwhere(devices == rank)[0]
        assert [m.coords[a] for a in tmesh.AXES] == list(pos)
        assert m.index(("data", "fsdp")) == pos[1] * 2 + pos[2]
        assert m.group_ranks("tensor") == list(devices[0, pos[1], pos[2], 0,
                                                       0, :])
        got = tshard.shard_batch(m, batch)["x"]
        i = m.index(("data", "fsdp"))
        np.testing.assert_array_equal(got, np.arange(16)[4 * i:4 * i + 4])
    assert tmesh.batch_axes(m) == ("data", "fsdp")
    assert tmesh.data_parallel_size(m) == 4


def test_dcn_numbers_ranks_node_by_node():
    """``--dcn data=2`` on data 4 × tensor 2: node 0 holds data rows 0-1
    (ranks 0-3), node 1 rows 2-3; intra-node axes innermost."""
    sizes = dict(pipeline=1, data=4, fsdp=1, expert=1, seq=1, tensor=2)
    order = tmesh._hybrid_order(sizes, {"data": 2})
    assert order == [0, 1, 2, 3, 4, 5, 6, 7]
    sizes = dict(pipeline=1, data=2, fsdp=1, expert=1, seq=1, tensor=4)
    order = tmesh._hybrid_order(sizes, {"tensor": 2})
    # tensor split over 2 nodes: positions (d, t) -> node t // 2.
    assert order == [0, 1, 4, 5, 2, 3, 6, 7]


@pytest.mark.parametrize("axis", ["seq", "pipeline"])
def test_build_mesh_refuses_seq_and_pipeline_naming_slice_20(axis):
    """The seq and pipeline axes build (their modules have landed): rank
    1 of a 2-rank mesh sits at index 1 along the axis, alone on the
    others, and the preset that names the axis resolves to it."""
    m = tmesh.build_mesh(tmesh.MeshConfig(data=1, **{axis: 2}),
                         world_size=2, rank=1)
    assert m.shape[axis] == 2 and m.size == 2
    assert m.index(axis) == 1 and m.index(("data", "fsdp")) == 0
    assert m.group_ranks(axis) == [0, 1]
    preset = {"seq": "dp_sp", "pipeline": "dp_pp"}[axis]
    assert tmesh.build_mesh(tmesh.MeshConfig(strategy=preset),
                            world_size=2, rank=0).shape[axis] == 2


@pytest.mark.parametrize("spec,warned", [
    ("data=4", ()), ("data=2,tensor=2", ("tensor=2",)),
    ("data=2,fsdp=2", ("fsdp=2",)),
    ("fsdp=2,tensor=2", ("tensor=2", "fsdp=2"))])
def test_launcher_warns_what_tensor_and_fsdp_leave_unsplit(spec, warned,
                                                          caplog):
    """A 4-rank launcher mesh with tensor (or fsdp) above 1 says, at
    launch, that the axis splits the optimizer state and not the
    compute (or the resident parameters), naming the ROADMAP item."""
    import logging
    import types

    from tensorflow_train_distributed_torch import launch as tlaunch

    args = tlaunch.build_parser().parse_args(
        ["--config", "llama_tiny_sft", "--strategy", "dp", "--mesh", spec,
         "--device", "cpu"])
    cluster = types.SimpleNamespace(num_processes=4, process_id=0)
    with caplog.at_level(logging.WARNING):
        mesh = tlaunch._build_mesh(
            args, treg.get_entry("llama_tiny_sft"), cluster)
    assert mesh.size == 4
    for w in warned:
        assert w in caplog.text and tmesh.UNSPLIT_COMPUTE in caplog.text
    assert ("whole forward" in caplog.text) == ("tensor=2" in warned)
    if not warned:
        assert tmesh.UNSPLIT_COMPUTE not in caplog.text


# -- cluster resolution --------------------------------------------------

_CLUSTER_ENV = ("TTD_COORDINATOR", "TTD_NUM_PROCESSES", "TTD_PROCESS_ID",
                "TF_CONFIG", "SLURM_PROCID", "SLURM_NTASKS",
                "SLURM_STEP_NODELIST", "SLURM_JOB_NODELIST",
                "JOB_COMPLETION_INDEX", "TTD_K8S_REPLICAS",
                "TTD_K8S_COORDINATOR", "TTD_K8S_JOB_NAME",
                "TTD_K8S_SUBDOMAIN", "TTD_GCE_METADATA")


def _tf(cluster, ttype, index):
    return json.dumps({"cluster": cluster,
                       "task": {"type": ttype, "index": index}})


CLUSTERS = {
    "none": {},
    "native": dict(TTD_COORDINATOR="h:1", TTD_NUM_PROCESSES="4",
                   TTD_PROCESS_ID="3"),
    "native_partial": dict(TTD_COORDINATOR="h:1", TTD_NUM_PROCESSES="4"),
    "tf_worker": dict(TF_CONFIG=_tf({"worker": ["a:1", "b:2", "c:3"]},
                                    "worker", 2)),
    "tf_chief": dict(TF_CONFIG=_tf({"chief": ["c:9"], "worker": ["a:1"]},
                                   "worker", 0)),
    "tf_chief_self": dict(TF_CONFIG=_tf({"chief": ["c:9"],
                                         "worker": ["a:1"]}, "chief", 0)),
    "tf_evaluator": dict(TF_CONFIG=_tf({"worker": ["a:1"]}, "evaluator",
                                       0)),
    "tf_ps": dict(TF_CONFIG=_tf({"worker": ["a:1"], "ps": ["p:1"]},
                                "worker", 0)),
    "tf_bad_type": dict(TF_CONFIG=_tf({"worker": ["a:1"]}, "bogus", 0)),
    "tf_malformed": dict(TF_CONFIG="{not json"),
    "tf_native_wins": dict(TF_CONFIG=_tf({"worker": ["a:1", "b:1"]},
                                         "worker", 1),
                           TTD_COORDINATOR="h:1", TTD_NUM_PROCESSES="2",
                           TTD_PROCESS_ID="0"),
    "slurm": dict(SLURM_PROCID="5", SLURM_NTASKS="8",
                  SLURM_STEP_NODELIST="node[3-5,9],other"),
    "slurm_job_nodes": dict(SLURM_PROCID="0", SLURM_NTASKS="2",
                            SLURM_JOB_NODELIST="gpu7"),
    "k8s": dict(JOB_COMPLETION_INDEX="2", TTD_K8S_REPLICAS="4",
                TTD_K8S_COORDINATOR="svc:7"),
    "k8s_dns": dict(JOB_COMPLETION_INDEX="1", TTD_K8S_REPLICAS="2",
                    TTD_K8S_JOB_NAME="train", TTD_K8S_SUBDOMAIN="sub"),
    "k8s_no_coord": dict(JOB_COMPLETION_INDEX="1", TTD_K8S_REPLICAS="2"),
    "gce": dict(TTD_GCE_METADATA=json.dumps(
        {"instances": ["vm-a", "vm-b", "vm-c"], "self": "vm-c",
         "port": 99})),
    "gce_bad": dict(TTD_GCE_METADATA=json.dumps({"instances": ["a"],
                                                 "self": "z"})),
}


def _resolve(module, **kw):
    try:
        return ("ok", module.resolve_cluster(**kw))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_resolve_cluster_matches_jax_under_the_same_env(name, monkeypatch,
                                                        tmp_path):
    for var in _CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)
    for k, v in CLUSTERS[name].items():
        monkeypatch.setenv(k, v)
    want, got = _resolve(jdist), _resolve(tdist)
    assert want[0] == got[0], (want, got)
    if want[0] == "error":
        assert got[1] == want[1]
    else:
        assert dataclass_fields(got[1]) == dataclass_fields(want[1])
    for kw in (dict(num_processes=2, process_id=1, coordinator_address="x"),
               dict(process_id=2), dict(num_processes=3)):
        assert _resolve(tdist, **kw)[0] == _resolve(jdist, **kw)[0]


def test_gce_metadata_from_a_file(monkeypatch, tmp_path):
    for var in _CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)
    path = tmp_path / "meta.json"
    path.write_text(json.dumps({"instances": ["a", "b"], "self": "b"}))
    monkeypatch.setenv("TTD_GCE_METADATA", f"@{path}")
    assert dataclass_fields(tdist.resolve_cluster()) == dataclass_fields(
        jdist.resolve_cluster())


def dataclass_fields(cfg):
    return (cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            cfg.source, cfg.is_multiprocess, cfg.is_coordinator)


def test_one_process_without_a_coordinator_joins_nothing():
    import torch.distributed as dist

    cfg = tdist.initialize_distributed(tdist.DistributedConfig(),
                                       device="cpu")
    assert cfg.num_processes == 1 and not dist.is_initialized()


def test_one_process_with_a_coordinator_makes_a_group_of_one():
    """``--num-processes 1 --coordinator-address``: a world-size-1 gloo
    group on a TCP store (the path the card's NCCL leg takes)."""
    import torch.distributed as dist

    from tensorflow_train_distributed_torch.testing import free_ports

    cfg = tdist.DistributedConfig(
        coordinator_address=f"127.0.0.1:{free_ports(1)[0]}")
    try:
        tdist.initialize_distributed(cfg, device="cpu", timeout_s=30)
        assert dist.is_initialized() and dist.get_world_size() == 1
        m = tmesh.build_mesh(tmesh.MeshConfig(strategy="fsdp_tp"))
        assert m.device_mesh is not None
        assert m.device_mesh.mesh_dim_names == tmesh.AXES
        assert m.group("data") is None
    finally:
        tdist.shutdown_distributed()
    assert not dist.is_initialized()


# -- sharding rules ------------------------------------------------------


def _jax_specs(name):
    task = jreg.get_task(name)
    batch = {"tokens": jnp.zeros((2, 16), jnp.int32),
             "inputs": jnp.zeros((2, 16), jnp.int32),
             "targets": jnp.zeros((2, 16), jnp.int32)}
    abstract = jax.eval_shape(
        lambda: task.init_variables(jax.random.key(0), batch))
    specs = traverse_util.flatten_dict(
        fnn.get_partition_spec(abstract["params"]), sep="/")
    shapes = traverse_util.flatten_dict(fnn.unbox(abstract["params"]),
                                        sep="/")
    return abstract, specs, shapes


def _port_name(flax_name):
    from tensorflow_train_distributed_torch import convert

    import re
    m = convert._UNROLLED.match(flax_name)
    if m:
        flax_name = f"layers/{m.group(1)}/{m.group(2)}"
    return flax_name.replace("/", ".")


@pytest.mark.parametrize("name", ["llama_tiny_sft", "moe_tiny_lm_gmm",
                                  "qwen_moe_tiny_lm"])
def test_param_logical_axes_match_the_jax_annotations(name):
    _, specs, shapes = _jax_specs(name)
    tnames = {k for k, _ in treg.make_task(
        treg.get_entry(name), device="meta").model.named_parameters()}
    for flax_name, spec in specs.items():
        port = _port_name(flax_name)
        assert port in tnames, port
        want = tuple(spec) if spec else None
        got = tshard.logical_axes(port, len(shapes[flax_name].shape))
        assert got == want, (port, got, want)


@pytest.mark.parametrize("sizes", [
    dict(data=2, fsdp=2, tensor=2), dict(data=1, fsdp=4, tensor=2),
    dict(data=4, tensor=2), dict(data=2, expert=4), dict(fsdp=8),
    dict(data=8)])
@pytest.mark.parametrize("name", ["llama_tiny_sft", "moe_tiny_lm_gmm"])
def test_state_shardings_and_zero1_match_jax(name, sizes):
    abstract, specs, shapes = _jax_specs(name)
    cfg = jmesh.MeshConfig(**sizes)
    jm = jmesh.build_mesh(cfg, devices=jax.devices()[:8])
    tm = tmesh.Mesh(cfg.resolve(8), 0)

    def flat_spec(tree):
        return {k: tuple(v.spec) for k, v in traverse_util.flatten_dict(
            tree, sep="/").items()}

    want = flat_spec(jshard.make_state_shardings(
        jm, abstract["params"]))
    want0 = flat_spec(jshard.zero1_opt_shardings(
        jm, abstract["params"], jshard.make_state_shardings(
            jm, abstract["params"])))
    tshapes = {_port_name(k): tuple(v.shape) for k, v in shapes.items()}
    got = tshard.make_state_shardings(tm, tshapes)
    got0 = tshard.zero1_opt_shardings(tm, tshapes, got)

    def norm(spec, rank):
        out = []
        for e in list(spec) + [None] * (rank - len(spec)):
            out.append(None if e is None else
                       ((e,) if isinstance(e, str) else tuple(e)))
        return tuple(out)

    for k in want:
        p, rank = _port_name(k), len(shapes[k].shape)
        assert got[p] == norm(want[k], rank), (p, got[p], want[k])
        assert got0[p] == norm(want0[k], rank), (p, got0[p], want0[k])
        assert tshard.cross_replica_update_shardings(
            tm, tshapes, got)[p] == got0[p]


def test_placements_are_dtensor_shard_and_replicate():
    from torch.distributed.tensor import Replicate, Shard

    m = tmesh.Mesh(dict(pipeline=1, data=2, fsdp=2, expert=1, seq=1,
                        tensor=2), 0)
    spec = tshard.make_state_shardings(
        m, {"layers.0.mlp.wi_gate.kernel": (64, 128)})[
            "layers.0.mlp.wi_gate.kernel"]
    assert spec == (("fsdp",), ("tensor",))
    got = tshard.placements(m, spec)
    assert got[tmesh.AXES.index("fsdp")] == Shard(0)
    assert got[tmesh.AXES.index("tensor")] == Shard(1)
    assert all(p == Replicate() for i, p in enumerate(got)
               if tmesh.AXES[i] not in ("fsdp", "tensor"))


@pytest.mark.parametrize("w_old,w_new", [(4, 2), (4, 1), (2, 4), (3, 2),
                                         (4, 3), (2, 2), (8, 4)])
def test_fold_leading_replicas_matches_jax(w_old, w_new):
    arr = np.random.default_rng(w_old * 10 + w_new).standard_normal(
        (w_old, 5, 3)).astype(np.float32)
    want = jshard.fold_leading_replicas(arr, w_new)
    np.testing.assert_array_equal(tshard.fold_leading_replicas(arr, w_new),
                                  want)
    got = tshard.fold_leading_replicas(torch.from_numpy(arr), w_new)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy().sum(0), arr.sum(0), rtol=1e-6,
                               atol=1e-6)


def test_shard_and_gather_round_trip_on_one_rank():
    m = tmesh.Mesh({a: 1 for a in tmesh.AXES}, 0)
    x = torch.arange(12.).reshape(3, 4)
    assert tshard.shard(m, (("fsdp",), None), x) is x
    assert torch.equal(tshard.gather(m, (("fsdp",), None), x), x)


def test_registry_strategies_match_jax():
    for name in treg.available():
        assert treg.get_entry(name)["strategy"] == \
            jreg.get_entry(name)["strategy"], name
