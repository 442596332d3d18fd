"""Worker functions the gloo tests run in ``MultiProcessRunner`` ranks
(``tests/test_torch_{collectives,parallel_train,expert_parallel}.py``).

Each is ``fn(rank, **payload)`` in a child that has joined the gloo
group; it returns JSON and writes arrays to the ``.npz`` paths its
payload names.  Imports torch and the port only (no JAX: the children
stay light).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _mesh(sizes: dict):
    from tensorflow_train_distributed_torch.runtime.mesh import (
        MeshConfig,
        build_mesh,
    )

    return build_mesh(MeshConfig(**sizes))


# -- collectives ---------------------------------------------------------


def ef_syncs(rank, *, world, seed, rounds, out):
    """3 rounds of ``ef_grad_sync`` and of ``ef_bucket_sync`` (2 buckets)
    on seeded per-rank leaves; rank 0 writes every round's sums and each
    rank's residuals to ``out`` (rank-suffixed)."""
    from tensorflow_train_distributed_torch.parallel import collectives as C

    mesh = _mesh({"data": world})
    group = mesh.group("data")
    shapes = [(40, 33), (7,), (1100,), (3, 700)]
    res = {"grad": [torch.zeros(s) for s in shapes],
           "bucket": [torch.zeros(s) for s in shapes]}
    saved = {}
    for step in range(rounds):
        rng = np.random.default_rng([seed, step, rank])
        grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in shapes]
        mean, res["grad"], fin = C.ef_grad_sync(grads, res["grad"], group)
        assert bool(fin)
        for j, m in enumerate(mean):
            saved[f"grad_sum_{step}_{j}"] = m.numpy()
        buckets = C.plan_grad_buckets(grads, 2)
        bmean = [None] * len(shapes)
        for b in buckets:
            bm, br, bf = C.ef_bucket_sync([grads[j] for j in b],
                                          [res["bucket"][j] for j in b],
                                          group)
            assert bool(bf)
            for j, a, r in zip(b, bm, br):
                bmean[j], res["bucket"][j] = a, r
        for j, m in enumerate(bmean):
            saved[f"bucket_sum_{step}_{j}"] = m.numpy()
    for kind in ("grad", "bucket"):
        for j, r in enumerate(res[kind]):
            saved[f"{kind}_res_{j}"] = r.numpy()
    np.savez(f"{out}.{rank}.npz", **saved)
    return {"rank": rank}


def named_collectives(rank, *, world):
    """The named collectives over a data group, against their meaning."""
    from tensorflow_train_distributed_torch.parallel import collectives as C

    mesh = _mesh({"data": world})
    g = mesh.group("data")
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 100 * rank
    out = {
        "sum": C.all_reduce(x, g).tolist(),
        "mean": C.all_reduce(x, g, op="mean").tolist(),
        "max": C.all_reduce(x, g, op="max").tolist(),
        "gather1": C.all_gather(x, g, gather_dim=1).tolist(),
        "scatter": C.reduce_scatter(x, g, scatter_dim=0).tolist(),
        "a2a": C.all_to_all(x, g, split_dim=0, concat_dim=1).tolist(),
        "ring": C.ring_permute(x, g, shift=1).tolist(),
        "q8": C.q8_all_reduce(x.reshape(-1) / 7.0, g).tolist(),
        "bcast": C.broadcast_from_coordinator({"r": rank}),
        "mean_metrics": C.host_all_reduce_mean({"loss": float(rank)}, g),
        "bus": C.allreduce_bus_bandwidth(g, size_mb=0.01, iters=2,
                                         warmup=1),
    }
    return out


# -- training --------------------------------------------------------------


def llama_batches(steps: int, batch: int, seed: int = 0):
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches

    it = iter(HostBatches(SyntheticLM(num_examples=64, seq_len=16,
                                      vocab_size=256), batch, seed=seed))
    return [next(it) for _ in range(steps)]


def make_llama_trainer(mesh=None, *, zero1=False, sharded_update=False,
                       grad_quant="none", grad_overlap=0, clip=1.0,
                       config="llama_tiny_sft", optimizer="adamw", lr=3e-3,
                       precision="float32"):
    """The trainer the tests hold against each other: f32 compute by
    default (a bf16 product rounds each rank's partial weight gradient,
    so a data-parallel bf16 step differs from one rank's by bf16 steps)."""
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    entry = registry.get_entry(config)
    task = registry.make_task(entry, device="meta")
    tx = optimizers.make_optimizer(optimizer, lr, weight_decay=0.01,
                                   grad_clip_norm=clip)
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy,
    )

    return Trainer(task, tx, device="cpu", mesh=mesh,
                   policy=Policy.from_name(precision), config=TrainerConfig(
        seed=0, log_every=1, log_grad_norm=True, zero1=zero1,
        sharded_update=sharded_update, grad_quant=grad_quant,
        grad_overlap=grad_overlap))


def train_llama(rank, *, mesh, steps, out, params_npz=None, batch=16,
                zero1=False, sharded_update=False, grad_quant="none",
                grad_overlap=0, config="llama_tiny_sft", optimizer="adamw",
                lr=3e-3, clip=1.0):
    """``steps`` trainer steps of ``config`` on ``mesh`` from the weights
    in ``params_npz`` (else the seed's); each rank trains on its rows of
    the same global batches.  Rank 0 writes the final params; every rank
    returns its history."""
    from tensorflow_train_distributed_torch.parallel.sharding import (
        shard_batch,
    )

    m = _mesh(mesh)
    trainer = make_llama_trainer(m, zero1=zero1,
                                 sharded_update=sharded_update,
                                 grad_quant=grad_quant,
                                 grad_overlap=grad_overlap, config=config,
                                 optimizer=optimizer, lr=lr, clip=clip)
    params = None
    if params_npz:
        with np.load(params_npz) as f:
            params = {k: torch.from_numpy(f[k]) for k in f.files}
    state = trainer.create_state(params)
    batches = [shard_batch(m, b) for b in llama_batches(steps, batch)]
    state, history = trainer.fit(batches, steps=steps, state=state)
    full = trainer.full_state(state)
    if rank == 0:
        np.savez(out, **{k: v.detach().numpy()
                         for k, v in full.params.items()})
    return {"history": [[s, m] for s, m in history],
            "mesh": m.shape}


def train_variants(rank, *, variants, out_dir, **common):
    """``train_llama`` for each of ``variants`` ({name: overrides}) in turn
    in this one process group (each builds its own mesh and groups), so
    one cluster start serves them all; rank 0 writes ``<out_dir>/<name>
    .npz``.  Returns {name: train_llama's result}."""
    return {name: train_llama(rank, **dict(common, **kw),
                              out=f"{out_dir}/{name}.npz")
            for name, kw in variants.items()}


def expert_block(cfg, seed):
    """A ``MoEMlpBlock`` without storage and its whole weights, drawn from
    ``seed`` (N(0, 1/fan_in))."""
    from tensorflow_train_distributed_torch.models.moe import MoEMlpBlock

    block = MoEMlpBlock(cfg, device="meta")
    gen = torch.Generator().manual_seed(seed)
    full = {}
    for name, p in block.named_parameters():
        shape = tuple(p.shape)
        fan_in = shape[-2] if len(shape) >= 2 else 1
        full[name] = torch.randn(shape, generator=gen) / fan_in ** 0.5
    return block, full


def moe_block_ep(rank, *, mesh, seed, out, dispatch="gmm"):
    """``moe_tiny_lm_gmm``'s block on ``mesh`` (data × expert): rank's rows
    of a seeded batch, forward and backward of sum(y²); rank 0 writes the
    whole output, the router's gradient and the gathered expert-stack
    gradients."""
    from tensorflow_train_distributed_torch.models import moe
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.parallel import collectives as C
    from tensorflow_train_distributed_torch.parallel.sharding import (
        shard_batch,
    )

    m = _mesh(mesh)
    cfg = dataclasses.replace(registry.get_entry("moe_tiny_lm_gmm")["config"],
                              dispatch=dispatch)
    block, full = expert_block(cfg, seed)
    moe.set_expert_parallel(block, m)
    ep, ix = m.shape["expert"], m.index("expert")
    local = {k: (v.chunk(ep, 0)[ix] if ".experts." in "." + k else v)
             for k, v in full.items()}
    block.load_state_dict({k: v.clone() for k, v in local.items()},
                          assign=True)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8, 16, cfg.d_model)).astype(np.float32))
    xl = shard_batch(m, {"x": x})["x"].requires_grad_(True)
    y, _, _ = block(xl)
    (y.float() ** 2).sum().backward()
    dgrp = m.group("data")
    grads = {}
    for k, p in block.named_parameters():
        g = C.all_reduce(p.grad, dgrp)
        if "experts." in k:
            g = C.all_gather(g, m.group("expert"), gather_dim=0)
        grads[k] = g
    y_all = C.all_gather(y.detach(), dgrp, gather_dim=0)
    dx = C.all_gather(xl.grad, dgrp, gather_dim=0)
    if rank == 0:
        np.savez(out, y=y_all.numpy(), dx=dx.numpy(),
                 **{f"grad.{k}": v.numpy() for k, v in grads.items()},
                 **{f"param.{k}": v.numpy() for k, v in full.items()},
                 x=x.numpy())
    return {"rank": rank}


def planted_overflow(rank, *, variants):
    """For each of ``variants`` ({name: dict(mesh, config, grad_quant)}):
    two float16 steps (sgd) on the mesh, with an inf planted at the first
    step in the last element of every local gradient, before the sync,
    on the ranks whose tensor and expert indices are their axes' last
    (those ranks' pieces hold it, their peers' do not).  Returns {name:
    each step's grads_finite and loss scale, and whether this rank's
    parameters came through the first step unchanged}."""
    from tensorflow_train_distributed_torch.parallel.sharding import (
        shard_batch,
    )

    out = {}
    for name, v in variants.items():
        m = _mesh(v["mesh"])
        trainer = make_llama_trainer(
            m, config=v["config"], optimizer="sgd", lr=0.3,
            grad_quant=v.get("grad_quant", "none"), precision="float16")
        state = trainer.create_state()
        init = [p.detach().clone() for p in state.params.values()]
        planted = all(m.index(a) == m.shape[a] - 1
                      for a in ("tensor", "expert"))
        sync, calls = trainer.plan.sync_grads, []

        def sync_with_inf(grads, sync=sync, calls=calls, planted=planted,
                          **kw):
            calls.append(None)
            if planted and len(calls) == 1:
                grads = [None if g is None else g.clone() for g in grads]
                for g in grads:
                    if g is not None:
                        g.view(-1)[-1] = float("inf")
            return sync(grads, **kw)

        trainer.plan.sync_grads = sync_with_inf
        batches = [shard_batch(m, b) for b in llama_batches(2, 16)]
        history = []
        state, h = trainer.fit(batches[:1], steps=1, state=state)
        history += h
        unchanged = all(torch.equal(p, q) for p, q in
                        zip(state.params.values(), init))
        state, h = trainer.fit(batches[1:], steps=1, state=state)
        history += h
        out[name] = {"finite": [m_["grads_finite"] for _, m_ in history],
                     "scale": [m_["loss_scale"] for _, m_ in history],
                     "unchanged": unchanged, "planted": planted}
    return out


# -- the trainer's flight-recorder spans and cross-rank BatchNorm -----------


def train_spans(rank, *, variants, steps, dump=None):
    """For each of ``variants`` ({name: TrainerConfig overrides}),
    ``steps`` of llama_tiny_sft on a data=2 mesh with the flight recorder
    cleared just before ``fit``: the ``train/*`` events as [name, attrs]
    in recording order.  Rank 0 saves each run's Chrome trace to
    ``<dump>.<name>.json``."""
    from tensorflow_train_distributed_torch.parallel.sharding import (
        shard_batch,
    )
    from tensorflow_train_distributed_torch.runtime import events

    m = _mesh({"data": 2})
    out = {}
    for name, kw in variants.items():
        trainer = make_llama_trainer(m, clip=0.0, **kw)
        state = trainer.create_state()
        batches = [shard_batch(m, b) for b in llama_batches(steps, 16)]
        rec = events.get_recorder()
        rec.clear()
        trainer.fit(batches, steps=steps, state=state)
        out[name] = [[e[0], e[5] or {}] for e in rec.events()
                     if e[0].startswith("train/")]
        if dump and rank == 0:
            rec.save(f"{dump}.{name}.json")
    return out


def resnet_entry(stride: int):
    """resnet_tiny's registry entry, BatchNorm's statistics over every
    ``stride``-th row and column."""
    from tensorflow_train_distributed_torch.models import registry

    entry = registry.get_entry("resnet_tiny")
    return dict(entry, config=dataclasses.replace(entry["config"],
                                                  bn_stats_stride=stride))


def resnet_trainer(entry, mesh=None):
    """resnet_tiny's trainer as the sync-BN tests hold it: adamw 1e-3,
    f32, a metric read every step."""
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy,
    )
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    return Trainer(registry.make_task(entry, device="meta"),
                   optimizers.make_optimizer("adamw", 1e-3), device="cpu",
                   mesh=mesh, policy=Policy.from_name("float32"),
                   config=TrainerConfig(log_every=1))


def resnet_batches(entry, steps: int, batch: int) -> list:
    from tensorflow_train_distributed_torch.data import datasets
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches

    it = iter(HostBatches(datasets.get_dataset(
        entry["dataset"], **dict(entry["dataset_kwargs"], num_examples=64)),
        batch, seed=0))
    return [next(it) for _ in range(steps)]


def sync_bn(rank, *, runs, steps, batch):
    """For each of ``runs`` ({stride: [params_npz, out]}), ``steps`` of
    resnet_tiny (``stats_stride`` stride) on a data=2 mesh from the
    weights and statistics in params_npz, each rank on its half of the
    global batches.  Rank 0 writes the running statistics to out; every
    rank returns, by stride, its history and a digest of its statistics
    (they must agree)."""
    from tensorflow_train_distributed_torch.parallel.sharding import (
        shard_batch,
    )

    m = _mesh({"data": 2})
    res = {}
    for stride, (params_npz, out) in runs.items():
        entry = resnet_entry(int(stride))
        trainer = resnet_trainer(entry, m)
        with np.load(params_npz) as f:
            params = {k: torch.from_numpy(f[k]) for k in f.files}
        state = trainer.create_state(params)
        batches = [shard_batch(m, b)
                   for b in resnet_batches(entry, steps, batch)]
        state, history = trainer.fit(batches, steps=steps, state=state)
        stats = {k: v.detach().numpy()
                 for k, v in state.model_state.items()}
        if rank == 0:
            np.savez(out, **stats)
        res[stride] = {"history": [[s, h] for s, h in history],
                       "digest": float(sum(np.abs(v).sum()
                                           for v in stats.values()))}
    return res


# -- the runner's own environment ------------------------------------------


def child_env(rank):
    """What the runner's child set up from its environment: torch's
    thread count and whether it joined a process group."""
    import torch.distributed as dist

    return {"rank": rank, "threads": torch.get_num_threads(),
            "distributed": dist.is_initialized(),
            "world": dist.get_world_size() if dist.is_initialized() else 1}
