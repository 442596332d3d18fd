"""Worker functions of the sequence, pipeline, embedding and tensor-split
serving tests (``tests/test_torch_{seq_parallel,pipeline,embedding,
sharded_serving}.py``), run in ``MultiProcessRunner`` gloo ranks.

Each is ``fn(rank, **payload)``; inputs come as ``.npz`` paths, and rank
0 writes the gathered results to the ``out`` path.  Imports torch and
the port only (no JAX).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from _torch_dist_workers import _mesh, make_llama_trainer


def _load(path) -> dict:
    with np.load(path) as f:
        return {k: torch.from_numpy(f[k].copy()) for k in f.files}


def _save(rank, out, arrays: dict):
    if rank == 0:
        np.savez(out, **{k: v.detach().cpu().numpy()
                         for k, v in arrays.items()})


# -- sequence parallelism ------------------------------------------------

# name -> (method, causal, packed, window, sinks, gqa)
ATTENTION_CASES = {
    f"{m}_{kind}": (m, causal, packed, window, sinks, gqa)
    for m in ("ring", "ulysses")
    for kind, causal, packed, window, sinks, gqa in (
        ("full", False, False, None, 0, False),
        ("causal", True, False, None, 0, False),
        ("packed_full", False, True, None, 0, False),
        ("packed_causal", True, True, None, 0, False),
        ("window_sinks", True, False, 20, 4, False),
        ("packed_window_sinks", True, True, 20, 4, False),
        ("gqa", True, False, None, 0, True))
}


def attention_cases(rank, *, inp, out):
    """Every ``ATTENTION_CASES`` case on this rank's sequence block of the
    inputs over the seq group: the output and the q/k/v gradients of the
    sum of all outputs, gathered along the sequence; plus Ulysses'
    refusal of 2 heads over the group."""
    from tensorflow_train_distributed_torch.parallel import collectives as C
    from tensorflow_train_distributed_torch.parallel.ring_attention import (
        shard_mapped_attention,
    )

    x = _load(inp)
    world = torch.distributed.get_world_size()
    m = _mesh({"data": 1, "seq": world})
    g = m.group("seq")
    i, s = m.index("seq"), x["q"].shape[2]
    w = s // world

    def block(t, dim=2):
        return t.narrow(dim, i * w, w).clone()

    saved = {}
    for name, (method, causal, packed, window, sinks, gqa) in \
            ATTENTION_CASES.items():
        q = block(x["q8"] if gqa else x["q"]).requires_grad_(True)
        k = block(x["k4"] if gqa else x["k"]).requires_grad_(True)
        v = block(x["v4"] if gqa else x["v"]).requires_grad_(True)
        seg = block(x["seg"], 1) if packed else None
        o = shard_mapped_attention(m, q, k, v, method=method, causal=causal,
                                   segment_ids=seg, window=window,
                                   sinks=sinks)
        o.sum().backward()
        for key, t in (("out", o.detach()), ("dq", q.grad), ("dk", k.grad),
                       ("dv", v.grad)):
            saved[f"{name}.{key}"] = C.all_gather(t, g, gather_dim=2)
    try:
        shard_mapped_attention(m, block(x["q"])[:, :2], block(x["k"])[:, :2],
                               block(x["v"])[:, :2], method="ulysses")
        refusal = None
    except ValueError as e:
        refusal = str(e)
    _save(rank, out, saved)
    return {"refusal": refusal}


def llama_sp_curves(rank, *, params_npz, batches_npz, steps, methods):
    """``steps`` adam steps of llama_tiny (MHA, as the JAX test) with
    ``seq_parallel`` = each of ``methods`` on a seq mesh of the world,
    from ``params_npz`` on the global batches of ``batches_npz``.
    Returns {method: losses}."""
    from tensorflow_train_distributed_torch.models import llama
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy,
    )
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    world = torch.distributed.get_world_size()
    params = _load(params_npz)
    data = _load(batches_npz)
    batches = [{k[len(f"{j}."):]: v for k, v in data.items()
                if k.startswith(f"{j}.")} for j in range(steps)]
    out = {}
    for method in methods:
        m = _mesh({"data": 1, "seq": world})
        cfg = dataclasses.replace(llama.LLAMA_PRESETS["llama_tiny"],
                                  seq_parallel=method, num_kv_heads=None)
        trainer = Trainer(llama.CausalLmTask(cfg, device="meta"),
                          optimizers.make_optimizer("adam", 1e-3),
                          device="cpu", mesh=m,
                          policy=Policy.from_name("float32"),
                          config=TrainerConfig(seed=0, log_every=1))
        state = trainer.create_state({k: v.clone()
                                      for k, v in params.items()})
        assert trainer.task.model.seq_sharded
        state, history = trainer.fit(batches, steps=steps, state=state)
        out[method] = [h["loss"] for _, h in history]
    return out


def llama_sp_predict(rank, *, params_npz, batches_npz, n, methods, out):
    """``Trainer.predict`` of llama_tiny (MHA) with ``seq_parallel`` = each
    of ``methods`` on a seq mesh of the world, from ``params_npz`` over the
    first ``n`` batches of ``batches_npz``; each rank writes each method's
    logits to ``out`` with its rank before the suffix (``x.npz`` ->
    ``x.1.npz``): every rank returns the whole rows."""
    from tensorflow_train_distributed_torch.models import llama
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy,
    )
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    world = torch.distributed.get_world_size()
    params = _load(params_npz)
    with np.load(batches_npz) as f:
        batches = [{k[len(f"{j}."):]: f[k] for k in f.files
                    if k.startswith(f"{j}.")} for j in range(n)]
    logits = {}
    for method in methods:
        cfg = dataclasses.replace(llama.LLAMA_PRESETS["llama_tiny"],
                                  seq_parallel=method, num_kv_heads=None)
        trainer = Trainer(llama.CausalLmTask(cfg, device="meta"),
                          optimizers.make_optimizer("adam", 1e-3),
                          device="cpu", mesh=_mesh({"data": 1,
                                                    "seq": world}),
                          policy=Policy.from_name("float32"),
                          config=TrainerConfig(seed=0))
        state = trainer.create_state({k: v.clone()
                                      for k, v in params.items()})
        logits[method] = trainer.predict(batches, state).numpy()
    np.savez(out.replace(".npz", f".{rank}.npz"), **logits)


# -- pipeline ------------------------------------------------------------


def stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_cases(rank, *, inp, out):
    """The gpipe and gpipe_layers cases on a pipeline=4 mesh (and
    pipeline=2 × data=2 for the composition with data): each output, and
    the gradients of mean(y²) over the stacked params and the input,
    gathered; the two refusals' texts."""
    from tensorflow_train_distributed_torch.parallel import collectives as C
    from tensorflow_train_distributed_torch.parallel import pipeline as P

    x = _load(inp)
    saved, texts = {}, {}

    def stacked(prefix):
        return {"w": x[f"{prefix}.w"].clone().requires_grad_(True),
                "b": x[f"{prefix}.b"].clone().requires_grad_(True)}

    def run(name, m, fn, params, xin, **kw):
        xin = xin.clone().requires_grad_(True)
        y = fn(stage_fn, params, xin, mesh=m, **kw)
        (y ** 2).mean().backward()
        pg = m.group("pipeline")
        saved[f"{name}.y"] = y.detach()
        saved[f"{name}.dx"] = xin.grad
        # Each stage's slice of the stacked grads is its own; the sum
        # over the pipeline gathers them (zero elsewhere).
        for k, p in params.items():
            saved[f"{name}.d{k}"] = C.all_reduce(p.grad, pg)

    m4 = _mesh({"data": 1, "pipeline": 4})
    for micro in (1, 2, 4, 8, 16):
        run(f"gpipe_m{micro}", m4, P.gpipe, stacked("s4"), x["x"],
            num_microbatches=micro)
    run("layers", m4, P.gpipe_layers, stacked("s8"), x["x8"],
        num_microbatches=4)
    for key, call in (
            ("microbatch", lambda: P.gpipe(stage_fn, stacked("s4"), x["x"],
                                           mesh=m4, num_microbatches=3)),
            ("layers", lambda: P.gpipe_layers(
                stage_fn, {k: v[:6] for k, v in stacked("s8").items()},
                x["x8"], mesh=m4, num_microbatches=2))):
        try:
            call()
            texts[key] = None
        except ValueError as e:
            texts[key] = str(e)
    m22 = _mesh({"data": 2, "pipeline": 2})
    d = m22.index("data")
    rows = x["x"].shape[0] // 2
    xd = x["x"][d * rows:(d + 1) * rows]
    y = P.gpipe(stage_fn, stacked("s2"), xd, mesh=m22, num_microbatches=2,
                batch_axes=("data",))
    saved["data.y"] = C.all_gather(y.detach(), m22.group("data"))
    _save(rank, out, saved)
    return texts


def llama_pp(rank, *, params_npz, steps, ckpt_dir, save_at):
    """``steps`` steps of llama_tiny_pp under dp_pp (pipeline = world),
    adam 1e-3, no clip, f32, from ``params_npz``; a whole-state
    checkpoint at step ``save_at`` (every rank gathers, rank 0 writes).
    Returns the losses, the layers this rank holds, and the model's
    refusal of decode under the pipeline mesh."""
    from _torch_dist_workers import llama_batches

    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    world = torch.distributed.get_world_size()
    m = _mesh({"data": 1, "pipeline": world})
    trainer = make_llama_trainer(m, config="llama_tiny_pp",
                                 optimizer="adam", lr=1e-3, clip=None)
    state = trainer.create_state(_load(params_npz))
    batches = llama_batches(steps, 16)
    state, h1 = trainer.fit(batches[:save_at], steps=save_at, state=state)
    trainer.save_checkpoint(save_at, state,
                            manager=CheckpointManager(ckpt_dir))
    state, h2 = trainer.fit(batches[save_at:], steps=steps - save_at,
                            state=state)
    model = trainer.task.model
    try:
        model(torch.zeros((1, 4), dtype=torch.long),
              model.init_cache(1, 8, device="cpu"))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return {"losses": [x["loss"] for _, x in h1 + h2],
            "layers": sorted({k.split(".")[1] for k in state.params
                              if k.startswith("layers.")}, key=int),
            "refusal": refusal}


# -- embeddings ------------------------------------------------------------


def embedding_cases(rank, *, inp, out):
    """The JAX ``tests/test_embedding.py`` cases on a tensor mesh of the
    world: lookups, zero rows, the sparse gradient, the refusals, the
    collection's outputs (whole tables from ``inp``)."""
    from tensorflow_train_distributed_torch.ops import embedding as E

    x = _load(inp)
    world = torch.distributed.get_world_size()
    m = _mesh({"data": 1, "tensor": world})
    saved, texts = {}, {}
    saved["lookup"] = E.sharded_lookup(x["table"], x["ids"], mesh=m)
    saved["ones"] = E.sharded_lookup(torch.ones(32, 8), x["pad_ids"], mesh=m)
    saved["unsharded"] = E.sharded_lookup(x["small"], x["small_ids"],
                                          mesh=None)
    n = x["table"].shape[0] // world
    block = x["table"][m.index("tensor") * n:][:n]
    saved["block"] = E.sharded_lookup(block, x["ids"], mesh=m,
                                      vocab_size=x["table"].shape[0])
    t = torch.zeros(16 // world, 4, requires_grad=True)
    E.sharded_lookup(t, x["grad_ids"], mesh=m, vocab_size=16).sum().backward()
    from tensorflow_train_distributed_torch.parallel import collectives as C

    saved["grad"] = C.all_gather(t.grad, m.group("tensor"))
    for key, call in (
            ("vocab", lambda: E.sharded_lookup(torch.zeros(31, 4),
                                               torch.zeros(2).long(),
                                               mesh=m)),
            ("unknown", lambda: E.EmbeddingCollection(
                E_TABLES(E), (E.FeatureSpec("x", table="nope"),), mesh=m)),
            ("duplicate", lambda: E.EmbeddingCollection(
                E_TABLES(E) + (E.TableSpec("ids", 64, 8),),
                E_FEATURES(E), mesh=m))):
        try:
            call()
            texts[key] = None
        except ValueError as e:
            texts[key] = str(e)
    coll = E.EmbeddingCollection(E_TABLES(E), E_FEATURES(E), mesh=m)
    coll.load_tables({"ids": x["t.ids"], "cats": x["t.cats"]})
    texts["shapes"] = {k: list(v.shape)
                       for k, v in coll.state_dict().items()}
    feats = {k[2:]: v for k, v in x.items() if k.startswith("f.")}
    for k, v in coll(feats).items():
        saved[f"coll.{k}"] = v.detach()
    _save(rank, out, saved)
    return texts


def E_TABLES(E):
    return (E.TableSpec("ids", vocab_size=64, dim=8),
            E.TableSpec("cats", vocab_size=32, dim=4))


def E_FEATURES(E):
    return (E.FeatureSpec("user", table="ids"),
            E.FeatureSpec("item", table="ids"),
            E.FeatureSpec("tags", table="cats", combiner="sum"),
            E.FeatureSpec("hist", table="cats", combiner="sqrtn"))


# -- tensor-split serving ----------------------------------------------------


def sharded_serving(rank, *, cases):
    """Each of ``cases`` ({name: dict(config, params_npz, mesh, engine
    kwargs, requests, prefix)}) through a ``ServingEngine(mesh=)`` on this
    rank; returns {name: the tokens, the rank's weight and pool shapes,
    the pool's block count}."""
    from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS
    from tensorflow_train_distributed_torch.models.moe import MOE_PRESETS
    from tensorflow_train_distributed_torch.serving import ServingEngine

    import os

    out = {}
    for name, c in cases.items():
        m = _mesh(c["mesh"])
        cfg = {**LLAMA_PRESETS, **MOE_PRESETS}[c["preset"]]
        if "hbm_bytes" in c:
            # This rank's memory report (the autosize solve reads it).
            os.environ["TTD_HBM_BYTES"] = str(c["hbm_bytes"][rank])
        eng = ServingEngine(cfg, _load(c["params_npz"]), mesh=m,
                            device="cpu", **c["engine"])
        pieces = []
        if c.get("prefix"):
            eng.preload_prefix(c["prefix"])
            orig = eng._prefill_piece

            def counting(cache_1, toks, *a, orig=orig, **kw):
                pieces.append(int(toks.shape[1]))
                return orig(cache_1, toks, *a, **kw)

            eng._prefill_piece = counting
        ids = [eng.submit(p, n) for p, n in c["requests"]]
        got = eng.run()
        model = eng._model
        shapes = {k: list(v.shape) for k, v in model.state_dict().items()
                  if k.startswith(("token_embed", "lm_head", "layers.0."))}
        out[name] = {"tokens": [got[i] for i in ids], "shapes": shapes,
                     "pool_blocks": (eng._kv_pool.n_blocks
                                     if eng._kv_pool is not None else None),
                     "budget": eng.hbm_budget_bytes, "pieces": pieces,
                     "pool_shape": list(eng._grids()[0].layers[0][
                         "key_pool"].shape) if eng.paged else None}
    return out
