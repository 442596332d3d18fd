"""Sequence parallelism (``parallel/ring_attention.py``, the llama
``seq_parallel`` hook and the trainer's seq axis) over gloo ranks
against the JAX package's ``shard_mapped_attention`` and ``dp_sp``
trainer on the virtual CPU mesh.

Attention: b 2, h 4, S 64, d 8 over a seq axis of 4 (16 rows a rank),
f32; every case of ``_torch_mesh_workers.ATTENTION_CASES`` (ring and
Ulysses; full and causal; packed segments; window 20 with 4 sinks, where
the ring runs 2 of its 3 hops; GQA with 8 query and 4 unrepeated kv
heads) in one 4-rank spawn, the JAX side on a seq=4 mesh of the first 4
devices.  The bars are the JAX ``tests/test_seq_parallel.py``'s: the
outputs within atol 2e-5, rtol 1e-4, the q/k/v gradients of the sum of
the outputs within atol 3e-5, rtol 2e-4.  Training: llama_tiny (MHA, as
the JAX end-to-end test), adam 1e-3, f32, 8 steps of 16 rows of 32
tokens from the JAX trainer's own initial params; the port's ring and
Ulysses curves under seq=2 against the JAX ring curve under dp_sp
(data 1 × seq 2) at rtol 2e-3, the JAX test's bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
import flax.linen as fnn

import _torch_mesh_workers as W
from tensorflow_train_distributed_tpu.models import llama as jllama
from tensorflow_train_distributed_tpu.parallel.ring_attention import (
    shard_mapped_attention as jax_attention,
)
from tensorflow_train_distributed_tpu.runtime import mesh as jmesh
from tensorflow_train_distributed_tpu.training.callbacks import History
from tensorflow_train_distributed_tpu.training.mixed_precision import (
    Policy as JaxPolicy,
)
from tensorflow_train_distributed_tpu.training.trainer import (
    Trainer as JaxTrainer,
    TrainerConfig as JaxTrainerConfig,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
from tensorflow_train_distributed_torch.data.pipeline import HostBatches
from tensorflow_train_distributed_torch.models import llama as tllama
from tensorflow_train_distributed_torch.testing import MultiProcessRunner

SEQ, STEPS = 4, 8


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    b, h, s, d = 2, 4, 64, 8
    arr = {k: rng.standard_normal((b, h, s, d)).astype(np.float32)
           for k in "qkv"}
    arr["q8"] = rng.standard_normal((b, 8, s, d)).astype(np.float32)
    arr["k4"] = rng.standard_normal((b, 4, s, d)).astype(np.float32)
    arr["v4"] = rng.standard_normal((b, 4, s, d)).astype(np.float32)
    # Contiguous segments per row, monotone like real packing.
    arr["seg"] = np.sort(rng.integers(1, 4, (b, s)), axis=1).astype(
        np.int32)
    path = str(tmp_path_factory.mktemp("sp") / "in.npz")
    np.savez(path, **arr)
    return arr, path


@pytest.fixture(scope="module")
def port(inputs):
    _, path = inputs
    out = path.replace("in.npz", "out.npz")
    res = MultiProcessRunner(
        "_torch_mesh_workers:attention_cases", SEQ,
        payload=dict(inp=path, out=out), timeout=240).run()
    with np.load(out) as f:
        return {k: f[k] for k in f.files}, res[0].value["refusal"]


@pytest.fixture(scope="module")
def jax_side(inputs):
    arr, _ = inputs
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=1, seq=SEQ),
                            devices=jax.devices()[:SEQ])
    out = {}
    for name, (method, causal, packed, window, sinks, gqa) in \
            W.ATTENTION_CASES.items():
        q, k, v = (jnp.asarray(arr[n]) for n in (
            ("q8", "k4", "v4") if gqa else ("q", "k", "v")))
        seg = jnp.asarray(arr["seg"]) if packed else None

        def f(q_, k_, v_):
            return jax_attention(mesh, q_, k_, v_, method=method,
                                 causal=causal, segment_ids=seg,
                                 window=window, sinks=sinks)

        def both(q_, k_, v_):
            y_, vjp = jax.vjp(f, q_, k_, v_)
            return (y_,) + vjp(jnp.ones_like(y_))

        y, dq, dk, dv = jax.jit(both)(q, k, v)
        for key, t in (("out", y), ("dq", dq), ("dk", dk), ("dv", dv)):
            out[f"{name}.{key}"] = np.asarray(t)
    try:
        jax_attention(mesh, *(jnp.asarray(arr[n][:, :2]) for n in "qkv"),
                      method="ulysses")
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return out, refusal


@pytest.mark.parametrize("name", list(W.ATTENTION_CASES))
def test_attention_matches_jax(port, jax_side, name):
    np.testing.assert_allclose(port[0][f"{name}.out"],
                               jax_side[0][f"{name}.out"],
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", list(W.ATTENTION_CASES))
def test_attention_gradients_match_jax(port, jax_side, name):
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(port[0][f"{name}.{key}"],
                                   jax_side[0][f"{name}.{key}"],
                                   atol=3e-5, rtol=2e-4, err_msg=key)


def test_ulysses_refuses_heads_the_axis_does_not_divide(port, jax_side):
    assert port[1] is not None and port[1] == jax_side[1]
    assert "divisible" in port[1]


def test_window_shortens_the_ring(monkeypatch):
    """S 64 over 4 ranks with window 20: ceil(19/16) = 2 hops of 3, so
    one KV block is never rotated in (k and v: two rotations a hop)."""
    from tensorflow_train_distributed_torch.parallel import ring_attention

    calls = []

    def rotate(x, group, shift=1):
        calls.append(shift)
        return x

    monkeypatch.setattr(ring_attention, "ring_permute", rotate)
    monkeypatch.setattr(ring_attention, "group_size", lambda g: 4)
    monkeypatch.setattr(ring_attention, "group_rank", lambda g: 1)
    q = torch.zeros(1, 1, 16, 8)
    ring_attention.ring_attention(q, q, q, group="seq", causal=True,
                                  window=20)
    assert calls == [1] * 4
    calls.clear()
    ring_attention.ring_attention(q, q, q, group="seq", causal=True)
    assert calls == [1] * 6


# -- the llama curve ----------------------------------------------------------


def _jax_cfg(method):
    cfg = jllama.LLAMA_PRESETS["llama_tiny"]
    return jllama.LlamaConfig(**{**cfg.__dict__, "seq_parallel": method,
                                 "num_kv_heads": None})


def _jax_trainer(mesh, method):
    hist = History()
    trainer = JaxTrainer(jllama.CausalLmTask(_jax_cfg(method)),
                         optax.adam(1e-3), mesh,
                         policy=JaxPolicy.from_name("float32"),
                         config=JaxTrainerConfig(log_every=1),
                         callbacks=[hist])
    return trainer, hist


@pytest.fixture(scope="module")
def curves(tmp_path_factory):
    it = iter(HostBatches(SyntheticLM(num_examples=64, seq_len=32,
                                      vocab_size=256), 16, seed=7))
    batches = [next(it) for _ in range(STEPS)]
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=1, seq=2),
                            devices=jax.devices()[:2])
    trainer, hist = _jax_trainer(mesh, "ring")
    state = trainer.create_state(batches[0])
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(state.params), sep="/").items()}
    tcfg = dataclasses.replace(tllama.LLAMA_PRESETS["llama_tiny"],
                               num_kv_heads=None)
    root = tmp_path_factory.mktemp("curve")
    params = str(root / "params.npz")
    np.savez(params, **{k: v.numpy() for k, v in convert.params_from_flax(
        flat, tcfg).items()})
    data = str(root / "batches.npz")
    np.savez(data, **{f"{j}.{k}": v for j, b in enumerate(batches)
                      for k, v in b.items()})
    res = MultiProcessRunner(
        "_torch_mesh_workers:llama_sp_curves", 2,
        payload=dict(params_npz=params, batches_npz=data, steps=STEPS,
                     methods=["ring", "ulysses"]), timeout=240).run()
    trainer.fit(iter(batches), steps=STEPS, state=state)
    return res[0].value, np.asarray(hist.history["loss"])


@pytest.mark.parametrize("method", ["ring", "ulysses"])
def test_llama_tiny_curve_under_seq2_matches_jax_dp_sp(curves, method):
    port, jax_loss = curves
    assert len(port[method]) == STEPS == len(jax_loss)
    np.testing.assert_allclose(port[method], jax_loss, rtol=2e-3)
    assert port[method][-1] < port[method][0]


# -- predict under seq -------------------------------------------------------


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    """Two batches of 4 rows of 32 tokens through ``Trainer.predict``
    under seq=2 (ring and Ulysses) and through the JAX ``predict`` of the
    ring model on its dp_sp mesh (data 1 x seq 2), from the JAX
    trainer's initial params."""
    it = iter(HostBatches(SyntheticLM(num_examples=16, seq_len=32,
                                      vocab_size=256), 4, seed=3))
    batches = [next(it) for _ in range(2)]
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=1, seq=2),
                            devices=jax.devices()[:2])
    trainer, _ = _jax_trainer(mesh, "ring")
    state = trainer.create_state(batches[0])
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(state.params), sep="/").items()}
    tcfg = dataclasses.replace(tllama.LLAMA_PRESETS["llama_tiny"],
                               num_kv_heads=None)
    root = tmp_path_factory.mktemp("predict")
    params = str(root / "params.npz")
    np.savez(params, **{k: v.numpy() for k, v in convert.params_from_flax(
        flat, tcfg).items()})
    data = str(root / "batches.npz")
    np.savez(data, **{f"{j}.{k}": v for j, b in enumerate(batches)
                      for k, v in b.items()})
    out = str(root / "logits.npz")
    MultiProcessRunner(
        "_torch_mesh_workers:llama_sp_predict", 2,
        payload=dict(params_npz=params, batches_npz=data, n=len(batches),
                     methods=["ring", "ulysses"], out=out),
        timeout=240).run()
    port = {}
    for rank in range(2):
        with np.load(out.replace(".npz", f".{rank}.npz")) as f:
            port.update({(rank, k): f[k] for k in f.files})
    return port, np.asarray(trainer.predict(iter(batches), state))


@pytest.mark.parametrize("method", ["ring", "ulysses"])
def test_predict_under_seq2_returns_every_position_as_jax(predictions,
                                                          method):
    """Every rank returns every position's logits, [8, 32, 256], as the
    JAX ``predict`` returns them (the forward bars of the attention
    cases)."""
    port, jax_logits = predictions
    assert jax_logits.shape == (8, 32, 256)
    for rank in range(2):
        np.testing.assert_allclose(port[rank, method], jax_logits,
                                   atol=2e-5, rtol=1e-4,
                                   err_msg=f"rank {rank}")
