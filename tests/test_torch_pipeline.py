"""The GPipe pipeline (``parallel/pipeline.py``, llama's
``_pipelined_blocks``, the trainer's stage-owned layers) over gloo ranks.

The schedule is an execution order, not a change of the math: ``gpipe``
and ``gpipe_layers`` are held to the sequential stack (the JAX
``tests/test_pipeline.py``'s stage function, tanh(x @ w + b), dim 8) at
rtol and atol 1e-6, values and the gradients of mean(y²) over the
stacked params and the input, on a pipeline=4 mesh at 1, 2, 4, 8 and 16
microbatches of 16 rows, 8 layers in groups of 2, and composed with data
(pipeline 2 × data 2), all in one 4-rank spawn.  llama_tiny_pp (4
layers, 4 microbatches) under dp_pp on 2 ranks, adam 1e-3, f32, 8 steps
of the port's batches from the JAX trainer's initial params: its losses
against the port's one-rank dp run and the JAX dp_pp trainer's at rtol
2e-4, atol 1e-5 (the JAX test's dp_pp-vs-dp bar); its step-4
checkpoint restored on one rank trains steps 5-8 to the same losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
import flax.linen as fnn

import _torch_dist_workers as D
from tensorflow_train_distributed_tpu.models import registry as jreg
from tensorflow_train_distributed_tpu.parallel import pipeline as jpipe
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
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.parallel import pipeline as P
from tensorflow_train_distributed_torch.testing import MultiProcessRunner
from tensorflow_train_distributed_torch.training.checkpoint import (
    CheckpointManager,
)

MICRO = (1, 2, 4, 8, 16)
STEPS, SAVE_AT = 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    rng = np.random.default_rng(0)
    arr = {}
    for name, n in (("s4", 4), ("s8", 8), ("s2", 2)):
        arr[f"{name}.w"] = (rng.standard_normal((n, 8, 8)) * 0.3).astype(
            np.float32)
        arr[f"{name}.b"] = (rng.standard_normal((n, 8)) * 0.1).astype(
            np.float32)
    arr["x"] = rng.standard_normal((16, 8)).astype(np.float32)
    arr["x8"] = rng.standard_normal((8, 8)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("pp") / "in.npz")
    np.savez(path, **arr)
    return arr, path


@pytest.fixture(scope="module")
def port(stacks):
    _, path = stacks
    out = path.replace("in.npz", "out.npz")
    res = MultiProcessRunner("_torch_mesh_workers:pipeline_cases", 4,
                             payload=dict(inp=path, out=out),
                             timeout=240).run()
    with np.load(out) as f:
        return {k: f[k] for k in f.files}, res[0].value


def _sequential(arr, prefix, x):
    """Stage after stage in order, and the gradients of mean(y²)."""
    w = torch.tensor(arr[f"{prefix}.w"], requires_grad=True)
    b = torch.tensor(arr[f"{prefix}.b"], requires_grad=True)
    x = torch.tensor(x, requires_grad=True)
    h = x
    for s in range(w.shape[0]):
        h = torch.tanh(h @ w[s] + b[s])
    (h ** 2).mean().backward()
    return {"y": h.detach(), "dw": w.grad, "db": b.grad, "dx": x.grad}


CASES = [(f"gpipe_m{m}", "s4", "x") for m in MICRO] + [("layers", "s8", "x8")]


@pytest.mark.parametrize("name,prefix,x", CASES)
def test_matches_sequential(port, stacks, name, prefix, x):
    arr, _ = stacks
    want = _sequential(arr, prefix, arr[x])
    np.testing.assert_allclose(port[0][f"{name}.y"], want["y"].numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,prefix,x", CASES)
def test_gradients_match_sequential(port, stacks, name, prefix, x):
    arr, _ = stacks
    want = _sequential(arr, prefix, arr[x])
    for key in ("dw", "db", "dx"):
        np.testing.assert_allclose(port[0][f"{name}.{key}"],
                                   want[key].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_composes_with_data_parallel(port, stacks):
    arr, _ = stacks
    np.testing.assert_allclose(port[0]["data.y"],
                               _sequential(arr, "s2", arr["x"])["y"].numpy(),
                               rtol=1e-6, atol=1e-6)


def _jax_refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_refusals_are_the_jax_texts(port, stacks):
    """A batch the microbatches do not divide and a layer count the
    stages do not divide raise the JAX package's messages."""
    arr, _ = stacks
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=1, pipeline=4),
                            devices=jax.devices()[:4])
    s4 = {k: jnp.asarray(arr[f"s4.{k}"]) for k in "wb"}
    s6 = {k: jnp.asarray(arr[f"s8.{k}"][:6]) for k in "wb"}

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    micro = _jax_refusal(lambda: jpipe.gpipe(
        stage, s4, jnp.asarray(arr["x"]), mesh=mesh, num_microbatches=3))
    layers = _jax_refusal(lambda: jpipe.gpipe_layers(
        stage, s6, jnp.asarray(arr["x8"]), mesh=mesh, num_microbatches=2))
    assert port[1] == {"microbatch": micro, "layers": layers}
    assert micro and layers


@pytest.mark.parametrize("m,s", [(4, 2), (8, 4), (1, 1)])
def test_num_pipeline_ticks(m, s):
    assert P.num_pipeline_ticks(m, s) == jpipe.num_pipeline_ticks(m, s) \
        == m + s - 1


# -- llama_tiny_pp under dp_pp --------------------------------------------------


def _jax_losses(batches):
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=1, pipeline=2),
                            devices=jax.devices()[:2])
    hist = History()
    trainer = JaxTrainer(jreg.get_task("llama_tiny_pp"), optax.adam(1e-3),
                         mesh, policy=JaxPolicy.from_name("float32"),
                         config=JaxTrainerConfig(log_every=1),
                         callbacks=[hist])
    state = trainer.create_state(batches[0])
    init = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(state.params), sep="/").items()}
    trainer.fit(iter(batches), steps=STEPS, state=state)
    return init, np.asarray(hist.history["loss"])


@pytest.fixture(scope="module")
def llama_runs(tmp_path_factory):
    batches = D.llama_batches(STEPS, 16)
    init, jax_loss = _jax_losses(batches)
    cfg = treg.get_entry("llama_tiny_pp")["config"]
    params = {k: v.numpy() for k, v in convert.params_from_flax(
        init, cfg).items()}
    root = tmp_path_factory.mktemp("llama_pp")
    path = str(root / "init.npz")
    np.savez(path, **params)
    ckpt = str(root / "ckpt")
    res = MultiProcessRunner(
        "_torch_mesh_workers:llama_pp", 2,
        payload=dict(params_npz=path, steps=STEPS, ckpt_dir=ckpt,
                     save_at=SAVE_AT), timeout=240).run()
    trainer = D.make_llama_trainer(None, config="llama_tiny_pp",
                                   optimizer="adam", lr=1e-3, clip=None)
    state = trainer.create_state({k: torch.from_numpy(v.copy())
                                  for k, v in params.items()})
    _, hist = trainer.fit(batches, steps=STEPS, state=state)
    return dict(pp=[r.value for r in res], dp=[m["loss"] for _, m in hist],
                jax=jax_loss, params=params, ckpt=ckpt, batches=batches)


def test_dp_pp_losses_match_the_port_dp_run(llama_runs):
    pp = llama_runs["pp"][0]["losses"]
    assert len(pp) == STEPS
    np.testing.assert_allclose(pp, llama_runs["dp"], rtol=2e-4, atol=1e-5)
    assert pp[-1] < pp[0]


def test_dp_pp_losses_match_jax_dp_pp(llama_runs):
    np.testing.assert_allclose(llama_runs["pp"][0]["losses"],
                               llama_runs["jax"], rtol=2e-4, atol=1e-5)


def test_each_stage_holds_its_layers_and_refuses_decode(llama_runs):
    r0, r1 = llama_runs["pp"]
    assert (r0["layers"], r1["layers"]) == (["0", "1"], ["2", "3"])
    assert r0["losses"] == r1["losses"]
    assert r0["refusal"] == ("decode mode does not run under a pipeline "
                             "mesh; generate outside the pipeline strategy")


def test_dp_pp_checkpoint_restores_on_one_rank(llama_runs):
    """The whole state of the 2-stage run at step 4 (every layer, the
    adam moments of every layer) restores into a one-rank trainer, whose
    steps 5-8 give the pipeline's losses."""
    trainer = D.make_llama_trainer(None, config="llama_tiny_pp",
                                   optimizer="adam", lr=1e-3, clip=None)
    state = trainer.create_state({k: torch.from_numpy(v.copy())
                                  for k, v in llama_runs["params"].items()})
    state = trainer.restore(CheckpointManager(llama_runs["ckpt"]), state)
    assert state.step == SAVE_AT
    assert sorted(state.params) == sorted(llama_runs["params"])
    _, hist = trainer.fit(llama_runs["batches"][SAVE_AT:],
                          steps=STEPS - SAVE_AT, state=state)
    np.testing.assert_allclose([m["loss"] for _, m in hist],
                               llama_runs["pp"][0]["losses"][SAVE_AT:],
                               rtol=1e-5, atol=1e-6)
