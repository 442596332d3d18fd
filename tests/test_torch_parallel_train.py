"""Multi-rank training over gloo (``training/trainer.py`` on a mesh,
``parallel/state_plan.py``, the launcher's cluster flags) against the
single-process port and the JAX ``Trainer`` on the same-shaped slice of
the 8-device virtual mesh.

llama_tiny_sft, 5 steps, global batch 16 of the port's ``SyntheticLM``
batches, from the JAX trainer's own initial params, in f32 (as
``_torch_dist_workers.make_llama_trainer`` says why).  Tolerances: the
losses within 1e-5 of the single-process port and 1e-4 of JAX (the
mean over the batch is taken in another order: two local means and a
mean of those; the port's step against JAX's is held to 1e-4 by
``tests/test_torch_training.py``); the final params within rtol 1e-3,
atol 1e-5 (sgd, whose update is the gradient itself: an adam update
turns a noise-level gradient into a whole step of the learning rate).
A mesh of one rank trains bit for bit as no mesh; ZeRO-1 and the
sharded update equal the replicated apply bit for bit (an elementwise
optimizer on a piece is the same arithmetic); the 2-rank launcher's
kill -9 and resume end bit for bit where an uninterrupted 2-rank run
ends.
"""

import json
import logging
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
import flax.linen as fnn

import _torch_dist_workers as W
from tensorflow_train_distributed_tpu.models import registry as jreg
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
from tensorflow_train_distributed_torch import launch as tlaunch
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.runtime import mesh as tmesh
from tensorflow_train_distributed_torch.testing import (
    MultiProcessRunner,
    free_ports,
)
from tensorflow_train_distributed_torch.training.checkpoint import (
    CheckpointManager,
)
from tensorflow_train_distributed_torch.training.train_state import (
    TrainState,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, LR = 5, 0.3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_params(params) -> dict:
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}
    tcfg = treg.get_entry("llama_tiny_sft")["config"]
    return {k: v.numpy() for k, v in convert.params_from_flax(
        flat, tcfg).items()}


def _jax_trainer(sizes, clip=1.0, **config):
    n = int(np.prod(list(sizes.values())))
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**sizes),
                            devices=jax.devices()[:n])
    hist = History()
    tx = optax.sgd(LR)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    trainer = JaxTrainer(jreg.get_task("llama_tiny_sft"), tx, mesh,
                         policy=JaxPolicy.from_name("float32"),
                         config=JaxTrainerConfig(log_every=1, **config),
                         callbacks=[hist])
    return trainer, hist


def _jax_run(sizes, clip=1.0, **config):
    """The JAX Trainer on a ``sizes`` mesh over the first devices: sgd
    (LR) after a global-norm clip of ``clip``, 5 steps of the port's
    batches from its own initial params (the same on every mesh).
    Returns the final params as port-named numpy and the losses."""
    trainer, hist = _jax_trainer(sizes, clip, **config)
    batches = W.llama_batches(STEPS, 16)
    state = trainer.fit(batches, steps=STEPS,
                        state=trainer.create_state(batches[0]))
    return _port_params(state.params), np.asarray(hist.history["loss"])


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """The JAX trainer's initial params (port names), and as an npz."""
    trainer, _ = _jax_trainer(dict(data=1))
    params = _port_params(trainer.create_state(
        W.llama_batches(1, 16)[0]).params)
    path = str(tmp_path_factory.mktemp("init") / "init.npz")
    np.savez(path, **params)
    return params, path


@pytest.fixture(scope="module")
def single(init):
    """The single-process port from ``init``: sgd after a clip of 1."""
    trainer = W.make_llama_trainer(None, optimizer="sgd", lr=LR)
    # Copies: the trainer updates the tensors it is given in place.
    state = trainer.create_state({k: torch.from_numpy(v.copy())
                                  for k, v in init[0].items()})
    state, hist = trainer.fit(W.llama_batches(STEPS, 16), steps=STEPS,
                              state=state)
    return ({k: v.detach().numpy() for k, v in state.params.items()},
            np.asarray([m["loss"] for _, m in hist]))


SGD = dict(optimizer="sgd", lr=LR)
ADAMW = dict(optimizer="adamw", lr=3e-3, clip=0.0)
TWO_RANKS = {
    "dp2": dict(mesh=dict(data=2), **SGD),
    "fsdp2": dict(mesh=dict(data=1, fsdp=2), **SGD),
    "tp2": dict(mesh=dict(data=1, tensor=2), **SGD),
    "adamw": dict(mesh=dict(data=2), **ADAMW),
    "zero1": dict(mesh=dict(data=2), zero1=True, **ADAMW),
    "sharded_update": dict(mesh=dict(data=2), sharded_update=True, **ADAMW),
    "exact": dict(mesh=dict(data=2), clip=0.0, **SGD),
    "int8_0": dict(mesh=dict(data=2), clip=0.0, grad_quant="int8",
                   grad_overlap=0, **SGD),
    "int8_4": dict(mesh=dict(data=2), clip=0.0, grad_quant="int8",
                   grad_overlap=4, **SGD),
}
FOUR_RANKS = {"dp2xtp2": dict(mesh=dict(data=2, tensor=2), **SGD)}


def _cluster(n, variants, init, out_dir):
    """One gloo cluster of ``n`` ranks training every variant in turn;
    {name: (final params, losses, mesh shape)}."""
    res = MultiProcessRunner(
        "_torch_dist_workers:train_variants", n, timeout=150,
        payload=dict(variants=variants, out_dir=str(out_dir),
                     steps=STEPS, params_npz=init[1])).run()
    out = {}
    for name in variants:
        losses = [np.asarray([m["loss"] for _, m in r.value[name][
            "history"]]) for r in res]
        for other in losses[1:]:    # every rank reports the global mean
            np.testing.assert_array_equal(other, losses[0])
        with np.load(f"{out_dir}/{name}.npz") as f:
            out[name] = ({k: f[k] for k in f.files}, losses[0],
                         res[0].value[name]["mesh"])
    return out


@pytest.fixture(scope="module")
def ranks(init, tmp_path_factory):
    """Every multi-rank variant: two clusters (2 and 4 ranks)."""
    out = _cluster(2, TWO_RANKS, init, tmp_path_factory.mktemp("two"))
    out.update(_cluster(4, FOUR_RANKS, init,
                        tmp_path_factory.mktemp("four")))
    return out


def _close(got, want, rtol=1e-3, atol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["dp2", "fsdp2", "tp2", "dp2xtp2"])
def test_strategies_match_single_process_and_jax(name, ranks, single):
    sizes = {**TWO_RANKS, **FOUR_RANKS}[name]["mesh"]
    jparams, jloss = _jax_run(sizes)
    sparams, sloss = single
    params, loss, shape = ranks[name]
    assert all(shape[a] == n for a, n in sizes.items())
    np.testing.assert_allclose(loss, sloss, rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-4)
    _close(params, sparams)
    _close(params, jparams)
    assert loss[-1] < loss[0]


def test_world_of_one_trains_bit_for_bit_as_no_mesh(caplog):
    """A mesh of one rank (no group) with every mesh knob set (no-ops
    there, grad_quant with the JAX warning) is the single-device step:
    adamw with a clip, bit for bit."""
    one = tmesh.build_mesh(tmesh.MeshConfig(strategy="fsdp_tp"))
    runs = []
    for mesh, kw in ((None, {}), (one, dict(zero1=True, sharded_update=True,
                                            grad_quant="int8",
                                            grad_overlap=4))):
        with caplog.at_level(logging.WARNING):
            trainer = W.make_llama_trainer(mesh, **kw)
        state = trainer.create_state()
        state, hist = trainer.fit(W.llama_batches(3, 16), steps=3,
                                  state=state)
        runs.append(({k: v.detach().clone() for k, v in
                      state.params.items()}, hist))
    assert "no-op on a data=1 mesh" in caplog.text
    (p0, h0), (p1, h1) = runs
    assert h0 == h1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


OVERFLOW = {
    "dp2xtp2": dict(mesh=dict(data=2, tensor=2), config="llama_tiny_sft"),
    "dp2xep2": dict(mesh=dict(data=2, expert=2), config="moe_tiny_lm_gmm"),
    "dp2xep2_int8": dict(mesh=dict(data=2, expert=2),
                         config="moe_tiny_lm_gmm", grad_quant="int8"),
}


@pytest.fixture(scope="module")
def overflow():
    """Every ``OVERFLOW`` variant in one 4-rank gloo cluster."""
    res = MultiProcessRunner(
        "_torch_dist_workers:planted_overflow", 4, timeout=150,
        payload=dict(variants=OVERFLOW)).run()
    return [r.value for r in res]


@pytest.mark.parametrize("name", list(OVERFLOW))
def test_float16_overflow_in_one_ranks_piece_skips_the_step_everywhere(
        name, overflow):
    """An inf in the gradient pieces of the last tensor (or expert) rank
    alone, under float16's loss scale: every rank skips that step and
    keeps its parameters, every rank halves the scale (2^15 to 2^14),
    and the next, clean, step is taken everywhere."""
    runs = [r[name] for r in overflow]
    assert any(r["planted"] for r in runs) and not all(
        r["planted"] for r in runs)
    for r in runs:
        assert r["finite"] == [0.0, 1.0], r
        assert r["scale"] == [2.0 ** 14, 2.0 ** 14], r
        assert r["unchanged"], r


@pytest.mark.parametrize("knob", ["zero1", "sharded_update"])
def test_zero1_and_sharded_update_equal_the_replicated_apply(knob, ranks):
    """dp=2, adamw without a clip: the update on each rank's piece and the
    gather are the replicated apply bit for bit."""
    want, wloss, _ = ranks["adamw"]
    got, gloss, _ = ranks[knob]
    np.testing.assert_array_equal(gloss, wloss)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("overlap", [0, 4])
def test_grad_quant_int8_matches_jax_on_the_same_mesh(overlap, ranks):
    """int8 with error feedback at data=2 (one sync, or 4 buckets)
    against the JAX trainer's on a data=2 mesh.  Both quantize the same
    recipe; an element whose f32 mean rounds to another int8 step moves
    by that step (amax/127 of its block, ~1% of the largest gradient),
    so the losses agree to 2e-4 and the params to atol 2e-3 (below one
    int8 step times LR); the exact run differs more.  Without a clip:
    JAX's bucketed step applies the optimizer bucket by bucket, which
    clips each bucket by its own norm (its documented caveat)."""
    jparams, jloss = _jax_run(dict(data=2), clip=0.0, grad_quant="int8",
                              grad_overlap=overlap)
    params, loss, _ = ranks[f"int8_{overlap}"]
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=2e-4)
    _close(params, jparams, rtol=0, atol=2e-3)
    exact = ranks["exact"][0]
    assert max(np.abs(params[k] - exact[k]).max() for k in exact) > 0


def test_grad_quant_switches_and_refusals(monkeypatch, caplog):
    """The JAX trainer's resolution: the kill switches, the data=1 no-op,
    no composition with steps_per_execution > 1, BatchNorm refused."""
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    two = tmesh.Mesh(dict(pipeline=1, data=2, fsdp=1, expert=1, seq=1,
                          tensor=1), 0)
    cfg = TrainerConfig(grad_quant="int8")
    assert Trainer._resolve_grad_quant(cfg, two) == "int8"
    assert Trainer._resolve_grad_overlap(cfg, "int8") == 4
    with caplog.at_level(logging.WARNING):
        assert Trainer._resolve_grad_quant(cfg, None) == "none"
    assert "no-op on a data=1 mesh" in caplog.text
    with pytest.raises(ValueError, match="steps_per_execution"):
        Trainer._resolve_grad_quant(TrainerConfig(
            grad_quant="int8", steps_per_execution=2), two)
    with pytest.raises(ValueError, match="none|f32|int8"):
        Trainer._resolve_grad_quant(TrainerConfig(grad_quant="int4"), two)
    monkeypatch.setenv("TTD_NO_GRAD_QUANT", "1")
    assert Trainer._resolve_grad_quant(cfg, two) == "none"
    monkeypatch.setenv("TTD_NO_GRAD_OVERLAP", "1")
    assert Trainer._resolve_grad_overlap(cfg, "int8") == 0
    assert Trainer._resolve_grad_overlap(TrainerConfig(grad_overlap=1),
                                         "int8") == 0
    monkeypatch.delenv("TTD_NO_GRAD_QUANT")
    entry = treg.get_entry("resnet_tiny")
    trainer = Trainer(treg.make_task(entry, device="meta"),
                      W.make_llama_trainer().tx, device="cpu", mesh=two,
                      config=TrainerConfig(grad_quant="int8"))
    with pytest.raises(ValueError, match="BatchNorm"):
        trainer.create_state()


def test_checkpoint_refolds_the_residual_onto_another_data_width(
        tmp_path, caplog):
    """The whole state's residual (one row a data rank) restores onto 1
    or 4 rows, sum-preserving (``fold_leading_replicas``); a checkpoint
    without one restores zero-initialized, and one a run does not use is
    dropped."""
    rows = torch.arange(2 * 6, dtype=torch.float32).reshape(2, 3, 2)

    def state(residual):
        return TrainState(step=3, params={"w": torch.ones(3, 2)},
                          opt_state=[torch.zeros(3, 2)],
                          grad_residual=residual)

    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(3, state([rows]))
    got = mgr.restore(state([torch.zeros(1, 3, 2)]))
    assert torch.equal(got.grad_residual[0], rows.sum(0, keepdim=True))
    got = mgr.restore(state([torch.zeros(4, 3, 2)]))
    assert torch.equal(got.grad_residual[0][:2], rows)
    assert not got.grad_residual[0][2:].any()
    with caplog.at_level(logging.WARNING):
        assert mgr.restore(state(None)).grad_residual is None
        plain = CheckpointManager(str(tmp_path / "b"))
        plain.save(3, state(None))
        got = plain.restore(state([torch.full((2, 3, 2), 7.0)]))
    assert "dropping them" in caplog.text
    assert "predates grad_residual" in caplog.text
    assert torch.equal(got.grad_residual[0], torch.full((2, 3, 2), 7.0))


# -- the launcher --------------------------------------------------------

FLAGS = ["--config", "llama_tiny_sft", "--device", "cpu", "--log-every",
         "1", "--global-batch-size", "8", "--seed", "3"]


def _losses(out: str) -> list:
    return [json.loads(x)["loss"] for x in out.splitlines()
            if x.startswith("{") and '"loss"' in x]


def test_launcher_group_of_one_is_bit_for_bit_the_plain_run(capsys):
    """``--num-processes 1 --process-id 0 --coordinator-address``: the
    world-size-1 process group the card's NCCL leg takes (gloo here),
    under the config's strategy and ``--zero1 --grad-quant int8``: the
    losses equal a plain run's bit for bit."""
    tlaunch.main(FLAGS + ["--steps", "4"])
    plain = _losses(capsys.readouterr().out)
    tlaunch.main(FLAGS + ["--steps", "4", "--num-processes", "1",
                          "--process-id", "0", "--coordinator-address",
                          f"127.0.0.1:{free_ports(1)[0]}", "--zero1",
                          "--grad-quant", "int8"])
    grouped = _losses(capsys.readouterr().out)
    assert len(plain) == 4 and grouped == plain
    import torch.distributed as dist
    assert not dist.is_initialized()


def _cli(args, env=None, check=True):
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch", *args],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1", TTD_DIST_TIMEOUT="60",
                 **(env or {})))
    if check:
        assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_two_rank_launcher_kill9_resume_and_elastic_restore(tmp_path):
    """Two gloo ranks under dp_tp (tensor 2): an uninterrupted 12-step
    run, and a run whose rank 1 is SIGKILLed at step 10 (rank 0 then
    fails on its next collective) resumed from step 8; their step-12
    checkpoints are equal byte for byte.  Then the supervisor's elastic
    relaunch (``TTD_ELASTIC_DEVICES=1``) restores step 12 onto one rank
    and trains on to 16."""
    flags = FLAGS + ["--strategy", "dp_tp", "--steps", "12",
                     "--checkpoint-every", "4"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full = _cli(flags + ["--checkpoint-dir", a, "--cpu-devices", "2"])
    assert len(_losses(full.stdout)) == 12
    port = free_ports(1)[0]
    procs = []
    for rank in range(2):
        cmd = flags + ["--checkpoint-dir", b, "--num-processes", "2",
                       "--process-id", str(rank), "--coordinator-address",
                       f"127.0.0.1:{port}"]
        if rank == 1:
            cmd += ["--fault-plan", "step:10:kill9"]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tensorflow_train_distributed_torch",
             *cmd], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="1",
                     TTD_DIST_TIMEOUT="60")))
    outs = [p.communicate(timeout=240) for p in procs]
    assert procs[1].returncode == -9, outs[1][1][-2000:]
    assert procs[0].returncode != 0
    assert CheckpointManager(b).latest_step() == 8
    resumed = _cli(flags + ["--checkpoint-dir", b, "--cpu-devices", "2"])
    assert "resumed from step 8" in resumed.stderr
    for name in ("tensors.bin", "manifest.json"):
        with open(os.path.join(a, "12", name), "rb") as f, \
                open(os.path.join(b, "12", name), "rb") as g:
            assert f.read() == g.read(), name
    elastic = _cli(FLAGS + ["--strategy", "dp_tp", "--steps", "16",
                            "--checkpoint-every", "4", "--checkpoint-dir",
                            a, "--cpu-devices", "2"],
                   env={"TTD_ELASTIC_DEVICES": "1"})
    assert "1 CPU rank(s) of 2" in elastic.stderr
    assert "resumed from step 12" in elastic.stderr
    assert len(_losses(elastic.stdout)) == 4
    assert CheckpointManager(a).latest_step() == 16
