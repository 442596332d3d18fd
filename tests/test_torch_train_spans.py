"""The trainer's flight-recorder spans (``training/trainer.py``,
``parallel/state_plan.py`` over ``runtime/events.py``) against the JAX
``Trainer``'s: span names, their order and count in each step, and their
attributes (``step``, ``steps``, ``final``, ``wire``, ``overlap``,
``bucket``, ``buckets``), in three forms on llama_tiny_sft:

- a plain ``fit`` of 4 steps with a read every 2, an evaluation and a
  checkpoint every 2 (``data_wait``, ``step_dispatch``,
  ``host_callbacks``, ``eval``, ``checkpoint_save``);
- int8 grad-quant, sequential, at dp 2 (``grad_fwdbwd``, ``grad_comm``
  with the wire MB, ``optimizer_apply``);
- int8 grad-quant in 2 buckets at dp 2 (a ``grad_comm`` and an
  ``optimizer_apply`` a bucket, one ``step_barrier``),

the port's ranks over gloo, JAX on 2 virtual CPU devices.  The wire MB
of a step equals JAX's to 1e-9 (relative): the same leaf sizes.
``TTD_NO_TRACE=1`` records nothing and trains bit for bit as the traced
run, and the repo-root ``tools/trace_report.py`` reads a port dump into
the per-step table it makes of a JAX dump.
"""

import importlib.util
import os

import jax
import numpy as np
import optax
import pytest
import torch

import _torch_dist_workers as W
from tensorflow_train_distributed_tpu.models import registry as jreg
from tensorflow_train_distributed_tpu.runtime import events as jevents
from tensorflow_train_distributed_tpu.runtime import mesh as jmesh
from tensorflow_train_distributed_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from tensorflow_train_distributed_tpu.training.mixed_precision import (
    Policy as JaxPolicy,
)
from tensorflow_train_distributed_tpu.training.trainer import (
    Trainer as JaxTrainer,
    TrainerConfig as JaxTrainerConfig,
)
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.runtime import events as tevents
from tensorflow_train_distributed_torch.testing import MultiProcessRunner
from tensorflow_train_distributed_torch.training import optimizers
from tensorflow_train_distributed_torch.training.checkpoint import (
    CheckpointManager,
)
from tensorflow_train_distributed_torch.training.mixed_precision import (
    Policy,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, DP_STEPS = 4, 3
FORMS = {"sequential": dict(grad_quant="int8", grad_overlap=0),
         "bucketed": dict(grad_quant="int8", grad_overlap=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_events(evs) -> list:
    return [[e[0], dict(e[5] or {})] for e in evs
            if e[0].startswith("train/")]


def _shape(evs) -> list:
    """(name, attrs but the wire MB) in order: the structure compared."""
    return [(n, tuple(sorted((k, v) for k, v in a.items() if k != "mb")))
            for n, a in evs]


def _mb_per_step(evs) -> list:
    out, cur = [], 0.0
    for name, attrs in evs:
        if name == "train/grad_comm":
            cur += attrs["mb"]
        elif name == "train/step_dispatch":
            out.append(cur)
            cur = 0.0
    return out


def _port_plain(root, no_trace: bool):
    prior = os.environ.pop("TTD_NO_TRACE", None)
    if no_trace:
        os.environ["TTD_NO_TRACE"] = "1"
    try:
        entry = treg.get_entry("llama_tiny_sft")
        trainer = Trainer(
            treg.make_task(entry, device="meta"),
            optimizers.make_optimizer("adamw", 1e-3), device="cpu",
            policy=Policy.from_name("float32"),
            config=TrainerConfig(log_every=2, checkpoint_every=2),
            checkpoint_manager=CheckpointManager(str(root)))
        batches = W.llama_batches(STEPS, 16)
        state = trainer.create_state()
        rec = tevents.get_recorder()
        rec.clear()
        state, _ = trainer.fit(batches, steps=STEPS, state=state,
                               eval_batches=batches[:1], eval_every=2,
                               eval_steps=1)
        return (_train_events(rec.events()),
                {k: v.detach().clone() for k, v in state.params.items()})
    finally:
        os.environ.pop("TTD_NO_TRACE", None)
        if prior is not None:
            os.environ["TTD_NO_TRACE"] = prior


def _jax_fit(devices: int, steps: int, ckpt_dir=None, **config):
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=devices),
                            devices=jax.devices()[:devices])
    batches = W.llama_batches(steps, 16)
    kw = {}
    if ckpt_dir is not None:
        kw["checkpoint_manager"] = JaxCheckpointManager(str(ckpt_dir))
        config = dict(config, checkpoint_every=2, log_every=2)
    trainer = JaxTrainer(jreg.get_task("llama_tiny_sft"), optax.adamw(1e-3),
                         mesh, policy=JaxPolicy.from_name("float32"),
                         config=JaxTrainerConfig(**{"log_every": 1,
                                                    **config}), **kw)
    state = trainer.create_state(batches[0])
    rec = jevents.get_recorder()
    rec.clear()
    if ckpt_dir is not None:
        trainer.fit(batches, steps=steps, state=state,
                    eval_batches=batches[:1], eval_every=2, eval_steps=1)
    else:
        trainer.fit(batches, steps=steps, state=state)
    return _train_events(rec.events()), rec.export_chrome_trace()


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    jev, _ = _jax_fit(1, STEPS, root / "jax")
    tev, traced = _port_plain(root / "port", no_trace=False)
    off, quiet = _port_plain(root / "port_off", no_trace=True)
    return dict(jev=jev, tev=tev, traced=traced, off=off, quiet=quiet)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans_dp2")
    res = MultiProcessRunner(
        "_torch_dist_workers:train_spans", 2,
        payload=dict(variants=FORMS, steps=DP_STEPS,
                     dump=str(root / "port")), timeout=240).run()
    out = {}
    for form, cfg in FORMS.items():
        jev, jdump = _jax_fit(2, DP_STEPS, **cfg)
        out[form] = dict(jev=jev, jdump=jdump, tev=res[0].value[form],
                         tev1=res[1].value[form],
                         tdump=str(root / f"port.{form}.json"))
    return out


def test_plain_fit_spans_match_jax(plain):
    names = {n for n, _ in plain["tev"]}
    assert names == {"train/data_wait", "train/step_dispatch",
                     "train/host_callbacks", "train/eval",
                     "train/checkpoint_save"}
    assert _shape(plain["tev"]) == _shape(plain["jev"])
    assert ("train/checkpoint_save", (("final", True), ("step", STEPS))) \
        in _shape(plain["tev"])


def test_no_trace_records_nothing_and_trains_bit_for_bit(plain):
    assert plain["off"] == []
    assert plain["traced"].keys() == plain["quiet"].keys()
    for k, v in plain["traced"].items():
        assert torch.equal(v, plain["quiet"][k]), k


@pytest.mark.parametrize("form", list(FORMS))
def test_grad_quant_spans_at_dp2_match_jax(dp2, form):
    r = dp2[form]
    assert _shape(r["tev"]) == _shape(r["jev"])
    assert _shape(r["tev1"]) == _shape(r["jev"])
    per_step = [n for n, _ in r["tev"]][:len(r["tev"]) // DP_STEPS]
    k = 2 if form == "bucketed" else 1
    assert per_step.count("train/grad_comm") == k
    assert per_step.count("train/optimizer_apply") == k
    assert per_step.count("train/step_barrier") == (form == "bucketed")
    np.testing.assert_allclose(_mb_per_step(r["tev"]),
                               _mb_per_step(r["jev"]), rtol=1e-9)


def _trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(REPO, "tools", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("form", list(FORMS))
def test_trace_report_reads_a_port_dump_as_a_jax_dump(dp2, form):
    tr = _trace_report()
    port = tr.train_step_summary(tr.load_events(dp2[form]["tdump"]))
    jax_rows = tr.train_step_summary(dp2[form]["jdump"]["traceEvents"])
    assert port and [r[:2] for r in port] == [r[:2] for r in jax_rows]
    assert all(0 < r[3] for r in port)
