"""What the port's launcher no longer refuses: fused steps
(``--steps-per-execution``), TensorBoard scalars (``--tensorboard-dir``)
and the profiler (``--profile-dir``), against the JAX package on the CPU.

- Fused steps: k = 4 for 8 steps equals k = 1 bit for bit in the port
  (state and the losses at the dispatch boundaries), and the JAX
  launcher's k = 4 curve within the launcher curve test's tolerance
  (1e-4, the two trainers' f32 rounding); a resume whose remaining steps
  are not a multiple of k rounds them up; ``steps % k`` raises JAX's
  message.
- TensorBoard: the same metrics through the JAX ``TensorBoardScalars``
  (flax's writer) and the port's (its own event files) read back by the
  installed ``tensorboard`` reader with equal tags, steps and values; a
  launcher run's scalars equal its history.
- The profiler writes a Chrome trace of the requested window on the CPU;
  ``trace``, ``annotate``, ``device_memory_stats`` and ``SpeedMonitor``.
"""

import json
import os
import tempfile

import jax
import numpy as np
import optax
import pytest
import torch

from tensorflow_train_distributed_tpu import launch as jlaunch
from tensorflow_train_distributed_tpu.data import DataConfig as JDataConfig
from tensorflow_train_distributed_tpu.data import (
    HostDataLoader as JHostDataLoader,
)
from tensorflow_train_distributed_tpu.data import datasets as jds
from tensorflow_train_distributed_tpu.models import registry as jreg
from tensorflow_train_distributed_tpu.runtime.mesh import (
    MeshConfig,
    build_mesh,
)
from tensorflow_train_distributed_tpu.training import callbacks as jcb
from tensorflow_train_distributed_tpu.training.trainer import (
    Trainer as JaxTrainer,
    TrainerConfig as JaxTrainerConfig,
)
from tensorflow_train_distributed_torch import launch as tlaunch
from tensorflow_train_distributed_torch.runtime import profiling
from tensorflow_train_distributed_torch.training import callbacks as tcb

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: a CPU run is bit for bit repeatable only
    then (a multi-threaded reduction's order varies from run to run), and
    the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FLAGS = ["--config", "llama_tiny_sft", "--steps", "8", "--precision",
         "float32", "--log-every", "1", "--seed", "0"]


def _flat(params) -> dict:
    import flax.linen as fnn
    from flax import traverse_util

    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


def _port(*flags):
    return tlaunch.run(tlaunch.build_parser().parse_args(
        [*FLAGS, "--device", "cpu", *flags]))


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    """The JAX launcher's initial weights (seed 0) as ``--params-npz``."""
    entry = jreg.get_entry("llama_tiny_sft")
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = JaxTrainer(entry["task_factory"](), optax.sgd(0.1), mesh,
                     config=JaxTrainerConfig(seed=0))
    src = jds.get_dataset("lm", **entry["dataset_kwargs"])
    sample = JHostDataLoader(src, JDataConfig(global_batch_size=16),
                             process_index=0, process_count=1)
    path = tmp_path_factory.mktemp("fused") / "init.npz"
    np.savez(path, **_flat(jtr.create_state(next(iter(sample))).params))
    return str(path)


# -- fused steps ----------------------------------------------------------------


def test_fused_steps_equal_single_steps_bit_for_bit(tmp_path):
    """The step-8 checkpoints (params, optimizer state, step) of k = 1
    and k = 4 are the same bytes; k = 4 reports the losses of steps 4
    and 8."""
    one = _port("--checkpoint-dir", str(tmp_path / "one"))
    four = _port("--checkpoint-dir", str(tmp_path / "four"),
                 "--steps-per-execution", "4")
    assert one.state.step == four.state.step == 8
    for f in ("tensors.bin", "manifest.json"):
        assert (tmp_path / "one" / "8" / f).read_bytes() == \
            (tmp_path / "four" / "8" / f).read_bytes(), f
    assert four.history["loss"] == [one.history["loss"][3],
                                    one.history["loss"][7]]


def test_fused_curve_matches_the_jax_launcher(init_npz):
    """JAX's launcher at k = 4 (a ``lax.scan`` of 4 steps a dispatch)
    and the port's from the same weights: the losses at steps 4 and 8
    agree to the launcher curve test's tolerance."""
    want = jlaunch.run(jlaunch.build_parser().parse_args(
        FLAGS + ["--strategy", "dp", "--steps-per-execution",
                 "4"])).history["loss"]
    got = _port("--params-npz", init_npz, "--steps-per-execution",
                "4").history["loss"]
    assert len(got) == len(want) == 2
    assert np.max(np.abs(np.array(got) - np.array(want))) <= 1e-4


def test_off_cycle_resume_rounds_up_and_steps_must_divide(tmp_path,
                                                          caplog):
    ck = str(tmp_path / "ck")
    _port("--steps", "6", "--checkpoint-dir", ck)
    res = _port("--steps", "8", "--checkpoint-dir", ck,
                "--steps-per-execution", "4")
    assert res.state.step == 10
    assert "training 4 steps" in caplog.text
    with pytest.raises(SystemExit, match="steps-per-execution must be"):
        _port("--steps-per-execution", "0")
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer, TrainerConfig,
    )
    from tensorflow_train_distributed_torch.models import registry

    task = registry.make_task(registry.get_entry("llama_tiny_sft"),
                              device="meta")
    tr = Trainer(task, None, config=TrainerConfig(steps_per_execution=4),
                 device="cpu")
    with pytest.raises(ValueError, match=r"steps=6 must be a multiple of "
                       r"steps_per_execution=4 \(each dispatch runs "
                       r"exactly k optimizer steps\)"):
        tr.fit(iter([]), steps=6)


# -- TensorBoard ----------------------------------------------------------------


def _accumulated(logdir) -> dict:
    """{tag: [(step, value)]} as TensorBoard reads the directory."""
    from tensorboard.backend.event_processing.plugin_event_accumulator \
        import EventAccumulator
    from tensorboard.util import tensor_util

    acc = EventAccumulator(logdir)
    acc.Reload()
    return {tag: [(e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                  for e in acc.Tensors(tag)]
            for tag in acc.Tags()["tensors"]}


def test_tensorboard_files_read_as_jaxs():
    rng = np.random.default_rng(0)
    events = [(s, {"loss": float(rng.standard_normal()), "lr": 1e-3 * s,
                   "accuracy": float(rng.random())}) for s in range(1, 7)]
    events.append((6, {"val_loss": 1.25, "val_perplexity": 3.5}))
    dirs = []
    for mod in (jcb, tcb):
        d = tempfile.mkdtemp()
        cb = mod.TensorBoardScalars(d)
        cb.on_train_begin(None)
        for step, metrics in events:
            cb.on_step_end(step, metrics)
        cb.on_train_end(None)
        dirs.append(d)
    want, got = _accumulated(dirs[0]), _accumulated(dirs[1])
    assert sorted(got) == sorted(want) == ["accuracy", "loss", "lr",
                                           "val_loss", "val_perplexity"]
    assert got == want
    assert tcb.read_scalars(dirs[1]) == got


def test_launcher_tensorboard_scalars_equal_its_history(tmp_path):
    tb = str(tmp_path / "tb")
    res = _port("--tensorboard-dir", tb, "--log-every", "2")
    scalars = tcb.read_scalars(tb)
    assert scalars == _accumulated(tb)
    assert [s for s, _ in scalars["loss"]] == list(range(1, 9))
    assert [v for _, v in scalars["loss"]] == [
        float(np.float32(x)) for x in res.history["loss"]]


# -- the profiler -----------------------------------------------------------------


def test_launcher_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    _port("--profile-dir", str(prof), "--profile-steps", "2,4")
    (trace,) = list(prof.iterdir())
    names = {e.get("name", "") for e in
             json.loads(trace.read_text())["traceEvents"]}
    assert any("aten::" in n for n in names)
    with pytest.raises(SystemExit, match="START,STOP"):
        _port("--profile-dir", str(prof), "--profile-steps", "2")


def test_trace_annotate_memory_and_speed(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("ttd/unit"):
            torch.ones(8).sum()
    (trace,) = list(tmp_path.iterdir())
    assert "ttd/unit" in trace.read_text()
    assert profiling.stop_trace() is None          # nothing active
    stats = profiling.device_memory_stats()
    assert stats and set(stats[0]) == {"device", "bytes_in_use",
                                       "peak_bytes_in_use", "bytes_limit"}
    mon = profiling.SpeedMonitor(examples_per_step=16)
    assert mon.summary() == {}
    mon.step_times_ms = [10.0, 20.0, 30.0]
    assert mon.summary()["median_step_ms"] == 20.0
    assert mon.summary()["examples_per_sec"] == 16 / 0.02
    with pytest.raises(ValueError, match="stop_step"):
        profiling.ProfileCallback(str(tmp_path), start_step=5, stop_step=2)


def test_profiler_port_captures_the_steps_asked_for(tmp_path):
    """``--profiler-port``: a capture request sent while the launcher
    runs gets a trace of the next 3 steps after the boundary that took
    it, with one step marker for each and no other."""
    import socket
    import threading
    import time

    from tensorflow_train_distributed_torch.testing import free_ports

    port = free_ports(1)[0]
    done = {}
    run = threading.Thread(target=lambda: done.update(out=_port(
        "--profiler-port", str(port), "--steps", "40")))
    run.start()
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                assert time.monotonic() < deadline and run.is_alive()
                time.sleep(0.02)
        reply = profiling.request_capture(port, 3, str(tmp_path / "cap"),
                                          timeout=120)
    finally:
        run.join(timeout=120)
    assert not run.is_alive() and "out" in done
    assert "error" not in reply, reply
    first, last = reply["first_step"], reply["last_step"]
    assert 2 <= first and last == first + 2 and last <= 40
    events = json.loads(open(reply["path"]).read())["traceEvents"]
    marks = sorted(int(e["name"][len(profiling.STEP_MARKER):])
                   for e in events
                   if e.get("name", "").startswith(profiling.STEP_MARKER))
    assert marks == [first, first + 1, first + 2]
    assert any("aten::" in e.get("name", "") for e in events)
