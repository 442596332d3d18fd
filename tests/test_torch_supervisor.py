"""The port's training supervisor against the JAX package's, mirroring JAX
``tests/test_supervisor.py`` (and the device-loss cases of
``tests/test_elastic.py``) on the CPU.

The unit tier drives both packages' ``TrainSupervisor`` over the same
throwaway ``python -c`` children: for the same exit sequence and the same
seeded jitter the two journals are equal record for record (the wall
clock's ``time`` and ``duration_s`` left out), and so are the results.
The recovery tier runs the port's launcher: one ``--supervise`` command
killed once resumes to the uninterrupted run's checkpoint bit for bit,
and a planted device loss exits 113, is journaled as one and relaunched
free of the crash budget.
"""

import json
import os
import random
import signal
import subprocess
import sys

import pytest
import torch

from tensorflow_train_distributed_tpu.runtime import supervisor as jsup
from tensorflow_train_distributed_torch import launch as tlaunch
from tensorflow_train_distributed_torch.runtime import supervisor as tsup
from tensorflow_train_distributed_torch.runtime.preemption import (
    PREEMPTION_EXIT_CODE,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERVISORS = {"jax": jsup, "port": tsup}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: a CPU run is bit for bit repeatable only
    then (a multi-threaded reduction's order varies from run to run), and
    the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _child(code: str) -> list:
    return [sys.executable, "-c", code]


def _counter_child(path, rcs) -> list:
    """A child whose exit code follows ``rcs`` across attempts (a counter
    file: each launch is a fresh process); a 113 writes ``survivors: 1``
    to the elastic sidecar the supervisor exported."""
    code = (
        "import json, os, pathlib, sys\n"
        f"p = pathlib.Path({str(path)!r})\n"
        "n = int(p.read_text()) if p.exists() else 0\n"
        "p.write_text(str(n + 1))\n"
        f"rc = {list(rcs)!r}[min(n, {len(rcs) - 1})]\n"
        "if rc == 113:\n"
        "    pathlib.Path(os.environ['TTD_ELASTIC_STATE']).write_text(\n"
        "        json.dumps({'survivors': 1}))\n"
        "sys.exit(rc)\n")
    return _child(code)


def _journal(path) -> list:
    """The journal's records without the wall clock's fields."""
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("time", None)
        rec.pop("duration_s", None)
        out.append(rec)
    return out


SEQUENCES = {
    "crash_then_clean": ([7, 7, 0], dict(max_restarts=3)),
    "budget_exhausted": ([9], dict(max_restarts=1)),
    "preemptions_free": ([PREEMPTION_EXIT_CODE, PREEMPTION_EXIT_CODE, 5],
                         dict(max_restarts=0)),
    "no_restart_on_preemption": ([PREEMPTION_EXIT_CODE],
                                 dict(restart_on_preemption=False)),
    "device_loss_then_clean": ([113, 0], dict(max_restarts=0)),
    "device_loss_cap": ([113], dict(max_restarts=0, max_device_losses=2)),
    "rolling_window": ([3, 3, 3, 0], dict(max_restarts=1,
                                         restart_window_s=1e-9)),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_journal_equals_jax_for_the_same_exits_and_seed(case, tmp_path):
    rcs, kw = SEQUENCES[case]
    results, journals, sleeps = [], [], []
    for name, mod in sorted(SUPERVISORS.items()):
        d = tmp_path / name
        d.mkdir()
        slept = []
        res = mod.TrainSupervisor(
            _counter_child(d / "counter", rcs), backoff_s=0.5,
            backoff_jitter=0.25, rng=random.Random(0),
            journal_path=str(d / "j.jsonl"), sleep=slept.append,
            handle_signals=False, **kw).run()
        results.append(res.__dict__)
        journals.append(_journal(d / "j.jsonl"))
        sleeps.append(slept)
    assert results[0] == results[1]
    assert journals[0] == journals[1]
    assert sleeps[0] == sleeps[1]
    assert journals[1][-1]["event"] in ("done", "giveup")


def test_classification_and_flag_stripping_equal_jax():
    for rc in (0, PREEMPTION_EXIT_CODE, 113, 1, -signal.SIGKILL,
               -signal.SIGSEGV):
        assert tsup.classify_exit(rc) == jsup.classify_exit(rc)
    argv = ["--config", "mnist", "--supervise", "--max-restarts", "5",
            "--restart-backoff=0.1", "--steps", "8",
            "--supervisor-journal", "/tmp/j.jsonl", "--no-elastic",
            "--no-restart-on-preemption", "--checkpoint-dir", "/ck"]
    assert tsup.strip_supervisor_flags(argv) == jsup.strip_supervisor_flags(
        argv) == ["--config", "mnist", "--steps", "8", "--checkpoint-dir",
                  "/ck"]
    assert tsup.SUPERVISOR_FLAGS == jsup.SUPERVISOR_FLAGS


@pytest.mark.parametrize("name", sorted(SUPERVISORS))
def test_stop_signal_during_backoff_blocks_relaunch(name, tmp_path):
    journal = tmp_path / "j.jsonl"

    def stop_mid_backoff(seconds):
        sup._stop_signal = signal.SIGTERM

    sup = SUPERVISORS[name].TrainSupervisor(
        _child("raise SystemExit(3)"), max_restarts=5, backoff_s=0.5,
        journal_path=str(journal), sleep=stop_mid_backoff,
        handle_signals=False)
    res = sup.run()
    assert (res.attempts, res.crashes, res.gave_up) == (1, 1, False)
    assert res.returncode == 128 + signal.SIGTERM
    assert _journal(journal)[-1]["event"] == "stopped"


def test_attempt_and_elastic_env_exported(tmp_path):
    """Each child sees its attempt number; after a device loss the
    relaunch sees the survivors in ``TTD_ELASTIC_DEVICES``."""
    out = tmp_path / "env.txt"
    code = (
        "import json, os, pathlib, sys\n"
        f"p = pathlib.Path({str(out)!r})\n"
        "with p.open('a') as f:\n"
        "    f.write(os.environ['TTD_SUPERVISE_ATTEMPT'] + ' ' +\n"
        "            os.environ.get('TTD_ELASTIC_DEVICES', '-') + '\\n')\n"
        "if p.read_text().count('\\n') < 2:\n"
        "    pathlib.Path(os.environ['TTD_ELASTIC_STATE']).write_text(\n"
        "        json.dumps({'survivors': 1}))\n"
        "    sys.exit(113)\n")
    res = tsup.TrainSupervisor(_child(code), backoff_s=0.0,
                               journal_path=str(tmp_path / "j.jsonl"),
                               handle_signals=False).run()
    assert res.returncode == 0 and res.device_losses == 1
    assert out.read_text().splitlines() == ["0 -", "1 1"]


# -- the launcher under --supervise ---------------------------------------------


_FLAGS = ["--config", "llama_tiny_sft", "--steps", "8",
          "--checkpoint-every", "2", "--max-to-keep", "2", "--log-every",
          "2", "--device", "cpu"]


def _supervised(tmp, ckpt, plan):
    env = {k: v for k, v in os.environ.items()
           if k not in ("TTD_FAULT_PLAN", "TTD_SUPERVISE_ATTEMPT")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch",
         *_FLAGS, "--checkpoint-dir", ckpt, "--supervise",
         "--restart-backoff", "0", "--fault-plan", plan], cwd=tmp,
        env=env, capture_output=True, text=True, timeout=300)


def test_supervised_kill_resumes_to_the_uninterrupted_checkpoint(tmp_path):
    """One command: the torn step-4 save, a kill -9 at step 6, the
    relaunch (attempt 1) quarantines step 4, restores step 2 and ends
    with the uninterrupted run's step-8 checkpoint, bit for bit; the
    supervising process itself never imports torch."""
    r = _supervised(tmp_path, "b", "ckpt:save:partial:step=4:attempt=0;"
                    "step:6:kill9:attempt=0")
    assert r.returncode == 0, r.stderr[-3000:]
    assert [(e["event"], e.get("class"), e.get("rc"))
            for e in _journal(tmp_path / "b" / "supervisor.jsonl")] == [
        ("exit", "crash", -9), ("exit", "clean", 0), ("done", None, None)]
    assert "restored checkpoint step 2" in r.stderr
    assert (tmp_path / "b" / "corrupt" / "4").is_dir()
    a = tlaunch.run(tlaunch.build_parser().parse_args(
        _FLAGS + ["--checkpoint-dir", str(tmp_path / "a")]))
    assert a.state.step == 8
    for f in ("tensors.bin", "manifest.json"):
        assert (tmp_path / "a" / "8" / f).read_bytes() == \
            (tmp_path / "b" / "8" / f).read_bytes(), f
    probe = subprocess.run(
        [sys.executable, "-c", "import sys; from tensorflow_train_distributed"
         "_torch import launch; launch.build_parser(light=True)"
         ".parse_args(['--supervise']); "
         "from tensorflow_train_distributed_torch.runtime import supervisor;"
         " print('torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert probe.stdout.strip() == "False", probe.stderr[-2000:]


def test_device_loss_exits_113_and_is_relaunched(tmp_path):
    """``mesh:device_lost`` at step 5: the child writes the survivors to
    the elastic sidecar and exits 113; the supervisor journals a device
    loss and a resize, spends no crash budget, and the relaunch (on the
    same device) finishes from the step-4 checkpoint."""
    r = _supervised(tmp_path, "ck", "mesh:device_lost:1:step=5:attempt=0")
    assert r.returncode == 0, r.stderr[-3000:]
    recs = _journal(tmp_path / "ck" / "supervisor.jsonl")
    assert [(e["event"], e.get("class")) for e in recs] == [
        ("exit", "device_loss"), ("resize", None), ("exit", "clean"),
        ("done", None)]
    assert recs[0]["rc"] == 113 and recs[0]["survivors"] == 1
    assert recs[-1]["crashes"] == 0
    assert "DEVICE LOSS" in r.stderr
    assert "restored checkpoint step 4" in r.stderr
