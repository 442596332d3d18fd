"""The port's data-parallel bench tools on the CPU
(``tensorflow_train_distributed_torch/tools/bench_{allreduce,
grad_quant}.py``): gloo ranks and the native host ring in real
processes, at tiny sizes.

- bench_allreduce: the device leg over 2 gloo ranks (no bandwidth under
  a device metric's name on the CPU: the gloo time alone) at the f32 and
  int8 wires, the int8 record's ``wire_bytes`` the collectives' own
  count; the host leg over 2 ring processes (host GB/s).
- bench_grad_quant at world 2: the kill switch bit for bit ``none``, the
  int8 losses within the JAX tool's bar, the restore check, each leg's
  spans (the pipeline's sub-spans one a step where it ran), and the wire
  bytes equal to the JAX package's ``grad_sync_wire_bytes`` over the JAX
  tool's model's parameters; ``--overlap`` likewise against ``seq``.
- with no card, ``--device cuda`` (the default) ends in a failure record
  under 500 bytes and a nonzero exit: no CPU fallback.
"""

import importlib.util
import io
import json
import os
from contextlib import redirect_stdout

import jax
import pytest
import torch

from tensorflow_train_distributed_torch.parallel import collectives as C
from tensorflow_train_distributed_torch.tools import (
    bench_allreduce,
    bench_grad_quant,
)

TINY = ["--steps", "3", "--batch", "8", "--seq", "16", "--world", "2",
        "--device", "cpu"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _lock_path(tmp_path, monkeypatch):
    monkeypatch.setenv("TTD_CHIP_LOCK_PATH", str(tmp_path / "card.lock"))


def _lines(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, [json.loads(x) for x in lines], lines[-1]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_bench_allreduce_device_leg_over_gloo(quant):
    rc, recs, _ = _lines(bench_allreduce.main, [
        "--device", "cpu", "--world", "2", "--size-mb", "0.5", "--iters",
        "2", "--quant", quant])
    rec = recs[-1]
    assert rc == 0 and rec["devices"] == 2 and rec["backend"] == "gloo"
    assert rec["value"] is None and rec["cpu_time_s"] > 0
    assert "bus_bandwidth_gbps" not in rec and rec["device"] == "cpu"
    n = rec["message_bytes"] // 4
    if quant == "int8":
        assert rec["wire"] == "int8"
        assert rec["wire_bytes"] == C.q8_wire_bytes(n, 2)
    else:
        assert rec["wire"] == "f32" and "wire_bytes" not in rec


def test_bench_allreduce_host_ring_over_processes():
    rc, recs, _ = _lines(bench_allreduce.main, [
        "--host", "--world", "2", "--size-mb", "0.5", "--iters", "2",
        "--device", "cpu"])
    rec = recs[-1]
    assert rc == 0 and rec["devices"] == 2
    assert rec["backend"] == "tcp_ring" and rec["value"] > 0
    assert rec["unit"] == "GB/s (host)" and "host work" in rec["note"]


def _jax_wire_bytes() -> dict:
    """The JAX package's ``grad_sync_wire_bytes`` over the params of the
    JAX tool's model at the same sizes (its trainer's state on one CPU
    device)."""
    import optax

    from tensorflow_train_distributed_tpu.parallel import collectives as JC
    from tensorflow_train_distributed_tpu.runtime.mesh import (
        MeshConfig,
        build_mesh,
    )
    from tensorflow_train_distributed_tpu.training import (
        Trainer,
        TrainerConfig,
    )

    spec = importlib.util.spec_from_file_location(
        "jax_bench_grad_quant", os.path.join(REPO, "tools",
                                              "bench_grad_quant.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    task = mod._make_task(256, 128, 2, 16)
    batch = mod._batches(1, 8, 16, 256, 0)[0]
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    params = Trainer(task, optax.adamw(3e-3), mesh,
                     config=TrainerConfig()).create_state(batch).params
    return {w: JC.grad_sync_wire_bytes(params, 2, w)
            for w in ("f32", "int8")}


@pytest.fixture(scope="module")
def quant_ab():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench_grad_quant.main(TINY)
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-2]), json.loads(lines[-1]), lines[-1]


def test_bench_grad_quant_legs_at_world_two(quant_ab):
    rc, rec, head, line = quant_ab
    assert rc == 0 and head["passed"] and len(line) < 500
    assert rec["killswitch"]["bitwise_equal_to_none"]
    assert rec["killswitch"]["resolved_grad_quant"] == "none"
    assert rec["loss_parity"]["within_tol"]
    assert rec["loss_parity"]["tol"] == 0.1
    assert rec["restore_compat_ok"] is True
    legs = rec["legs"]
    assert {k: v["grad_quant"] for k, v in legs.items()} == {
        "none": "none", "f32": "f32", "int8": "int8"}
    for name, leg in legs.items():
        spans = leg["span_counts"]
        for s in ("train/data_wait", "train/step_dispatch",
                  "train/host_callbacks"):
            assert spans[s] == 3, (name, spans)
        piped = name != "none"
        for s in ("train/grad_fwdbwd", "train/grad_comm",
                  "train/optimizer_apply"):
            assert spans.get(s, 0) == (3 if piped else 0), (name, spans)
        assert 0 < leg["comm_fraction"] < 1 if piped else \
            "comm_fraction" not in leg
        # A CPU run measures no step time.
        assert leg["wall_per_step_ms"] is None and "walls_ms" not in leg


def test_bench_grad_quant_wire_bytes_equal_jax(quant_ab):
    _, rec, _, _ = quant_ab
    want = _jax_wire_bytes()
    assert rec["legs"]["none"]["wire_bytes_per_step"] == want["f32"]
    assert rec["legs"]["f32"]["wire_bytes_per_step"] == want["f32"]
    assert rec["legs"]["int8"]["wire_bytes_per_step"] == want["int8"]
    assert rec["value"] == want["f32"] / want["int8"]


def test_bench_grad_quant_overlap_at_world_two():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench_grad_quant.main(TINY + ["--overlap", "--grad-overlap",
                                           "3"])
    lines = buf.getvalue().strip().splitlines()
    rec, head = json.loads(lines[-2]), json.loads(lines[-1])
    assert rc == 0 and head["passed"] and len(lines[-1]) < 500
    assert rec["killswitch"]["bitwise_equal_to_seq"]
    assert rec["killswitch"]["resolved_grad_overlap"] == 0
    assert rec["loss_parity"]["within_tol"]
    assert rec["loss_parity"]["tol"] == 1e-3
    ovl = rec["legs"]["ovl"]
    assert ovl["grad_buckets"] == 3
    assert ovl["span_counts"]["train/grad_comm"] == 9
    assert ovl["span_counts"]["train/optimizer_apply"] == 9
    assert ovl["span_counts"]["train/step_barrier"] == 3
    assert rec["legs"]["seq"]["span_counts"]["train/grad_comm"] == 3
    assert rec["value"] is None        # no wall ratio off the card


@pytest.mark.parametrize("fn,argv", [
    (bench_allreduce.main, []), (bench_allreduce.main, ["--host"]),
    (bench_grad_quant.main, []), (bench_grad_quant.main, ["--overlap"])])
def test_no_card_no_fallback(fn, argv):
    assert not torch.cuda.is_available()
    rc, recs, line = _lines(fn, argv)
    assert rc == 1 and len(line) < 500
    assert "NoCard" in recs[-1]["error"] and recs[-1]["value"] is None
