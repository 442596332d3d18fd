"""``export_program`` (the port's counterpart of the JAX package's
``export_tf.py``): a ``torch.export`` program of a task's ``predict_fn``,
saved, loaded back and run, case by case with the JAX
``tests/test_export_tf.py``.

The round trip is the proof: export a launcher checkpoint, load the file
with ``torch.export.load`` (no import of the package needed to run it),
run it at two batch sizes and match the task's own ``predict_fn`` on the
restored weights within the JAX test's 1e-5 (f32; the same graph of the
same operators), BatchNorm's running statistics carried as the
program's buffers.
"""

import numpy as np
import pytest
import torch

from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch import export_program as EP
from tensorflow_train_distributed_torch import launch as tlaunch
from tensorflow_train_distributed_torch.data.datasets import get_dataset
from tensorflow_train_distributed_torch.models import registry
from tensorflow_train_distributed_torch.training.checkpoint import (
    CheckpointManager,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Five adamw steps of mnist and of resnet_tiny through the launcher
    (the steps move every BatchNorm statistic off its init)."""
    root = tmp_path_factory.mktemp("export_program")
    out = {}
    for name, batch in (("mnist", "32"), ("resnet_tiny", "16")):
        ck = str(root / name)
        tlaunch.run(tlaunch.build_parser().parse_args([
            "--config", name, "--steps", "5", "--global-batch-size", batch,
            "--optimizer", "adamw", "--checkpoint-dir", ck,
            "--checkpoint-every", "5", "--log-every", "5", "--device",
            "cpu", "--precision", "float32"]))
        out[name] = ck
    return out


def _restored_task(name, ck, stats=True):
    """The config's task holding the checkpoint's weights (and, with
    ``stats``, its BatchNorm statistics; else the fresh ones)."""
    task = registry.make_task(registry.get_entry(name), device="meta")
    mgr = CheckpointManager(ck)
    params = mgr.restore_params()
    names = convert.model_state_names(task.model)
    if stats:
        params.update({names[k]: v for k, v in
                       mgr.restore_model_state().items()})
    else:
        fresh = convert.init_params(task.config, torch.Generator(),
                                    device="cpu")
        params.update({b: fresh[b] for b in names.values()})
    task.model.load_state_dict(params, strict=True, assign=True)
    task.model.eval()
    return task


def _batch(name, n, seed=0):
    entry = registry.get_entry(name)
    src = get_dataset(entry["dataset"], num_examples=n + seed,
                      **entry["dataset_kwargs"])
    return {k: torch.as_tensor(np.stack([src[seed + i][k]
                                         for i in range(n)]))
            for k in src[0]}


@pytest.fixture(scope="module")
def programs(checkpoints, tmp_path_factory):
    root = tmp_path_factory.mktemp("programs")
    out = {}
    for name, ck in checkpoints.items():
        path = root / f"{name}.pt2"
        program = EP.export_from_registry(name, ck, path)
        out[name] = (path, program)
    return out


@pytest.mark.parametrize("batch", [3, 16])
@pytest.mark.parametrize("name", ["mnist", "resnet_tiny"])
def test_export_load_parity(checkpoints, programs, name, batch):
    served = EP.load_program(programs[name][0], "cpu")
    task = _restored_task(name, checkpoints[name])
    b = _batch(name, batch, seed=5)
    with torch.no_grad():
        want = task.predict_fn(b)
    got = served(b)
    assert got.shape == (batch, 10)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_batch_polymorphic_serves_any_batch(programs):
    served = EP.load_program(programs["mnist"][0], "cpu")
    for b in (1, 4, 7):
        out = served({"image": torch.zeros(b, 28, 28, 1),
                      "label": torch.zeros(b, dtype=torch.int32)})
        assert out.shape == (b, 10)


def test_static_batch_export_refuses_other_batches(tmp_path):
    task = registry.make_task(registry.get_entry("mnist"), device="meta")
    task.model.load_state_dict(convert.init_params(
        task.config, torch.Generator().manual_seed(0), device="cpu"),
        assign=True)
    sample = _batch("mnist", 4)
    EP.export_program(task, sample, tmp_path / "static.pt2",
                      batch_polymorphic=False)
    served = EP.load_program(tmp_path / "static.pt2", "cpu")
    assert served(sample).shape == (4, 10)
    with pytest.raises(Exception):
        served(_batch("mnist", 5))


@pytest.mark.parametrize("name", ["mnist", "resnet_tiny"])
def test_weights_and_statistics_are_program_state(programs, name):
    """Real restorable weights, not graph constants: every parameter is a
    parameter of the program and every BatchNorm statistic a buffer."""
    program = programs[name][1]
    model = registry.make_task(registry.get_entry(name),
                               device="meta").model
    sig = program.graph_signature
    assert len(sig.parameters) == len(list(model.parameters())) > 0
    stats = convert.model_state_names(model)
    assert len(sig.buffers) == len(stats) == (18 if name == "resnet_tiny"
                                              else 0)
    state = program.state_dict
    for k, v in model.state_dict().items():
        assert tuple(state["model." + k].shape) == tuple(v.shape), k
    assert not program.constants


def test_task_without_predict_fn_rejected(tmp_path):
    class NoPredict:
        pass

    with pytest.raises(ValueError, match="predict_fn"):
        EP.export_program(NoPredict(), {}, tmp_path / "x.pt2")


def test_registry_wrapper_fresh_init(tmp_path, capsys):
    out = tmp_path / "mnist.pt2"
    assert EP.main(["--config", "mnist", "--out", str(out)]) == 0
    assert "exported program written" in capsys.readouterr().out
    served = EP.load_program(out, "cpu")
    assert served(_batch("mnist", 2)).shape == (2, 10)
    with pytest.raises(SystemExit, match="no checkpoint under"):
        EP.main(["--config", "mnist", "--checkpoint-dir",
                 str(tmp_path / "empty"), "--out", str(out)])


def test_registry_export_carries_trained_bn_stats(checkpoints, programs):
    """The export restores the model state (BatchNorm's running
    statistics) with the weights: its output is the trained statistics',
    not the fresh ones' (mean 0, var 1) a weights-only restore would
    serve."""
    ck = checkpoints["resnet_tiny"]
    stats = CheckpointManager(ck).restore_model_state()
    means = [v for k, v in stats.items() if k.endswith("/mean")]
    assert means and any(m.abs().max() > 0 for m in means)
    served = EP.load_program(programs["resnet_tiny"][0], "cpu")
    b = _batch("resnet_tiny", 4, seed=11)
    with torch.no_grad():
        trained = _restored_task("resnet_tiny", ck).predict_fn(b)
        fresh = _restored_task("resnet_tiny", ck,
                               stats=False).predict_fn(b)
    got = served(b)
    np.testing.assert_allclose(got.numpy(), trained.numpy(), **TOL)
    assert not np.allclose(got.numpy(), fresh.numpy(), **TOL)


def test_vit_exports_through_the_registry(tmp_path):
    """The new family exports too (its attention traced as the plain
    math): the program equals ``predict_fn`` of the same weights."""
    EP.export_from_registry("vit_tiny", None, tmp_path / "vit.pt2")
    served = EP.load_program(tmp_path / "vit.pt2", "cpu")
    task = registry.make_task(registry.get_entry("vit_tiny"), device="meta")
    task.model.load_state_dict(convert.init_params(
        task.config, torch.Generator().manual_seed(0), device="cpu"),
        assign=True)
    task.model.eval()
    b = _batch("vit_tiny", 6)
    with torch.no_grad():
        want = task.predict_fn(b)
    np.testing.assert_allclose(served(b).numpy(), want.numpy(), **TOL)


def test_loaded_program_moves_whole_to_another_device(programs):
    """The CPU trace asserts the CPU in its graph; ``load_program`` moves
    those assertions with the state, so the program runs on the device
    it is loaded for (the card; here the meta device stands in)."""
    served = EP.load_program(programs["mnist"][0], "meta")
    devices = {str(n.kwargs["device"]) for n in served.graph.nodes
               if "device" in n.kwargs}
    assert devices == {"meta"}
    assert all(p.device.type == "meta" for p in served.parameters())
    out = served({"image": torch.zeros(5, 28, 28, 1, device="meta"),
                  "label": torch.zeros(5, dtype=torch.int32,
                                       device="meta")})
    assert out.device.type == "meta" and out.shape == (5, 10)
