"""The port's loader sharding and its data service against the JAX
package's, on the CPU.

Every batch comparison is bitwise (``assert_array_equal``): the index
stride and the FILE autoshard of ``HostDataLoader(process_index=p,
process_count=P)``; the data service's frame, byte for byte; its batches
at W = 2 workers against the JAX dispatcher's over the same source and
seed (synthetic and TFRecord); two hosts' fleets covering an epoch once.
Then the port's own contract: refusals, a dead worker failing the run,
the trainer fed by the service and the launcher's ``--data-workers``
with its guards.  The JAX dispatchers are module-scoped: their spawned
workers import JAX.
"""

import os

import numpy as np
import pytest
import torch

from tensorflow_train_distributed_tpu.data import datasets as jds
from tensorflow_train_distributed_tpu.data import pipeline as jpl
from tensorflow_train_distributed_tpu.data import service as jsv
from tensorflow_train_distributed_tpu.data import tfrecord as jtf
from tensorflow_train_distributed_torch import launch as tlaunch
from tensorflow_train_distributed_torch.data import datasets as tds
from tensorflow_train_distributed_torch.data import pipeline as tpl
from tensorflow_train_distributed_torch.data import service as tsv


def _same(a_batches, b_batches):
    assert len(a_batches) == len(b_batches)
    for i, (a, b) in enumerate(zip(a_batches, b_batches)):
        assert a.keys() == b.keys(), i
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k],
                                          err_msg=f"batch {i} {k}")


# -- loader sharding ----------------------------------------------------------


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_index_stride_shards_match_jax(count, drop_remainder, shuffle):
    """37 records, global batch 6 over P processes, two epochs: each
    process's batches (and pad weights) equal the JAX loader's."""
    kw = dict(num_examples=37, seq_len=8, vocab_size=64, seed=5)
    cfg = dict(global_batch_size=6, seed=3, shuffle=shuffle,
               drop_remainder=drop_remainder, num_epochs=2)
    seen = []
    for p in range(count):
        jl = jpl.HostDataLoader(jds.SyntheticLM(**kw), jpl.DataConfig(**cfg),
                                process_index=p, process_count=count)
        tl = tpl.HostDataLoader(tds.SyntheticLM(**kw), tpl.DataConfig(**cfg),
                                process_index=p, process_count=count)
        assert tl.host_batch_size == 6 // count
        assert tl.steps_per_epoch() == jl.steps_per_epoch()
        ta = list(tl)
        _same(list(jl), ta)
        _same(list(jl.iter_from(3)), list(tl.iter_from(3)))
        seen.append(ta)
    if drop_remainder:
        return
    # Padded: over the processes, epoch 0 holds every record once.
    spe = len(seen[0]) // 2
    rows = [np.asarray(b["tokens"])[b["sample_weight"] > 0]
            for batches in seen for b in batches[:spe]]
    assert sum(len(r) for r in rows) == 37


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_file_autoshard_matches_jax(count, shuffle):
    """A ``ConcatSource`` of 5 files of 7-12 records: process p reads the
    files f % P == p, shuffled within its shard."""
    sizes = [7, 12, 9, 8, 11]
    parts = [dict(num_examples=n, seq_len=4, vocab_size=32, seed=i)
             for i, n in enumerate(sizes)]
    cfg = dict(global_batch_size=2 * count, seed=1, shuffle=shuffle,
               shard_policy="file", num_epochs=2)
    for p in range(count):
        jl = jpl.HostDataLoader(
            jpl.ConcatSource([jds.SyntheticLM(**k) for k in parts]),
            jpl.DataConfig(**cfg), process_index=p, process_count=count)
        tl = tpl.HostDataLoader(
            tpl.ConcatSource([tds.SyntheticLM(**k) for k in parts]),
            tpl.DataConfig(**cfg), process_index=p, process_count=count)
        assert tl.steps_per_epoch() == jl.steps_per_epoch()
        _same(list(jl), list(tl))


def test_sharding_refusals_match_jax():
    src = tds.SyntheticLM(num_examples=16, seq_len=4, vocab_size=32)
    cat = tpl.ConcatSource([src, src])
    with pytest.raises(ValueError, match="not divisible"):
        tpl.HostDataLoader(src, tpl.DataConfig(global_batch_size=6),
                           process_index=0, process_count=4)
    with pytest.raises(ValueError, match="ConcatSource"):
        tpl.HostDataLoader(src, tpl.DataConfig(global_batch_size=4,
                                               shard_policy="file"))
    with pytest.raises(ValueError, match="one file per process"):
        tpl.HostDataLoader(cat, tpl.DataConfig(global_batch_size=3,
                                               shard_policy="file"),
                           process_index=0, process_count=3)
    with pytest.raises(ValueError, match="data\\|file"):
        tpl.HostDataLoader(src, tpl.DataConfig(shard_policy="row"))


# -- the data service ---------------------------------------------------------


def _mnist_spec(mod, n=96):
    return mod.SourceSpec("mnist", {"num_examples": n})


def _config(mod, **kw):
    return mod.DataConfig(**dict(dict(global_batch_size=16, seed=3,
                                      num_epochs=1), **kw))


@pytest.fixture(scope="module")
def jax_mnist_batches():
    """The JAX dispatcher's batches over 96 synthetic MNIST records, one
    epoch, W = 2: one host, and each host of two."""
    out = {}
    for hosts in (1, 2):
        for h in range(hosts):
            with jsv.DataServiceDispatcher(
                    _mnist_spec(jsv), _config(jpl), num_workers=2,
                    host_index=h, host_count=hosts) as disp:
                out[(h, hosts)] = list(disp.client())
    return out


def test_frame_matches_jax_byte_for_byte():
    batch = {"tokens": np.arange(24, dtype=np.int32).reshape(2, 12),
             "image": np.linspace(0, 1, 30, dtype=np.float32)
             .reshape(2, 5, 3), "label": np.int32(7) * np.ones(2, np.int32)}
    jh, jp = jsv._encode_batch(batch)
    th, tp = tsv._encode_batch(batch)
    assert th == jh and tp == jp

    class Sink:
        def __init__(self):
            self.data = b""

        def sendall(self, b):
            self.data += b

    js, ts = Sink(), Sink()
    jsv._send_frame(js, jh, jp)
    tsv._send_frame(ts, th, tp)
    assert ts.data == js.data
    back = tsv._decode_batch(th, tp)
    _same([batch], [back])


def test_service_batches_match_jax(jax_mnist_batches):
    with tsv.DataServiceDispatcher(_mnist_spec(tsv), _config(tpl),
                                   num_workers=2) as disp:
        got = list(disp.client())
    assert len(got) == 6 and got[0]["image"].shape == (16, 28, 28, 1)
    _same(jax_mnist_batches[(0, 1)], got)
    # Each step is the two workers' slices: shards 0 and 1 of 2.
    shards = [list(tpl.HostDataLoader(_mnist_spec(tsv).build(), _config(tpl),
                                      process_index=w, process_count=2))
              for w in range(2)]
    for i, b in enumerate(got):
        np.testing.assert_array_equal(
            b["label"], np.concatenate([shards[0][i]["label"],
                                        shards[1][i]["label"]]))


def test_two_hosts_cover_an_epoch_once_as_jax(jax_mnist_batches):
    images = []
    for h in range(2):
        with tsv.DataServiceDispatcher(
                _mnist_spec(tsv), _config(tpl), num_workers=2,
                host_index=h, host_count=2) as disp:
            got = list(disp.client())
        _same(jax_mnist_batches[(h, 2)], got)
        assert len(got) == 6 and got[0]["label"].shape == (8,)
        images += [b["image"] for b in got]
    # The union is the epoch: every record once.
    src = _mnist_spec(tsv).build()
    want = np.stack([src[i]["image"] for i in range(len(src))])
    have = np.concatenate(images)
    order = np.lexsort(have.reshape(len(have), -1).T)
    worder = np.lexsort(want.reshape(len(want), -1).T)
    np.testing.assert_array_equal(have[order], want[worder])


def test_service_refusals():
    with pytest.raises(ValueError, match="not divisible"):
        tsv.DataServiceDispatcher(_mnist_spec(tsv), _config(tpl),
                                  num_workers=3)
    with pytest.raises(ValueError, match="host_count"):
        tsv.DataServiceDispatcher(_mnist_spec(tsv), _config(tpl),
                                  num_workers=3, host_index=0, host_count=2)
    with pytest.raises(ValueError, match="host_index"):
        tsv.DataServiceDispatcher(_mnist_spec(tsv), _config(tpl),
                                  num_workers=2, host_index=2, host_count=2)
    with pytest.raises(RuntimeError, match="died during startup"):
        tsv.DataServiceDispatcher(tsv.SourceSpec("no_such_dataset"),
                                  _config(tpl), num_workers=2).start()


def _write_tfrecords(mod, root):
    rng = np.random.default_rng(0)
    for f in range(2):
        with mod.TFRecordWriter(os.path.join(root, f"s{f}.tfrecord")) as w:
            for i in range(32):
                w.write_example({"input_ids": rng.integers(0, 100, 8),
                                 "uid": np.asarray([f * 32 + i])})
    mod.write_features_sidecar(root, {"input_ids": ((8,), np.int64),
                                      "uid": ((1,), np.int64)})


def test_service_serves_tfrecord_corpus_as_jax(tmp_path):
    _write_tfrecords(jtf, str(tmp_path))
    spec = dict(dataset="tfrecord_dir", kwargs={"root": str(tmp_path)})
    with jsv.DataServiceDispatcher(jsv.SourceSpec(**spec), _config(jpl),
                                   num_workers=2) as disp:
        want = list(disp.client())
    with tsv.DataServiceDispatcher(tsv.SourceSpec(**spec), _config(tpl),
                                   num_workers=2) as disp:
        got = list(disp.client())
    assert len(got) == 4
    _same(want, got)
    uids = np.sort(np.concatenate([b["uid"].ravel() for b in got]))
    np.testing.assert_array_equal(uids, np.arange(64))


def test_dead_worker_fails_the_run():
    """A worker killed mid-run raises in the consumer (here the trainer's
    fit); nothing falls back to reading in-process."""
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training import optimizers as O
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    entry = registry.get_entry("mnist")
    trainer = Trainer(registry.make_task(entry, device="meta"),
                      O.adam(1e-3), config=TrainerConfig(log_every=1),
                      device="cpu")
    disp = tsv.DataServiceDispatcher(
        _mnist_spec(tsv, 256), _config(tpl, num_epochs=None), num_workers=2)
    with disp:
        batches = iter(disp.client())
        next(batches)
        disp._procs[1].kill()
        disp._procs[1].join()
        with pytest.raises(ConnectionError):
            trainer.fit(batches, steps=10)


def test_trainer_consumes_service_batches():
    """The port's Trainer fed by two workers: 20 mnist steps, the loss
    falls."""
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training import optimizers as O
    from tensorflow_train_distributed_torch.training.callbacks import History
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    entry = registry.get_entry("mnist")
    hist = History()
    trainer = Trainer(registry.make_task(entry, device="meta"),
                      O.adam(3e-3), config=TrainerConfig(log_every=5),
                      device="cpu", callbacks=[hist])
    with tsv.DataServiceDispatcher(
            _mnist_spec(tsv, 256), tpl.DataConfig(global_batch_size=32),
            num_workers=2) as disp:
        state, _ = trainer.fit(disp.client(), steps=20)
    assert state.step == 20
    loss = hist.history["loss"]
    assert np.isfinite(loss).all() and loss[-1] < loss[0]
    assert trainer.timing["data_wait_s"] > 0


# -- the launcher -------------------------------------------------------------


@pytest.mark.parametrize("config,extra", [
    ("resnet_tiny", ["--global-batch-size", "16"]),
    ("llama_tiny_sft", []),
])
def test_cli_data_workers_train(config, extra):
    res = tlaunch.run(tlaunch.build_parser().parse_args([
        "--config", config, "--steps", "3", "--log-every", "1",
        "--device", "cpu", "--data-workers", "2", *extra]))
    assert res.state.step == 3
    assert np.isfinite(res.history["loss"]).all()
    assert res.summary["data_wait_ms_per_step"] > 0


def test_cli_data_workers_match_the_service_batches():
    """The launcher's run through the workers trains on the service's
    batches: the same weights as the trainer fed by a dispatcher of the
    same spec, seed and worker count."""
    from tensorflow_train_distributed_torch.models import registry

    args = tlaunch.build_parser().parse_args([
        "--config", "llama_tiny_sft", "--steps", "3", "--device", "cpu",
        "--data-workers", "2", "--log-every", "1"])
    res = tlaunch.run(args)
    entry = registry.get_entry("llama_tiny_sft")
    _, trainer, _ = tlaunch.make_trainer(args, entry, with_loader=False)
    with tsv.DataServiceDispatcher(
            tlaunch.source_spec(args, entry),
            tpl.DataConfig(global_batch_size=16, seed=0),
            num_workers=2) as disp:
        state, _ = trainer.fit(disp.client(), steps=3)
    for k, v in state.params.items():
        torch.testing.assert_close(res.state.params[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("flags,match", [
    (["--data-dir", "/nonexistent", "--pack-seq", "16"], "pack-seq"),
    (["--eval-split", "0.1", "--eval-steps", "1"], "eval-split"),
    (["--global-batch-size", "6", "--data-workers", "4"], "not divisible"),
    (["--data-workers", "-1"], "data-workers"),
])
def test_cli_data_workers_guards(flags, match):
    argv = ["--config", "llama_tiny_sft", "--steps", "1", "--device", "cpu",
            "--data-workers", "2", *flags]
    with pytest.raises(SystemExit, match=match):
        tlaunch.run(tlaunch.build_parser().parse_args(argv))
