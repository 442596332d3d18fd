"""The port's data layer against the JAX package's, on the CPU.

Every comparison is bitwise (``assert_array_equal`` on the numpy
batches): the synthetic sources, the loader's epoch order with and
without shuffling, its padded evaluation batches and their
``sample_weight``, ``iter_from(k)`` (mid-epoch resume), the mixture and
file-list sources, and the TFRecord, mmap-shard and packed sources over
corpora the tests write themselves.  Then the port's own device side:
``prefetch_to_device`` and the ``data:read`` fault site.
"""

import numpy as np
import pytest
import torch

from tensorflow_train_distributed_tpu.data import datasets as jds
from tensorflow_train_distributed_tpu.data import filesource as jfs
from tensorflow_train_distributed_tpu.data import packing as jpk
from tensorflow_train_distributed_tpu.data import pipeline as jpl
from tensorflow_train_distributed_tpu.data import tfrecord as jtf
from tensorflow_train_distributed_torch.data import datasets as tds
from tensorflow_train_distributed_torch.data import filesource as tfs
from tensorflow_train_distributed_torch.data import packing as tpk
from tensorflow_train_distributed_torch.data import pipeline as tpl
from tensorflow_train_distributed_torch.data import tfrecord as ttf
from tensorflow_train_distributed_torch.runtime import faults


def _same_batches(a_iter, b_iter, n):
    for i in range(n):
        a, b = next(a_iter), next(b_iter)
        assert a.keys() == b.keys(), i
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k],
                                          err_msg=f"batch {i} {k}")


def _loaders(jsrc, tsrc, shard_policy="data", **cfg):
    """The JAX loader (one process, under ``shard_policy``) and the
    port's, which has one order for both policies."""
    jl = jpl.HostDataLoader(jsrc, jpl.DataConfig(shard_policy=shard_policy,
                                                 **cfg),
                            process_index=0, process_count=1)
    tl = tpl.HostDataLoader(tsrc, tpl.DataConfig(**cfg))
    return jl, tl


@pytest.mark.parametrize("name,kw", [
    ("mnist", {}), ("blobs", {}), ("imagenet", dict(image_size=16)),
    ("lm", dict(seq_len=16, vocab_size=256)), ("mlm", dict(seq_len=16)),
    ("wmt", dict(seq_len=8))])
def test_synthetic_sources_match_jax(name, kw):
    jsrc = jds.get_dataset(name, num_examples=12, **kw)
    tsrc = tds.get_dataset(name, num_examples=12, **kw)
    assert len(jsrc) == len(tsrc) == 12
    for i in (0, 5, 11):
        a, b = jsrc[i], tsrc[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_loader_epochs_match_jax(shuffle, drop_remainder):
    """Three epochs of 37 records in batches of 8 (4 whole, or 5 with
    the last padded and weighted)."""
    kw = dict(num_examples=37, seq_len=8, vocab_size=64, seed=5)
    jl, tl = _loaders(jds.SyntheticLM(**kw), tds.SyntheticLM(**kw),
                      global_batch_size=8, seed=3, shuffle=shuffle,
                      drop_remainder=drop_remainder, num_epochs=3)
    assert jl.steps_per_epoch() == tl.steps_per_epoch()
    ja, ta = list(jl), list(tl)
    assert len(ja) == len(ta) == 3 * tl.steps_per_epoch()
    _same_batches(iter(ja), iter(ta), len(ja))
    if not drop_remainder:
        w = np.concatenate([b["sample_weight"] for b in ta[:5]])
        np.testing.assert_array_equal(w, [1.0] * 37 + [0.0] * 3)


@pytest.mark.parametrize("k", [0, 1, 4, 5, 9, 13])
def test_iter_from_matches_jax(k):
    """Resume after k batches (5 a epoch): mid-epoch, at an epoch
    boundary and in a later epoch, for training and padded evaluation
    loaders."""
    kw = dict(num_examples=42, seq_len=8, vocab_size=64)
    for drop in (True, False):
        jl, tl = _loaders(jds.SyntheticLM(**kw), tds.SyntheticLM(**kw),
                          global_batch_size=8, seed=11,
                          drop_remainder=drop)
        _same_batches(jl.iter_from(k), tl.iter_from(k), 6)
        fresh = iter(tl)
        for _ in range(k):
            next(fresh)
        _same_batches(fresh, tl.iter_from(k), 3)


def test_iter_from_past_the_last_epoch_is_empty():
    kw = dict(num_examples=16, seq_len=4, vocab_size=16)
    _, tl = _loaders(jds.SyntheticLM(**kw), tds.SyntheticLM(**kw),
                     global_batch_size=8, num_epochs=1)
    assert list(tl.iter_from(2)) == []
    assert len(list(tl.iter_from(1))) == 1


def test_loader_refusals():
    src = tds.SyntheticLM(num_examples=4, seq_len=4, vocab_size=16)
    with pytest.raises(ValueError, match="0 batches"):
        tpl.HostDataLoader(src, tpl.DataConfig(global_batch_size=8))

    class Weighted:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return {"x": np.zeros(2, np.float32),
                    "sample_weight": np.float32(1)}

    loader = tpl.HostDataLoader(Weighted(), tpl.DataConfig(
        global_batch_size=4, drop_remainder=False))
    with pytest.raises(ValueError, match="sample_weight"):
        next(iter(loader))


def test_split_mixture_and_file_list_match_jax():
    kw = dict(num_examples=50, seq_len=8, vocab_size=64)
    jtrain, jval = jds.train_val_split(jds.SyntheticLM(**kw), 0.2,
                                       min_val=8, min_train=8)
    ttrain, tval = tds.train_val_split(tds.SyntheticLM(**kw), 0.2,
                                       min_val=8, min_train=8)
    assert (len(ttrain), len(tval)) == (len(jtrain), len(jval)) == (40, 10)
    jl, tl = _loaders(jval, tval, global_batch_size=4, seed=1,
                      num_epochs=1, drop_remainder=False)
    _same_batches(iter(jl), iter(tl), 3)

    parts = [dict(num_examples=n, seq_len=8, vocab_size=64, seed=s)
             for n, s in ((20, 1), (7, 2), (13, 3))]
    jmix = jpl.MixtureSource([jds.SyntheticLM(**p) for p in parts],
                             [0.5, 0.2, 0.3], seed=4, num_examples=64)
    tmix = tpl.MixtureSource([tds.SyntheticLM(**p) for p in parts],
                             [0.5, 0.2, 0.3], seed=4, num_examples=64)
    jl, tl = _loaders(jmix, tmix, global_batch_size=8, seed=2)
    _same_batches(jl.iter_from(3), tl.iter_from(3), 10)

    jcat = jpl.ConcatSource([jds.SyntheticLM(**p) for p in parts])
    tcat = tpl.ConcatSource([tds.SyntheticLM(**p) for p in parts])
    for policy in ("data", "file"):
        jl, tl = _loaders(jcat, tcat, global_batch_size=8, seed=6,
                          shard_policy=policy)
        _same_batches(iter(jl), iter(tl), 12)


def _lm_records(n, seq, seed=9):
    src = tds.SyntheticLM(num_examples=n, seq_len=seq, vocab_size=128,
                          seed=seed)
    return [src[i] for i in range(n)]


def test_tfrecord_corpus_matches_jax(tmp_path):
    """Fixed-shape Examples in two files (one gzip), written by the port
    and read by both packages; a record written by the JAX writer reads
    the same in the port."""
    recs = _lm_records(24, 16)
    for name, part in (("a.tfrecord", recs[:10]),
                       ("b.tfrecord.gz", recs[10:])):
        with ttf.TFRecordWriter(tmp_path / name) as w:
            for r in part:
                w.write_example(r)
    spec = {"tokens": ((16,), np.int64), "targets": ((16,), np.int64)}
    ttf.write_features_sidecar(tmp_path, spec)
    jsrc = jds.get_dataset("tfrecord_dir", root=str(tmp_path))
    tsrc = tds.get_dataset("tfrecord_dir", root=str(tmp_path))
    assert len(jsrc) == len(tsrc) == 24
    np.testing.assert_array_equal(tsrc[13]["tokens"], recs[13]["tokens"])
    for policy in ("data", "file"):
        jl, tl = _loaders(jsrc, tsrc, global_batch_size=8, seed=2,
                          shard_policy=policy)
        _same_batches(jl.iter_from(2), tl.iter_from(2), 5)
    assert jtf.encode_example(recs[0]) == ttf.encode_example(recs[0])
    decoded = ttf.decode_example(jtf.encode_example(recs[3]))
    np.testing.assert_array_equal(decoded["tokens"], recs[3]["tokens"])


def test_mmap_shards_match_jax(tmp_path):
    src = tds.SyntheticLM(num_examples=30, seq_len=8, vocab_size=64)
    tfs.write_shards(tmp_path / "c", src, num_shards=4)
    jsrc = jfs.open_sharded(tmp_path / "c")
    tsrc = tds.get_dataset("array_dir", root=str(tmp_path / "c"))
    assert len(tsrc.parts) == 4 and len(tsrc) == 30
    jl, tl = _loaders(jsrc, tsrc, global_batch_size=8, seed=7)
    _same_batches(jl.iter_from(1), tl.iter_from(1), 6)


def test_packed_documents_match_jax(tmp_path):
    """Variable-length token documents in a RAW TFRecord corpus, packed
    into 16-token rows with segment ids and loss weights."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 100, rng.integers(1, 30)).astype(np.int64)
            for _ in range(40)]
    with ttf.TFRecordWriter(tmp_path / "docs.tfrecord") as w:
        for d in docs:
            w.write_example({"tokens": d})
    jp = jpk.PackedLmSource.from_source(
        jtf.TFRecordSource([tmp_path / "docs.tfrecord"]), 16)
    tp = tpk.PackedLmSource.from_source(
        ttf.TFRecordSource([tmp_path / "docs.tfrecord"]), 16)
    assert len(jp) == len(tp) and tp.max_token_id == jp.max_token_id
    jl, tl = _loaders(jp, tp, global_batch_size=4, seed=1)
    _same_batches(iter(jl), iter(tl), 2 * tl.steps_per_epoch())
    assert {"segment_ids", "loss_weights"} <= set(tp[0])


def test_prefetch_to_device_keeps_order_and_errors():
    src = tds.SyntheticLM(num_examples=40, seq_len=8, vocab_size=64)
    loader = tpl.HostBatches(src, 8, seed=1)
    got = tpl.prefetch_to_device(iter(loader), "cpu")
    for i, (want, dev) in enumerate(zip(iter(loader), got)):
        assert isinstance(dev["tokens"], torch.Tensor)
        np.testing.assert_array_equal(dev["tokens"].numpy(),
                                      want["tokens"])
        if i == 7:          # two epochs in, then stop early
            break
    got.close()

    def broken():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("reader died")

    it = tpl.prefetch_to_device(broken(), "cpu")
    assert next(it)["x"].shape == (2,)
    with pytest.raises(RuntimeError, match="reader died"):
        next(it)


def test_data_read_faults_retry_then_propagate(tmp_path):
    """``data:read:transient_io:n=2`` is absorbed by the read retry; n=5
    outlasts its budget of 3 attempts and the error propagates."""
    src = tds.SyntheticLM(num_examples=8, seq_len=4, vocab_size=16)
    tfs.write_shards(tmp_path / "c", src, num_shards=2)
    corpus = tfs.open_sharded(tmp_path / "c")
    try:
        faults.arm("data:read:transient_io:n=2")
        np.testing.assert_array_equal(corpus[3]["tokens"],
                                      src[3]["tokens"])
        faults.arm("data:read:transient_io:n=5")
        with pytest.raises(OSError):
            corpus[4]
    finally:
        faults.disarm()
    assert not faults.ARMED
