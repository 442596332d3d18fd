"""The port's native host runtime (``tensorflow_train_distributed_torch/
native/``): the cases of the JAX package's ``tests/test_native.py`` on the
port's copy, then the port against the JAX native modules (the stager's
batches, the ring's sums, the q8 codes and scales bit for bit, the JPEG
pixels, the ``use_native`` loader), and the no-fallback rule.

The ring runs its W processes as W threads (ctypes releases the GIL on
every native call, so the blocking socket exchange behaves as it does
across processes; ``tests/test_torch_bench_dist.py`` runs it across
processes).  The JPEG decoder links the libjpeg PIL loads, so its pixels
equal PIL's exactly.
"""

import io
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from tensorflow_train_distributed_torch import native
from tensorflow_train_distributed_torch.testing import free_ports


def test_library_builds_and_loads():
    lib = native.load_library()
    assert hasattr(lib, "ttd_stager_create")
    assert hasattr(lib, "ttd_ring_create")
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.exists(path)


# --- staging ----------------------------------------------------------------


def _toy_source(n=64):
    return [{"x": np.full((3, 2), i, np.float32), "y": np.int32(i * 7)}
            for i in range(n)]


def test_record_layout_roundtrip():
    from tensorflow_train_distributed_torch.native.staging import (
        RecordLayout,
    )

    src = _toy_source(8)
    layout = RecordLayout(src[0])
    packed = layout.pack_source(src)
    assert packed.shape == (8, layout.record_bytes)
    batch = layout.unpack_batch(packed[[3, 1, 4]])
    np.testing.assert_array_equal(batch["y"], [21, 7, 28])
    np.testing.assert_array_equal(batch["x"][0], np.full((3, 2), 3))


def test_stager_matches_numpy_gather():
    from tensorflow_train_distributed_torch.native.staging import (
        NativeBatchStager,
        RecordLayout,
    )

    src = _toy_source(64)
    layout = RecordLayout(src[0])
    packed = layout.pack_source(src)
    stager = NativeBatchStager(packed, batch_size=8, num_threads=3)
    rng = np.random.default_rng(0)
    orders = [rng.permutation(64)[:8] for _ in range(20)]
    for order in orders:
        stager.submit(order)
    for order in orders:    # delivery follows submission order
        np.testing.assert_array_equal(stager.next_batch(), packed[order])
    stager.close()


def test_stager_rejects_bad_index():
    from tensorflow_train_distributed_torch.native.staging import (
        NativeBatchStager,
        RecordLayout,
    )

    src = _toy_source(8)
    layout = RecordLayout(src[0])
    stager = NativeBatchStager(layout.pack_source(src), batch_size=4)
    with pytest.raises(ValueError, match="rejected"):
        stager.submit([0, 1, 2, 999])
    # A valid submit after the rejected one still delivers (no seq gap).
    stager.submit([0, 1, 2, 3])
    assert stager.next_batch().shape[0] == 4
    stager.close()


def _loaders(**cfg):
    from tensorflow_train_distributed_torch.data.datasets import get_dataset
    from tensorflow_train_distributed_torch.data.pipeline import (
        DataConfig,
        HostDataLoader,
    )

    src = get_dataset("mnist", num_examples=256)
    kw = dict(process_index=0, process_count=2)
    py = HostDataLoader(src, DataConfig(global_batch_size=32, seed=5,
                                        num_epochs=2, **cfg), **kw)
    nat = HostDataLoader(src, DataConfig(global_batch_size=32, seed=5,
                                         num_epochs=2, use_native=True,
                                         **cfg), **kw)
    return py, nat


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_native_loader_matches_python_loader(drop_remainder):
    """use_native=True yields byte-identical batches in identical order
    (with the pad mask where the last batch is padded)."""
    py, nat = _loaders(drop_remainder=drop_remainder)
    py_batches, nat_batches = list(py), list(nat)
    assert len(py_batches) == len(nat_batches) > 0
    for a, b in zip(py_batches, nat_batches):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# --- ring collectives -------------------------------------------------------


def _run_group(world, fn, cls_name="HostRing", peers=None):
    """fn(group, rank) in ``world`` threads over a localhost group."""
    from tensorflow_train_distributed_torch.native import ringcoll

    cls = getattr(ringcoll, cls_name)
    peers = peers or [f"127.0.0.1:{p}" for p in free_ports(world)]
    results, errors = [None] * world, []

    def work(rank):
        try:
            group = cls(rank, peers)
            results[rank] = fn(group, rank)
            group.close()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append((rank, e))

    threads = [threading.Thread(target=work, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    return results


def test_ring_allreduce_matches_sum():
    world, n = 4, 1000      # uneven chunks

    def fn(ring, rank):
        return ring.allreduce(np.arange(n, dtype=np.float32) * (rank + 1))

    want = np.arange(n, dtype=np.float32) * sum(range(1, world + 1))
    for r in _run_group(world, fn):
        np.testing.assert_allclose(r, want, rtol=1e-6)


def test_ring_allreduce_q8_approx_and_bit_consistent():
    world, n = 4, 2000

    def fn(ring, rank):
        x = np.random.default_rng(rank).normal(0, 1, n).astype(np.float32)
        return x, ring.allreduce_q8(x)

    results = _run_group(world, fn)
    want = np.sum([x for x, _ in results], axis=0)
    got0 = results[0][1]
    np.testing.assert_allclose(got0, want, atol=0.2)
    assert not np.array_equal(got0, want)      # it is quantized
    for _, r in results[1:]:
        np.testing.assert_array_equal(r, got0)


def test_ring_allreduce_q8_small_and_zero():
    for r in _run_group(3, lambda ring, rank: ring.allreduce_q8(
            np.asarray([float(rank)], np.float32))):
        np.testing.assert_allclose(r, [3.0], atol=0.02)
    for r in _run_group(2, lambda ring, rank: ring.allreduce_q8(
            np.zeros(700, np.float32))):
        np.testing.assert_array_equal(r, np.zeros(700, np.float32))


def test_ring_allreduce_small_vector():
    for r in _run_group(3, lambda ring, rank: ring.allreduce(
            np.asarray([float(rank)], np.float32))):
        np.testing.assert_allclose(r, [3.0])


def test_ring_broadcast():
    payload = np.arange(17, dtype=np.int64)

    def fn(ring, rank):
        x = payload if rank == 1 else np.zeros_like(payload)
        return ring.broadcast(x, root=1)

    for r in _run_group(4, fn):
        np.testing.assert_array_equal(r, payload)


def test_ring_setup_times_out_when_predecessor_missing():
    from tensorflow_train_distributed_torch.native.ringcoll import HostRing

    ports = free_ports(3)
    peers = [f"127.0.0.1:{p}" for p in ports]
    fake = socket.socket()
    fake.bind(("127.0.0.1", ports[1]))
    fake.listen(1)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            HostRing(0, peers, timeout_ms=1500)
        assert time.monotonic() - t0 < 10
    finally:
        fake.close()


def test_ring_world_one_is_noop():
    from tensorflow_train_distributed_torch.native.ringcoll import HostRing

    ring = HostRing(0, [f"127.0.0.1:{free_ports(1)[0]}"])
    np.testing.assert_allclose(
        ring.allreduce(np.asarray([5.0], np.float32)), [5.0])
    ring.close()


@pytest.mark.parametrize("algorithm", ["hd", "shuffle"])
@pytest.mark.parametrize("world,n", [(4, 1000), (8, 64), (2, 7), (4, 3)])
def test_mesh_allreduce_matches_sum(algorithm, world, n):
    def fn(mesh, rank):
        return mesh.allreduce(np.arange(n, dtype=np.float32) * (rank + 1),
                              algorithm=algorithm)

    want = np.arange(n, dtype=np.float32) * sum(range(1, world + 1))
    for r in _run_group(world, fn, "HostMesh"):
        np.testing.assert_allclose(r, want, rtol=1e-6)


def test_mesh_rejects_non_power_of_two():
    def fn(mesh, rank):
        with pytest.raises(ValueError, match="power-of-2"):
            mesh.allreduce(np.ones(8, np.float32), algorithm="hd")
        return True

    assert all(_run_group(3, fn, "HostMesh"))


def test_mesh_world_one_is_noop():
    from tensorflow_train_distributed_torch.native.ringcoll import HostMesh

    mesh = HostMesh(0, ["127.0.0.1:1"])
    np.testing.assert_allclose(mesh.allreduce(np.asarray([3.0],
                                                         np.float32)), [3.0])
    mesh.close()


# --- the JPEG decoder ---------------------------------------------------------


def _jpeg(rng, h, w, gray=False, quality=90):
    from PIL import Image

    arr = rng.integers(0, 255, (h, w) if gray else (h, w, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _pil(data):
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def test_jpeg_decode_matches_pil_exactly():
    from tensorflow_train_distributed_torch.native import jpeg as njpeg

    data = _jpeg(np.random.default_rng(0), 97, 133)
    np.testing.assert_array_equal(njpeg.decode_rgb(data), _pil(data))


def test_jpeg_grayscale_converts_to_rgb():
    from tensorflow_train_distributed_torch.native import jpeg as njpeg

    out = njpeg.decode_rgb(_jpeg(np.random.default_rng(1), 40, 56,
                                 gray=True))
    assert out.shape == (40, 56, 3)
    np.testing.assert_array_equal(out[..., 0], out[..., 1])


def test_jpeg_scale_denom_dims():
    from tensorflow_train_distributed_torch.native import jpeg as njpeg

    data = _jpeg(np.random.default_rng(2), 96, 132)
    assert njpeg.output_dims(data, 1) == (96, 132)
    assert njpeg.output_dims(data, 2) == (48, 66)
    assert njpeg.output_dims(data, 4) == (24, 33)
    assert njpeg.decode_rgb(data, scale_denom=2).shape == (48, 66, 3)


def test_jpeg_batch_threaded_matches_single_and_flags_failures():
    from tensorflow_train_distributed_torch.native import jpeg as njpeg

    rng = np.random.default_rng(3)
    datas = [_jpeg(rng, int(rng.integers(30, 90)),
                   int(rng.integers(30, 90))) for _ in range(12)]
    datas.insert(5, b"not a jpeg at all")
    out = njpeg.decode_batch(datas, num_threads=4)
    assert out[5] is None
    for i, data in enumerate(datas):
        if i != 5:
            np.testing.assert_array_equal(out[i], njpeg.decode_rgb(data))


def test_jpeg_garbage_raises_cleanly():
    from tensorflow_train_distributed_torch.native import jpeg as njpeg

    with pytest.raises(ValueError):
        njpeg.decode_rgb(b"\xff\xd8garbage-after-soi")
    with pytest.raises(ValueError):
        njpeg.output_dims(b"")


def test_decode_image_uses_native_path_transparently():
    """``decode_image`` chose libjpeg here (the parity probe holds) and
    gives PIL's pixels; a PNG goes to PIL."""
    from PIL import Image

    from tensorflow_train_distributed_torch.data import image as I
    from tensorflow_train_distributed_torch.native import jpeg as njpeg

    assert I.decoder() == ("libjpeg", "the native decoder's pixels equal "
                           "PIL's on the probe")
    data = _jpeg(np.random.default_rng(4), 50, 70)
    np.testing.assert_array_equal(I.decode_image(data),
                                  njpeg.decode_rgb(data))
    arr = np.random.default_rng(5).integers(0, 255, (9, 7, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    np.testing.assert_array_equal(I.decode_image(buf.getvalue()), arr)


# --- against the JAX package's native modules -------------------------------


@pytest.fixture(scope="module")
def jnative():
    from tensorflow_train_distributed_tpu import native as jn

    if jn.load_library() is None:
        pytest.fail("the JAX package's native library did not build")
    return jn


def test_stager_batches_equal_jax(jnative):
    from tensorflow_train_distributed_tpu.native import staging as jst

    from tensorflow_train_distributed_torch.native import staging as tst

    src = _toy_source(64)
    orders = [np.random.default_rng(7).permutation(64) for _ in range(2)]
    got = list(tst.native_batch_iterator(src, iter(orders), 8))
    want = list(jst.native_batch_iterator(src, iter(orders), 8))
    assert len(got) == len(want) == 16
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_ring_sums_equal_jax(jnative):
    """The port's ring and the JAX package's, on the same inputs: the f32
    and q8 sums bit for bit."""
    from tensorflow_train_distributed_tpu.native import ringcoll as jrc

    def inputs(rank):
        return np.random.default_rng([9, rank]).normal(
            0, 2, 3001).astype(np.float32)

    def fn(group, rank):
        return group.allreduce(inputs(rank)), group.allreduce_q8(
            inputs(rank))

    got = _run_group(3, fn)
    peers = [f"127.0.0.1:{p}" for p in free_ports(3)]
    want, errors = [None] * 3, []

    def jwork(rank):
        try:
            ring = jrc.HostRing(rank, peers)
            want[rank] = fn(ring, rank)
            ring.close()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=jwork, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    for (a, qa), (b, qb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(qa, qb)


@pytest.mark.parametrize("case", ["normal", "zeros", "tiny", "nonfinite",
                                  "ragged"])
def test_q8_codes_and_scales_equal_jax_and_the_port_collectives(case):
    """``ringcoll.quantize_q8_np``: the JAX package's recipe and the
    port's device-side ``collectives.quantize_q8``, bit for bit."""
    from tensorflow_train_distributed_tpu.native import ringcoll as jrc

    from tensorflow_train_distributed_torch.native import ringcoll as trc
    from tensorflow_train_distributed_torch.parallel import collectives as C

    rng = np.random.default_rng(11)
    x = {"normal": rng.normal(0, 3, 4096),
         "zeros": np.zeros(1024),
         "tiny": rng.normal(0, 1e-40, 1024),
         "nonfinite": np.concatenate([rng.normal(0, 1, 1000),
                                      [np.inf, -np.inf, np.nan],
                                      rng.normal(0, 1, 533)]),
         "ragged": rng.normal(0, 5, 1537)}[case].astype(np.float32)
    assert trc.Q8_BLOCK == jrc.Q8_BLOCK == C.Q8_BLOCK == 512
    q, s = trc.quantize_q8_np(x)
    jq, js = jrc.quantize_q8_np(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(trc.dequantize_q8_np(q, s),
                                  jrc.dequantize_q8_np(jq, js))
    if case != "nonfinite" and x.size % 512 == 0:
        tq, ts = C.quantize_q8(torch.from_numpy(x))
        np.testing.assert_array_equal(q, tq.numpy())
        np.testing.assert_array_equal(s, ts.numpy())


def test_jpeg_pixels_equal_jax_and_pil(jnative):
    from tensorflow_train_distributed_tpu.native import jpeg as jjpeg

    from tensorflow_train_distributed_torch.native import jpeg as njpeg

    if not jjpeg.available():
        pytest.fail("the JAX package's JPEG decoder did not build")
    rng = np.random.default_rng(12)
    datas = [_jpeg(rng, int(rng.integers(20, 120)),
                   int(rng.integers(20, 120)), quality=q)
             for q in (50, 75, 90, 95)]
    got = njpeg.decode_batch(datas, num_threads=2)
    want = jjpeg.decode_batch(datas, num_threads=2)
    for data, a, b in zip(datas, got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _pil(data))
        np.testing.assert_array_equal(njpeg.decode_rgb(data, 2),
                                      jjpeg.decode_rgb(data, 2))


def test_use_native_loader_equals_jax_use_native_loader(jnative):
    from tensorflow_train_distributed_tpu.data import (
        DataConfig as JDataConfig,
        HostDataLoader as JLoader,
    )
    from tensorflow_train_distributed_tpu.data.datasets import (
        get_dataset as jget,
    )

    _, nat = _loaders()
    jl = JLoader(jget("mnist", num_examples=256),
                 JDataConfig(global_batch_size=32, seed=5, num_epochs=2,
                             use_native=True),
                 process_index=0, process_count=2)
    got, want = list(nat), list(jl)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_missing_compiler_raises_where_native_was_asked(monkeypatch,
                                                        tmp_path):
    """No g++ on PATH and nothing built: ``use_native=True``, the host
    ring and the JPEG decoder raise with the reason; ``decode_image``
    alone takes PIL, and says why."""
    from tensorflow_train_distributed_torch.data import image as I
    from tensorflow_train_distributed_torch.native import jpeg as njpeg
    from tensorflow_train_distributed_torch.native.ringcoll import HostRing

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(I, "_DECODER", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(native.NativeUnavailable, match="no C.. compiler"):
        _loaders()
    with pytest.raises(native.NativeUnavailable, match="no C.. compiler"):
        HostRing(0, ["127.0.0.1:1"])
    with pytest.raises(native.NativeUnavailable, match="no C.. compiler"):
        njpeg.decode_rgb(_jpeg(np.random.default_rng(6), 8, 8))
    assert not njpeg.available()
    decoder, why = I.decoder()
    assert decoder == "pil" and "no C++ compiler" in why
    data = _jpeg(np.random.default_rng(6), 8, 8)
    np.testing.assert_array_equal(I.decode_image(data), _pil(data))
