"""Python face of the native batch stager: structured batches in, out
(the port's copy of the JAX package's ``native/staging.py``, over
``src/staging.cpp``).

``NativeBatchStager`` serves the hot path of ``data.pipeline``: given a
random-access source flattened to one contiguous ``[N, record_bytes]``
byte matrix, worker threads gather shuffled index lists into pooled
batch buffers off the GIL and deliver them in submission order (the
determinism multi-host SPMD requires).  Field structure (names/dtypes/
shapes) is packed/unpacked at the edges, so consumers still see
``{"image": ..., "label": ...}`` dict batches.

A stager builds the library and raises ``native.NativeUnavailable`` where
it cannot: ``DataConfig(use_native=True)`` never falls back to the Python
path.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Sequence

import numpy as np

from tensorflow_train_distributed_torch import native


class RecordLayout:
    """Field names/dtypes/shapes ↔ one packed record row."""

    def __init__(self, sample: dict[str, np.ndarray]):
        self.fields = []
        offset = 0
        for name in sorted(sample):
            arr = np.asarray(sample[name])
            nbytes = arr.dtype.itemsize * int(np.prod(arr.shape, dtype=int))
            self.fields.append((name, arr.dtype, tuple(arr.shape),
                                offset, nbytes))
            offset += nbytes
        self.record_bytes = offset

    def pack_source(self, source) -> np.ndarray:
        """Flatten a random-access source into a [N, record_bytes] matrix."""
        n = len(source)
        out = np.empty((n, self.record_bytes), np.uint8)
        for i in range(n):
            rec = source[i]
            for name, dtype, shape, offset, nbytes in self.fields:
                out[i, offset:offset + nbytes] = np.ascontiguousarray(
                    rec[name], dtype=dtype).view(np.uint8).reshape(-1)
        return out

    def unpack_batch(self, flat: np.ndarray) -> dict[str, np.ndarray]:
        """[B, record_bytes] bytes → field dict with leading batch dim."""
        batch = {}
        for name, dtype, shape, offset, nbytes in self.fields:
            field = flat[:, offset:offset + nbytes]
            batch[name] = np.ascontiguousarray(field).view(dtype).reshape(
                (flat.shape[0],) + shape)
        return batch


class NativeBatchStager:
    """Deterministic-order threaded batch assembly over a packed source."""

    def __init__(self, packed: np.ndarray, batch_size: int, *,
                 num_threads: int = 2, pool_size: int = 4):
        lib = native.load_library()
        if packed.dtype != np.uint8 or packed.ndim != 2:
            raise ValueError("packed source must be [N, record_bytes] uint8")
        self._lib = lib
        self._packed = np.ascontiguousarray(packed)  # keep alive: borrowed
        self.num_records, self.record_bytes = self._packed.shape
        self.batch_size = batch_size
        self._handle = lib.ttd_stager_create(
            self._packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.num_records, self.record_bytes, batch_size,
            num_threads, pool_size)
        if not self._handle:
            raise RuntimeError("ttd_stager_create failed")

    def _require_handle(self):
        # ctypes would pass NULL straight into native code → segfault.
        if not self._handle:
            raise RuntimeError("stager is closed")
        return self._handle

    def submit(self, indices: Sequence[int]) -> None:
        self._require_handle()
        idx = np.ascontiguousarray(indices, dtype=np.uint64)
        if idx.shape != (self.batch_size,):
            raise ValueError(
                f"need exactly {self.batch_size} indices, got {idx.shape}")
        rc = self._lib.ttd_stager_submit(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        if rc != 0:
            raise ValueError("submit rejected (index out of range or closed)")

    def next_batch(self) -> np.ndarray:
        """Blocking; returns an owned [B, record_bytes] uint8 copy."""
        buf = self._lib.ttd_stager_acquire(self._require_handle())
        if not buf:
            raise StopIteration
        try:
            flat = np.ctypeslib.as_array(
                buf, shape=(self.batch_size, self.record_bytes))
            return flat.copy()
        finally:
            self._lib.ttd_stager_release(self._handle, buf)

    def close(self) -> None:
        if self._handle:
            self._lib.ttd_stager_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def pack_for_staging(source) -> tuple[RecordLayout, np.ndarray]:
    """One-time O(N) flatten of a source for the stager.

    Callers that re-create iterators (periodic eval, preemption restart)
    should pack once and pass the result to ``native_batch_iterator`` —
    packing copies the whole dataset.
    """
    layout = RecordLayout(source[0])
    return layout, layout.pack_source(source)


def native_batch_iterator(
    source,
    order_epochs: Iterator[np.ndarray],
    batch_size: int,
    *,
    num_threads: int = 2,
    lookahead: int = 2,
    packed: Optional[tuple[RecordLayout, np.ndarray]] = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Iterate structured batches drawn via the native stager.

    ``order_epochs`` yields per-epoch index arrays (already sharded/
    shuffled by the caller — ``HostDataLoader`` semantics).  Keeps
    ``lookahead`` submissions in flight so worker threads stay busy one
    batch ahead of the consumer.  ``packed`` is a cached
    ``pack_for_staging`` result; omitted, the source is packed here.
    """
    layout, packed = packed if packed is not None else pack_for_staging(source)
    stager = NativeBatchStager(packed, batch_size,
                               num_threads=num_threads,
                               pool_size=lookahead + 2)
    try:
        pending = 0

        def _batches():
            for order in order_epochs:
                for b in range(len(order) // batch_size):
                    yield order[b * batch_size:(b + 1) * batch_size]

        it = _batches()
        done = False
        while True:
            while pending < 1 + lookahead and not done:
                try:
                    stager.submit(next(it))
                    pending += 1
                except StopIteration:
                    done = True
            if pending == 0:
                return
            flat = stager.next_batch()
            pending -= 1
            yield layout.unpack_batch(flat)
    finally:
        stager.close()
