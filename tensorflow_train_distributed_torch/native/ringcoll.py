"""Python face of the native TCP host collectives (the port's copy of the
JAX package's ``native/ringcoll.py``, over ``src/ringcoll.cpp``).

Host-side analog of the reference's graph-level allreduce builders
(SURVEY.md §2.2/§2.3): ``HostRing`` is the ring algorithm
(``distribute/v1/all_reduce.py`` ``build_ring_all_reduce:250`` /
``RingReducer``), ``HostMesh`` carries the remaining two —
recursive halving-doubling (``build_recursive_hd_all_reduce:422``) and
shuffle (``build_shuffle_all_reduce:554``).  Used for cross-process host
data (metric fan-in, input-pipeline bookkeeping, toolchain tests) where
pulling the device fabric in would be wrong.  The device path never
touches this: NCCL owns it.  Constructing a group builds the library
and raises ``native.NativeUnavailable`` where it cannot.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from tensorflow_train_distributed_torch import native

#: Quantization block size of the EQuARX-style int8 wire format — ONE
#: recipe shared by every quantized collective in the stack: the native
#: C++ ring (``kQBlock`` in native/src/ringcoll.cpp), this module's
#: numpy reference below, and the device-side gradient pipeline
#: (``parallel.collectives.quantize_q8``, which reads this constant).  A
#: drift between them would silently change the error bound of every
#: quantized allreduce, so the three are pinned against each other in
#: tests/test_torch_native.py.
Q8_BLOCK = 512


def quantize_q8_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Numpy reference of the shared int8 quantization recipe.

    Mirrors ``QuantizeBlocks`` in native/src/ringcoll.cpp exactly
    (float32 arithmetic throughout): per ``Q8_BLOCK``-element block,
    scale = amax/127 with a fallback to 1.0 when the derived scale/inv
    are zero or non-finite (all-zero, subnormal, or non-finite blocks),
    values clamped to [-127, 127] with NaN mapping to 0, rounded
    half-to-even (``lrintf`` semantics).  Returns ``(q int8 [n],
    scales f32 [ceil(n/Q8_BLOCK)])`` for a 1-D input.
    """
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    n = x.size
    nb = -(-n // Q8_BLOCK) if n else 0
    xb = np.zeros((nb, Q8_BLOCK), np.float32)
    xb.reshape(-1)[:n] = x
    a = np.abs(xb)
    # C's running `if (a > amax)` skips NaN (comparisons are false):
    amax = np.where(np.isnan(a), np.float32(0), a).max(axis=1,
                                                       initial=np.float32(0))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        scale = (amax / np.float32(127.0)).astype(np.float32)
        inv = (np.float32(1.0) / scale).astype(np.float32)
    bad = ~(scale > 0) | ~np.isfinite(inv) | ~np.isfinite(scale)
    scale = np.where(bad, np.float32(1.0), scale)
    inv = np.where(bad, np.float32(1.0), inv)
    v = xb * inv[:, None]
    v = np.where(np.isnan(v), np.float32(0),
                 np.clip(v, np.float32(-127.0), np.float32(127.0)))
    q = np.rint(v).astype(np.int8)
    return q.reshape(-1)[:n], scale


def dequantize_q8_np(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of ``quantize_q8_np`` (``DequantInto`` in the native
    ring): per-block ``q * scale`` in float32."""
    q = np.ascontiguousarray(q, np.int8).reshape(-1)
    n = q.size
    nb = -(-n // Q8_BLOCK) if n else 0
    qb = np.zeros((nb, Q8_BLOCK), np.int8)
    qb.reshape(-1)[:n] = q
    out = qb.astype(np.float32) * np.asarray(scales,
                                             np.float32)[:, None]
    return out.reshape(-1)[:n]


class _NativeGroup:
    """Shared lifecycle for ctypes-backed process groups.

    Subclasses set ``_PREFIX`` (the C symbol prefix); create/destroy/rank/
    world symbols follow ``<prefix>_create`` etc.
    """

    _PREFIX = ""
    _KIND = "group"

    def __init__(self, rank: int, peers: Sequence[str], *,
                 timeout_ms: int = 10_000):
        """``peers``: rank-ordered ``host:port`` strings, one per process."""
        lib = native.load_library()
        self._lib = lib
        self._handle = getattr(lib, f"{self._PREFIX}_create")(
            rank, len(peers), ",".join(peers).encode(), timeout_ms)
        if not self._handle:
            raise RuntimeError(
                f"{self._KIND} setup failed (rank={rank}, "
                f"peers={list(peers)})")

    def _require_handle(self):
        # ctypes would pass NULL straight into native code → segfault.
        if not self._handle:
            raise RuntimeError(f"{type(self).__name__} is closed")
        return self._handle

    @property
    def rank(self) -> int:
        return getattr(self._lib, f"{self._PREFIX}_rank")(
            self._require_handle())

    @property
    def world(self) -> int:
        return getattr(self._lib, f"{self._PREFIX}_world")(
            self._require_handle())

    def _reduce_f32(self, fn, x: np.ndarray) -> np.ndarray:
        """Marshal ``x`` to an owned contiguous f32 buffer, reduce in
        place, reshape back."""
        self._require_handle()
        out = np.array(x, dtype=np.float32, order="C")  # always a copy
        rc = fn(self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                out.size)
        if rc == -2:
            raise ValueError(
                f"this algorithm requires a power-of-2 world, got "
                f"{self.world}; use HostRing")
        if rc != 0:
            raise RuntimeError(f"{self._KIND} allreduce failed "
                               "(peer died?)")
        return out.reshape(np.shape(x))

    def close(self) -> None:
        if self._handle:
            getattr(self._lib, f"{self._PREFIX}_destroy")(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class HostRing(_NativeGroup):
    """Blocking ring collectives among ``world`` processes over TCP
    (bandwidth-optimal: 2·(W-1)/W · N bytes on the wire per rank)."""

    _PREFIX = "ttd_ring"
    _KIND = "ring"

    def allreduce(self, x: np.ndarray) -> np.ndarray:
        """Sum-allreduce; returns a new float32 array of ``x``'s shape."""
        return self._reduce_f32(self._lib.ttd_ring_allreduce_f32, x)

    def allreduce_q8(self, x: np.ndarray) -> np.ndarray:
        """Quantized sum-allreduce (EQuARX-style): int8 blocks + f32
        scales on the wire — ~4x less traffic than f32, for the
        bandwidth-scarce host/DCN path.  Approximate (per-hop
        requantization in the reduce-scatter phase; error ~(W-1)·
        max|partial|/254 per element) but BIT-CONSISTENT across ranks
        (the all-gather forwards each owner's bytes verbatim).  The
        quantization recipe is the module-level shared one
        (``Q8_BLOCK``/``quantize_q8_np`` above == the device-side
        ``parallel.collectives.quantize_q8``), cross-checked in
        tests/test_torch_native.py."""
        return self._reduce_f32(self._lib.ttd_ring_allreduce_q8_f32, x)

    def broadcast(self, x: np.ndarray, root: int = 0) -> np.ndarray:
        """Broadcast ``x`` (same shape/dtype everywhere) from ``root``."""
        self._require_handle()
        out = np.ascontiguousarray(x).copy()
        rc = self._lib.ttd_ring_broadcast(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.nbytes, root)
        if rc != 0:
            raise RuntimeError("ring broadcast failed (peer died?)")
        return out


class HostMesh(_NativeGroup):
    """Fully-connected host group: butterfly (recursive halving-doubling)
    and shuffle allreduce.  HD is latency-optimal (2·log2 W exchanges) for
    small messages; the ring stays bandwidth-optimal for large ones.
    Power-of-2 world sizes only — callers fall back to ``HostRing``
    otherwise.
    """

    _PREFIX = "ttd_mesh"
    _KIND = "mesh"

    def allreduce(self, x: np.ndarray, *,
                  algorithm: str = "hd") -> np.ndarray:
        """Sum-allreduce; ``algorithm`` is ``"hd"`` or ``"shuffle"``."""
        fns = {"hd": self._lib.ttd_mesh_allreduce_hd_f32,
               "shuffle": self._lib.ttd_mesh_allreduce_shuffle_f32}
        if algorithm not in fns:
            raise ValueError(f"algorithm must be hd|shuffle, "
                             f"got {algorithm!r}")
        return self._reduce_f32(fns[algorithm], x)
