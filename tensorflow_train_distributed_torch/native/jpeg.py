"""Python face of the native JPEG decoder (``src/jpegdec.cpp``; the
port's copy of the JAX package's ``native/jpeg.py``).

The reference decodes JPEG inside tf.data's C++ kernels (SURVEY §2.1);
the rebuild's default is PIL, which holds the GIL for part of each
decode.  This module exposes the libjpeg-backed native path:

- ``decode_rgb``   — one image → uint8 [H, W, 3]; bit-identical to PIL
                     for baseline JPEGs (both are libjpeg underneath).
- ``decode_batch`` — N images decoded by a C++ thread pool while Python
                     holds NO GIL (ctypes releases it for the call): host
                     decode throughput scales with cores in ONE process,
                     where the PIL path needs a process per core.
- ``scale_denom``  — 1/2/4/8 DCT-domain downscale: libjpeg reconstructs
                     at reduced resolution for a fraction of the IDCT
                     work.  Opt-in (changes pixels vs full-size decode).

Every entry point builds the library and raises
``native.NativeUnavailable`` where it cannot (no toolchain, no libjpeg);
``available()`` asks without raising.  Exotic color spaces (CMYK/YCCK)
fail per-image with rc=-1 — use ``data.image.decode_image`` for those
records.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from tensorflow_train_distributed_torch import native


def available() -> bool:
    return native.jpeg_status()[0]


def output_dims(data: bytes, scale_denom: int = 1) -> tuple[int, int]:
    """(height, width) of the decode at ``scale_denom`` — header-only."""
    lib = native.load_jpeg_library()
    buf = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.ttd_jpeg_dims(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        scale_denom, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"not a decodable JPEG (rc={rc})")
    return h.value, w.value


def decode_rgb(data: bytes, scale_denom: int = 1) -> np.ndarray:
    """JPEG bytes → uint8 [H, W, 3] RGB via libjpeg."""
    lib = native.load_jpeg_library()
    hh, ww = output_dims(data, scale_denom)
    out = np.empty((hh, ww, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.ttd_jpeg_decode_rgb(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        scale_denom, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.nbytes, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def decode_batch(datas: Sequence[bytes], scale_denom: int = 1,
                 num_threads: int = 4,
                 ) -> list[Optional[np.ndarray]]:
    """Decode N JPEGs on a C++ thread pool (GIL released for the call).

    Returns one uint8 [H, W, 3] array per input, ``None`` where a record
    failed to decode (corrupt bytes, CMYK, ...) — the caller decides
    whether to PIL-fallback or drop.
    """
    lib = native.load_jpeg_library()
    n = len(datas)
    if n == 0:
        return []
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bufs, outs = [], []
    ptrs, lens, optrs, caps = ((u8p * n)(), (ctypes.c_uint64 * n)(),
                               (u8p * n)(), (ctypes.c_uint64 * n)())
    for i, data in enumerate(datas):
        buf = np.frombuffer(data, np.uint8)
        bufs.append(buf)  # keep alive
        ptrs[i] = buf.ctypes.data_as(u8p)
        lens[i] = len(data)
        try:
            hh, ww = output_dims(data, scale_denom)
            out = np.empty((hh, ww, 3), np.uint8)
        except ValueError:
            out = np.empty((1, 1, 3), np.uint8)  # rc will mark failure
        outs.append(out)
        optrs[i] = out.ctypes.data_as(u8p)
        caps[i] = out.nbytes
    ws = (ctypes.c_int * n)()
    hs = (ctypes.c_int * n)()
    rcs = (ctypes.c_int * n)()
    lib.ttd_jpeg_decode_batch(n, ptrs, lens, scale_denom, optrs, caps,
                              ws, hs, rcs, num_threads)
    return [outs[i] if rcs[i] == 0 else None for i in range(n)]
