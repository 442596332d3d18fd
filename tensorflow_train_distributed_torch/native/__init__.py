"""Native (C++) host runtime, bound with ctypes: the port's copy of the
JAX package's ``native/`` (which it does not import: importing any part
of that package loads jax).

- ``staging``  — threaded, GIL-free batch assembly with a buffer arena
                 (the tf.data-kernel analog), ``src/staging.cpp``.
- ``ringcoll`` — TCP ring allreduce and broadcast, and the
                 halving-doubling and shuffle allreduces, for host data
                 (the ``RingAlg``/``RingReducer`` analog),
                 ``src/ringcoll.cpp``.
- ``jpeg``     — libjpeg decode on a GIL-free thread pool with DCT-domain
                 downscaling (the tf.image JPEG-kernel analog),
                 ``src/jpegdec.cpp``, a library of its own (it links
                 libjpeg, the other links nothing).

Each library is built with ``g++`` at first use into ``_build/`` beside
this file (git-ignored), named by a hash of its sources, through a
temporary file renamed into place, so concurrent processes never load a
half-written library.  There is no quiet fallback: where the caller asked
for the native path, a missing toolchain or library raises
``NativeUnavailable`` with the compiler's message.  ``jpeg_status`` serves
the one optional caller, ``data/image.decode_image``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

logger = logging.getLogger(__name__)

SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")

# (library, sources, extra compile and link flags; a callable makes them
# at build time)
_CORE = ("ttd_native", ("staging.cpp", "ringcoll.cpp"), ())


def _jpeg_flags() -> tuple:
    """The decoder compiles against the libjpeg-turbo 2.1.5 headers in
    ``src/libjpeg/`` (the jpeg62 interface; their licence beside them)
    and links the libjpeg that PIL loads, the one in the Pillow wheel's
    ``pillow.libs/`` (a host need not have libjpeg's headers or library
    installed, and the pixels are PIL's by construction); a PIL built
    against the system's libjpeg means ``-ljpeg``."""
    import glob

    inc = "-I" + os.path.join(SRC_DIR, "libjpeg")
    try:
        import PIL
    except ImportError:
        return (inc, "-ljpeg")
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libjpeg*.so*")))
    if not found:
        return (inc, "-ljpeg")
    return (inc, found[-1], f"-Wl,-rpath,{libs}")


_JPEG = ("ttd_jpeg", ("jpegdec.cpp",), _jpeg_flags)

_lock = threading.Lock()
# name -> the loaded library, or the NativeUnavailable it failed with.
_loaded: dict = {}


class NativeUnavailable(RuntimeError):
    """A native library could not be built or loaded (the compiler's or
    the loader's message)."""


def _lib_path(name: str, sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    headers = (tuple(os.path.join("libjpeg", f) for f in sorted(
        os.listdir(os.path.join(SRC_DIR, "libjpeg"))))
        if name == _JPEG[0] else ())
    for src in (*sources, *headers):
        with open(os.path.join(SRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _compile(sources, out_path: str, flags) -> None:
    """g++ -> a temporary file -> rename: a process never loads a
    half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out_path}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", "-std=c++17", "-O3", "-fPIC", "-shared", "-pthread",
           *[os.path.join(SRC_DIR, s) for s in sources], "-o", tmp, *flags]
    logger.info("building native library: %s", " ".join(cmd))
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeUnavailable(f"no C++ compiler: {e}") from e
        except subprocess.CalledProcessError as e:
            raise NativeUnavailable(
                f"g++ failed ({' '.join(cmd)}):\n"
                f"{(e.stderr or '').strip()[-2000:]}") from e
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(spec, bind) -> ctypes.CDLL:
    name, sources, flags = spec
    got = _loaded.get(name)
    if callable(flags) and not isinstance(got, ctypes.CDLL):
        flags = flags()
    if isinstance(got, ctypes.CDLL):
        return got
    with _lock:
        got = _loaded.get(name)
        if got is None:
            try:
                path = _lib_path(name, sources, flags)
                if not os.path.exists(path):
                    _compile(sources, path, flags)
                try:
                    lib = ctypes.CDLL(path)
                except OSError as e:
                    raise NativeUnavailable(
                        f"cannot load {path}: {e}") from e
                bind(lib)
                got = lib
            except NativeUnavailable as e:
                got = e
            _loaded[name] = got
    if isinstance(got, NativeUnavailable):
        raise got
    return got


def build() -> str:
    """Build (if needed) and load the staging and ring library; returns
    its path.  Raises ``NativeUnavailable``."""
    load_library()
    return _lib_path(*_CORE)


def load_library() -> ctypes.CDLL:
    """The staging and ring library; raises ``NativeUnavailable``."""
    return _load(_CORE, _bind_signatures)


def load_jpeg_library() -> ctypes.CDLL:
    """The libjpeg decoder; raises ``NativeUnavailable``."""
    return _load(_JPEG, _bind_jpeg_signatures)


def jpeg_status() -> tuple[bool, Optional[str]]:
    """(whether the JPEG decoder loads, why not)."""
    try:
        load_jpeg_library()
    except NativeUnavailable as e:
        return False, str(e)
    return True, None


def _bind_jpeg_signatures(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u8pp = ctypes.POINTER(u8p)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int)

    lib.ttd_jpeg_dims.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_int, i32p, i32p]
    lib.ttd_jpeg_dims.restype = ctypes.c_int
    lib.ttd_jpeg_decode_rgb.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_int, u8p, ctypes.c_uint64,
        i32p, i32p]
    lib.ttd_jpeg_decode_rgb.restype = ctypes.c_int
    lib.ttd_jpeg_decode_batch.argtypes = [
        ctypes.c_int, u8pp, u64p, ctypes.c_int, u8pp, u64p,
        i32p, i32p, i32p, ctypes.c_int]
    lib.ttd_jpeg_decode_batch.restype = ctypes.c_int


def _bind_signatures(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.ttd_stager_create.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int]
    lib.ttd_stager_create.restype = ctypes.c_void_p
    lib.ttd_stager_submit.argtypes = [ctypes.c_void_p, u64p]
    lib.ttd_stager_submit.restype = ctypes.c_int
    lib.ttd_stager_acquire.argtypes = [ctypes.c_void_p]
    lib.ttd_stager_acquire.restype = u8p
    lib.ttd_stager_release.argtypes = [ctypes.c_void_p, u8p]
    lib.ttd_stager_release.restype = None
    lib.ttd_stager_batch_bytes.argtypes = [ctypes.c_void_p]
    lib.ttd_stager_batch_bytes.restype = ctypes.c_uint64
    lib.ttd_stager_destroy.argtypes = [ctypes.c_void_p]
    lib.ttd_stager_destroy.restype = None

    for prefix in ("ttd_ring", "ttd_mesh"):
        create = getattr(lib, f"{prefix}_create")
        create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                           ctypes.c_int]
        create.restype = ctypes.c_void_p
        for fn in ("rank", "world"):
            f = getattr(lib, f"{prefix}_{fn}")
            f.argtypes = [ctypes.c_void_p]
            f.restype = ctypes.c_int
        destroy = getattr(lib, f"{prefix}_destroy")
        destroy.argtypes = [ctypes.c_void_p]
        destroy.restype = None
    for fn in ("ttd_ring_allreduce_f32", "ttd_ring_allreduce_q8_f32",
               "ttd_mesh_allreduce_hd_f32",
               "ttd_mesh_allreduce_shuffle_f32"):
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p, f32p, ctypes.c_uint64]
        f.restype = ctypes.c_int
    lib.ttd_ring_broadcast.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_uint64, ctypes.c_int]
    lib.ttd_ring_broadcast.restype = ctypes.c_int
