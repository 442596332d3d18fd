"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``ctypes``.

Every source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` with a plain C interface (no PyTorch headers,
so a build takes seconds, not minutes); the objects are linked into one
shared library that ``ctypes`` loads.  The library is built at first use
into ``csrc/build/`` (listed in ``.gitignore``) under a name keyed by a
hash of the sources and flags, so an edited source is never served a
stale binary and a fresh checkout builds everything from the repo alone.

Nothing here runs at import: the CPU tests import every module of the
package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("rms_norm.cu", "paged_attention.cu", "paged_kv_gather.cu",
           "cross_entropy.cu", "flash_attention_fwd.cu",
           "flash_attention_bwd.cu", "grouped_matmul.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # seconds, path, ptxas report of the last build

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ttd_rms_norm_fwd": [_VP, _VP, _VP, _VP, _I, _I, _F, _I, _I, _I, _VP],
    "ttd_rms_norm_body": [_I, _I, _I, _I, _I],
    "ttd_rms_norm_bwd": [_VP] * 7 + [_I] * 5 + [_VP],
    "ttd_rms_norm_bwd_partials": [_I, _I, _I, _I],
    "ttd_cross_entropy_fwd": [_VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "ttd_cross_entropy_bwd": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "ttd_flash_attention_fwd": [_VP] * 7 + [_I] * 5 + [_F] + [_I] * 3
                               + [_VP],
    "ttd_flash_attention_bwd": [_VP] * 12 + [_I] * 5 + [_F] + [_I] * 3
                               + [_VP],
    "ttd_splash_attention_fwd": [_VP] * 7 + [_I] * 8 + [_VP],
    "ttd_splash_attention_bwd": [_VP] * 12 + [_I] * 8 + [_VP],
    "ttd_flash_attention_body": [_I, _I],
    "ttd_paged_kv_gather": [_VP, _VP, _VP, _I, _I, _I, _I,
                            ctypes.c_longlong, _I, _I, _VP],
    "ttd_paged_kv_gather_body": [ctypes.c_longlong, _I],
    "ttd_paged_attention": [_VP] * 10 + [_I] * 9 + [_F, _I, _I, _I, _VP],
    "ttd_paged_attention_smem": [_I, _I, _I],
    "ttd_paged_attention_body": [_I, _I, _I, _I],
    "ttd_paged_attention_chunk_rows": [],
    "ttd_gmm": [_VP] * 4 + [_I] * 8 + [_VP],
    "ttd_tgmm": [_VP] * 4 + [_I] * 7 + [_VP],
    "ttd_gmm_as": [_VP] * 4 + [_I] * 11 + [_VP],
    "ttd_tgmm_as": [_VP] * 4 + [_I] * 9 + [_VP],
    "ttd_gmm_body": [_I] * 6,
    "ttd_tgmm_body": [_I] * 6,
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources (in parallel) and link the shared library;
    returns its path.  A library already built from the same sources and
    flags is reused."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libttd_kernels-{_digest()}.so")
    if os.path.exists(lib_path):
        build_info.update(seconds=0.0, path=lib_path, cached=True)
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o",
                 obj], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            report.append(f"== {src}\n{out}")
            if proc.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(report))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_lib, *[o for _, o, _ in procs]],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builds agree
    build_info.update(seconds=time.perf_counter() - t0, path=lib_path,
                      cached=False, ptxas="\n".join(report))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = (ctypes.c_longlong
                              if name == "ttd_paged_attention_smem"
                              else ctypes.c_int)
            _lib = lib
        return _lib
