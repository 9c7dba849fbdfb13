"""Build and bind the CUDA kernels: one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` from the sources in
``csrc/`` at first use and loaded with ``ctypes``.

The library lands in ``build/kernels/`` at the root of the checkout, under
a name that hashes the sources and the flags, so an edited source is never
served a stale build.  Each source compiles in its own ``nvcc`` process,
all started together.  Nothing here runs at import time, and nothing falls
back: a missing ``nvcc`` or a failed build raises.

``LAUNCHES`` counts kernel launches per wrapper; each wrapper adds one
where it launches its kernel and nowhere else (CPU calls run the plain
version and count nothing).  Of those, ``CLUSTER`` counts the Stockham
calls whose rows ran on a thread-block cluster (8192 to 65536 points) and
``TWO_PASS`` those whose rows were longer still and took two passes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["LAUNCHES", "CLUSTER", "TWO_PASS", "reset_launches", "build",
           "library", "check", "BUILD_LOG"]

LAUNCHES = {"fft_stockham": 0, "fft_stockham_scale": 0, "spectral_scale": 0,
            "twiddle_pack": 0, "fft_stockham_twiddle": 0}
CLUSTER = {"fft_stockham": 0, "fft_stockham_scale": 0,
           "fft_stockham_twiddle": 0}
TWO_PASS = {"fft_stockham": 0, "fft_stockham_scale": 0,
            "fft_stockham_twiddle": 0}

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fft_stockham.cu", "spectral_scale.cu", "twiddle_pack.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -split-compile=0: nvcc optimizes a source's kernels in parallel, one
# worker per CPU (the Stockham source holds one kernel per row length)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")

# the compiler's output of the last build (ptxas register / spill report)
BUILD_LOG: list = []

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    # x, x_complex, out, g, a, b, twiddles, scratch, rows, n_in, n,
    # inverse, max_radix, start, k, grows, stream
    "repro_fft_stockham_f32": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P],
    "repro_fft_stockham_f64": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P],
    # x, x_complex, g, out, batch, plane, scale, stream
    "repro_spectral_scale_f32": [_P, _I, _P, _P, _LL, _LL, _D, _P],
    "repro_spectral_scale_f64": [_P, _I, _P, _P, _LL, _LL, _D, _P],
    # x, pitch, a, b, y, rows, k, stream
    "repro_twiddle_pack_f32": [_P, _LL, _P, _P, _P, _LL, _I, _P],
    "repro_twiddle_pack_f64": [_P, _LL, _P, _P, _P, _LL, _I, _P],
}

_lib = None
_lock = threading.Lock()


def reset_launches():
    """Set every launch count (and cluster and two-pass count) to 0."""
    for counts in (LAUNCHES, CLUSTER, TWO_PASS):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are compiled "
            "from src/repro_torch/kernels/csrc at first use on a GPU")
    return path


def build() -> Path:
    """Compile the kernels into the shared library (once per source
    digest) and return its path."""
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    lib = BUILD_DIR / f"librepro_kernels_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    pid = os.getpid()
    procs = []
    for s in srcs:
        obj = BUILD_DIR / f"{s.stem}_{tag}_{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
        procs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    BUILD_LOG.clear()
    failed = []
    for s, _, p in procs:
        out, _ = p.communicate()
        BUILD_LOG.append(f"== {s.name}\n{out}")
        if p.returncode != 0:
            failed.append(f"nvcc failed on {s.name} "
                          f"(exit {p.returncode}):\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = BUILD_DIR / f"librepro_kernels_{tag}_{pid}.tmp.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)
    for _, o, _ in procs:
        o.unlink()
    return lib


def library():
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, what: str):
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
