#!/usr/bin/env python3
"""Grid and cache-hint variants of the spectral_scale kernel against
``torch.mul``, on one NVIDIA GPU.

    python3 tools/probe_spectral_scale_grid.py

Builds a probe copy of the kernel's B = 1 loop (real float32 and
complex128, 16-byte accesses, 4 units in flight per thread) in two grid
shapes -- a persistent one-wave grid (resident blocks per SM times the SM
count, each block striding over the plane) and one tile per block -- each
with and without the evict-first hints (``__ldcs`` / ``__stcs``), and
times them beside the port's ``spectral_scale`` and ``torch.mul`` at the
SYM384 real-field shape (384^3 float32) and the NODE (U,U,U) n=64 shape
(128 x 128 x 65 complex128).  Each time is the device time of 50
back-to-back calls between one event pair, over 4 rotating input and
output sets (so no call finds its operands in L2), three rounds each.
Exits 2 without a CUDA device.
"""
from __future__ import annotations

import collections
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float4 ap(float4 x, float4 g) {
  return make_float4(x.x * g.x, x.y * g.y, x.z * g.z, x.w * g.w);
}
__device__ __forceinline__ double2 ap(double2 x, double g) {
  return make_double2(x.x * g, x.y * g);
}
__device__ __forceinline__ float4 gs(float4 g, float s) {
  return make_float4(g.x * s, g.y * s, g.z * s, g.w * s);
}
__device__ __forceinline__ double gs(double g, double s) { return g * s; }
template <typename X> __device__ __forceinline__ X ld(const X* p, bool h) {
  return h ? __ldcs(p) : *p;
}
template <typename X> __device__ __forceinline__ void st(X* p, X v, bool h) {
  if (h) __stcs(p, v); else *p = v;
}

template <typename X, typename G, typename T>
__global__ void __launch_bounds__(kThreads)
probe(const X* __restrict__ x, const G* __restrict__ g, X* __restrict__ o,
      long long units, T s, bool hint) {
  const long long step = (long long)gridDim.x * kUnroll * blockDim.x;
  for (long long q0 = (long long)blockIdx.x * kUnroll * blockDim.x +
                      threadIdx.x; q0 < units; q0 += step) {
    G gv[kUnroll];
    X xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + (long long)u * blockDim.x;
      if (q < units) gv[u] = gs(g[q], s);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + (long long)u * blockDim.x;
      if (q < units) xv[u] = ld(x + q, hint);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + (long long)u * blockDim.x;
      if (q < units) st(o + q, ap(xv[u], gv[u]), hint);
    }
  }
}

// wave = 1: the persistent one-wave grid; 0: one tile per block
template <typename X, typename G, typename T>
int go(const void* x, const void* g, void* o, long long units, double s,
       int wave, int hint, void* stream) {
  auto kern = probe<X, G, T>;
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (units + kUnroll * kThreads - 1) / (kUnroll * kThreads);
  if (wave && blocks > (long long)per_sm * sms) blocks = per_sm * sms;
  kern<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const X*)x, (const G*)g, (X*)o, units, (T)s, hint != 0);
  return (int)cudaGetLastError();
}

extern "C" {
int probe_f32(const void* x, const void* g, void* o, long long units,
              double s, int wave, int hint, void* stream) {
  return go<float4, float4, float>(x, g, o, units, s, wave, hint, stream);
}
int probe_c128(const void* x, const void* g, void* o, long long units,
               double s, int wave, int hint, void* stream) {
  return go<double2, double, double>(x, g, o, units, s, wave, hint, stream);
}
}
"""

REPS = 50
SETS = 4


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("probe_spectral_scale_grid.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels._build import _nvcc
    from repro_torch.kernels.spectral_scale import spectral_scale

    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "spectral_scale_grid.cu", \
        out_dir / "libspectral_scale_grid.so"
    src.write_text(SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, LL, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_double)
    for fn in (lib.probe_f32, lib.probe_c128):
        fn.argtypes = [P, P, P, LL, D, I, I, P]
        fn.restype = ctypes.c_int

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")

    def loop_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        # the device sleeps while the host queues the calls, so the event
        # pair sees them back to back
        torch.cuda._sleep(10_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(REPS):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / REPS

    shapes = (("SYM384 real float32", (384 * 384, 384), torch.float32,
               torch.float32, lib.probe_f32, 4),
              ("NODE n=64 complex128", (128 * 128, 65), torch.complex128,
               torch.float64, lib.probe_c128, 1))
    for label, shape, dt, rdt, fn, per_unit in shapes:
        xs = [torch.randn(shape, dtype=dt, device=dev) for _ in range(SETS)]
        gs = [torch.randn(shape, dtype=rdt, device=dev) for _ in range(SETS)]
        os_ = [torch.empty_like(xs[0]) for _ in range(SETS)]
        scalars = xs[0].numel() * (2 if dt.is_complex else 1)
        units = scalars * xs[0].real.element_size() // 16
        stream = torch.cuda.current_stream().cuda_stream
        byts = 2 * xs[0].numel() * xs[0].element_size() + \
            gs[0].numel() * gs[0].element_size()
        turn = [0]
        kept = collections.deque(maxlen=SETS)   # outputs stay distinct

        def nxt():
            turn[0] = (turn[0] + 1) % SETS
            return turn[0]

        def variant(wave, hint):
            def call():
                i = nxt()
                err = fn(xs[i].data_ptr(), gs[i].data_ptr(),
                         os_[i].data_ptr(), units, 0.5, wave, hint, stream)
                if err:
                    raise RuntimeError(f"probe launch: CUDA error {err}")
            return call

        def port():
            i = nxt()
            kept.append(spectral_scale(xs[i], gs[i], 0.5))

        def mul():
            i = nxt()
            torch.mul(xs[i], gs[i], out=os_[i])

        variants = {"torch.mul": mul, "port spectral_scale": port,
                    "one wave, hints": variant(1, 1),
                    "one wave, no hints": variant(1, 0),
                    "one tile per block, hints": variant(0, 1),
                    "one tile per block, no hints": variant(0, 0)}
        want = xs[0] * (gs[0] * 0.5)
        for name, call in variants.items():
            if name.startswith("one"):
                turn[0] = SETS - 1
                call()
                torch.cuda.synchronize()
                if not torch.allclose(os_[0], want, rtol=1e-6, atol=0):
                    raise AssertionError(f"{label} {name}: wrong result")
        times = {k: [] for k in variants}
        for _ in range(3):
            for name, call in variants.items():
                times[name].append(loop_ms(call))
        print(f"{label}: {byts / 1e6:.1f} MB per call, bound "
              f"{byts / 3.35e12 * 1e3:.5f} ms at 3.35 TB/s")
        for name, ts in times.items():
            print(f"  {name:30s} " + " ".join(f"{t:.5f}" for t in ts)
                  + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
