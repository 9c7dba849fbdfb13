// Fused Green-function multiply + normalization, for sm_90a.
//
// Replaces the TPU kernel spectral_scale of
// src/repro/kernels/spectral_scale.py (_kernel and _kernel_batched):
// out = x * (g * scale), x real or interleaved complex of shape
// (B, rows, lanes), one real Green plane (rows, lanes) shared across B.
//
// What bounds it on this card: memory.  Two flops per value against 8-16
// bytes moved per value; the least time is (x read + g read once + out
// written) / HBM bandwidth.
//
// What the design does about it:
// - wide accesses: x and out move as 16-byte vectors (four float, two
//   complex64, two double or one complex128) wherever x and out start on
//   16 bytes and g on its vector's size, every batch entry too, with the
//   few scalars after the last whole vector done one by one; otherwise one
//   value (one complex) per access.  (out is a fresh allocation, so it
//   always starts aligned, and an x that does not cannot be brought into
//   line with it by a scalar head);
// - in flight: each thread loads its g values and 4 independent x vectors
//   before any multiply or store, the 4 strided by the block so that every
//   warp-wide load and store covers whole lines;
// - streaming: x is read with __ldcs and out written with __stcs
//   (evict-first: neither is read again by this kernel), g through the
//   normal cached path;
// - the plane once: the batch loop runs inside the thread, so a g value is
//   loaded once into a register and applied to all B entries and the plane
//   crosses device memory once per call, not B times;
// - one tile per block: a block takes kUnroll * kThreads units of the
//   plane and the grid covers the plane, so the block scheduler balances
//   the tail.  A persistent one-wave grid (resident blocks per SM times the
//   SM count, each block striding over the plane) measured 5% slower on a
//   226 MB plane, where 20% of its blocks take one tile more than the rest
//   (tools/probe_spectral_scale_grid.py).
// Any (rows, lanes) works, the ragged (7, 130) and (129, 384) included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// Unit<T, Comps, Wide>: the x access type X and the g access type G of one
// step of a thread; Wide moves 16 bytes of x, else one value of x
template <typename T, int Comps, bool Wide> struct Unit;
template <> struct Unit<float, 1, true> { using X = float4; using G = float4; };
template <> struct Unit<float, 2, true> { using X = float4; using G = float2; };
template <> struct Unit<double, 1, true> { using X = double2; using G = double2; };
template <> struct Unit<double, 2, true> { using X = double2; using G = double; };
template <> struct Unit<float, 1, false> { using X = float; using G = float; };
template <> struct Unit<float, 2, false> { using X = float2; using G = float; };
template <> struct Unit<double, 1, false> { using X = double; using G = double; };
template <> struct Unit<double, 2, false> { using X = double2; using G = double; };

// g * scale (the reference's order: the plane is scaled, then multiplied)
__device__ __forceinline__ float gscale(float g, float s) { return g * s; }
__device__ __forceinline__ double gscale(double g, double s) { return g * s; }
__device__ __forceinline__ float2 gscale(float2 g, float s) {
  return make_float2(g.x * s, g.y * s);
}
__device__ __forceinline__ float4 gscale(float4 g, float s) {
  return make_float4(g.x * s, g.y * s, g.z * s, g.w * s);
}
__device__ __forceinline__ double2 gscale(double2 g, double s) {
  return make_double2(g.x * s, g.y * s);
}

// x * g, each component of x times the g value of its lane
__device__ __forceinline__ float apply(float x, float g) { return x * g; }
__device__ __forceinline__ double apply(double x, double g) { return x * g; }
__device__ __forceinline__ float2 apply(float2 x, float g) {
  return make_float2(x.x * g, x.y * g);
}
__device__ __forceinline__ double2 apply(double2 x, double g) {
  return make_double2(x.x * g, x.y * g);
}
__device__ __forceinline__ double2 apply(double2 x, double2 g) {
  return make_double2(x.x * g.x, x.y * g.y);
}
__device__ __forceinline__ float4 apply(float4 x, float2 g) {
  return make_float4(x.x * g.x, x.y * g.x, x.z * g.y, x.w * g.y);
}
__device__ __forceinline__ float4 apply(float4 x, float4 g) {
  return make_float4(x.x * g.x, x.y * g.y, x.z * g.z, x.w * g.w);
}

// plane: scalars of x per batch entry; units: whole X accesses per entry;
// block i takes units [i, i + 1) * kUnroll * blockDim; the scalars after
// the units (at most 3, Wide only) are done one by one by the last block
template <typename T, int Comps, bool Wide>
__global__ void __launch_bounds__(kThreads)
spectral_scale_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      T* __restrict__ out, long long batch, long long plane,
                      long long units, T scale) {
  using X = typename Unit<T, Comps, Wide>::X;
  using G = typename Unit<T, Comps, Wide>::G;
  constexpr int kXs = sizeof(X) / sizeof(T);  // scalars of x per unit
  const X* xu = reinterpret_cast<const X*>(x);
  const G* gu = reinterpret_cast<const G*>(g);
  X* ou = reinterpret_cast<X*>(out);
  const long long pitch = plane / kXs;  // units between batch entries
  const long long q0 = (long long)blockIdx.x * kUnroll * blockDim.x +
                       threadIdx.x;
  G gv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long q = q0 + (long long)u * blockDim.x;
    if (q < units) gv[u] = gscale(gu[q], scale);
  }
  for (long long b = 0; b < batch; ++b) {
    X xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + (long long)u * blockDim.x;
      if (q < units) xv[u] = __ldcs(xu + b * pitch + q);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + (long long)u * blockDim.x;
      if (q < units) __stcs(ou + b * pitch + q, apply(xv[u], gv[u]));
    }
  }
  const long long tail0 = units * kXs;
  const long long tail = plane - tail0;
  if (Wide && tail > 0 && blockIdx.x == gridDim.x - 1) {
    for (long long i = threadIdx.x; i < batch * tail; i += blockDim.x) {
      const long long b = i / tail;
      const long long s = tail0 + (i - b * tail);
      const size_t at = (size_t)b * plane + s;
      out[at] = x[at] * (g[s / Comps] * scale);
    }
  }
}

template <typename T, int Comps, bool Wide>
int run(const T* x, const T* g, T* out, long long batch, long long plane,
        long long units, double scale, cudaStream_t stream) {
  const long long per_block = (long long)kUnroll * kThreads;
  long long blocks = (units + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;  // the tail alone
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  spectral_scale_kernel<T, Comps, Wide>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(x, g, out, batch, plane,
                                                  units, (T)scale);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// gvals: values of the Green plane; x holds batch * gvals * Comps scalars
template <typename T, int Comps>
int launch(const void* xp, const void* gp, void* op, long long batch,
           long long gvals, double scale, void* stream) {
  if (batch < 1 || gvals < 1) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xp);
  const T* g = static_cast<const T*>(gp);
  T* out = static_cast<T*>(op);
  cudaStream_t s = (cudaStream_t)stream;
  const long long plane = gvals * Comps;
  constexpr int kXs = 16 / sizeof(T);
  using GW = typename Unit<T, Comps, true>::G;
  // the wide path: every batch entry of x and out on 16 bytes, g on its
  // vector's size
  if (aligned(x, 16) && aligned(out, 16) && aligned(g, sizeof(GW)) &&
      (batch == 1 || (plane * sizeof(T)) % 16 == 0)) {
    return run<T, Comps, true>(x, g, out, batch, plane, plane / kXs, scale,
                               s);
  }
  return run<T, Comps, false>(x, g, out, batch, plane, gvals, scale, s);
}

}  // namespace

extern "C" {

int repro_spectral_scale_f32(const void* x, int x_complex, const void* g,
                             void* out, long long batch, long long plane,
                             double scale, void* stream) {
  return x_complex ? launch<float, 2>(x, g, out, batch, plane, scale, stream)
                   : launch<float, 1>(x, g, out, batch, plane, scale, stream);
}

int repro_spectral_scale_f64(const void* x, int x_complex, const void* g,
                             void* out, long long batch, long long plane,
                             double scale, void* stream) {
  return x_complex ? launch<double, 2>(x, g, out, batch, plane, scale, stream)
                   : launch<double, 1>(x, g, out, batch, plane, scale, stream);
}

}  // extern "C"
