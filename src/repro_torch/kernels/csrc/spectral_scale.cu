// Fused Green-function multiply + normalization, for sm_90a.
//
// Replaces the TPU kernel spectral_scale of
// src/repro/kernels/spectral_scale.py (_kernel and _kernel_batched):
// out = x * (g * scale), x real or interleaved complex of shape
// (B, rows, lanes), one real Green plane (rows, lanes) shared across B.
//
// What bounds it on this card: memory.  Two flops per value against 8-16
// bytes moved per value; the least time is (x read + g read + out
// written) / HBM bandwidth.
//
// What the design does about it: one pass, each value read once and
// written once, the complex pair loaded and stored as one 8- or 16-byte
// vector, neighbouring threads on neighbouring values.  The grid's y axis
// walks the batch, so the Green plane is indexed without B and never
// broadcast into memory (batches after the first find it in L2 where the
// plane fits).  Any (rows, lanes) works, the ragged (7, 130) and
// (129, 384) included: the kernel sees one flat plane and masks its tail.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 132 * 16;

template <typename T, int Comps> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<double, 2> { using type = double2; };

template <typename T>
__device__ __forceinline__ T scaled(T v, T gs) { return v * gs; }
__device__ __forceinline__ float2 scaled(float2 v, float gs) {
  return make_float2(v.x * gs, v.y * gs);
}
__device__ __forceinline__ double2 scaled(double2 v, double gs) {
  return make_double2(v.x * gs, v.y * gs);
}

template <typename T, int Comps>
__global__ void __launch_bounds__(kThreads)
spectral_scale_kernel(const typename Vec<T, Comps>::type* __restrict__ x,
                      const T* __restrict__ g,
                      typename Vec<T, Comps>::type* __restrict__ out,
                      long long plane, T scale) {
  const long long base = (long long)blockIdx.y * plane;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < plane; p += (long long)gridDim.x * blockDim.x) {
    const T gs = g[p] * scale;
    out[base + p] = scaled(x[base + p], gs);
  }
}

template <typename T, int Comps>
int launch(const void* x, const void* g, void* out, long long batch,
           long long plane, double scale, void* stream) {
  using V = typename Vec<T, Comps>::type;
  if (batch < 1 || batch > 65535 || plane < 1) {
    return (int)cudaErrorInvalidValue;
  }
  long long bx = (plane + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  dim3 grid((unsigned)bx, (unsigned)batch);
  spectral_scale_kernel<T, Comps><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const V*>(x), static_cast<const T*>(g), static_cast<V*>(out),
      plane, (T)scale);
  return (int)cudaGetLastError();
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
