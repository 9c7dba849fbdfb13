// DCT/DST post-twiddle y = a Re(x) + b Im(x), for sm_90a.
//
// Replaces the TPU kernel twiddle_pack of src/repro/kernels/twiddle_pack.py
// (_kernel): x complex (rows, k), read in place with a row pitch, a and b
// real (k,) tables broadcast along rows, y real (rows, k) contiguous.  It
// runs where the fused FFT epilogue cannot: after the library rfft of a
// DCT-II / DST-II extension whose length is not a power of two.
//
// What bounds it on this card: memory.  Three flops per value against 12
// bytes (float32: 8 read, 4 written) or 24 (float64); the least time is
// (x read + tables read + y written) / HBM bandwidth.
//
// What the design does about it: one pass, each value read once and
// written once.  x is torch's interleaved complex tensor, read as one 8- or
// 16-byte vector per value, so the real and imaginary planes are never
// split.  The kernel takes a row pitch, so the window f[..., start:start+k]
// of a contiguous rfft half spectrum (k of its k+1 or k+2 bins) is read
// where it lies and no copy of the field is made first.  A block is 8 warps
// on 8 rows; each warp walks its row's k columns 32 at a time, so
// neighbouring threads read neighbouring values (coalesced) and the tables,
// a few KB, stay in L1/L2.  Blocks walk the rows grid-stride.  Simple
// first: no vector width beyond one complex value per thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kMaxBlocks = 132 * 16;

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
twiddle_pack_kernel(const typename Cplx<T>::type* __restrict__ x,
                    long long pitch, const T* __restrict__ a,
                    const T* __restrict__ b, T* __restrict__ y,
                    long long rows, int k) {
  for (long long r = (long long)blockIdx.x * kRowsPerBlock + threadIdx.y;
       r < rows; r += (long long)gridDim.x * kRowsPerBlock) {
    const typename Cplx<T>::type* xr = x + r * pitch;
    T* yr = y + r * k;
    for (int c = threadIdx.x; c < k; c += kWarp) {
      const typename Cplx<T>::type v = xr[c];
      yr[c] = a[c] * v.x + b[c] * v.y;
    }
  }
}

template <typename T>
int launch(const void* x, long long pitch, const void* a, const void* b,
           void* y, long long rows, int k, void* stream) {
  if (rows < 1 || k < 1 || pitch < k) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  twiddle_pack_kernel<T><<<(unsigned)blocks, dim3(kWarp, kRowsPerBlock), 0,
                           (cudaStream_t)stream>>>(
      static_cast<const typename Cplx<T>::type*>(x), pitch,
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(y),
      rows, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: complex (rows, k) with row pitch `pitch` complex values; y: real
// (rows, k) contiguous
int repro_twiddle_pack_f32(const void* x, long long pitch, const void* a,
                           const void* b, void* y, long long rows, int k,
                           void* stream) {
  return launch<float>(x, pitch, a, b, y, rows, k, stream);
}

int repro_twiddle_pack_f64(const void* x, long long pitch, const void* a,
                           const void* b, void* y, long long rows, int k,
                           void* stream) {
  return launch<double>(x, pitch, a, b, y, rows, k, stream);
}

}  // extern "C"
