// Batched radix-4/2 Stockham complex FFT along the last axis, for sm_90a.
//
// Replaces the TPU kernels fft_stockham, fft_stockham_scale and
// fft_stockham_twiddle of src/repro/kernels/fft_stockham.py (bodies
// _fft_body, _kernel, _kernel_scale and _kernel_twiddle): one kernel
// computes all three; the epilogue is chosen by which optional operand is
// given (a Green plane g, or the twiddle tables a and b).
//
// What bounds it on this card: memory.  A length-N FFT does about
// 5 N log2 N flops against 16 N bytes (complex64 read and written): under
// 4 flops per byte at N = 4096, far below the ~20 flops per byte at which
// an H100's fp32 units (67 TFLOP/s over 3.35 TB/s) would become the limit.
// So the least time is (bytes read + bytes written) / HBM bandwidth.
//
// What the design does about it: each row is read from device memory once
// and its spectrum written once; all log2 N stages run in shared memory.
// A block holds rows_per_block rows (at least 2048 complex points in all)
// as two ping-pong complex buffers, and its threads sweep the butterflies
// of one stage, then synchronise.  The pruned Hockney first stage
// (n_in = N/2, zero tail) is applied while the live samples are loaded, so
// the zero tail is never read or stored.  A real input (x_complex = 0)
// is read as is, with no zeros plane.  The epilogue writes only the bins
// [start, start+k) the caller keeps (the half spectrum of an rfft, the head
// of a pruned inverse), scaled by 1/N for the inverse and multiplied by the
// Green plane row r % grows when g is given.  With the tables a and b (k
// values each) it writes instead the real a[j] Re + b[j] Im of the j-th
// kept bin: the DCT/DST post-twiddle, so a real-to-real transform's complex
// spectrum never reaches device memory and the kernel writes 4 or 8 bytes
// per kept bin instead of 8 or 16 (M or M+1 bins of the length-2M
// extension's spectrum).  Twiddles come from a precomputed table
// W[t] = exp(-2 pi i t / N) (float64 host values, cast once), conjugated
// for the inverse.  Simple first: no register blocking, no vectorized
// global access; those are for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 4096;
constexpr int kMinPointsPerBlock = 2048;

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

template <typename T>
__device__ __forceinline__ typename Cplx<T>::type mk(T re, T im) {
  typename Cplx<T>::type r;
  r.x = re;
  r.y = im;
  return r;
}

template <typename T>
__device__ __forceinline__ typename Cplx<T>::type add(
    typename Cplx<T>::type a, typename Cplx<T>::type b) {
  return mk<T>(a.x + b.x, a.y + b.y);
}

template <typename T>
__device__ __forceinline__ typename Cplx<T>::type sub(
    typename Cplx<T>::type a, typename Cplx<T>::type b) {
  return mk<T>(a.x - b.x, a.y - b.y);
}

// a * w, the reference's formula (re = ar wr - ai wi, im = ar wi + ai wr)
template <typename T>
__device__ __forceinline__ typename Cplx<T>::type mul(
    typename Cplx<T>::type a, typename Cplx<T>::type w) {
  return mk<T>(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// twiddle W^t of the forward table, conjugated for the inverse
template <typename T>
__device__ __forceinline__ typename Cplx<T>::type twiddle(
    const typename Cplx<T>::type* __restrict__ tw, int t, bool inverse) {
  typename Cplx<T>::type w = tw[t];
  if (inverse) w.y = -w.y;
  return w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stockham_kernel(const T* __restrict__ x, int x_complex,
                typename Cplx<T>::type* __restrict__ out,
                const T* __restrict__ g,
                const T* __restrict__ ta, const T* __restrict__ tb,
                const typename Cplx<T>::type* __restrict__ tw,
                int rows, int n_in, int n, int inverse, int max_radix,
                int start, int k, int grows, int rows_per_block) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* src = reinterpret_cast<C*>(smem_raw);
  C* dst = src + (size_t)rows_per_block * n;
  const int row0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, rows - row0);
  const bool inv = inverse != 0;

  // load, with the pruned first stage folded in: x1 == 0, so the DIF
  // butterfly of index j gives e = x0 and d = x0 * W^j, stored at 2j, 2j+1
  const bool pruned = n_in < n;
  const int total_in = nrows * n_in;
  const int lg_in = __ffs(n_in) - 1;  // every extent here is a power of 2
  for (int i = threadIdx.x; i < total_in; i += blockDim.x) {
    const int r = i >> lg_in;
    const int j = i & (n_in - 1);
    const size_t gi = (size_t)(row0 + r) * n_in + j;
    const C v = x_complex ? reinterpret_cast<const C*>(x)[gi]
                          : mk<T>(x[gi], T(0));
    if (pruned) {
      src[r * n + 2 * j] = v;
      src[r * n + 2 * j + 1] = mul<T>(v, twiddle<T>(tw, j, inv));
    } else {
      src[r * n + j] = v;
    }
  }
  int m = pruned ? n / 2 : n;
  int l = pruned ? 2 : 1;
  __syncthreads();

  while (m > 1) {
    const int stride = n / m;  // twiddle index step of this stage
    const int lg_l = __ffs(l) - 1;
    if (max_radix >= 4 && (m & 3) == 0) {
      // radix-4 DIF stage: quarters (A, B, C, D) of each length-m
      // sub-transform; outputs packed [y0 y1 y2 y3] along the l axis
      const int q = m >> 2;
      const int per_row = q * l;
      const int lg_row = __ffs(per_row) - 1;
      const int total = nrows * per_row;
      for (int b = threadIdx.x; b < total; b += blockDim.x) {
        const int r = b >> lg_row;
        const int rem = b & (per_row - 1);
        const int j = rem >> lg_l;
        const int kk = rem & (l - 1);
        const C* s = src + r * n + kk;
        const C A = s[j * l], B = s[(j + q) * l];
        const C Cq = s[(j + 2 * q) * l], D = s[(j + 3 * q) * l];
        const C t0 = add<T>(A, Cq), t1 = sub<T>(A, Cq);
        const C t2 = add<T>(B, D), t3 = sub<T>(B, D);
        // -i t3 forward, +i t3 inverse
        const C u3 = inv ? mk<T>(-t3.y, t3.x) : mk<T>(t3.y, -t3.x);
        C* d = dst + r * n + j * 4 * l + kk;
        d[0] = add<T>(t0, t2);
        d[l] = mul<T>(add<T>(t1, u3), twiddle<T>(tw, j * stride, inv));
        d[2 * l] = mul<T>(sub<T>(t0, t2), twiddle<T>(tw, 2 * j * stride, inv));
        d[3 * l] = mul<T>(sub<T>(t1, u3), twiddle<T>(tw, 3 * j * stride, inv));
      }
      m = q;
      l *= 4;
    } else {
      // radix-2 step: the odd log2 factor, or every stage at max_radix 2
      const int half = m >> 1;
      const int per_row = half * l;
      const int lg_row = __ffs(per_row) - 1;
      const int total = nrows * per_row;
      for (int b = threadIdx.x; b < total; b += blockDim.x) {
        const int r = b >> lg_row;
        const int rem = b & (per_row - 1);
        const int j = rem >> lg_l;
        const int kk = rem & (l - 1);
        const C* s = src + r * n + kk;
        const C x0 = s[j * l], x1 = s[(j + half) * l];
        C* d = dst + r * n + j * 2 * l + kk;
        d[0] = add<T>(x0, x1);
        d[l] = mul<T>(sub<T>(x0, x1), twiddle<T>(tw, j * stride, inv));
      }
      m = half;
      l *= 2;
    }
    __syncthreads();
    C* t = src;
    src = dst;
    dst = t;
  }

  // epilogue: bins [start, start+k), then the real post-twiddle
  // (ta, tb given: a real (rows, k) output), or 1/N for the inverse and
  // the Green multiply (a complex (rows, k) output)
  const int total_out = nrows * k;
  for (int i = threadIdx.x; i < total_out; i += blockDim.x) {
    const int r = i / k;
    const int b = i - r * k;
    C v = src[r * n + start + b];
    if (ta != nullptr) {
      reinterpret_cast<T*>(out)[(size_t)(row0 + r) * k + b] =
          ta[b] * v.x + tb[b] * v.y;
      continue;
    }
    if (inv) {
      v.x = v.x / T(n);
      v.y = v.y / T(n);
    }
    if (g != nullptr) {
      const T gv = g[(size_t)((row0 + r) % grows) * k + b];
      v.x = v.x * gv;
      v.y = v.y * gv;
    }
    out[(size_t)(row0 + r) * k + b] = v;
  }
}

template <typename T>
int launch(const void* x, int x_complex, void* out, const void* g,
           const void* ta, const void* tb, const void* tw, int rows,
           int n_in, int n, int inverse, int max_radix, int start, int k,
           int grows, void* stream) {
  using C = typename Cplx<T>::type;
  if (n < 2 || n > kMaxN || (n & (n - 1)) != 0 ||
      !(n_in == n || 2 * n_in == n) || rows < 1 || k < 1 ||
      start < 0 || start + k > n || grows < 1 || rows % grows != 0 ||
      (ta == nullptr) != (tb == nullptr) ||
      (ta != nullptr && (g != nullptr || inverse))) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows_per_block = n >= kMinPointsPerBlock ? 1
                                                      : kMinPointsPerBlock / n;
  const size_t smem = 2 * (size_t)rows_per_block * n * sizeof(C);
  // the opt-in above 48 KB is a per-device attribute: set it (always to the
  // largest size, so concurrent launches never lower it for each other) on
  // every launch that needs it, whichever device is current
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stockham_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(2 * kMaxN * sizeof(C)));
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  stockham_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), x_complex, static_cast<C*>(out),
      static_cast<const T*>(g), static_cast<const T*>(ta),
      static_cast<const T*>(tb), static_cast<const C*>(tw), rows, n_in, n,
      inverse, max_radix, start, k, grows, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out is complex (rows, k), or real (rows, k) when ta and tb are given
int repro_fft_stockham_f32(const void* x, int x_complex, void* out,
                           const void* g, const void* ta, const void* tb,
                           const void* tw, int rows, int n_in, int n,
                           int inverse, int max_radix, int start, int k,
                           int grows, void* stream) {
  return launch<float>(x, x_complex, out, g, ta, tb, tw, rows, n_in, n,
                       inverse, max_radix, start, k, grows, stream);
}

int repro_fft_stockham_f64(const void* x, int x_complex, void* out,
                           const void* g, const void* ta, const void* tb,
                           const void* tw, int rows, int n_in, int n,
                           int inverse, int max_radix, int start, int k,
                           int grows, void* stream) {
  return launch<double>(x, x_complex, out, g, ta, tb, tw, rows, n_in, n,
                        inverse, max_radix, start, k, grows, stream);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
