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
//
// Rows longer than kMaxN (= N2 = 4096) points do not fit in shared memory
// and take two passes (the four-step FFT), N = N1 N2 with N1 = N / 4096,
// input n = N2 n1 + n2, output f = k1 + N1 k2:
//   X[k1 + N1 k2] = sum_n2 W_N2^(n2 k2) W_N^(n2 k1) sum_n1 x[N2 n1 + n2] W_N1^(n1 k1)
// Pass 1 (column_kernel) runs the N1-point FFTs down the stride-N2 columns
// of a row, a tile of adjacent columns per block so that each warp reads
// whole 128-byte lines, multiplies by the inter-pass twiddle W_N^(n2 k1)
// (n2 k1 < N: no overflow) and stores Z[r, k1, n2] to a scratch buffer.
// The pruned input (n < N/2, so n1 < N1/2) is the pruned first stage of
// the column FFTs.  Pass 2 is stockham_kernel over the rows * N1
// contiguous rows Z[r, k1, :], with the twiddle table read at stride N1;
// its epilogue maps kernel row (r, k1) and bin k2 to f = k1 + N1 k2 and
// keeps the same bin windows, so all three epilogues stay fused.  Its
// stores are strided (N1 apart).  One table of length N serves both
// passes (pass 1 reads it at stride N2); only pass 2 scales the inverse,
// by 1/N.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 4096;
constexpr int kMinPointsPerBlock = 2048;
// dynamic shared memory of the largest block: two 4096-point complex128
// buffers (or two 8192-point complex64 column tiles)
constexpr int kMaxSmem = 2 * kMaxN * 16;

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
__device__ __forceinline__ typename Cplx<T>::type load(const T* x,
                                                       int x_complex,
                                                       size_t i) {
  return x_complex ? reinterpret_cast<const typename Cplx<T>::type*>(x)[i]
                   : mk<T>(x[i], T(0));
}

// sample j of a row, the pruned first stage folded in when pruned: x1 ==
// 0, so the DIF butterfly of index j gives e = x0 and d = x0 * W^j, stored
// at 2j, 2j+1 (W^j of the row's own length: table index j * tw_stride)
template <typename T>
__device__ __forceinline__ void put_first(
    typename Cplx<T>::type* row, int j, typename Cplx<T>::type v,
    bool pruned, const typename Cplx<T>::type* __restrict__ tw,
    int tw_stride, bool inv) {
  if (pruned) {
    row[2 * j] = v;
    row[2 * j + 1] = mul<T>(v, twiddle<T>(tw, j * tw_stride, inv));
  } else {
    row[j] = v;
  }
}

// The Stockham DIF stages of nrows rows of length n held in shared memory
// (ping-pong src/dst, swapped after each stage), from sub-transform length
// m and span l (m = n, l = 1 unpruned; n/2, 2 after the pruned first
// stage).  The twiddle W_n^t is table entry t * tw_stride.  Returns with
// the natural-order spectrum in src.
template <typename T>
__device__ __forceinline__ void stages(
    typename Cplx<T>::type*& src, typename Cplx<T>::type*& dst, int nrows,
    int n, int m, int l, int max_radix,
    const typename Cplx<T>::type* __restrict__ tw, int tw_stride, bool inv) {
  using C = typename Cplx<T>::type;
  while (m > 1) {
    const int stride = n / m * tw_stride;  // twiddle index step of the stage
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
}

// One kept bin v of caller row r, place b in the window [start, start+k):
// the real post-twiddle (ta, tb given: a real output), or 1/N for the
// inverse and the Green multiply (a complex output), stored at out[at]
template <typename T>
__device__ __forceinline__ void emit(
    typename Cplx<T>::type* __restrict__ out, size_t at,
    typename Cplx<T>::type v, int r, int b, const T* __restrict__ g,
    int grows, int k, const T* __restrict__ ta, const T* __restrict__ tb,
    bool inv, T n_total) {
  if (ta != nullptr) {
    reinterpret_cast<T*>(out)[at] = ta[b] * v.x + tb[b] * v.y;
    return;
  }
  if (inv) {
    v.x = v.x / n_total;
    v.y = v.y / n_total;
  }
  if (g != nullptr) {
    const T gv = g[(size_t)(r % grows) * k + b];
    v.x = v.x * gv;
    v.y = v.y * gv;
  }
  out[at] = v;
}

// kRowPass false: the whole FFT of rows of length n, in one pass.
// kRowPass true: pass 2 of the two-pass FFT (n = N2, kernel row R =
// (r, k1) with n1 = N1, rows = the caller's rows times N1, table of length
// n * n1 read at stride n1).  A template parameter, so the one-pass kernel
// carries none of the row pass's index arithmetic.
template <typename T, bool kRowPass>
__global__ void __launch_bounds__(kThreads)
stockham_kernel(const T* __restrict__ x, int x_complex,
                typename Cplx<T>::type* __restrict__ out,
                const T* __restrict__ g,
                const T* __restrict__ ta, const T* __restrict__ tb,
                const typename Cplx<T>::type* __restrict__ tw,
                int rows, int n_in, int n, int n1_arg, int inverse,
                int max_radix, int start, int k, int grows,
                int rows_per_block) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* src = reinterpret_cast<C*>(smem_raw);
  C* dst = src + (size_t)rows_per_block * n;
  const int row0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, rows - row0);
  const bool inv = inverse != 0;
  const int n1 = kRowPass ? n1_arg : 1;

  const bool pruned = n_in < n;
  const int total_in = nrows * n_in;
  const int lg_in = __ffs(n_in) - 1;  // every extent here is a power of 2
  for (int i = threadIdx.x; i < total_in; i += blockDim.x) {
    const int r = i >> lg_in;
    const int j = i & (n_in - 1);
    put_first<T>(src + r * n, j,
                 load<T>(x, x_complex, (size_t)(row0 + r) * n_in + j),
                 pruned, tw, n1, inv);
  }
  __syncthreads();
  stages<T>(src, dst, nrows, n, pruned ? n / 2 : n, pruned ? 2 : 1,
            max_radix, tw, n1, inv);

  // epilogue: the bins [start, start+k) of each row
  if constexpr (!kRowPass) {
    const int total_out = nrows * k;
    for (int i = threadIdx.x; i < total_out; i += blockDim.x) {
      const int r = i / k;
      const int b = i - r * k;
      emit<T>(out, (size_t)(row0 + r) * k + b, src[r * n + start + b],
              row0 + r, b, g, grows, k, ta, tb, inv, T(n));
    }
  } else {
    // kernel row (r, k1) holds the bins f = k1 + n1 k2: at most
    // ceil(k / n1) of them in the window, from k2 = lo on
    const int lg_n1 = __ffs(n1) - 1;
    const int span = (k + n1 - 1) >> lg_n1;
    const int total_out = nrows * span;
    for (int i = threadIdx.x; i < total_out; i += blockDim.x) {
      const int rr = i / span;
      const int row = row0 + rr;
      const int r = row >> lg_n1;
      const int k1 = row & (n1 - 1);
      const int lo = start > k1 ? (start - k1 + n1 - 1) >> lg_n1 : 0;
      const int k2 = lo + (i - rr * span);
      const int f = k1 + (k2 << lg_n1);
      if (k2 >= n || f >= start + k) continue;
      const int b = f - start;
      emit<T>(out, (size_t)r * k + b, src[rr * n + k2], r, b, g, grows, k,
              ta, tb, inv, T(n) * T(n1));
    }
  }
}

// Pass 1 of the two-pass FFT: block (r, tile) runs the n1-point FFTs of
// the columns [c0, c0 + cols) of row r (column c is x[r, n2 n1' + c0 + c]
// over n1' < n_in / n2), multiplies bin k1 of column n2 by W_N^(n2 k1) and
// writes z[(r n1 + k1) n2 + n2'].  Shared memory holds the tile as cols
// rows of n1 points; neighbouring threads load and store neighbouring
// columns, so device memory is read and written in whole lines.
template <typename T>
__global__ void __launch_bounds__(kThreads)
column_kernel(const T* __restrict__ x, int x_complex,
              typename Cplx<T>::type* __restrict__ z,
              const typename Cplx<T>::type* __restrict__ tw, int n_in,
              int n1, int n2, int cols, int inverse, int max_radix) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* src = reinterpret_cast<C*>(smem_raw);
  C* dst = src + (size_t)cols * n1;
  const int tiles = n2 / cols;
  const int r = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - r * tiles) * cols;
  const bool inv = inverse != 0;
  const int lg_cols = __ffs(cols) - 1;

  const int n1_in = n_in / n2;  // n1, or n1 / 2 pruned
  const bool pruned = n1_in < n1;
  const int total_in = cols * n1_in;
  for (int i = threadIdx.x; i < total_in; i += blockDim.x) {
    const int c = i & (cols - 1);
    const int j = i >> lg_cols;
    const size_t gi = (size_t)r * n_in + (size_t)j * n2 + c0 + c;
    put_first<T>(src + c * n1, j, load<T>(x, x_complex, gi), pruned, tw, n2,
                 inv);
  }
  __syncthreads();
  stages<T>(src, dst, cols, n1, pruned ? n1 / 2 : n1, pruned ? 2 : 1,
            max_radix, tw, n2, inv);

  const int total = cols * n1;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i & (cols - 1);
    const int k1 = i >> lg_cols;
    const C v = src[c * n1 + k1];
    z[((size_t)r * n1 + k1) * n2 + c0 + c] =
        mul<T>(v, twiddle<T>(tw, (c0 + c) * k1, inv));
  }
}

template <typename KernelPtr>
cudaError_t allow_smem(KernelPtr kernel, size_t smem) {
  // the opt-in above 48 KB is a per-device attribute: set it (always to the
  // largest size, so concurrent launches never lower it for each other) on
  // every launch that needs it, whichever device is current
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <typename T>
int launch(const void* x, int x_complex, void* out, const void* g,
           const void* ta, const void* tb, const void* tw, void* scratch,
           int rows, int n_in, int n, int inverse, int max_radix, int start,
           int k, int grows, void* stream) {
  using C = typename Cplx<T>::type;
  if (n < 2 || (n & (n - 1)) != 0 || n > kMaxN * kMaxN ||
      !(n_in == n || 2 * n_in == n) || rows < 1 || k < 1 ||
      start < 0 || start + k > n || grows < 1 || rows % grows != 0 ||
      (ta == nullptr) != (tb == nullptr) ||
      (ta != nullptr && (g != nullptr || inverse)) ||
      (n > kMaxN && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const C* twc = static_cast<const C*>(tw);
  int n1 = 1;
  if (n > kMaxN) {
    // pass 1 into the scratch; pass 2 reads it as rows * n1 full rows
    n1 = n / kMaxN;
    const int n2 = kMaxN;
    int cols = kMinPointsPerBlock / n1 > 16 ? kMinPointsPerBlock / n1 : 16;
    if (cols > n2) cols = n2;
    while (cols > 1 && 2 * (size_t)cols * n1 * sizeof(C) > kMaxSmem) {
      cols /= 2;
    }
    const size_t smem = 2 * (size_t)cols * n1 * sizeof(C);
    cudaError_t e = allow_smem(column_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
    column_kernel<T><<<(unsigned)rows * (n2 / cols), kThreads, smem, s>>>(
        static_cast<const T*>(x), x_complex, static_cast<C*>(scratch), twc,
        n_in, n1, n2, cols, inverse, max_radix);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    x = scratch;
    x_complex = 1;
    rows *= n1;
    n = n_in = n2;
  }
  const int rows_per_block = n >= kMinPointsPerBlock ? 1
                                                      : kMinPointsPerBlock / n;
  const size_t smem = 2 * (size_t)rows_per_block * n * sizeof(C);
  const auto kernel =
      n1 > 1 ? stockham_kernel<T, true> : stockham_kernel<T, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), x_complex, static_cast<C*>(out),
      static_cast<const T*>(g), static_cast<const T*>(ta),
      static_cast<const T*>(tb), twc, rows, n_in, n, n1, inverse, max_radix,
      start, k, grows, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out is complex (rows, k), or real (rows, k) when ta and tb are given;
// tw is the length-n table; scratch (rows * n complex) is needed, and
// used, only when n > 4096
int repro_fft_stockham_f32(const void* x, int x_complex, void* out,
                           const void* g, const void* ta, const void* tb,
                           const void* tw, void* scratch, int rows, int n_in,
                           int n, int inverse, int max_radix, int start,
                           int k, int grows, void* stream) {
  return launch<float>(x, x_complex, out, g, ta, tb, tw, scratch, rows, n_in,
                       n, inverse, max_radix, start, k, grows, stream);
}

int repro_fft_stockham_f64(const void* x, int x_complex, void* out,
                           const void* g, const void* ta, const void* tb,
                           const void* tw, void* scratch, int rows, int n_in,
                           int n, int inverse, int max_radix, int start,
                           int k, int grows, void* stream) {
  return launch<double>(x, x_complex, out, g, ta, tb, tw, scratch, rows,
                        n_in, n, inverse, max_radix, start, k, grows, stream);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
