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
// So the least time is (bytes read + bytes written) / HBM bandwidth, and
// the kernel has to keep enough bytes in flight to reach it.
//
// The stages are those of the plain version (kernels/ref.py): radix-4 DIF
// Stockham stages with one radix-2 step for the odd log2 factor (every
// stage radix-2 at max_radix 2), the twiddle W_n^t read from a table of
// W[t] = exp(-2 pi i t / N) (float64 host values, cast once; conjugated
// for the inverse).  What the design does with them:
//
// - Registers, not shared memory, hold the data.  A thread holds P = 16
//   points of a row (P = n below 16 points) and runs a pass: two
//   consecutive radix-4 stages in registers (radix 16), or the last one or
//   two stages (radix 8 = radix 4 then the radix-2 step, 4, 2).  A radix-R
//   pass from sub-transform length m and span l takes group g = j l + kk
//   (j < m / R, kk < l) from the points g + i n / R, i < R, and leaves its
//   outputs at j R l + kk + o l, o < R: the same values, with the same
//   twiddles W_m^(a j') and W_(m/4)^(b j), as the two stages it groups.  A
//   thread runs P / R groups, g = t + c n / P.  So a 4096-point row takes
//   3 passes, a 512-point row 2 and the radix-2 step, and the data crosses
//   shared memory only between passes (2 round trips at 4096 points, not
//   6 stages of ping-pong buffers).  One buffer of n + n / 16 points per
//   row suffices: 34.8 KB for a 4096-point complex64 row.  The row length
//   is a template parameter (one kernel per power of two up to 4096), so
//   every register and shared-memory offset is a constant; each kernel
//   holds the code of the pass radices its length can take.
// - Registers per thread: at most 128 in float32 (__launch_bounds__ asks
//   for 2 blocks of 256 threads per SM; the kernels need 118-128 with no
//   spill), about 200 in float64 (one block per SM): ptxas's report is in
//   chip_smoke.py's build lines.
// - Bytes in flight.  A complex unpruned row is read straight from device
//   memory: all 16 of a thread's loads (8 or 16 bytes each, neighbouring
//   threads on neighbouring points, so each warp load is whole 32-byte
//   sectors) are issued before the first butterfly, 32 KB of complex64 per
//   block.  A real row (4- or 8-byte loads) or a pruned one (two threads
//   load each point) would keep half that in flight, so its row-blocks
//   arrive by bulk copy (the TMA: one thread asks for a row-block's whole
//   input span, rows_per_block * n_in contiguous elements) into a ring of
//   kSlots input slots in shared memory, each completing on an mbarrier.
//   Those blocks are persistent (as many as fit on the card; block b takes
//   row-blocks b, b + gridDim.x, ...), and a slot is refilled with the
//   row-block kSlots ahead as soon as the first pass has read it, so the
//   copies run under the butterflies of the row-blocks before them.  An
//   input the bulk copy cannot take (a base address off 16-byte alignment,
//   as a contiguous view one element into a buffer; a real row of 1 or 2
//   points, not a multiple of 16 bytes) is read straight from device
//   memory, with loads one element wide.
// - The last pass writes the kept bins straight from registers: its group
//   g holds bins g + o n / R, so neighbouring threads store neighbouring
//   bins (whole sectors of each warp store).
// - No bank conflicts: shared memory point q lives at q + q / 16.  A
//   radix-16 pass stores at j 16 l + kk + o l; for span l = 1 the 16
//   threads of a half-warp (j = 16 h .. 16 h + 15) hit points 17 j + o:
//   16 distinct 8-byte bank pairs (complex64; for complex128 the 8 threads
//   of a quarter-warp hit 8 distinct 16-byte slots); for l = 2 (after the
//   pruned stage) 34 j + kk + 2 o + const covers 2 j + kk: distinct; for
//   l >= 16 neighbouring threads differ in kk, so neighbouring points.
//   Loads read g + i n / R: neighbouring threads, neighbouring points.
// - Twiddles: a radix-16 pass loads the 15 table entries of its group (12
//   for the four first-stage butterflies, 3 for the second stage) once per
//   thread, not 3 per butterfly per stage.
// - The epilogue multiplies by 1 / N (exact: N is a power of two) instead
//   of dividing per element, and finds a bin's place without a division.
//
// The pruned Hockney first stage (n_in = N/2, zero tail) is folded into
// the first pass's loads: x1 == 0, so the DIF butterfly of index j gives
// e = x0 and d = x0 W^j at points 2j, 2j+1 and the passes start from
// m = N/2, l = 2; the zero tail is never read.  A real input (x_complex =
// 0) is read as is, with no zeros plane.  The epilogue writes only the
// bins [start, start+k) the caller keeps (the half spectrum of an rfft,
// the head of a pruned inverse), scaled by 1/N for the inverse and
// multiplied by the Green plane row r % grows when g is given.  With the
// tables a and b (k values each) it writes instead the real a[j] Re +
// b[j] Im of the j-th kept bin: the DCT/DST post-twiddle, so a
// real-to-real transform's complex spectrum never reaches device memory.
//
// Rows longer than kMaxN (= N2 = 4096) points do not fit one block's
// shared memory and take the four-step FFT, N = N1 N2 with N1 = N / 4096,
// input n = N2 n1 + n2, output f = k1 + N1 k2:
//   X[k1 + N1 k2] = sum_n2 W_N2^(n2 k2) W_N^(n2 k1) sum_n1 x[N2 n1 + n2] W_N1^(n1 k1)
// the N1-point FFTs down the stride-N2 columns, the inter-pass twiddle
// W_N^(n2 k1) (n2 k1 < N: no overflow), then the register core above on
// the rows Z[k1, :] with the table read at stride N1; its epilogue maps
// kernel row (r, k1) and bin k2 to f = k1 + N1 k2 and keeps the same bin
// windows, so all three epilogues stay fused.  The pruned input (n < N/2,
// so n1 < N1/2) is the pruned first stage of the column FFTs.  One table
// of length N serves both steps (the columns read it at stride N2); only
// the row step scales the inverse, by 1/N.  Its stores are strided (N1
// apart); the N1 kernel rows of a caller row fill each sector together.
// So the rows take three tiers by length, each bounded by memory:
// - N <= 4096: one pass, the core alone (one block a row or less).
// - 4096 < N <= 32768 (N1 = 2, 4, 8): one pass on a thread-block cluster
//   of N1 blocks a row (cluster_kernel).  Block c loads its slice of every
//   column (N1 contiguous segments of 4096 / N1 >= 512 points), runs
//   those columns' FFTs in registers (16 / N1 columns a thread), and
//   stores Z[k1, n2] straight into block k1's shared memory (distributed
//   shared memory); after the cluster barrier each block runs the core on
//   its own Z row.  Z never reaches device memory: the call reads its
//   input once and writes its kept bins once, the bound's bytes.  At most
//   8 blocks a cluster (the portable limit) keeps N1 <= 8.
// - N > 32768 (up to 4096^2): two passes.  Pass 1 (column_kernel) runs the
//   column FFTs, a tile of adjacent columns per block so that each warp
//   reads whole 128-byte lines, one stage per sweep over ping-pong
//   shared-memory buffers (stages()), and stores Z[r, k1, n2] to a scratch
//   buffer; pass 2 is the core over the rows * N1 rows of Z.  Z's round
//   trip through device memory (rows * N complex values written, then
//   read) is paid on top of the bound's bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 4096;
// the longest row on one thread-block cluster: kMaxN points a block, at
// most 8 blocks (the portable cluster size)
constexpr int kClusterN = 8 * kMaxN;
// points a thread of the register core holds (fewer for rows below 16)
constexpr int kPoints = 16;
// the column pass's tiles: at least this many points per block
constexpr int kMinPointsPerBlock = 2048;
// dynamic shared memory of the largest column-pass block: two 8192-point
// complex64 column tiles
constexpr int kMaxSmem = 2 * kMaxN * 16;
// the most dynamic shared memory a block may opt in to on an H100 (the
// core's largest block takes 134 KB: the exchange buffer of a 4096-point
// complex128 row and two 32 KB input slots)
constexpr int kSmemOptIn = 232448;
// blocks of the core per SM that the float32 register budget allows
// (65536 registers / (2 * 256 threads) = 128 a thread); float64 holds 16
// complex128 points a thread and takes one block
template <typename T> struct CoreBlocks { static constexpr int value = 2; };
template <> struct CoreBlocks<double> { static constexpr int value = 1; };
// blocks of the cluster kernel per SM that its register budget asks for:
// float32 64 registers a thread with no spill, the fastest of 2, 3 and 4
// blocks at every cluster size on an H100
// (tools/probe_cluster_variants.py); float64 takes one block, as the core
template <typename T> struct ClusterBlocks { static constexpr int value = 4; };
template <> struct ClusterBlocks<double> { static constexpr int value = 1; };
// input slots of a core block's bulk-copy ring: the copy of the next
// row-block is in flight while one is transformed
constexpr int kSlots = 2;

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
  typename Cplx<T>::type w = __ldg(tw + t);
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

// radix-4 DIF butterfly on the quarters (a, b, c, d), in place:
//   y0 = (a+c) + (b+d)          y1 = ((a-c) -+ i(b-d)) w1
//   y2 = ((a+c) - (b+d)) w2     y3 = ((a-c) +- i(b-d)) w3
template <typename T>
__device__ __forceinline__ void bfly4(
    typename Cplx<T>::type& a, typename Cplx<T>::type& b,
    typename Cplx<T>::type& c, typename Cplx<T>::type& d,
    typename Cplx<T>::type w1, typename Cplx<T>::type w2,
    typename Cplx<T>::type w3, bool inv) {
  using C = typename Cplx<T>::type;
  const C t0 = add<T>(a, c), t1 = sub<T>(a, c);
  const C t2 = add<T>(b, d), t3 = sub<T>(b, d);
  // -i t3 forward, +i t3 inverse
  const C u3 = inv ? mk<T>(-t3.y, t3.x) : mk<T>(t3.y, -t3.x);
  a = add<T>(t0, t2);
  b = mul<T>(add<T>(t1, u3), w1);
  c = mul<T>(sub<T>(t0, t2), w2);
  d = mul<T>(sub<T>(t1, u3), w3);
}

// radix-2 DIF butterfly, in place: (x0 + x1, (x0 - x1) w)
template <typename T>
__device__ __forceinline__ void bfly2(typename Cplx<T>::type& a,
                                      typename Cplx<T>::type& b,
                                      typename Cplx<T>::type w) {
  const typename Cplx<T>::type d = sub<T>(a, b);
  a = add<T>(a, b);
  b = mul<T>(d, w);
}

// ---------------------------------------------------------------------
// Bulk copies (the TMA) from device to shared memory, completing on an
// mbarrier, in PTX (the 1-D cp.async.bulk: no tensor map; 16-byte aligned
// addresses, a multiple of 16 bytes).

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   shared_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: expect `bytes` on bar and copy them from src to dst (after
// the block's generic-proxy reads of dst, ordered by a __syncthreads)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// every thread: wait until the phase of bar with this parity completes
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(shared_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------
// Thread-block clusters: the block's rank in its cluster, stores to
// another block's shared memory (distributed shared memory), and the
// cluster barrier, in PTX.

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the address of p (in this block's shared memory) in block `rank`'s
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(shared_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void store_remote(uint32_t a, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
               "f"(v.x), "f"(v.y)
               : "memory");
}

__device__ __forceinline__ void store_remote(uint32_t a, double2 v) {
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};\n" ::"r"(a),
               "d"(v.x), "d"(v.y)
               : "memory");
}

// the cluster barrier, run by every thread of every block: arrive
// (release: this thread's earlier stores, to any block's shared memory,
// become visible to the threads that wait; relaxed: nothing to release),
// then wait until every thread has arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// The column pass's stages: one stage per sweep over shared memory.

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

// The same stages on one column of kN <= 8 points held in registers, from
// sub-transform length kM and span kL: radix-4 stages with one radix-2
// step (kR4), or radix-2 only.  W_kN^t is table entry t * kMaxN (the table
// of an N = kN * kMaxN point row).  x holds the column in natural order,
// and then its spectrum.
template <typename T, int kN, int kM, int kL, bool kR4>
__device__ __forceinline__ void column_stages(
    typename Cplx<T>::type (&x)[kN],
    const typename Cplx<T>::type* __restrict__ tw, bool inv) {
  using C = typename Cplx<T>::type;
  if constexpr (kM > 1) {
    constexpr int kStep = kN / kM * kMaxN;
    C y[kN];
    if constexpr (kR4 && kM % 4 == 0) {
      constexpr int kQ = kM / 4;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const C w1 = twiddle<T>(tw, j * kStep, inv);
        const C w2 = twiddle<T>(tw, 2 * j * kStep, inv);
        const C w3 = twiddle<T>(tw, 3 * j * kStep, inv);
#pragma unroll
        for (int kk = 0; kk < kL; ++kk) {
          C a = x[j * kL + kk], b = x[(j + kQ) * kL + kk];
          C c = x[(j + 2 * kQ) * kL + kk], d = x[(j + 3 * kQ) * kL + kk];
          bfly4<T>(a, b, c, d, w1, w2, w3, inv);
          y[j * 4 * kL + kk] = a;
          y[j * 4 * kL + kL + kk] = b;
          y[j * 4 * kL + 2 * kL + kk] = c;
          y[j * 4 * kL + 3 * kL + kk] = d;
        }
      }
      column_stages<T, kN, kQ, 4 * kL, kR4>(y, tw, inv);
    } else {
      constexpr int kH = kM / 2;
#pragma unroll
      for (int j = 0; j < kH; ++j) {
        const C w = twiddle<T>(tw, j * kStep, inv);
#pragma unroll
        for (int kk = 0; kk < kL; ++kk) {
          C a = x[j * kL + kk], b = x[(j + kH) * kL + kk];
          bfly2<T>(a, b, w);
          y[j * 2 * kL + kk] = a;
          y[j * 2 * kL + kL + kk] = b;
        }
      }
      column_stages<T, kN, kH, 2 * kL, kR4>(y, tw, inv);
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) x[i] = y[i];
  }
}

// the N1-point FFT of a column in registers, x[0, kN / 2) its samples when
// pruned (the zero tail not stored): the pruned first stage (put_first's
// e = x0, d = x0 W^j at 2j, 2j+1), then the stages
template <typename T, int kN>
__device__ __forceinline__ void column_fft(
    typename Cplx<T>::type (&x)[kN], bool pruned, int max_radix,
    const typename Cplx<T>::type* __restrict__ tw, bool inv) {
  using C = typename Cplx<T>::type;
  if (pruned) {
    C y[kN];
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) {
      y[2 * j] = x[j];
      y[2 * j + 1] = mul<T>(x[j], twiddle<T>(tw, j * kMaxN, inv));
    }
    if (max_radix >= 4)
      column_stages<T, kN, kN / 2, 2, true>(y, tw, inv);
    else
      column_stages<T, kN, kN / 2, 2, false>(y, tw, inv);
#pragma unroll
    for (int i = 0; i < kN; ++i) x[i] = y[i];
  } else if (max_radix >= 4) {
    column_stages<T, kN, kN, 1, true>(x, tw, inv);
  } else {
    column_stages<T, kN, kN, 1, false>(x, tw, inv);
  }
}

// ---------------------------------------------------------------------
// The register core (one-pass rows, and pass 2 of long rows).

template <int R> struct Radix { static constexpr int value = R; };

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v >> 1);
}

// a core block for rows of 2^kLgN points: kP points a thread, 2^kLgT
// threads a row, kRows rows a block, kPad shared-memory points a row
template <int kLgN>
struct Shape {
  static constexpr int kN = 1 << kLgN;
  static constexpr int kP = kN < kPoints ? kN : kPoints;
  static constexpr int kLgT = kLgN - ilog2(kP);
  static constexpr int kRows = kThreads >> kLgT;
  static constexpr int kPad = kN + (kN >> 4);
};

// whether a pass of radix R can occur in a row of 2^kLgN points: radix 2
// (max_radix 2), 16 (two radix-4 stages), and the last pass of the
// unpruned and of the pruned row (sub-transform length 2^lg_m: radix 16,
// 2, 4 or 8 as lg_m % 4 is 0, 1, 2 or 3)
template <int kLgN>
__host__ __device__ constexpr bool occurs(int R) {
  constexpr int kP = Shape<kLgN>::kP;
  constexpr int kLast[4] = {16, 2, 4, 8};
  return R <= kP && (R == 2 || (R == 16 && kLgN >= 4) ||
                     R == kLast[kLgN % 4] || R == kLast[(kLgN - 1) % 4]);
}

// f(Radix<R>{}) for the run-time radix r of a pass, compiled only for the
// radices that occur at this length
template <int kLgN, typename F>
__device__ __forceinline__ void with_radix(int r, F&& f) {
  if constexpr (occurs<kLgN>(16)) {
    if (r == 16) {
      f(Radix<16>{});
      return;
    }
  }
  if constexpr (occurs<kLgN>(8)) {
    if (r == 8) {
      f(Radix<8>{});
      return;
    }
  }
  if constexpr (occurs<kLgN>(4)) {
    if (r == 4) {
      f(Radix<4>{});
      return;
    }
  }
  f(Radix<2>{});
}

// radix of the pass that starts at sub-transform length m: two radix-4
// stages while at least two are left, then what is left (radix 4, the
// radix-4 stage and the radix-2 step as radix 8, or the radix-2 step):
// the plain version's stage order
template <int P>
__device__ __forceinline__ int pass_radix(int m, int max_radix) {
  if (max_radix < 4) return 2;
  if (P >= 16 && (m & 15) == 0) return 16;
  if (P >= 8 && m == 8) return 8;
  return (m & 3) == 0 ? 4 : 2;
}

// output o (in units of the span l) that a radix-R pass leaves in
// register r of a group: register 4a + b holds output 4b + a of a radix-16
// pass (a: first stage's output, b: second's), 2a + b output 4b + a of a
// radix-8 pass
template <int R>
__device__ __forceinline__ constexpr int out_slot(int r) {
  return R == 16 ? (r & 3) * 4 + (r >> 2)
         : R == 8 ? (r & 1) * 4 + (r >> 1)
                  : r;
}

// what every pass of a thread needs
template <typename T>
struct Core {
  const typename Cplx<T>::type* __restrict__ tw;
  int tw_stride;  // the table holds W of length n * tw_stride
  int t;          // this thread's place among its row's threads
  bool inv;
};

// shared-memory place of point q of a row: one pad point per 16
__device__ __forceinline__ int padded(int q) { return q + (q >> 4); }

// The butterflies of a radix-R pass from sub-transform length m = 2^lg_m
// and span 2^lg_l on the P / R groups in v (registers c R .. c R + R - 1
// hold group g = t + c n / P, point i at g + i n / R)
template <typename T, int kLgN, int R>
__device__ __forceinline__ void butterflies(
    typename Cplx<T>::type (&v)[Shape<kLgN>::kP], const Core<T>& c,
    int lg_m, int lg_l) {
  using C = typename Cplx<T>::type;
  using S = Shape<kLgN>;
  // table step of W_m: (n / m) * tw_stride
  const int s1 = c.tw_stride << (kLgN - lg_m);
#pragma unroll
  for (int gi = 0; gi < S::kP / R; ++gi) {
    const int b = gi * R;
    const int jp = (c.t + (gi << S::kLgT)) >> lg_l;
    if constexpr (R == 16) {
      // first stage: butterfly j = jp + g m / 16 on registers g, 4+g, 8+g,
      // 12+g; second (length m / 4): butterfly jp on registers 4a .. 4a+3
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int j = jp + (g << (lg_m - 4));
        bfly4<T>(v[b + g], v[b + 4 + g], v[b + 8 + g], v[b + 12 + g],
                 twiddle<T>(c.tw, j * s1, c.inv),
                 twiddle<T>(c.tw, 2 * j * s1, c.inv),
                 twiddle<T>(c.tw, 3 * j * s1, c.inv), c.inv);
      }
      const C w1 = twiddle<T>(c.tw, jp * (s1 << 2), c.inv);
      const C w2 = twiddle<T>(c.tw, 2 * jp * (s1 << 2), c.inv);
      const C w3 = twiddle<T>(c.tw, 3 * jp * (s1 << 2), c.inv);
#pragma unroll
      for (int a = 0; a < 4; ++a)
        bfly4<T>(v[b + 4 * a], v[b + 4 * a + 1], v[b + 4 * a + 2],
                 v[b + 4 * a + 3], w1, w2, w3, c.inv);
    } else if constexpr (R == 8) {
      // radix-4 butterflies j = jp + g m / 8 on registers g, 2+g, 4+g,
      // 6+g, then the radix-2 step (length m / 4) jp on 2a, 2a+1
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int j = jp + (g << (lg_m - 3));
        bfly4<T>(v[b + g], v[b + 2 + g], v[b + 4 + g], v[b + 6 + g],
                 twiddle<T>(c.tw, j * s1, c.inv),
                 twiddle<T>(c.tw, 2 * j * s1, c.inv),
                 twiddle<T>(c.tw, 3 * j * s1, c.inv), c.inv);
      }
      const C w = twiddle<T>(c.tw, jp * (s1 << 2), c.inv);
#pragma unroll
      for (int a = 0; a < 4; ++a) bfly2<T>(v[b + 2 * a], v[b + 2 * a + 1], w);
    } else if constexpr (R == 4) {
      bfly4<T>(v[b], v[b + 1], v[b + 2], v[b + 3],
               twiddle<T>(c.tw, jp * s1, c.inv),
               twiddle<T>(c.tw, 2 * jp * s1, c.inv),
               twiddle<T>(c.tw, 3 * jp * s1, c.inv), c.inv);
    } else {
      bfly2<T>(v[b], v[b + 1], twiddle<T>(c.tw, jp * s1, c.inv));
    }
  }
}

// the first pass's input from the row x + base (in the block's input slot
// in shared memory, or in device memory): point p of the stage input is
// x[p], or with the pruned stage folded in (fold) x[p / 2], times
// W^(p / 2) for odd p; points at or past n_in (the zero tail of a pruned
// 2-point row) are 0.  All loads are issued before the first use, at
// offsets fixed at compile time.
template <typename T, int kLgN, int R>
__device__ __forceinline__ void load_input(
    typename Cplx<T>::type (&v)[Shape<kLgN>::kP], const Core<T>& c,
    const T* x, int x_complex, size_t base, bool live, int n_in,
    bool fold) {
  using S = Shape<kLgN>;
  constexpr int kStride = S::kN / R;  // between a group's points
#pragma unroll
  for (int gi = 0; gi < S::kP / R; ++gi) {
    const int g = c.t + (gi << S::kLgT);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int src = !fold               ? g + i * kStride
                      : kStride % 2 == 0 ? (g >> 1) + i * (kStride / 2)
                                          : (g + i * kStride) >> 1;
      v[gi * R + i] = (live && src < n_in)
                          ? load<T>(x, x_complex, base + src)
                          : mk<T>(T(0), T(0));
    }
  }
  if (fold) {
#pragma unroll
    for (int gi = 0; gi < S::kP / R; ++gi) {
      const int g = c.t + (gi << S::kLgT);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int p = g + i * kStride;
        if (p & 1)
          v[gi * R + i] = mul<T>(
              v[gi * R + i], twiddle<T>(c.tw, (p >> 1) * c.tw_stride, c.inv));
      }
    }
  }
}

// a radix-R pass's outputs to the row's shared memory: group g = j l + kk
// leaves output o at j R l + kk + o l (for l >= 16, padded(q + o l) =
// padded(q) + o (l + l / 16))
template <typename T, int kLgN, int R>
__device__ __forceinline__ void to_shared(
    const typename Cplx<T>::type (&v)[Shape<kLgN>::kP],
    typename Cplx<T>::type* sm, const Core<T>& c, int lg_l) {
  using S = Shape<kLgN>;
  constexpr int kLgR = ilog2(R);
#pragma unroll
  for (int gi = 0; gi < S::kP / R; ++gi) {
    const int g = c.t + (gi << S::kLgT);
    const int q0 = ((g >> lg_l) << (lg_l + kLgR)) + (g & ((1 << lg_l) - 1));
    if (lg_l >= 4) {
      typename Cplx<T>::type* at = sm + padded(q0);
      const int step = (1 << lg_l) + (1 << (lg_l - 4));
#pragma unroll
      for (int r = 0; r < R; ++r) at[out_slot<R>(r) * step] = v[gi * R + r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        sm[padded(q0 + (out_slot<R>(r) << lg_l))] = v[gi * R + r];
    }
  }
}

// the next radix-R pass's inputs from the row's shared memory
template <typename T, int kLgN, int R>
__device__ __forceinline__ void from_shared(
    typename Cplx<T>::type (&v)[Shape<kLgN>::kP],
    const typename Cplx<T>::type* sm, const Core<T>& c) {
  using S = Shape<kLgN>;
  constexpr int kStride = S::kN / R;
#pragma unroll
  for (int gi = 0; gi < S::kP / R; ++gi) {
    const int g = c.t + (gi << S::kLgT);
    if constexpr (kStride % 16 == 0) {
      const typename Cplx<T>::type* at = sm + padded(g);
#pragma unroll
      for (int i = 0; i < R; ++i)
        v[gi * R + i] = at[i * (kStride + kStride / 16)];
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i)
        v[gi * R + i] = sm[padded(g + i * kStride)];
    }
  }
}

// where the epilogue puts the kept bins
template <typename T>
struct Epilogue {
  void* out;                    // the caller row of the output
  const T* g;                   // its Green row, or null
  const T* ta;                  // post-twiddle tables, or null
  const T* tb;
  int start, k;
  int lg_n1;  // kernel row (r, k1) holds bins k1 + n1 k2 (n1 = 1: a
  int k1;     // one-pass row)
  bool inv;
  T scale;    // 1 / N for the inverse
};

// the last pass (m = R, span n / R) holds bin k2 = g + o n / R of group g
// in register out_slot^-1(o): keep those whose bin f = k1 + n1 k2 lies in
// the window.  Neighbouring threads hold neighbouring bins.  The pointers
// are marked unaliased, so the Green values and the post-twiddle tables
// may be loaded ahead of the stores.
template <typename T, int kLgN, int R>
__device__ __forceinline__ void epilogue(
    const typename Cplx<T>::type (&v)[Shape<kLgN>::kP], const Core<T>& c,
    const Epilogue<T>& e) {
  using C = typename Cplx<T>::type;
  using S = Shape<kLgN>;
  constexpr int kStride = S::kN / R;
  const unsigned k = e.k;
  if (e.ta != nullptr) {
    const T* __restrict__ ta = e.ta;
    const T* __restrict__ tb = e.tb;
    T* __restrict__ out = static_cast<T*>(e.out);
#pragma unroll
    for (int gi = 0; gi < S::kP / R; ++gi) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k2 = c.t + (gi << S::kLgT) + out_slot<R>(r) * kStride;
        const int b = e.k1 + (k2 << e.lg_n1) - e.start;
        const C w = v[gi * R + r];
        if ((unsigned)b < k) out[b] = ta[b] * w.x + tb[b] * w.y;
      }
    }
  } else if (e.g != nullptr) {
    const T* __restrict__ g = e.g;
    C* __restrict__ out = static_cast<C*>(e.out);
#pragma unroll
    for (int gi = 0; gi < S::kP / R; ++gi) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k2 = c.t + (gi << S::kLgT) + out_slot<R>(r) * kStride;
        const int b = e.k1 + (k2 << e.lg_n1) - e.start;
        const C w = v[gi * R + r];
        if ((unsigned)b < k) out[b] = mk<T>(w.x * g[b], w.y * g[b]);
      }
    }
  } else {
    C* __restrict__ out = static_cast<C*>(e.out);
    const T s = e.inv ? e.scale : T(1);
#pragma unroll
    for (int gi = 0; gi < S::kP / R; ++gi) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k2 = c.t + (gi << S::kLgT) + out_slot<R>(r) * kStride;
        const int b = e.k1 + (k2 << e.lg_n1) - e.start;
        const C w = v[gi * R + r];
        if ((unsigned)b < k) out[b] = mk<T>(w.x * s, w.y * s);
      }
    }
  }
}

// The passes of a row from sub-transform length 2^lg_m and span 2^lg_l,
// v holding the first pass's (radix `radix`) inputs: the butterflies in
// registers, the exchanges through the row's shared memory sm between
// passes (after the caller's __syncthreads once the first pass's input
// has been read).  Returns the last pass's radix, v holding the bins.
template <typename T, int kLgN>
__device__ __forceinline__ int row_passes(
    typename Cplx<T>::type (&v)[Shape<kLgN>::kP], const Core<T>& c,
    typename Cplx<T>::type* sm, int lg_m, int lg_l, int radix,
    int max_radix) {
  for (bool exchanged = false;; exchanged = true) {
    with_radix<kLgN>(radix, [&](auto r) {
      butterflies<T, kLgN, decltype(r)::value>(v, c, lg_m, lg_l);
    });
    const int lg_r = __ffs(radix) - 1;
    if (lg_m == lg_r) return radix;  // the last pass: its outputs are bins
    if (exchanged) __syncthreads();  // the last exchange has been read
    with_radix<kLgN>(radix, [&](auto r) {
      to_shared<T, kLgN, decltype(r)::value>(v, sm, c, lg_l);
    });
    __syncthreads();
    lg_m -= lg_r;
    lg_l += lg_r;
    radix = pass_radix<Shape<kLgN>::kP>(1 << lg_m, max_radix);
    with_radix<kLgN>(radix, [&](auto r) {
      from_shared<T, kLgN, decltype(r)::value>(v, sm, c);
    });
  }
}

// The epilogue of kernel row `row`, the bins of the last pass (radix
// `radix`) in v: the bins [start, start+k) of caller row row >> lg_n1.
// A long row's kernel row (r, k1 = row % n1), n1 = 2^lg_n1, holds the
// bins f = k1 + n1 k2; a one-pass row is lg_n1 = 0.
template <typename T, int kLgN>
__device__ __forceinline__ void row_epilogue(
    const typename Cplx<T>::type (&v)[Shape<kLgN>::kP], const Core<T>& c,
    int radix, typename Cplx<T>::type* out, const T* g, const T* ta,
    const T* tb, int start, int k, int grows, int row, int lg_n1) {
  Epilogue<T> e;
  e.ta = ta;
  e.tb = tb;
  e.start = start;
  e.k = k;
  e.inv = c.inv;
  e.lg_n1 = lg_n1;
  e.k1 = row & ((1 << lg_n1) - 1);
  const int r = row >> lg_n1;
  // a real output (the post-twiddle) or a complex one
  e.out = ta != nullptr
              ? static_cast<void*>(reinterpret_cast<T*>(out) + (size_t)r * k)
              : static_cast<void*>(out + (size_t)r * k);
  e.g = g != nullptr ? g + (size_t)(r % grows) * k : nullptr;
  e.scale = T(1) / (T(Shape<kLgN>::kN) * T(1 << lg_n1));
  with_radix<kLgN>(radix, [&](auto rd) {
    epilogue<T, kLgN, decltype(rd)::value>(v, c, e);
  });
}

// kRowPass false: the whole FFT of rows of length n = 2^kLgN, in one
// pass.  kRowPass true: pass 2 of the two-pass FFT (n = N2, kernel row R =
// (r, k1) with n1 = N1, rows = the caller's rows times N1, table of length
// n * n1 read at stride n1).  Shape<kLgN>: P points a thread, n / P
// threads a row, kRows rows a row-block.  The blocks are persistent: block
// b takes row-blocks b, b + gridDim.x, ...  With bulk (the input 16-byte
// aligned and each row a multiple of 16 bytes) a row-block's input span
// (contiguous: kRows * n_in elements) arrives by one bulk copy into the
// block's input slot, and the next row-block's copy is issued as soon as
// the first pass has read the slot, so it runs under this row-block's
// later passes and stores; otherwise (an input one element off 16-byte
// alignment, or a real row of 1 or 2 points) the first pass reads device
// memory directly.
template <typename T, bool kRowPass, int kLgN>
__global__ void __launch_bounds__(kThreads, CoreBlocks<T>::value)
stockham_kernel(const T* __restrict__ x, int x_complex,
                typename Cplx<T>::type* __restrict__ out,
                const T* __restrict__ g,
                const T* __restrict__ ta, const T* __restrict__ tb,
                const typename Cplx<T>::type* __restrict__ tw,
                int rows, int n_in, int n1_arg, int inverse, int max_radix,
                int start, int k, int grows, int bulk) {
  using C = typename Cplx<T>::type;
  using S = Shape<kLgN>;
  constexpr int P = S::kP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Core<T> c;
  c.tw = tw;
  c.tw_stride = kRowPass ? n1_arg : 1;
  c.t = threadIdx.x & ((1 << S::kLgT) - 1);
  c.inv = inverse != 0;
  const int rr = threadIdx.x >> S::kLgT;
  // shared memory: the exchange buffer (kPad points a row), the ring's
  // input slots (n_in elements of x a row), their mbarriers
  C* sm = reinterpret_cast<C*>(smem_raw) + rr * S::kPad;
  constexpr size_t kXchBytes =
      ((size_t)S::kRows * S::kPad * sizeof(C) + 15) & ~(size_t)15;
  const size_t elem = x_complex ? sizeof(C) : sizeof(T);
  const size_t span = (size_t)S::kRows * n_in * elem;
  unsigned char* slots = smem_raw + kXchBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + kSlots * span);
  const int row_blocks = (rows + S::kRows - 1) / S::kRows;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  // row-block rb into slot i (one thread)
  auto fetch = [&](int rb, int i) {
    const int nrows = min(S::kRows, rows - rb * S::kRows);
    bulk_load(slots + i * span, xb + (size_t)rb * span,
              (uint32_t)((size_t)nrows * n_in * elem), bars + i);
  };
  if (bulk && threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) {
      bar_init(bars + i);
      const int rb = blockIdx.x + i * gridDim.x;
      if (rb < row_blocks) fetch(rb, i);
    }
  }
  __syncthreads();

  // the pruned first stage is folded into the loads (a pruned 2-point
  // row instead reads its zero tail as 0 and runs the radix-2 pass)
  const bool fold = n_in < S::kN && S::kN > 2;
  const int lg_m0 = fold ? kLgN - 1 : kLgN;
  const int radix0 = pass_radix<P>(1 << lg_m0, max_radix);
  for (int rb = blockIdx.x, it = 0; rb < row_blocks;
       rb += gridDim.x, ++it) {
    const int row = rb * S::kRows + rr;
    // this row-block's slot, and the parity of its fill
    const int i_slot = it % kSlots;
    const unsigned char* slot = slots + i_slot * span;
    const bool live = row < rows;
    int lg_m = lg_m0;
    int lg_l = fold ? 1 : 0;
    int radix = radix0;
    C v[P];
    if (bulk) bar_wait(bars + i_slot, (it / kSlots) & 1);
    with_radix<kLgN>(radix, [&](auto r) {
      constexpr int R = decltype(r)::value;
      if (bulk)
        load_input<T, kLgN, R>(v, c, reinterpret_cast<const T*>(slot),
                               x_complex, (size_t)rr * n_in, live, n_in,
                               fold);
      else
        load_input<T, kLgN, R>(v, c, x, x_complex, (size_t)row * n_in,
                               live, n_in, fold);
    });
    // the slot has been read (and the last row-block's exchanges): refill
    // it with the row-block kSlots ahead
    __syncthreads();
    const int ahead = rb + kSlots * gridDim.x;
    if (bulk && threadIdx.x == 0 && ahead < row_blocks) fetch(ahead, i_slot);
    radix = row_passes<T, kLgN>(v, c, sm, lg_m, lg_l, radix, max_radix);
    if (!live) continue;
    // kernel row (r, k1) of a long row holds the bins f = k1 + n1 k2
    row_epilogue<T, kLgN>(v, c, radix, out, g, ta, tb, start, k, grows, row,
                          kRowPass ? __ffs(n1_arg) - 1 : 0);
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

// A row of N = n1 * kMaxN points (n1 = 2^kLgN1 <= 8) on a cluster of n1
// blocks, the same four-step split as the two passes: cluster r takes
// caller row r, and its block c first runs the n1-point FFTs of the
// columns n2 in [c w, (c + 1) w), w = kMaxN / n1 (each thread w / 256 of
// them, one column in registers), multiplies bin k1 by W_N^(n2 k1) and
// stores it at point n2 of block k1's row Z[k1, :] in shared memory.  After
// the cluster barrier, block c holds Z[c, :] and runs the register core on
// it as kernel row (r, c) of the row pass (lg_n1 = kLgN1), Z read where
// the core's first pass reads a bulk-copied slot; its exchange buffer
// overlays Z, which the first pass has read by its __syncthreads.  The
// block's input, the n1 (n1 / 2 pruned) segments x[r, j kMaxN + c w ..
// + w) of w >= 512 elements, is loaded straight into registers, all of it
// before the first butterfly (neighbouring threads on neighbouring
// elements): faster than bulk copies into shared memory here, which add
// the slot's round trip to a block that has nothing to overlap with it.
template <typename T, int kLgN1>
__global__ void __launch_bounds__(kThreads, ClusterBlocks<T>::value)
cluster_kernel(const T* __restrict__ x, int x_complex,
               typename Cplx<T>::type* __restrict__ out,
               const T* __restrict__ g, const T* __restrict__ ta,
               const T* __restrict__ tb,
               const typename Cplx<T>::type* __restrict__ tw, int n_in,
               int inverse, int max_radix, int start, int k, int grows) {
  using C = typename Cplx<T>::type;
  constexpr int kLgN = 12;
  constexpr int kN1 = 1 << kLgN1;
  constexpr int kW = kMaxN / kN1;
  constexpr int kCols = kW / kThreads;
  static_assert(Shape<kLgN>::kRows == 1, "a block holds one 4096-point row");
  // shared memory: Z[c, :] (kMaxN points), then the core's exchange buffer
  // over it
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* z = reinterpret_cast<C*>(smem_raw);
  const int c = (int)cluster_rank();
  const int r = blockIdx.x >> kLgN1;
  // this block has started: the others may store to its shared memory
  // once every block has arrived here
  cluster_arrive_relaxed();

  const bool inv = inverse != 0;
  const int t = threadIdx.x;
  const int n1_in = n_in >> kLgN;  // n1, or n1 / 2 pruned
  const size_t base = (size_t)r * n_in + (size_t)c * kW + t;
  C v[kCols][kN1];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
#pragma unroll
    for (int j = 0; j < kN1; ++j)
      v[i][j] = j < n1_in ? load<T>(x, x_complex,
                                    base + (size_t)j * kMaxN + i * kThreads)
                          : mk<T>(T(0), T(0));
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    column_fft<T, kN1>(v[i], n1_in < kN1, max_radix, tw, inv);

  // bin k1 of column n2, times W_N^(n2 k1), to point n2 of block k1's Z
  uint32_t zr[kN1];
#pragma unroll
  for (int j = 0; j < kN1; ++j) zr[j] = map_rank(z, j);
  cluster_wait();
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int n2 = c * kW + t + i * kThreads;
#pragma unroll
    for (int k1 = 0; k1 < kN1; ++k1)
      store_remote(zr[k1] + n2 * (uint32_t)sizeof(C),
                   mul<T>(v[i][k1], twiddle<T>(tw, n2 * k1, inv)));
  }
  cluster_arrive();
  cluster_wait();

  // the row pass on Z[c, :]: kernel row (r, c), the table read at stride n1
  Core<T> cr;
  cr.tw = tw;
  cr.tw_stride = kN1;
  cr.t = t;
  cr.inv = inv;
  int radix = pass_radix<Shape<kLgN>::kP>(kMaxN, max_radix);
  C u[Shape<kLgN>::kP];
  with_radix<kLgN>(radix, [&](auto rd) {
    load_input<T, kLgN, decltype(rd)::value>(
        u, cr, reinterpret_cast<const T*>(z), 1, 0, true, kMaxN, false);
  });
  __syncthreads();
  radix = row_passes<T, kLgN>(u, cr, z, kLgN, 0, radix, max_radix);
  row_epilogue<T, kLgN>(u, cr, radix, out, g, ta, tb, start, k, grows,
                        (r << kLgN1) + c, kLgN1);
}

template <typename KernelPtr>
cudaError_t allow_smem(KernelPtr kernel, size_t smem) {
  // the opt-in above 48 KB is a per-device attribute: set it (always to the
  // largest size, so concurrent launches never lower it for each other) on
  // every launch that needs it, whichever device is current
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
}

// the register core for rows of 2^kLgN points.  The bulk-copy ring takes
// the inputs whose direct loads would keep few bytes in flight (a real
// row: 4 or 8 bytes a load; a pruned row: two threads load each point)
// and that it can copy (16-byte aligned, rows a multiple of 16 bytes);
// its blocks are persistent, as many as fit on the card at once.  A
// complex unpruned row (16 loads of 8 or 16 bytes a thread) is loaded
// directly, one block a row-block.
template <typename T, bool kRowPass, int kLgN>
cudaError_t launch_core(const T* x, int x_complex,
                        typename Cplx<T>::type* out, const T* g, const T* ta,
                        const T* tb, const typename Cplx<T>::type* tw,
                        int rows, int n_in, int n1, int inverse,
                        int max_radix, int start, int k, int grows,
                        cudaStream_t s) {
  using C = typename Cplx<T>::type;
  using S = Shape<kLgN>;
  const size_t elem = x_complex ? sizeof(C) : sizeof(T);
  const bool sparse = !x_complex || n_in < S::kN;
  const int bulk = sparse && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (size_t)n_in * elem % 16 == 0;
  const size_t smem =
      (((size_t)S::kRows * S::kPad * sizeof(C) + 15) & ~(size_t)15) +
      (bulk ? kSlots * ((size_t)S::kRows * n_in * elem + sizeof(uint64_t))
            : 0);
  const auto kernel = stockham_kernel<T, kRowPass, kLgN>;
  cudaError_t e = allow_smem(kernel, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int row_blocks = (rows + S::kRows - 1) / S::kRows;
  const int blocks =
      bulk && per_sm * sms < row_blocks ? per_sm * sms : row_blocks;
  kernel<<<blocks, kThreads, smem, s>>>(x, x_complex, out, g, ta, tb, tw,
                                        rows, n_in, n1, inverse, max_radix,
                                        start, k, grows, bulk);
  return cudaGetLastError();
}

// launch_core for a one-pass row of 2^lg_n points (lg_n in [kLgN, 12])
template <typename T, int kLgN = 1>
cudaError_t launch_one_pass(int lg_n, const T* x, int x_complex,
                            typename Cplx<T>::type* out, const T* g,
                            const T* ta, const T* tb,
                            const typename Cplx<T>::type* tw, int rows,
                            int n_in, int inverse, int max_radix, int start,
                            int k, int grows, cudaStream_t s) {
  if constexpr (kLgN <= 12) {
    if (lg_n == kLgN)
      return launch_core<T, false, kLgN>(x, x_complex, out, g, ta, tb, tw,
                                         rows, n_in, 1, inverse, max_radix,
                                         start, k, grows, s);
    return launch_one_pass<T, kLgN + 1>(lg_n, x, x_complex, out, g, ta, tb,
                                        tw, rows, n_in, inverse, max_radix,
                                        start, k, grows, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

// a row of 2^(12 + kLgN1) points on a cluster of 2^kLgN1 blocks, one
// cluster a caller row.  Refused (and not launched) when no such cluster
// fits on the card.
template <typename T, int kLgN1>
cudaError_t launch_cluster(const T* x, int x_complex,
                           typename Cplx<T>::type* out, const T* g,
                           const T* ta, const T* tb,
                           const typename Cplx<T>::type* tw, int rows,
                           int n_in, int inverse, int max_radix, int start,
                           int k, int grows, cudaStream_t s) {
  using C = typename Cplx<T>::type;
  constexpr int kN1 = 1 << kLgN1;
  const size_t smem = (size_t)Shape<12>::kPad * sizeof(C);
  const auto kernel = cluster_kernel<T, kLgN1>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * kN1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kN1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, x, x_complex, out, g, ta, tb, tw,
                         n_in, inverse, max_radix, start, k, grows);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, int x_complex, void* out, const void* g,
           const void* ta, const void* tb, const void* tw, void* scratch,
           int rows, int n_in, int n, int inverse, int max_radix, int start,
           int k, int grows, void* stream) {
  using C = typename Cplx<T>::type;
  static_assert(1 << 12 == kMaxN, "the row pass is the 4096-point core");
  if (n < 2 || (n & (n - 1)) != 0 || n > kMaxN * kMaxN ||
      !(n_in == n || 2 * n_in == n) || rows < 1 || k < 1 ||
      start < 0 || start + k > n || grows < 1 || rows % grows != 0 ||
      (ta == nullptr) != (tb == nullptr) ||
      (ta != nullptr && (g != nullptr || inverse)) ||
      (n > kClusterN && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const C* twc = static_cast<const C*>(tw);
  if (n <= kMaxN) {
    int lg_n = 0;
    while ((1 << lg_n) < n) ++lg_n;
    return (int)launch_one_pass<T>(
        lg_n, static_cast<const T*>(x), x_complex, static_cast<C*>(out),
        static_cast<const T*>(g), static_cast<const T*>(ta),
        static_cast<const T*>(tb), twc, rows, n_in, inverse, max_radix,
        start, k, grows, s);
  }
  const int n1 = n / kMaxN;
  if (n <= kClusterN) {
    const auto cluster = n1 == 2   ? launch_cluster<T, 1>
                         : n1 == 4 ? launch_cluster<T, 2>
                                   : launch_cluster<T, 3>;
    return (int)cluster(static_cast<const T*>(x), x_complex,
                        static_cast<C*>(out), static_cast<const T*>(g),
                        static_cast<const T*>(ta), static_cast<const T*>(tb),
                        twc, rows, n_in, inverse, max_radix, start, k, grows,
                        s);
  }
  // pass 1 into the scratch; pass 2 reads it as rows * n1 full rows
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
  return (int)launch_core<T, true, 12>(
      static_cast<const T*>(x), 1, static_cast<C*>(out),
      static_cast<const T*>(g), static_cast<const T*>(ta),
      static_cast<const T*>(tb), twc, rows * n1, n2, n1, inverse, max_radix,
      start, k, grows, s);
}

}  // namespace

extern "C" {

// out is complex (rows, k), or real (rows, k) when ta and tb are given;
// tw is the length-n table; scratch (rows * n complex) is needed, and
// used, only when n > 32768 (it may be null otherwise)
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
