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
// the rows Z[k1, :]; kernel row (r, k1) holds the bins f = k1 + N1 k2 and
// keeps the same bin windows, so all three epilogues stay fused.  The
// pruned input (n < N/2, so n1 < N1/2) is the pruned first stage of the
// column FFTs.  The wrapper's table holds, for N > 4096, three tables one
// after another, whose values are all the length-N table's, bit for bit:
// that table (the columns read W_N1 at stride N2), the 4096-point table
// (the rows read it contiguously: the long table at stride N1) and the
// inter-pass twiddles laid out as W[k1 N2 + n2] = W_N^(n2 k1), so that
// neighbouring threads (neighbouring n2) read neighbouring entries rather
// than entries k1 apart.  Only the row step scales the inverse, by 1/N.
// A kernel row's bins lie N1 apart in the caller's row, so the rows'
// stores are strided unless the blocks of G adjacent kernel rows exchange
// their bins first (exchange_epilogue: block j then holds, for k2 in its
// 4096 / G, the G bins k1_0 .. k1_0 + G - 1 side by side, and stores runs
// of G contiguous bins: whole 32-byte sectors from G = 4 in complex64).
// So the rows take four tiers by length, each bounded by memory:
// - 8 <= N <= 32 in float32, 8 <= N <= 16 in float64: the short tier
//   (short_kernel), one pass.  There the core's own loads and stores do
//   not fill a sector: a thread holds a whole row of up to 16 points (two
//   threads a 32-point row), so a warp load or store of one point a row
//   touches 32 rows' sectors, 8 or 16 bytes of each.  The short tier
//   instead moves each row-block's input span and output span (kRows *
//   n_in and kRows * k contiguous elements) element by element,
//   neighbouring threads on neighbouring elements, through shared memory:
//   the input by asynchronous copies (cp.async) into a ring of two slots,
//   the next row-block in flight while one is transformed, the output
//   from the bins the core leaves there, through the epilogue.
//   The rows lie in shared memory at a pitch p = s (mod 2 s) (strip_pitch:
//   a warp's rows read or write s consecutive elements at a time, and r p
//   then covers distinct banks), so the core's reads and writes there are
//   conflict-free and the copies' writes and the stores' reads at most
//   2-way; the pitch is written by the copies themselves, as a bulk copy
//   (one contiguous span) cannot pad rows.  Shorter and longer rows run
//   the core, which ran them faster on an H100 (tools/compare_stockham.py):
//   below 8 points a row is 16 or 32 bytes, so a thread's few loads cover
//   its row's sectors back to back, and from 64 points (32 in float64)
//   the threads of a row load and store whole sectors together, so the
//   staging's shared-memory round trips cost more than they save.
// - N <= 4096: one pass, the core alone (one block a row or less).
// - 4096 < N <= 65536 (N1 = 2 .. 16): one pass on a thread-block cluster
//   of N1 blocks a row (cluster_kernel).  Block c loads its slice of every
//   column (N1 contiguous segments of 4096 / N1 >= 256 points), runs
//   those columns' FFTs in registers (16 / N1 columns a thread, at least
//   one), and stores Z[k1, n2] straight into block k1's shared memory
//   (distributed shared memory); after the cluster barrier each block
//   runs the core on its own Z row.  Z never reaches device memory: the
//   call reads its input once and writes its kept bins once, the bound's
//   bytes.  The blocks then exchange their bins (exchange_epilogue, G =
//   N1), so that block c stores the caller row's bins [4096 c, 4096 c +
//   4096), except an 8192-point row's post-twiddle, whose real bins the
//   two blocks store two apart.  A 65536-point row takes 16 blocks, a
//   non-portable cluster size, which an H100 allows.
// - N > 65536 (up to 4096^2): two passes through a scratch buffer.  Pass
//   1 (column_kernel) runs the column FFTs in registers, the core's
//   passes on columns: a block holds 4096 / N1 adjacent columns (16
//   points a thread, N1 / 16 threads a column), neighbouring threads on
//   neighbouring columns, so every load of the input and store of Z is a
//   run of adjacent columns (whole 128-byte lines up to N1 = 256 in
//   complex64), and the exchanges between passes go through shared
//   memory with the columns interleaved.  It stores Z[r, k1, n2] times the
//   inter-pass twiddle.  Pass 2 (row_kernel) runs the core on the rows *
//   N1 rows of Z on clusters of G blocks, which exchange their bins.  Z's
//   round trip through device memory (rows * N complex values written,
//   then read) is paid on top of the bound's bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 4096;
// the longest row on one thread-block cluster: kMaxN points a block, at
// most 16 blocks (the largest cluster an H100 takes, non-portable above 8)
constexpr int kClusterN = 16 * kMaxN;
// the cluster rows from which the blocks exchange their bins before they
// store them (log2 N1), whatever the epilogue: from 16384 points; at 8192
// only a complex output does (the post-twiddle's 4-byte bins store faster
// two apart; tools/probe_two_pass_stores.py)
constexpr int kExchangeLgN1 = 2;
// points a thread of the register core holds (fewer for rows below 16)
constexpr int kPoints = 16;
// log2 of G, the blocks of the row pass's clusters (float32, float64):
// G adjacent kernel rows exchange their bins, so that each block stores
// runs of G contiguous bins (tools/probe_two_pass_stores.py times G)
constexpr int kRowGroupLg[2] = {2, 1};
// the most dynamic shared memory a block may opt in to on an H100 (the
// core's largest block takes 134 KB: the exchange buffer of a 4096-point
// complex128 row and two 32 KB input slots)
constexpr int kSmemOptIn = 232448;
// blocks of the core per SM that the float32 register budget allows
// (65536 registers / (2 * 256 threads) = 128 a thread); float64 holds 16
// complex128 points a thread and takes one block (the short tier's blocks
// ask the same: 128 registers a thread, 255 in float64)
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
// log2 of the shortest and the longest row of the short tier
// (short_kernel), float32 and float64: where it beat the register core in
// tools/compare_stockham.py (shorter and longer rows run the core)
template <typename T> struct ShortTier {
  static constexpr int kLo = 3;
  static constexpr int kHi = sizeof(T) == 8 ? 4 : 5;
};

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

// Asynchronous copies of one element (kBytes = 4, 8 or 16, aligned to
// its size) from device to shared memory by each thread (cp.async), in
// groups: commit closes this thread's group; wait<n> returns once at most
// n of its groups are still in flight (its copies then visible to it; a
// __syncthreads makes them visible to the block).
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

// v to address a (from map_rank) of another block's shared memory
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
// The cluster kernel's column FFTs: one column in registers.

// The Stockham DIF stages (as kernels/ref.py runs them) on one column of
// kN <= 16 points held in registers, from sub-transform length kM and span
// kL: radix-4 stages with one radix-2 step (kR4), or radix-2 only.  W_kN^t
// is table entry t * kMaxN (the table of an N = kN * kMaxN point row).  x
// holds the column in natural order, and then its spectrum.
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
// pruned (the zero tail not stored): the pruned first stage (x1 == 0, so
// the DIF butterfly of index j gives e = x0, d = x0 W^j at 2j, 2j+1), then
// the stages
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
// The register core: one-pass rows, the long rows' 4096-point rows (on a
// cluster, and pass 2) and the two-pass columns (pass 1).

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

// x / d for 0 <= x < 2^31, d fixed at launch, by a multiply and a shift:
// q = umulhi(x, mul) >> shr = x mul / 2^p rounded down, mul = ceil(2^p /
// d), p = 31 + ceil(log2 d) (the rounding error x (mul d - 2^p) / (d
// 2^p) < 1 / d never reaches the next integer)
struct Divmod {
  int d;
  unsigned mul;
  int shr;
};

Divmod make_divmod(int d) {
  Divmod m{d, 0u, 0};
  if (d > 1) {
    int lg = 0;
    while ((1 << lg) < d) ++lg;
    m.mul = (unsigned)(((1ull << (31 + lg)) + (unsigned)d - 1) / (unsigned)d);
    m.shr = lg - 1;
  }
  return m;
}

__device__ __forceinline__ int quotient(const Divmod& m, int x) {
  return m.d == 1 ? x : (int)(__umulhi((unsigned)x, m.mul) >> m.shr);
}

// bytes of a 4096-point row's exchange buffer (16-byte aligned)
template <typename T>
constexpr size_t kZBytes =
    ((size_t)Shape<12>::kPad * sizeof(typename Cplx<T>::type) + 15) &
    ~(size_t)15;

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

// Where point q of a row lies in the block's exchange buffer, from the
// row's own place: the rows one after another, one pad point per 16 (the
// threads of a row are neighbours), or 2^kLgC rows (columns) interleaved,
// point-major (neighbouring threads hold neighbouring columns).  Both
// place q + l at q's place plus at(l) when l is a multiple of 16.
struct Padded {
  static __device__ __forceinline__ int at(int q) { return padded(q); }
};
template <int kLgC>
struct Interleaved {
  static __device__ __forceinline__ int at(int q) { return q << kLgC; }
};

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
// in shared memory, or in device memory), its points xs elements apart (a
// column's: kMaxN): point p of the stage input is x[p], or with the pruned
// stage folded in (fold) x[p / 2], times W^(p / 2) for odd p; points at or
// past n_in (the zero tail of a pruned 2-point row) are 0.  All loads are
// issued before the first use, at offsets fixed at compile time.
template <typename T, int kLgN, int R>
__device__ __forceinline__ void load_input(
    typename Cplx<T>::type (&v)[Shape<kLgN>::kP], const Core<T>& c,
    const T* x, int x_complex, size_t base, int xs, bool live, int n_in,
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
                          ? load<T>(x, x_complex, base + (size_t)src * xs)
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

// a radix-R pass's outputs to the row's shared memory (laid out by L):
// group g = j l + kk leaves output o at j R l + kk + o l
template <typename T, int kLgN, int R, typename L>
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
      typename Cplx<T>::type* at = sm + L::at(q0);
      const int step = L::at(1 << lg_l);
#pragma unroll
      for (int r = 0; r < R; ++r) at[out_slot<R>(r) * step] = v[gi * R + r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        sm[L::at(q0 + (out_slot<R>(r) << lg_l))] = v[gi * R + r];
    }
  }
}

// the next radix-R pass's inputs from the row's shared memory
template <typename T, int kLgN, int R, typename L>
__device__ __forceinline__ void from_shared(
    typename Cplx<T>::type (&v)[Shape<kLgN>::kP],
    const typename Cplx<T>::type* sm, const Core<T>& c) {
  using S = Shape<kLgN>;
  constexpr int kStride = S::kN / R;
#pragma unroll
  for (int gi = 0; gi < S::kP / R; ++gi) {
    const int g = c.t + (gi << S::kLgT);
    if constexpr (kStride % 16 == 0) {
      const typename Cplx<T>::type* at = sm + L::at(g);
#pragma unroll
      for (int i = 0; i < R; ++i) v[gi * R + i] = at[i * L::at(kStride)];
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i)
        v[gi * R + i] = sm[L::at(g + i * kStride)];
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
// registers, the exchanges through the row's shared memory sm (laid out
// by L) between passes (after the caller's __syncthreads once the first
// pass's input has been read, where it was read from shared memory).
// Returns the last pass's radix, v holding the bins.
template <typename T, int kLgN, typename L = Padded>
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
      to_shared<T, kLgN, decltype(r)::value, L>(v, sm, c, lg_l);
    });
    __syncthreads();
    lg_m -= lg_r;
    lg_l += lg_r;
    radix = pass_radix<Shape<kLgN>::kP>(1 << lg_m, max_radix);
    with_radix<kLgN>(radix, [&](auto r) {
      from_shared<T, kLgN, decltype(r)::value, L>(v, sm, c);
    });
  }
}

// the epilogue's arguments for caller row r of a transform of 2^lg_n
// points (the inverse's scale 1 / N is exact: N is a power of two)
template <typename T>
__device__ __forceinline__ Epilogue<T> epilogue_of(
    typename Cplx<T>::type* out, const T* g, const T* ta, const T* tb,
    int start, int k, int grows, int r, bool inv, int lg_n) {
  Epilogue<T> e;
  e.ta = ta;
  e.tb = tb;
  e.start = start;
  e.k = k;
  e.inv = inv;
  e.lg_n1 = 0;
  e.k1 = 0;
  // a real output (the post-twiddle) or a complex one
  e.out = ta != nullptr
              ? static_cast<void*>(reinterpret_cast<T*>(out) + (size_t)r * k)
              : static_cast<void*>(out + (size_t)r * k);
  e.g = g != nullptr ? g + (size_t)(r % grows) * k : nullptr;
  e.scale = T(1) / T(1 << lg_n);
  return e;
}

// The epilogue of kernel row `row`, the bins of the last pass (radix
// `radix`) in v: the bins [start, start+k) of caller row row >> lg_n1.
// A long row's kernel row (r, k1 = row % n1), n1 = 2^lg_n1, holds the
// bins f = k1 + n1 k2, stored n1 apart; a one-pass row is lg_n1 = 0.
template <typename T, int kLgN>
__device__ __forceinline__ void row_epilogue(
    const typename Cplx<T>::type (&v)[Shape<kLgN>::kP], const Core<T>& c,
    int radix, typename Cplx<T>::type* out, const T* g, const T* ta,
    const T* tb, int start, int k, int grows, int row, int lg_n1) {
  Epilogue<T> e = epilogue_of<T>(out, g, ta, tb, start, k, grows,
                                 row >> lg_n1, c.inv, kLgN + lg_n1);
  e.lg_n1 = lg_n1;
  e.k1 = row & ((1 << lg_n1) - 1);
  with_radix<kLgN>(radix, [&](auto rd) {
    epilogue<T, kLgN, decltype(rd)::value>(v, c, e);
  });
}

// The epilogue of G = 2^kLgG adjacent kernel rows (r, k1_0 + c), 4096
// points each, on a cluster of G blocks, block c (its rank) holding row
// k1_0 + c and its last pass's (radix `radix`) bins k2 in v.  Block c
// sends its bins k2 in [j W, j W + W) (W = 4096 / G) to block j's buffer
// `recv`, at point c (W + 1) + k2 - j W: neighbouring threads hold
// neighbouring k2, so each warp's remote stores are one contiguous run.
// The buffer is free once every block of the cluster has started (a
// cluster barrier's wait, its arrive made when the block started), or,
// with kAliased, where it is the row passes' own exchange buffer, once
// every block has read it (a whole cluster barrier here).  After the
// next cluster barrier block j holds bin f = k1_0 + c' + n1 (j W + k2')
// at point c' (W + 1) + k2', and neighbouring threads store neighbouring
// bins, runs of G, reading points W + 1 apart (distinct banks), with the
// epilogue e (the window, the Green row, the post-twiddle or the
// inverse's scale) as a one-pass row's.
template <typename T, int kLgG, bool kAliased>
__device__ __forceinline__ void exchange_epilogue(
    const typename Cplx<T>::type (&v)[kPoints], const Core<T>& c, int radix,
    typename Cplx<T>::type* recv, const Epilogue<T>& e, int rank, int k1_0,
    int lg_n1) {
  using C = typename Cplx<T>::type;
  constexpr int kG = 1 << kLgG;
  constexpr int kLgW = 12 - kLgG;
  constexpr int kW = 1 << kLgW;
  static_assert(kLgW >= 8, "a thread's bins k2 = t + a multiple of 256 "
                           "each go to one block, known at compile time");
  if constexpr (kAliased) cluster_arrive();
  cluster_wait();
  with_radix<12>(radix, [&](auto rd) {
    constexpr int R = decltype(rd)::value;
    constexpr int kStride = kMaxN / R;
#pragma unroll
    for (int gi = 0; gi < kPoints / R; ++gi) {
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const int off = (gi << 8) + out_slot<R>(o) * kStride;  // k2 - t
        const int q = rank * (kW + 1) + c.t + (off & (kW - 1));
        store_remote(map_rank(recv, off >> kLgW) + (uint32_t)(q * sizeof(C)),
                     v[gi * R + o]);
      }
    }
  });
  cluster_arrive();
  cluster_wait();
  const unsigned k = e.k;
  const int f0 = k1_0 + (rank << (kLgW + lg_n1)) - e.start;
  // point i of the caller row's run: its bin less start, and its value
  auto bin = [&](int i) {
    return f0 + (i & (kG - 1)) + ((i >> kLgG) << lg_n1);
  };
  auto at = [&](int i) {
    return recv[(i & (kG - 1)) * (kW + 1) + (i >> kLgG)];
  };
  if (e.ta != nullptr) {
    const T* __restrict__ ta = e.ta;
    const T* __restrict__ tb = e.tb;
    T* __restrict__ out = static_cast<T*>(e.out);
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
      const int i = threadIdx.x + m * kThreads;
      const int b = bin(i);
      const C w = at(i);
      if ((unsigned)b < k) out[b] = ta[b] * w.x + tb[b] * w.y;
    }
  } else if (e.g != nullptr) {
    const T* __restrict__ g = e.g;
    C* __restrict__ out = static_cast<C*>(e.out);
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
      const int i = threadIdx.x + m * kThreads;
      const int b = bin(i);
      const C w = at(i);
      if ((unsigned)b < k) out[b] = mk<T>(w.x * g[b], w.y * g[b]);
    }
  } else {
    C* __restrict__ out = static_cast<C*>(e.out);
    const T s = e.inv ? e.scale : T(1);
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
      const int i = threadIdx.x + m * kThreads;
      const int b = bin(i);
      const C w = at(i);
      if ((unsigned)b < k) out[b] = mk<T>(w.x * s, w.y * s);
    }
  }
}

// The whole FFT of rows of length n = 2^kLgN <= 4096, in one pass.
// Shape<kLgN>: P points a thread, n / P threads a row, kRows rows a
// row-block.  The blocks are persistent: block b takes row-blocks b, b +
// gridDim.x, ...  With bulk (the input 16-byte aligned and each row a
// multiple of 16 bytes) a row-block's input span (contiguous: kRows *
// n_in elements) arrives by one bulk copy into the block's input slot,
// and the next row-block's copy is issued as soon as the first pass has
// read the slot, so it runs under this row-block's later passes and
// stores; otherwise (an input one element off 16-byte alignment, or a
// real row of 1 or 2 points) the first pass reads device memory
// directly.
template <typename T, int kLgN>
__global__ void __launch_bounds__(kThreads, CoreBlocks<T>::value)
stockham_kernel(const T* __restrict__ x, int x_complex,
                typename Cplx<T>::type* __restrict__ out,
                const T* __restrict__ g,
                const T* __restrict__ ta, const T* __restrict__ tb,
                const typename Cplx<T>::type* __restrict__ tw,
                int rows, int n_in, int inverse, int max_radix, int start,
                int k, int grows, int bulk) {
  using C = typename Cplx<T>::type;
  using S = Shape<kLgN>;
  constexpr int P = S::kP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Core<T> c;
  c.tw = tw;
  c.tw_stride = 1;
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
                               x_complex, (size_t)rr * n_in, 1, live, n_in,
                               fold);
      else
        load_input<T, kLgN, R>(v, c, x, x_complex, (size_t)row * n_in, 1,
                               live, n_in, fold);
    });
    // the slot has been read (and the last row-block's exchanges): refill
    // it with the row-block kSlots ahead
    __syncthreads();
    const int ahead = rb + kSlots * gridDim.x;
    if (bulk && threadIdx.x == 0 && ahead < row_blocks) fetch(ahead, i_slot);
    radix = row_passes<T, kLgN>(v, c, sm, lg_m, lg_l, radix, max_radix);
    if (!live) continue;
    row_epilogue<T, kLgN>(v, c, radix, out, g, ta, tb, start, k, grows, row,
                          0);
  }
}

// The short tier's block: kThr threads (256, 128 in float64) running the
// register core's Shape on rows of 2^kLgN points, each thread taking kF
// rows (kF > 1 below 16 points), so that a row-block holds kRows rows,
// kThr * kPoints points: 32 KB of complex input whatever the length and
// precision
template <typename T, int kLgN>
struct ShortShape {
  using S = Shape<kLgN>;
  static constexpr int kThr = sizeof(T) == 8 ? kThreads / 2 : kThreads;
  static constexpr int kF = S::kN < kPoints ? kPoints / S::kN : 1;
  static constexpr int kCoreRows = kThr >> S::kLgT;
  static constexpr int kRows = kCoreRows * kF;
};

// Where a short block's shared memory holds what: two input slots (a
// row-block's rows of x, row r at r * ipitch elements) and, with a Green
// plane, two slots of its values (element i of the output span at i),
// then the exchange rows (kPad points a core row) and over them the bins
// (row r at r * opitch points)
struct ShortStage {
  size_t in, green, xo;  // bytes of an input slot, a Green slot, the rest
  size_t bytes() const { return 2 * (in + green) + xo; }
};

// a row-block's copies, as one group of this thread's asynchronous
// copies: the input span (count elements of x, rows of 2^lg_in) into
// `in`, row r at r * pitch, and the Green values of the output span
// (nrows * k elements from caller row row0 on; row r's bin b at r k + b,
// from Green row (row0 + r) % grows) into `green`.  Element e = threadIdx.x
// + j kThr: neighbouring threads copy neighbouring elements (each warp's
// copies whole sectors, at any alignment).
template <int kThr, typename E>
__device__ __forceinline__ void fetch_span(const E* __restrict__ src,
                                           int count, int lg_in, int pitch,
                                           E* in) {
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int e = threadIdx.x + j * kThr;
    if (e < count)
      copy_async<sizeof(E)>(
          in + (e >> lg_in) * pitch + (e & ((1 << lg_in) - 1)), src + e);
  }
}

template <int kThr, typename T>
__device__ __forceinline__ void fetch_green(const T* __restrict__ g,
                                            int row0, int nrows, int k,
                                            const Divmod& kdiv,
                                            const Divmod& gdiv, T* green) {
  const int count = nrows * k;
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int i = threadIdx.x + j * kThr;
    if (i < count) {
      const int r = quotient(kdiv, i);
      const int gr = row0 + r - quotient(gdiv, row0 + r) * gdiv.d;
      copy_async<sizeof(T)>(green + i, g + (size_t)gr * k + (i - r * k));
    }
  }
}

// the kept bins of the last pass (radix R, bin k2 = g + o n / R of group
// g in register out_slot^-1(o)) to the row's stage row, bin b at b - start
template <typename T, int kLgN, int R>
__device__ __forceinline__ void stage_bins(
    const typename Cplx<T>::type (&v)[Shape<kLgN>::kP], const Core<T>& c,
    typename Cplx<T>::type* row, int start, int k) {
  using S = Shape<kLgN>;
  constexpr int kStride = S::kN / R;
#pragma unroll
  for (int gi = 0; gi < S::kP / R; ++gi) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = c.t + (gi << S::kLgT) + out_slot<R>(r) * kStride - start;
      if ((unsigned)b < (unsigned)k) row[b] = v[gi * R + r];
    }
  }
}

// the row-block's output span (nrows * k elements from caller row row0 on)
// from the bins (row r's at r * pitch) through the epilogue e (the Green
// values `green`, the post-twiddle or the inverse's scale; its out is
// caller row 0): element i = threadIdx.x + j kThr, neighbouring threads
// storing neighbouring elements (each warp's stores whole sectors)
template <int kThr, typename T>
__device__ __forceinline__ void store_span(const typename Cplx<T>::type* bins,
                                           int pitch, const T* green,
                                           int row0, int nrows,
                                           const Divmod& kdiv,
                                           const Epilogue<T>& e) {
  using C = typename Cplx<T>::type;
  const int k = e.k;
  const int count = nrows * k;
  const size_t base = (size_t)row0 * k;
  if (e.ta != nullptr) {
    const T* __restrict__ ta = e.ta;
    const T* __restrict__ tb = e.tb;
    T* __restrict__ out = static_cast<T*>(e.out) + base;
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      const int i = threadIdx.x + j * kThr;
      if (i < count) {
        const int r = quotient(kdiv, i);
        const int b = i - r * k;
        const C w = bins[r * pitch + b];
        out[i] = ta[b] * w.x + tb[b] * w.y;
      }
    }
  } else {
    C* __restrict__ out = static_cast<C*>(e.out) + base;
    const T s = e.inv ? e.scale : T(1);
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      const int i = threadIdx.x + j * kThr;
      if (i < count) {
        const int r = quotient(kdiv, i);
        const C w = bins[r * pitch + i - r * k];
        if (green != nullptr)
          out[i] = mk<T>(w.x * green[i], w.y * green[i]);
        else
          out[i] = mk<T>(w.x * s, w.y * s);
      }
    }
  }
}

// The rows of the short tier (n = 2^kLgN points), in one pass on
// persistent blocks, block b taking row-blocks b, b + gridDim.x, ...
// (kRows rows each).  For each row-block:
// 1. its input span (kRows * n_in contiguous elements of x), and with a
//    Green plane the Green values of its output span, arrive by
//    asynchronous element copies (cp.async: neighbouring threads on
//    neighbouring elements, whole sectors of each warp's copies, at any
//    alignment) in a slot of a two-slot ring, row r at r * ipitch: the
//    copies of the next row-block are issued before this one is
//    transformed, so they run under its passes and stores;
// 2. thread (rr, t) of the register core reads its rows' points from the
//    slot into registers (the first pass's load_input, the pruned stage
//    folded in) and runs the passes, exchanging through the exchange rows
//    where a row's passes exchange;
// 3. the kept bins go to shared memory over the exchange rows, row r at r
//    * opitch (stage_bins);
// 4. the block stores the output span (kRows * k contiguous elements)
//    through the epilogue (store_span).
// The pitches are chosen at launch so that the register core's reads of
// the slot and writes of the bins fall on distinct banks, and the copies'
// writes and the stores' reads on at most two a bank (launch_short).
template <typename T, int kLgN>
__global__ void __launch_bounds__(ShortShape<T, kLgN>::kThr,
                                  CoreBlocks<T>::value)
short_kernel(const T* __restrict__ x, int x_complex,
             typename Cplx<T>::type* __restrict__ out,
             const T* __restrict__ g, const T* __restrict__ ta,
             const T* __restrict__ tb,
             const typename Cplx<T>::type* __restrict__ tw, int rows,
             int n_in, int inverse, int max_radix, int start, int k,
             int grows, int ipitch, int opitch, ShortStage st, Divmod kdiv,
             Divmod gdiv) {
  using C = typename Cplx<T>::type;
  using S = Shape<kLgN>;
  using SS = ShortShape<T, kLgN>;
  constexpr int P = S::kP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* xo = reinterpret_cast<C*>(smem_raw + 2 * (st.in + st.green));
  unsigned char* greens = smem_raw + 2 * st.in;
  Core<T> c;
  c.tw = tw;
  c.tw_stride = 1;
  c.t = threadIdx.x & ((1 << S::kLgT) - 1);
  c.inv = inverse != 0;
  const int rr = threadIdx.x >> S::kLgT;
  // the pruned first stage is folded into the loads (a pruned 2-point
  // row instead reads its zero tail as 0 and runs the radix-2 pass)
  const bool fold = n_in < S::kN && S::kN > 2;
  const int lg_in = n_in < S::kN ? kLgN - 1 : kLgN;
  const int lg_m0 = fold ? kLgN - 1 : kLgN;
  const int radix0 = pass_radix<P>(1 << lg_m0, max_radix);
  // whether a row's passes exchange
  const bool exchanges = (1 << lg_m0) != radix0;
  const Epilogue<T> e = epilogue_of<T>(out, g, ta, tb, start, k, grows, 0,
                                       c.inv, kLgN);
  const int row_blocks = (rows + SS::kRows - 1) / SS::kRows;
  // row-block rb's copies into slot i, as one group
  auto fetch = [&](int rb, int i) {
    if (rb < row_blocks) {
      const int row0 = rb * SS::kRows;
      const int nrows = min(SS::kRows, rows - row0);
      unsigned char* in = smem_raw + i * st.in;
      if (x_complex)
        fetch_span<SS::kThr>(
            reinterpret_cast<const C*>(x) + ((size_t)row0 << lg_in),
            nrows << lg_in, lg_in, ipitch, reinterpret_cast<C*>(in));
      else
        fetch_span<SS::kThr>(x + ((size_t)row0 << lg_in), nrows << lg_in,
                             lg_in, ipitch, reinterpret_cast<T*>(in));
      if (g != nullptr)
        fetch_green<SS::kThr>(g, row0, nrows, k, kdiv, gdiv,
                              reinterpret_cast<T*>(greens + i * st.green));
    }
    copy_commit();
  };
  fetch(blockIdx.x, 0);
  for (int rb = blockIdx.x, it = 0; rb < row_blocks;
       rb += gridDim.x, ++it) {
    const int row0 = rb * SS::kRows;
    const int nrows = min(SS::kRows, rows - row0);
    const int slot = it & 1;
    // the next row-block's copies (into the slot the last one read), then
    // this one's complete
    fetch(rb + gridDim.x, slot ^ 1);
    copy_wait<1>();
    __syncthreads();
    const T* in = reinterpret_cast<const T*>(smem_raw + slot * st.in);
    // row f * SS::kCoreRows + rr of the row-block in v[f]
    C v[SS::kF][P];
#pragma unroll
    for (int f = 0; f < SS::kF; ++f) {
      with_radix<kLgN>(radix0, [&](auto r) {
        const int row = f * SS::kCoreRows + rr;
        load_input<T, kLgN, decltype(r)::value>(v[f], c, in, x_complex,
                                                (size_t)row * ipitch, 1,
                                                row < nrows, n_in, fold);
      });
    }
    // (a thread of kF > 1 rows holds each whole and exchanges in its own
    // kPad points only)
    int radix = radix0;
#pragma unroll
    for (int f = 0; f < SS::kF; ++f)
      radix = row_passes<T, kLgN>(v[f], c, xo + rr * S::kPad, lg_m0,
                                  fold ? 1 : 0, radix0, max_radix);
    // the last exchange has been read
    if (exchanges) __syncthreads();
#pragma unroll
    for (int f = 0; f < SS::kF; ++f) {
      const int row = f * SS::kCoreRows + rr;
      if (row < nrows)
        with_radix<kLgN>(radix, [&](auto r) {
          stage_bins<T, kLgN, decltype(r)::value>(v[f], c, xo + row * opitch,
                                                  start, k);
        });
    }
    __syncthreads();
    store_span<SS::kThr>(
        xo, opitch,
        g != nullptr ? reinterpret_cast<const T*>(greens + slot * st.green)
                     : nullptr,
        row0, nrows, kdiv, e);
    // the bins and this slot have been read: the next exchanges may
    // start, and the slot take the next row-block's copies
    __syncthreads();
  }
}

// Pass 1 of the two-pass FFT: the n1-point FFTs (n1 = 2^kLgN1) of the
// stride-kMaxN columns, on the register core.  Block (r, tile) takes the
// C = kRows adjacent columns n2 of row r in its tile; thread (t, cc) holds
// 16 points of column cc (neighbouring threads: neighbouring columns, the
// same points), so its loads (x[r, n1' kMaxN + n2] over n1' < n_in /
// kMaxN) and its stores of Z are runs of C adjacent elements, and the
// exchanges between passes use the column-interleaved layout.  Bin k1 of
// column n2, times W_N^(n2 k1) (the inter-pass table's entry k1 kMaxN +
// n2), goes to z[(r n1 + k1) kMaxN + n2].  The columns' W_n1 is the
// length-N table's entry at stride kMaxN.
template <typename T, int kLgN1>
__global__ void __launch_bounds__(kThreads, CoreBlocks<T>::value)
column_kernel(const T* __restrict__ x, int x_complex,
              typename Cplx<T>::type* __restrict__ z,
              const typename Cplx<T>::type* __restrict__ tw, int n_in,
              int inverse, int max_radix) {
  using C = typename Cplx<T>::type;
  using S = Shape<kLgN1>;
  static_assert(S::kP == kPoints, "16 points a thread");
  constexpr int kLgC = ilog2(S::kRows);
  constexpr int kTiles = kMaxN >> kLgC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cc = threadIdx.x & (S::kRows - 1);
  C* sm = reinterpret_cast<C*>(smem_raw) + cc;
  Core<T> c;
  c.tw = tw;
  c.tw_stride = kMaxN;
  c.t = threadIdx.x >> kLgC;
  c.inv = inverse != 0;
  const int r = blockIdx.x / kTiles;
  const int n2 = ((blockIdx.x % kTiles) << kLgC) + cc;
  const int n1_in = n_in >> 12;  // n1, or n1 / 2 pruned
  const bool fold = n1_in < S::kN;
  const int lg_m = fold ? kLgN1 - 1 : kLgN1;
  int radix = pass_radix<kPoints>(1 << lg_m, max_radix);
  C v[kPoints];
  with_radix<kLgN1>(radix, [&](auto rd) {
    load_input<T, kLgN1, decltype(rd)::value>(
        v, c, x, x_complex, (size_t)r * n_in + n2, kMaxN, true, n1_in, fold);
  });
  radix = row_passes<T, kLgN1, Interleaved<kLgC>>(v, c, sm, lg_m, fold,
                                                  radix, max_radix);
  // the inter-pass table, after the length-N and the 4096-point ones
  const C* tw_ip = tw + ((size_t)1 << (12 + kLgN1)) + kMaxN;
  with_radix<kLgN1>(radix, [&](auto rd) {
    constexpr int R = decltype(rd)::value;
    constexpr int kStride = S::kN / R;
#pragma unroll
    for (int gi = 0; gi < kPoints / R; ++gi) {
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const int k1 = c.t + (gi << S::kLgT) + out_slot<R>(o) * kStride;
        z[(((size_t)r << kLgN1) + k1) * kMaxN + n2] =
            mul<T>(v[gi * R + o], twiddle<T>(tw_ip, k1 * kMaxN + n2, c.inv));
      }
    }
  });
}

// A row of N = n1 * kMaxN points (n1 = 2^kLgN1 <= 16) on a cluster of n1
// blocks, the same four-step split as the two passes: cluster r takes
// caller row r, and its block c first runs the n1-point FFTs of the
// columns n2 in [c w, (c + 1) w), w = kMaxN / n1 (each thread w / 256 of
// them, one column in registers), multiplies bin k1 by W_N^(n2 k1) and
// stores it at point n2 of block k1's row Z[k1, :] in shared memory.  After
// the cluster barrier, block c holds Z[c, :] and runs the register core on
// it as kernel row (r, c) of the row pass, Z read where the core's first
// pass reads a bulk-copied slot; its exchange buffer overlays Z, which
// the first pass has read by its __syncthreads.  With kExchange the bins
// are exchanged before they are stored, else stored n1 apart.  The
// block's input, the n1 (n1 / 2 pruned) segments x[r, j kMaxN + c w .. +
// w) of w >= 256 elements, is loaded straight into registers, all of it
// before the first butterfly (neighbouring threads on neighbouring
// elements): faster than bulk copies into shared memory here, which add
// the slot's round trip to a block that has nothing to overlap with it.
template <typename T, int kLgN1, bool kExchange>
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
  static_assert(kCols >= 1, "a thread holds at least one column");
  // shared memory: Z[c, :] (kMaxN points), then the core's exchange buffer
  // over it, and the bins' exchange buffer over that
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
  const C* tw_ip = tw + (kN1 + 1) * kMaxN;
  cluster_wait();
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int n2 = c * kW + t + i * kThreads;
#pragma unroll
    for (int k1 = 0; k1 < kN1; ++k1)
      store_remote(map_rank(z, k1) + n2 * (uint32_t)sizeof(C),
                   mul<T>(v[i][k1], twiddle<T>(tw_ip, k1 * kMaxN + n2, inv)));
  }
  cluster_arrive();
  cluster_wait();

  // the row pass on Z[c, :]: kernel row (r, c), the 4096-point table
  // stored after the length-N one
  Core<T> cr;
  cr.tw = tw + kN1 * kMaxN;
  cr.tw_stride = 1;
  cr.t = t;
  cr.inv = inv;
  int radix = pass_radix<Shape<kLgN>::kP>(kMaxN, max_radix);
  C u[Shape<kLgN>::kP];
  with_radix<kLgN>(radix, [&](auto rd) {
    load_input<T, kLgN, decltype(rd)::value>(
        u, cr, reinterpret_cast<const T*>(z), 1, 0, 1, true, kMaxN, false);
  });
  __syncthreads();
  radix = row_passes<T, kLgN>(u, cr, z, kLgN, 0, radix, max_radix);
  if constexpr (kExchange) {
    exchange_epilogue<T, kLgN1, true>(
        u, cr, radix, z,
        epilogue_of<T>(out, g, ta, tb, start, k, grows, r, inv,
                       kLgN + kLgN1),
        c, 0, kLgN1);
  } else {
    row_epilogue<T, kLgN>(u, cr, radix, out, g, ta, tb, start, k, grows,
                          (r << kLgN1) + c, kLgN1);
  }
}

// Pass 2 of the two-pass FFT: block b runs the register core on kernel
// row b = (r, k1) of Z (n1 = 2^lg_n1 kernel rows a caller row), read
// straight from device memory (neighbouring threads on neighbouring
// points, all 16 loads of a thread issued before the first butterfly),
// with the 4096-point table stored after the length-N one; the cluster of
// G = 2^kLgG blocks holding k1_0 .. k1_0 + G - 1 exchanges the bins
// through a buffer of their own (exchange_epilogue), so that no block
// waits for another's passes.
template <typename T, int kLgG>
__global__ void __launch_bounds__(kThreads, CoreBlocks<T>::value)
row_kernel(const typename Cplx<T>::type* __restrict__ z,
           typename Cplx<T>::type* __restrict__ out,
           const T* __restrict__ g, const T* __restrict__ ta,
           const T* __restrict__ tb,
           const typename Cplx<T>::type* __restrict__ tw, int lg_n1,
           int inverse, int max_radix, int start, int k, int grows) {
  using C = typename Cplx<T>::type;
  constexpr int kLgN = 12;
  // shared memory: the passes' exchange buffer, then the bins'
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  C* recv = reinterpret_cast<C*>(smem_raw + kZBytes<T>);
  // this block has started: the others may store to its bins' buffer
  // once every block has arrived here
  cluster_arrive_relaxed();
  Core<T> c;
  c.tw = tw + ((size_t)kMaxN << lg_n1);
  c.tw_stride = 1;
  c.t = threadIdx.x;
  c.inv = inverse != 0;
  const int rank = (int)cluster_rank();
  const int r = blockIdx.x >> lg_n1;
  const int k1 = blockIdx.x & ((1 << lg_n1) - 1);
  int radix = pass_radix<kPoints>(kMaxN, max_radix);
  C v[kPoints];
  with_radix<kLgN>(radix, [&](auto rd) {
    load_input<T, kLgN, decltype(rd)::value>(
        v, c, reinterpret_cast<const T*>(z), 1, (size_t)blockIdx.x * kMaxN,
        1, true, kMaxN, false);
  });
  radix = row_passes<T, kLgN>(v, c, sm, kLgN, 0, radix, max_radix);
  exchange_epilogue<T, kLgG, false>(
      v, c, radix, recv,
      epilogue_of<T>(out, g, ta, tb, start, k, grows, r, c.inv,
                     kLgN + lg_n1),
      rank, k1 - rank, lg_n1);
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
template <typename T, int kLgN>
cudaError_t launch_core(const T* x, int x_complex,
                        typename Cplx<T>::type* out, const T* g, const T* ta,
                        const T* tb, const typename Cplx<T>::type* tw,
                        int rows, int n_in, int inverse, int max_radix,
                        int start, int k, int grows, cudaStream_t s) {
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
  const auto kernel = stockham_kernel<T, kLgN>;
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
                                        rows, n_in, inverse, max_radix,
                                        start, k, grows, bulk);
  return cudaGetLastError();
}

// the least pitch p >= n with p = s (mod 2 s): rows r at r p, read or
// written s consecutive elements a row at a time by the rows of a warp,
// then fall on distinct banks (r p mod the elements a bank sweep holds,
// a power of two, are distinct multiples of s: p is s times an odd
// number)
int strip_pitch(int n, int s) {
  const int p = n / (2 * s) * (2 * s) + s;
  return p < n ? p + 2 * s : p;
}

// short_kernel for rows of 2^kLgN points: the pitches (a row's T = 2^kLgT
// threads read T consecutive points of a slot at a time, T / 2 of a
// pruned row, and write T consecutive bins), the shared memory (two input
// slots, two Green slots, the larger of the exchange rows and the bins),
// as many persistent blocks as fit on the card at once
template <typename T, int kLgN>
cudaError_t launch_short(const T* x, int x_complex,
                         typename Cplx<T>::type* out, const T* g,
                         const T* ta, const T* tb,
                         const typename Cplx<T>::type* tw, int rows,
                         int n_in, int inverse, int max_radix, int start,
                         int k, int grows, cudaStream_t s) {
  using C = typename Cplx<T>::type;
  using S = Shape<kLgN>;
  using SS = ShortShape<T, kLgN>;
  constexpr int kT = 1 << S::kLgT;
  const bool fold = n_in < S::kN && S::kN > 2;
  const int ipitch = strip_pitch(n_in, fold && kT > 1 ? kT / 2 : kT);
  const int opitch = strip_pitch(k, kT);
  auto align = [](size_t b) { return (b + 15) & ~(size_t)15; };
  ShortStage st;
  st.in = align((size_t)SS::kRows * ipitch *
                (x_complex ? sizeof(C) : sizeof(T)));
  st.green = g != nullptr ? align((size_t)SS::kRows * k * sizeof(T)) : 0;
  st.xo = align(std::max((size_t)SS::kCoreRows * S::kPad,
                         (size_t)SS::kRows * opitch) *
                sizeof(C));
  const size_t smem = st.bytes();
  const auto kernel = short_kernel<T, kLgN>;
  cudaError_t e = allow_smem(kernel, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      SS::kThr, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int row_blocks = (rows + SS::kRows - 1) / SS::kRows;
  const int blocks = std::min(row_blocks, per_sm * sms);
  kernel<<<blocks, SS::kThr, smem, s>>>(
      x, x_complex, out, g, ta, tb, tw, rows, n_in, inverse, max_radix,
      start, k, grows, ipitch, opitch, st, make_divmod(k),
      make_divmod(grows));
  return cudaGetLastError();
}

// a one-pass row of 2^lg_n points (lg_n in [kLgN, 12]): short_kernel on
// the short tier's lengths, the register core's stockham_kernel on the
// others
template <typename T, int kLgN = 1>
cudaError_t launch_one_pass(int lg_n, const T* x, int x_complex,
                            typename Cplx<T>::type* out, const T* g,
                            const T* ta, const T* tb,
                            const typename Cplx<T>::type* tw, int rows,
                            int n_in, int inverse, int max_radix, int start,
                            int k, int grows, cudaStream_t s) {
  if constexpr (kLgN >= ShortTier<T>::kLo && kLgN <= ShortTier<T>::kHi) {
    if (lg_n == kLgN)
      return launch_short<T, kLgN>(x, x_complex, out, g, ta, tb, tw, rows,
                                   n_in, inverse, max_radix, start, k,
                                   grows, s);
    return launch_one_pass<T, kLgN + 1>(lg_n, x, x_complex, out, g, ta, tb,
                                        tw, rows, n_in, inverse, max_radix,
                                        start, k, grows, s);
  } else if constexpr (kLgN <= 12) {
    if (lg_n == kLgN)
      return launch_core<T, kLgN>(x, x_complex, out, g, ta, tb, tw, rows,
                                  n_in, inverse, max_radix, start, k, grows,
                                  s);
    return launch_one_pass<T, kLgN + 1>(lg_n, x, x_complex, out, g, ta, tb,
                                        tw, rows, n_in, inverse, max_radix,
                                        start, k, grows, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

// kernel on `blocks` blocks in clusters of `cluster` blocks.  Refused (and
// not launched) when no such cluster fits on the card; clusters above 8
// blocks (the portable size) are asked for explicitly.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, unsigned blocks, int cluster,
                            size_t smem, cudaStream_t s, Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// a row of 2^(12 + lg_n1) points (lg_n1 in [kLgN1, 4]) on a cluster of
// 2^lg_n1 blocks, one cluster a caller row
template <typename T, int kLgN1 = 1>
cudaError_t launch_cluster(int lg_n1, const T* x, int x_complex,
                           typename Cplx<T>::type* out, const T* g,
                           const T* ta, const T* tb,
                           const typename Cplx<T>::type* tw, int rows,
                           int n_in, int inverse, int max_radix, int start,
                           int k, int grows, cudaStream_t s) {
  if constexpr (kLgN1 <= 4) {
    if (lg_n1 != kLgN1)
      return launch_cluster<T, kLgN1 + 1>(lg_n1, x, x_complex, out, g, ta,
                                          tb, tw, rows, n_in, inverse,
                                          max_radix, start, k, grows, s);
    auto go = [&](auto kernel) {
      return launch_clusters(kernel, (unsigned)rows << kLgN1, 1 << kLgN1,
                             kZBytes<T>, s, x, x_complex, out, g, ta, tb, tw,
                             n_in, inverse, max_radix, start, k, grows);
    };
    // the blocks exchange their bins, but below kExchangeLgN1 for the
    // post-twiddle's real bins, which they store n1 apart
    if constexpr (kLgN1 < kExchangeLgN1) {
      if (ta != nullptr) return go(cluster_kernel<T, kLgN1, false>);
    }
    return go(cluster_kernel<T, kLgN1, true>);
  } else {
    return cudaErrorInvalidValue;
  }
}

// pass 1 for columns of 2^lg_n1 points (lg_n1 in [kLgN1, 12]): 4096 points
// a block
template <typename T, int kLgN1 = 4>
cudaError_t launch_columns(int lg_n1, const T* x, int x_complex,
                           typename Cplx<T>::type* z,
                           const typename Cplx<T>::type* tw, int rows,
                           int n_in, int inverse, int max_radix,
                           cudaStream_t s) {
  if constexpr (kLgN1 <= 12) {
    if (lg_n1 != kLgN1)
      return launch_columns<T, kLgN1 + 1>(lg_n1, x, x_complex, z, tw, rows,
                                          n_in, inverse, max_radix, s);
    using C = typename Cplx<T>::type;
    const size_t smem = (size_t)kMaxN * sizeof(C);
    const auto kernel = column_kernel<T, kLgN1>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const unsigned tiles = kMaxN / Shape<kLgN1>::kRows;
    kernel<<<(unsigned)rows * tiles, kThreads, smem, s>>>(
        x, x_complex, z, tw, n_in, inverse, max_radix);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
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
  const T* xt = static_cast<const T*>(x);
  C* o = static_cast<C*>(out);
  const T* gt = static_cast<const T*>(g);
  const T* at = static_cast<const T*>(ta);
  const T* bt = static_cast<const T*>(tb);
  const C* twc = static_cast<const C*>(tw);
  int lg_n = 0;
  while ((1 << lg_n) < n) ++lg_n;
  if (n <= kMaxN)
    return (int)launch_one_pass<T>(lg_n, xt, x_complex, o, gt, at, bt, twc,
                                   rows, n_in, inverse, max_radix, start, k,
                                   grows, s);
  const int lg_n1 = lg_n - 12;
  if (n <= kClusterN)
    return (int)launch_cluster<T>(lg_n1, xt, x_complex, o, gt, at, bt, twc,
                                  rows, n_in, inverse, max_radix, start, k,
                                  grows, s);
  // pass 1 into the scratch; pass 2 reads it as rows * n1 rows
  C* z = static_cast<C*>(scratch);
  cudaError_t e = launch_columns<T>(lg_n1, xt, x_complex, z, twc, rows, n_in,
                                    inverse, max_radix, s);
  if (e != cudaSuccess) return (int)e;
  // pass 2: the rows of Z
  constexpr int kLgG = kRowGroupLg[sizeof(T) == 8];
  return (int)launch_clusters(row_kernel<T, kLgG>, (unsigned)rows << lg_n1,
                              1 << kLgG, 2 * kZBytes<T>, s,
                              static_cast<const C*>(z), o, gt, at, bt, twc,
                              lg_n1, inverse, max_radix, start, k, grows);
}

}  // namespace

extern "C" {

// out is complex (rows, k), or real (rows, k) when ta and tb are given;
// tw is the length-n table, followed for n > 4096 by the 4096-point table;
// scratch (rows * n complex) is needed, and used, only when n > 65536 (it
// may be null otherwise)
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
