#!/usr/bin/env python3
"""Run the Stockham kernel's CUDA source on the CPU, thread for thread,
against its plain version, bit for bit.

    python3 tools/emulate_stockham.py [--quick] [--lengths N ...]

There is no GPU or ``nvcc`` needed: the script compiles
``src/repro_torch/kernels/csrc/fft_stockham.cu`` with ``g++ -std=c++20
-O1`` after textual substitutions and an emulation header.  Every CUDA
thread is a host thread (``threadIdx``, ``blockIdx``, ``blockDim`` and
``gridDim`` are thread-local); ``__syncthreads`` is a ``std::barrier`` over
the block's threads; a launch, ``<<<...>>>`` or ``cudaLaunchKernelEx``,
runs the grid one thread-block cluster at a time, all the cluster's
blocks at once (a plain launch: clusters of one block).  The PTX helpers
(between ``shared_addr`` and the cluster kernel's column FFTs) are
replaced: each block's shared memory is one array filled with NaN bytes;
a bulk copy is a ``memcpy`` deferred to the first ``bar_wait`` of its
mbarrier phase, its bytes checked against the expected count; the
cluster rank is thread-local; ``map_rank`` encodes (rank << 24 | offset)
into the cluster's array of blocks for ``store_remote``; the cluster
barrier is the ``arrive()`` / ``wait(token)`` of one ``std::barrier`` over
all the cluster's threads, and a wait without an arrive, or a thread that
exits with an arrive pending, aborts.  It finds wrong indices, missing
barriers and races that change values (NaN from unwritten shared memory
reaches the output); it says nothing of speed.

The C entry points are then called through ``ctypes`` on CPU tensors, with
the wrapper's tables (``kernel_twiddles``), and each result is compared
with ``kernels/ref.py`` by ``torch.equal``: the host compiler contracts no
multiply-add at this target, so the kernel's arithmetic is the plain
version's, operation for operation.  The cases: every tier's lengths
(one-pass 16 and 4096, cluster 8192 to 65536, two-pass 131072 to 2^20),
float32 and float64, the forward, inverse, pruned, real-input ``keep``
window, the Green epilogue (start 0 on the pruned half spectrum, start 1
on an interior window) and the twiddle epilogue (the DCT-II, DCT-I and
DST-II windows), radix 4 and, on the pruned forward, radix 2.  Prints one
line per case and exits 1 on the first difference.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/fft_stockham.cu"

HEADER = r"""
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <optional>
#include <pthread.h>
#include <stdint.h>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) alignas(n)

struct float2 { float x, y; };
struct double2 { double x, y; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize,
                         cudaFuncAttributeNonPortableClusterSizeAllowed };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  int id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

thread_local uint3 threadIdx, blockIdx;
thread_local dim3 blockDim, gridDim;

struct EmuBar {  // an mbarrier of one arrival a phase, and its bulk copies
  std::mutex m;
  std::vector<std::pair<std::pair<void*, const void*>, uint32_t>> copies;
  int64_t tx = 0;    // bytes expected and not yet arrived
  int pending = 1;    // arrivals the current phase still needs
  int completed = 0;  // phases completed
  void complete() {
    if (pending == 0 && tx == 0) {
      ++completed;
      pending = 1;
    }
  }
};
struct EmuBlock {
  unsigned char* smem;
  size_t smem_bytes;
  std::barrier<>* bar;
  std::mutex m;
  std::vector<std::pair<uintptr_t, EmuBar*>> mbars;
};
struct EmuCluster {
  std::vector<EmuBlock>* blocks;
  std::barrier<>* bar;
};
thread_local EmuBlock* emu_blk;
thread_local EmuCluster emu_cl;
thread_local int emu_rank;
thread_local std::optional<std::barrier<>::arrival_token> emu_token;

// cp.async: a thread's element copies: those of its open group, then its committed
// groups in order; a group's copies are made when a wait retires it, so
// a read of the destination before the wait sees the old bytes
struct EmuCopy {
  void* dst;
  const void* src;
  uint32_t bytes;
};
thread_local std::vector<EmuCopy> emu_open;
thread_local std::vector<std::vector<EmuCopy>> emu_groups;


static void emu_fail(const char* what) {
  std::fprintf(stderr, "emulation: %s (block %u thread %u)\n", what,
               blockIdx.x, threadIdx.x);
  std::abort();
}
inline unsigned char* emu_smem() { return emu_blk->smem; }
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
using std::min;

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// two SMs: a persistent grid's blocks each take several row-blocks
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2; return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t smem) {
  *n = smem <= 232448 ? 1 : 0;
  return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveClusters(
    int* n, K, const cudaLaunchConfig_t* cfg) {
  *n = (cfg->attrs[0].val.clusterDim.x <= 16 &&
        cfg->dynamicSmemBytes <= 232448) ? 1 : 0;
  return cudaSuccess;
}

template <typename F>
struct EmuThread {
  F* f;
  EmuBlock* blk;
  EmuCluster cl;
  int rank;
  unsigned t, b;
  dim3 grid, block;
};
template <typename F>
void* emu_thread_main(void* arg) {
  auto* a = static_cast<EmuThread<F>*>(arg);
  threadIdx = {a->t, 0, 0};
  blockIdx = {a->b, 0, 0};
  blockDim = a->block;
  gridDim = a->grid;
  emu_blk = a->blk;
  emu_cl = a->cl;
  emu_rank = a->rank;
  emu_token.reset();
  emu_open.clear();
  emu_groups.clear();
  (*a->f)();
  if (emu_token) emu_fail("exit with a cluster arrive pending");
  return nullptr;
}

// the grid in clusters of `cluster` blocks, a cluster's blocks at once
template <typename... P, typename... A>
void emu_run(void (*k)(P...), dim3 grid, dim3 block, size_t smem,
             unsigned cluster, A... args) {
  if (grid.x % cluster) emu_fail("grid not a multiple of the cluster");
  const unsigned nt = block.x;
  auto body = [&]() { k(args...); };
  using F = decltype(body);
  pthread_attr_t attr;
  pthread_attr_init(&attr);
  pthread_attr_setstacksize(&attr, 1 << 20);
  for (unsigned c0 = 0; c0 < grid.x; c0 += cluster) {
    std::vector<EmuBlock> blocks(cluster);
    std::vector<std::vector<unsigned char>> mem(cluster);
    std::barrier<> cbar(cluster * nt);
    for (unsigned i = 0; i < cluster; ++i) {
      mem[i].assign(smem + 16, 0xff);  // NaN bytes
      blocks[i].smem = mem[i].data();
      blocks[i].smem_bytes = smem;
      blocks[i].bar = new std::barrier<>(nt);
    }
    EmuCluster cl{&blocks, &cbar};
    std::vector<EmuThread<F>> ts(cluster * nt);
    std::vector<pthread_t> ids(cluster * nt);
    for (unsigned i = 0; i < cluster * nt; ++i) {
      ts[i] = EmuThread<F>{&body, &blocks[i / nt], cl, (int)(i / nt),
                           i % nt, c0 + i / nt, grid, block};
      if (pthread_create(&ids[i], &attr, emu_thread_main<F>, &ts[i]))
        emu_fail("pthread_create");
    }
    for (auto& id : ids) pthread_join(id, nullptr);
    for (auto& b : blocks) {
      delete b.bar;
      for (auto& m : b.mbars) delete m.second;
    }
  }
  pthread_attr_destroy(&attr);
}

template <typename K>
struct EmuLaunch {
  K k;
  dim3 grid, block;
  size_t smem;
  template <typename... A> void operator()(A... a) {
    emu_run(k, grid, block, smem, 1, a...);
  }
};
template <typename K>
EmuLaunch<K> emu_launch(K k, dim3 grid, dim3 block, size_t smem,
                        cudaStream_t) {
  return EmuLaunch<K>{k, grid, block, smem};
}
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*k)(P...), A... a) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = cfg->attrs[i].val.clusterDim.x;
  emu_run(k, cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, cluster,
          a...);
  return cudaSuccess;
}
"""

# the PTX helpers, emulated
PTX = r"""
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  const unsigned char* q = static_cast<const unsigned char*>(p);
  if (q < emu_blk->smem || q >= emu_blk->smem + emu_blk->smem_bytes)
    emu_fail("shared_addr outside the block's shared memory");
  return (uint32_t)(q - emu_blk->smem);
}

static EmuBar* emu_bar(uint64_t* bar) {
  std::lock_guard<std::mutex> g(emu_blk->m);
  for (auto& m : emu_blk->mbars)
    if (m.first == (uintptr_t)bar) return m.second;
  emu_blk->mbars.push_back({(uintptr_t)bar, new EmuBar});
  return emu_blk->mbars.back().second;
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  shared_addr(bar);
  EmuBar* b = emu_bar(bar);
  std::lock_guard<std::mutex> g(b->m);
  b->copies.clear();
  b->tx = 0;
  b->pending = 1;
  b->completed = 0;
}

// one thread: arrive on bar expecting `bytes`, copied from src to dst
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  shared_addr(dst);
  shared_addr(static_cast<unsigned char*>(dst) + bytes - 1);
  if (bytes % 16 || (uintptr_t)src % 16 || shared_addr(dst) % 16)
    emu_fail("bulk copy not 16-byte aligned");
  EmuBar* b = emu_bar(bar);
  std::lock_guard<std::mutex> g(b->m);
  if (b->pending != 1 || !b->copies.empty())
    emu_fail("a second fill of a pending phase");
  b->tx += bytes;
  b->pending = 0;
  b->copies.push_back({{dst, src}, bytes});
}

// the phase of this parity complete: the first waiter makes the deferred
// bulk copies, which complete it
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  EmuBar* b = emu_bar(bar);
  std::lock_guard<std::mutex> g(b->m);
  for (auto& c : b->copies) {
    std::memcpy(c.first.first, c.first.second, c.second);
    b->tx -= c.second;
  }
  b->copies.clear();
  b->complete();
  if (b->completed == 0 || ((b->completed - 1) & 1) != (int)parity)
    emu_fail("wait on a phase no copy completes");
}

template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  shared_addr(static_cast<unsigned char*>(dst) + kBytes - 1);
  if ((uintptr_t)src % kBytes || shared_addr(dst) % kBytes)
    emu_fail("cp.async not aligned to its size");
  emu_open.push_back({dst, src, (uint32_t)kBytes});
}

__device__ __forceinline__ void copy_commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  while ((int)emu_groups.size() > kPending) {
    for (auto& c : emu_groups.front()) std::memcpy(c.dst, c.src, c.bytes);
    emu_groups.erase(emu_groups.begin());
  }
}

__device__ __forceinline__ uint32_t cluster_rank() { return emu_rank; }

__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  if (rank >= emu_cl.blocks->size()) emu_fail("map_rank outside the cluster");
  return (rank << 24) | shared_addr(p);
}

template <typename V>
static void emu_store_remote(uint32_t a, V v) {
  EmuBlock& b = (*emu_cl.blocks)[a >> 24];
  const uint32_t off = a & 0xffffff;
  if (off + sizeof(V) > b.smem_bytes) emu_fail("remote store out of range");
  std::memcpy(b.smem + off, &v, sizeof(V));
}
__device__ __forceinline__ void store_remote(uint32_t a, float2 v) {
  emu_store_remote(a, v);
}
__device__ __forceinline__ void store_remote(uint32_t a, double2 v) {
  emu_store_remote(a, v);
}

__device__ __forceinline__ void cluster_arrive() {
  if (emu_token) emu_fail("cluster arrive twice");
  emu_token.emplace(emu_cl.bar->arrive());
}
__device__ __forceinline__ void cluster_arrive_relaxed() { cluster_arrive(); }
__device__ __forceinline__ void cluster_wait() {
  if (!emu_token) emu_fail("cluster wait without an arrive");
  emu_cl.bar->wait(std::move(*emu_token));
  emu_token.reset();
}

"""


def emulated_source(text: str) -> str:
    """The kernel source with the emulation's substitutions made."""
    a = text.index("__device__ __forceinline__ uint32_t shared_addr")
    b = text.index("// The cluster kernel's column FFTs")
    b = text.rindex("// ----", a, b)
    text = text[:a] + PTX + text[b:]
    text = text.replace("#include <cuda_runtime.h>", HEADER)
    n = text.count("extern __shared__ __align__(16) unsigned char "
                   "smem_raw[];")
    if n == 0:
        raise RuntimeError("no dynamic shared memory declaration found")
    text = text.replace("extern __shared__ __align__(16) unsigned char "
                        "smem_raw[];", "unsigned char* smem_raw = "
                        "emu_smem();")
    text, n = re.subn(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2)(", text,
                      flags=re.S)
    if n == 0:
        raise RuntimeError("no <<<...>>> launch found")
    if "asm" in re.sub(r"//.*", "", text):
        raise RuntimeError("inline PTX left outside the emulated helpers")
    return text


def build(out_dir: Path) -> Path:
    cc = out_dir / "fft_stockham_emulated.cc"
    cc.write_text(emulated_source(SRC.read_text()))
    so = out_dir / "libstockham_emulated.so"
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                        "-pthread", "-Wno-unknown-pragmas", "-o", str(so),
                        str(cc)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed:\n{r.stderr[-6000:]}")
    return so


# the short tier's lengths and the other tiers' default lengths
SHORT_LENGTHS = (2, 4, 8, 16, 32, 64, 128)
LONG_LENGTHS = (4096, 8192, 16384, 32768, 65536, 2 ** 17, 2 ** 18, 2 ** 20)
# rows of a short-row case (257, or 3000 and at most 48000 points): no
# multiple of a row-block's rows, and more row-blocks than the emulated
# card's persistent blocks
SHORT_ROWS = (257, 3000)
SHORT_POINTS = 48000


def bind(so: Path):
    """The built library's two entry points, by real dtype."""
    import torch
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(so))
    fns = {}
    for dt, name in ((torch.float32, "repro_fft_stockham_f32"),
                     (torch.float64, "repro_fft_stockham_f64")):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
        fns[dt] = fn
    return fns


def cases(n: int, rdt, rng):
    """(label, keyword arguments) of every case of transform length ``n``
    in precision ``rdt``: x (rows, n or n / 2 pruned), and pad_to,
    inverse, keep, max_radix as ``ref.fft_stockham`` takes them, or g
    (grows, k) and start (the Green epilogue), or ab = (start, k) (the
    twiddle epilogue).  Short lengths (up to 128 points) take 257 rows
    or 3000 (at most 48000 points) and add the radix-2 forward,
    the real input with ``keep`` and inputs one element off 16-byte
    alignment; longer ones take 3, 2 or 1 rows."""
    import torch
    from repro_torch.kernels import ref
    cdt = ref._cdt(rdt)
    short = n <= SHORT_LENGTHS[-1]

    def rnd(shape, dtype, misaligned=False):
        if misaligned:
            numel = 1
            for s in shape:
                numel *= s
            return rnd((numel + 1,), dtype)[1:].view(shape)
        if dtype.is_complex:
            return torch.complex(*(torch.from_numpy(
                rng.standard_normal(shape)).to(rdt) for _ in range(2)))
        return torch.from_numpy(rng.standard_normal(shape)).to(rdt)
    h = max(n // 2, 1)
    out = []
    for i, (label, make) in enumerate([
        ("pruned forward", lambda r: dict(x=rnd((r, h), cdt), pad_to=n)),
        ("forward", lambda r: dict(x=rnd((r, n), cdt))),
        ("inverse", lambda r: dict(x=rnd((r, n), cdt), inverse=True)),
        ("pruned inverse keep", lambda r: dict(x=rnd((r, n), cdt),
                                               inverse=True, keep=h)),
        ("real pruned keep", lambda r: dict(x=rnd((r, h), rdt), pad_to=n,
                                            keep=h + 1)),
        ("real keep", lambda r: dict(x=rnd((r, n), rdt), keep=h + 1)),
        ("pruned forward radix 2", lambda r: dict(x=rnd((r, h), cdt),
                                                  pad_to=n, max_radix=2)),
        ("forward radix 2", lambda r: dict(x=rnd((r, n), cdt),
                                           max_radix=2)),
        ("Green, pruned, start 0", lambda r: dict(
            x=rnd((2 * r, h), cdt), pad_to=n, g=rnd((r, h + 1), rdt),
            start=0)),
        ("Green, start 1", lambda r: dict(x=rnd((r, n), cdt),
                                          g=rnd((1, n - 1), rdt), start=1)),
        ("twiddle DCT-II, pruned", lambda r: dict(x=rnd((r, h), rdt),
                                                  pad_to=n, ab=(0, h))),
        ("twiddle DCT-I", lambda r: dict(x=rnd((r, n), rdt), ab=(0, h + 1))),
        ("twiddle DST-II", lambda r: dict(x=rnd((r, n), rdt), ab=(1, h))),
        ("misaligned forward", lambda r: dict(
            x=rnd((r, n), cdt, True))),
        ("misaligned real pruned keep", lambda r: dict(
            x=rnd((r, h), rdt, True), pad_to=n, keep=h + 1)),
    ]):
        if ("radix 2" in label and n == 2
                or label == "misaligned forward" and rdt == torch.float64
                or not short and (
                "misaligned" in label or label == "forward radix 2"
                or label == "real keep")):
            continue
        if short:
            rows = min(SHORT_ROWS[i % 2], SHORT_POINTS // n)
        else:
            rows = 3 if n <= 2 ** 17 else 2 if n <= 2 ** 18 else 1
        kw = make(rows)
        if "ab" in kw:
            start, k = kw["ab"]
            kw["ab"] = (start, rnd((k,), rdt), rnd((k,), rdt))
        out.append((label, kw))
    return out


def run_case(fns, n: int, kw: dict):
    """The kernel's output for case ``kw`` (see ``cases``) against
    ``kernels/ref.py``'s: (bit-equal, error code, max |difference|)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fft_stockham import kernel_twiddles
    kw = dict(kw)
    x = kw.pop("x")
    pad = kw.get("pad_to")
    g = kw.pop("g", None)
    start = kw.pop("start", 0)
    ab = kw.pop("ab", None)
    radix = kw.get("max_radix", 4)
    rdt = ref._rdt(x)
    cdt = ref._cdt(rdt)
    a = b = None
    if g is not None:
        want = ref.fft_stockham_scale(x, g, start=start, pad_to=pad,
                                      max_radix=radix)
        k, grows = g.shape[1], g.shape[0]
    elif ab is not None:
        start, a, b = ab
        k = a.shape[0]
        want = ref.fft_stockham_twiddle(x, a, b, start=start, pad_to=pad,
                                        max_radix=radix)
        grows = 1
    else:
        want = ref.fft_stockham(x, **kw)
        k, grows = want.shape[1], 1
    out = torch.empty(want.shape, dtype=want.dtype)
    tw = kernel_twiddles(n, cdt, torch.device("cpu"))
    scratch = torch.empty(x.shape[0] * n if n > 65536 else 1, dtype=cdt)
    err = fns[rdt](
        x.data_ptr(), int(x.is_complex()), out.data_ptr(),
        None if g is None else g.data_ptr(),
        None if a is None else a.data_ptr(),
        None if b is None else b.data_ptr(), tw.data_ptr(),
        scratch.data_ptr(), x.shape[0], x.shape[1], n,
        int(kw.get("inverse", False)), radix, start, k, grows, None)
    same = err == 0 and torch.equal(out, want)
    d = (out - want).abs().max().item() if err == 0 else float("nan")
    return same, err, d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="one case per length and precision")
    ap.add_argument("--lengths", type=int, nargs="*", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fns = bind(build(Path(tmp)))
        print(f"built in {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(0)
        lengths = args.lengths or SHORT_LENGTHS + LONG_LENGTHS
        n_cases = 0
        for rdt in (torch.float32, torch.float64):
            for n in lengths:
                todo = cases(n, rdt, rng)
                if args.quick:
                    todo = todo[:1]
                for label, kw in todo:
                    t1 = time.perf_counter()
                    same, err, d = run_case(fns, n, kw)
                    print(f"{rdt} N={n} {label}: rows {kw['x'].shape[0]}: "
                          f"{'bit-equal' if same else 'DIFFERS'} "
                          f"(err {err}, max |d| {d:.3e}) in "
                          f"{time.perf_counter() - t1:.1f} s", flush=True)
                    n_cases += 1
                    if not same:
                        return 1
        print(f"all {n_cases} cases bit-equal to kernels/ref.py")
    return 0


if __name__ == "__main__":
    sys.exit(main())
