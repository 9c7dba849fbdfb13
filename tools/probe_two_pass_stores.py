#!/usr/bin/env python3
"""Where the long rows' Stockham FFT time goes, on one NVIDIA GPU.

    python3 tools/probe_two_pass_stores.py [tree]

Builds ``src/repro_torch/kernels/csrc/fft_stockham.cu`` of ``tree`` (this
checkout by default; e.g. ``git archive <commit>`` unpacked under
``build/``) several times: as it is, and with source edits that take one
piece of the long-row path away or change it.  Which edits apply depends
on the source's design, told apart by an anchor text:

- column stages (the column pass one stage per shared-memory sweep, the
  row pass storing each kernel row's bins N1 apart): "contiguous stores"
  stores each kernel row's kept bins contiguously (the same bytes in the
  same buffer at the wrong places: what the strided stores would cost if
  they were not strided; exact for the windows timed here, which start
  at bin 0 and hold a multiple of N1 bins); "pass 1 only" returns after
  the column pass.
- register columns (the column FFTs in registers, the row pass on
  clusters of G kernel rows that exchange their bins so that each block
  stores runs of G contiguous bins; as built G = 4 in float32): "G = g"
  builds the row pass with clusters of g blocks (g = 1: each block
  stores its own row's bins, N1 apart); "pass 1 only" returns after the
  column pass; "cluster b blocks an SM" builds the float32 cluster kernel
  for b blocks an SM (as built 4); "strided stores" has the cluster
  kernel's blocks store their own bins, N1 apart, at every length (as
  built they exchange them, but for the 8192-point post-twiddle), and
  "8192 twiddle exchanged" has that one exchange them too; "65536
  columns only" returns after the 16-block cluster's column step;
  "column pass 3 blocks an SM" and "row pass 3 blocks an SM" build pass
  1 or pass 2 for 3 blocks an SM (as built 2 in float32).  Rows of up
  to 65536 points run on one cluster and take no pass 1, so there the
  pass-2 variants time the same call.

A source edit whose text is not found where it is expected stops the
probe (a RuntimeError, exit 1) before anything is timed.

The calls, float32, at the bytes of chip_smoke.py's LONG_UUU and
LONG_SEMI calls: at 8192 points the pruned forward of 4160 complex rows,
the fused DCT-II window of 4096 real rows and the inverse of 4096
complex rows, the pruned forward of the same bytes at 16384 and 32768
points; at 65536 points the pruned forward of 520 complex rows,
the same fused with a Green plane, the fused DCT-II window of 512 real
rows and the inverse of 512 complex rows; at 131072 points the pruned
forward of 260 rows and the inverse of 256; at 2^20 points 32 and 32;
and in float64 the 131072-point pruned forward of 130 rows (the G
variants set float64's G too; as built it is 2).
Each time is the device time of 20 back-to-back calls between one event
pair, the median of 5 rounds taken in turn.  Pass 2 is the whole call
less pass 1.  Each call's plain PyTorch version (``kernels/ref.py``) is
timed beside it, the median of 3 single calls after one warm-up call,
and for the complex forward and inverse the ``torch.fft`` call of the
same transform (cuFFT), timed as the kernel is.  The bound is the call's
input and output bytes once at the HBM rate; the two-pass floor adds the
scratch buffer written and read once.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 20
ROUNDS = 5
# device-memory rate of an H100 SXM (bytes/s), NVIDIA's data sheet
HBM = 3.35e12

# the row pass's cluster sizes as built (log2 G: float32, float64)
ROW_GROUP = "constexpr int kRowGroupLg[2] = {2, 1};"
# the float32 cluster kernel's blocks an SM as built
CLUSTER_BLOCKS = ("template <typename T> struct ClusterBlocks { static "
                  "constexpr int value = 4; };")
# design -> (anchor text, {label: [(old, new, count)]}) of source edits
DESIGNS = {
    "column stages": ("stages<T>(src, dst, cols", {
        "as built": [],
        "contiguous stores": [(
            "if ((unsigned)b < k) out[b] =",
            "if ((unsigned)b < k) out[(b >> e.lg_n1) + (b & "
            "((1 << e.lg_n1) - 1)) * (e.k >> e.lg_n1)] =", 3)],
        "pass 1 only": [("  x = scratch;\n",
                         "  if (rows > 0) return 0;\n  x = scratch;\n", 1)],
    }),
    "register columns": ("row_kernel<T, kLgG>", {
        "as built": [],
        **{f"G = {g}": [(ROW_GROUP, "constexpr int kRowGroupLg[2] = {"
                         f"{lg}, {lg}}};", 1)]
           for lg, g in enumerate((1, 2, 4, 8, 16)) if g != 4},
        "pass 1 only": [("  // pass 2: the rows of Z\n",
                         "  if (rows > 0) return 0;\n", 1)],
        **{f"cluster {b} blocks an SM": [(
            CLUSTER_BLOCKS, CLUSTER_BLOCKS.replace("4", str(b)), 1)]
           for b in (2, 3)},
        "strided stores": [("    if constexpr (kLgN1 < kExchangeLgN1) {\n"
                            "      if (ta != nullptr)",
                            "    if constexpr (true) {\n      if (true)", 1)],
        "8192 twiddle exchanged": [("constexpr int kExchangeLgN1 = 2;",
                                    "constexpr int kExchangeLgN1 = 1;", 1)],
        **{f"{kern} pass 3 blocks an SM": [(
            f"CoreBlocks<T>::value)\n{kern}_kernel(",
            f"3)\n{kern}_kernel(", 1)] for kern in ("column", "row")},
        "65536 columns only": [(
            "  // the row pass on Z[c, :]: kernel row (r, c)",
            "  if (kLgN1 == 4) return;\n  // the row pass on Z[c, :]: kernel"
            " row (r, c)", 1)],
    }),
}


def variants_of(src):
    """The design of ``src`` and its variants' edits."""
    for design, (anchor, variants) in DESIGNS.items():
        if anchor in src:
            return design, variants
    raise RuntimeError("fft_stockham.cu: neither design's anchor found ("
                       + ", ".join(a for a, _ in DESIGNS.values()) + ")")


def build(nvcc, flags, tree, out_dir):
    src = (tree / "src/repro_torch/kernels/csrc/fft_stockham.cu").read_text()
    design, variants = variants_of(src)
    procs = {}
    for i, (label, edits) in enumerate(variants.items()):
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{label}: expected {count} x {old!r} in "
                                   "fft_stockham.cu")
            text = text.replace(old, new)
        cu = out_dir / f"stockham_variant{i}.cu"
        cu.write_text(text)
        so = out_dir / f"libstockham_variant{i}.so"
        procs[label] = (so, subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {label} variant:\n{out}")
        libs[label] = ctypes.CDLL(str(so))
    return design, libs


def main() -> int:
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("probe_two_pass_stores.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.fft_stockham import kernel_twiddles

    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    design, libs = build(_build._nvcc(), _build.NVCC_FLAGS, tree, out_dir)
    fns = {}
    for label, lib in libs.items():
        for rdt, name in ((torch.float32, "repro_fft_stockham_f32"),
                          (torch.float64, "repro_fft_stockham_f64")):
            fn = getattr(lib, name)
            fn.argtypes = _build._SIGNATURES[name]
            fn.restype = ctypes.c_int
            fns[label, rdt] = fn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; tree: {tree} ({design})")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    null = None

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    # label, x, n_fft, inverse, kept bins, post-twiddle tables, Green plane
    cases = []
    # the cluster tier's calls below 65536 points (LONG_UUU's and
    # LONG_SEMI's at 8192, the same bytes at 16384 and 32768)
    cases.append(("pruned forward", randn((4160, 4096), torch.complex64),
                  8192, 0, 8192, None, None))
    cases.append(("fused DCT-II", randn((4096, 8192), torch.float32), 8192,
                  0, 4096, randn((2, 4096), torch.float32), None))
    cases.append(("inverse", randn((4096, 8192), torch.complex64), 8192, 1,
                  8192, None, None))
    for n, rows in ((16384, 1040), (32768, 520)):
        cases.append(("pruned forward",
                      randn((rows, n // 2), torch.complex64), n, 0, n, None,
                      None))
    n = 65536
    x = randn((520, n // 2), torch.complex64)
    cases.append(("pruned forward", x, n, 0, n, None, None))
    cases.append(("pruned forward x Green", x, n, 0, n, None,
                  randn((520, n), torch.float32)))
    cases.append(("fused DCT-II", randn((512, n), torch.float32), n, 0,
                  n // 2, randn((2, n // 2), torch.float32), None))
    cases.append(("inverse", randn((512, n), torch.complex64), n, 1, n,
                  None, None))
    for n, rows in ((2 ** 17, (260, 256)), (2 ** 20, (32, 32))):
        cases.append(("pruned forward",
                      randn((rows[0], n // 2), torch.complex64), n, 0, n,
                      None, None))
        cases.append(("inverse", randn((rows[1], n), torch.complex64), n,
                      1, n, None, None))
    # float64 at the 131072-point forward's bytes (the row pass's G for
    # complex128)
    cases.append(("pruned forward", randn((130, 2 ** 16), torch.complex128),
                  2 ** 17, 0, 2 ** 17, None, None))

    def loop_ms(fn):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(REPS):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / REPS

    for label, x, nf, inverse, k, ab, g in cases:
        rows, n_in = x.shape
        cdt = torch.complex128 if x.dtype in (
            torch.float64, torch.complex128) else torch.complex64
        rdt = torch.float64 if cdt == torch.complex128 else torch.float32
        tw = kernel_twiddles(nf, cdt, dev)
        real_out = ab is not None
        out = torch.empty((rows, k), device=dev,
                          dtype=rdt if real_out else cdt)
        scratch = torch.empty(rows * nf, dtype=cdt, device=dev)
        a_ptr = ab[0].data_ptr() if real_out else null
        b_ptr = ab[1].data_ptr() if real_out else null

        def call(fn):
            def run():
                err = fn(x.data_ptr(), int(x.is_complex()), out.data_ptr(),
                         null if g is None else g.data_ptr(), a_ptr, b_ptr,
                         tw.data_ptr(), scratch.data_ptr(), rows, n_in, nf,
                         inverse, 4, 0, k, rows if g is not None else 1,
                         stream)
                if err:
                    raise RuntimeError(f"launch: CUDA error {err}")
            return run
        runs = {v: call(fn) for (v, dt), fn in fns.items() if dt == rdt}
        for run in runs.values():
            run()
        times = {v: [] for v in runs}
        for _ in range(ROUNDS):
            for v, run in runs.items():
                times[v].append(loop_ms(run))
        med = {v: statistics.median(t) for v, t in times.items()}
        byts = sum(t.numel() * t.element_size()
                   for t in (x, out, ab, g) if t is not None)
        z = 2 * rows * nf * scratch.element_size()
        whole, p1 = med["as built"], med["pass 1 only"]
        print(f"{label}: x {tuple(x.shape)} {x.dtype}, {nf} points, "
              f"{byts / 1e6:.1f} MB, bound {byts / HBM * 1e3:.4f} ms, "
              f"two-pass floor {(byts + z) / HBM * 1e3:.4f} ms")
        line = (f"  whole call {whole:.4f} ms; pass 1 {p1:.4f} ms, pass 2 "
                f"{whole - p1:.4f} ms")
        if "contiguous stores" in med:
            contig = med["contiguous stores"]
            line += (f"; contiguous stores {contig:.4f} ms, so the strided "
                     f"stores cost {whole - contig:.4f} ms "
                     f"({(whole - contig) / whole:.0%} of the call)")
        print(line)
        for v, t in times.items():
            print(f"    {v:18s} median {med[v]:.4f}: "
                  + " ".join(f"{u:.4f}" for u in t))
        # the plain version of the same call (the wrappers' arguments)
        if g is not None:
            plain = lambda: ref.fft_stockham_scale(  # noqa: E731
                x, g, pad_to=nf)
        elif real_out:
            plain = lambda: ref.fft_stockham_twiddle(  # noqa: E731
                x, ab[0], ab[1])
        else:
            plain = lambda: ref.fft_stockham(  # noqa: E731
                x, inverse=bool(inverse),
                pad_to=nf if n_in < nf else None)
        plain()  # warm, as the kernel calls are
        ts = []
        for _ in range(3):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            s.record()
            plain()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        print(f"  plain version {statistics.median(ts):.4f} ms "
              "(median of 3 single calls)")
        # the one PyTorch call that computes the same function, where
        # there is one (cuFFT), timed as the kernel is
        if g is None and not real_out:
            lib = torch.fft.ifft if inverse else torch.fft.fft
            t_lib = statistics.median(
                loop_ms(lambda: lib(x, n=nf)) for _ in range(ROUNDS))
            print(f"  library call (torch.fft, cuFFT) {t_lib:.4f} ms "
                  f"(median of {ROUNDS} rounds of {REPS} calls)")
        del scratch, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
