#!/usr/bin/env python3
"""The Stockham kernel of this checkout against other checkouts', in
turns, on one NVIDIA GPU.

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_stockham.py build/parent [build/variant ...]
        [--only short|long] [--plain]

Builds ``src/repro_torch/kernels/csrc/fft_stockham.cu`` of every tree,
binds each with the C signature its source declares (with the long
rows' scratch pointer or without it), and times the calls of
chip_smoke.py's solves, in the order other trees, this, this, other
trees reversed, three times over.  The first tree named is the parent:
each time is also given as a ratio to its time.

The long cases (``--only long``), float32: the one-pass calls of (U,U,U)
256^3 (the pruned real forward, the pruned complex forward, the pruned
forward fused with the Green multiply, the two inverse shapes) and
SEMI_E's fused DCT-II; the 8192-point calls of LONG_UUU (the pruned
forward, and the same call fused with a Green plane, which no solve
runs) and LONG_SEMI (the fused DCT-II and the inverse), pruned forwards
of the same bytes as LONG_UUU's at 16384 and 32768 points, and the long
rows' pruned forward and inverse at the same bytes at 65536 (LONG_XL_UUU's
forward; 520 and 512 rows), 131072 (LONG_XXL_UUU's; 260 and 256) and
2^20 points (32 and 32); float64, the NODE HEJ4 n=64 calls (the real and
complex 128-point forwards, the inverse, and the semi-even case's fused
DCT-I on 256 points).

The short cases (``--only short``): LONG_XL_UUU's calls on its 16-point
directions (the real pruned 16 -> 32 forward keeping 17 bins, the pruned
complex forward fused with its Green plane, and the two 16-point inverse
halves' shapes), LONG_UUU's on its 64-point directions (the same four on
64 and 128 points), and a sweep of complex forwards of 2 to 256 points
on 2^20 rows or more (2^24 points at least: more than the L2 cache
holds), float32 and float64.

Each time is the device time of 20 back-to-back calls
between one event pair after a device sleep; the script prints every
time, the ratio of the medians to the parent's and each build's share of
the call's bound (its input and output bytes once at the HBM rate), and
the ``torch.fft`` call of the same function where one exists (cuFFT:
``rfft`` / ``fft`` / ``ifft`` with the ``n=`` that pads the pruned
input; for a Green-fused call the FFT alone, without the multiply),
timed as the kernels are, and with ``--plain`` the plain version's
(``kernels/ref.py`` on the same inputs: one warm-up call, then the
median of three single calls).  Every long-row call is given a scratch
buffer, which a tree takes where its rows run in two passes, and the
wrapper's twiddle table (``kernel_twiddles``).  Every build's output is
compared with this tree's before timing (long rows only with trees whose
source takes a scratch pointer).  The ptxas lines (registers, spills)
of this tree's short-row kernels are printed after the build.  Exits 2
without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 20
ROUNDS = 3
# device-memory rate of an H100 SXM (bytes/s), NVIDIA's data sheet
HBM = 3.35e12
# the longest row the short cases take
SHORT_N = 256


def _cases(torch):
    f32, c64 = torch.float32, torch.complex64
    f64, c128 = torch.float64, torch.complex128
    # label, x shape and dtype, n_fft, inverse, kept bins, Green rows,
    # twiddle-table bins (the r2r epilogue)
    cases = [
        ("(U,U,U) real pruned forward", (65536, 256), f32, 512, 0, 257, 0, 0),
        ("(U,U,U) pruned forward", (65792, 256), c64, 512, 0, 512, 0, 0),
        ("(U,U,U) pruned forward x Green", (131584, 256), c64, 512, 0, 512,
         131584, 0),
        ("(U,U,U) inverse, 131584 rows", (131584, 256), c64, 256, 1, 256, 0,
         0),
        ("(U,U,U) inverse, 65792 rows", (65792, 256), c64, 256, 1, 256, 0, 0),
        ("SEMI_E fused DCT-II", (65536, 1024), f32, 1024, 0, 512, 0, 512),
        ("LONG_UUU pruned forward", (4160, 4096), c64, 8192, 0, 8192, 0, 0),
        ("LONG_UUU pruned forward x Green", (4160, 4096), c64, 8192, 0,
         8192, 4160, 0),
        ("LONG_SEMI fused DCT-II", (4096, 8192), f32, 8192, 0, 4096, 0,
         4096),
        ("LONG_SEMI inverse", (4096, 8192), c64, 8192, 1, 8192, 0, 0),
        ("16384-point pruned forward", (1040, 8192), c64, 16384, 0, 16384,
         0, 0),
        ("32768-point pruned forward", (520, 16384), c64, 32768, 0, 32768,
         0, 0),
        ("65536-point pruned forward", (520, 32768), c64, 65536, 0, 65536,
         0, 0),
        ("65536-point inverse", (512, 65536), c64, 65536, 1, 65536, 0, 0),
        ("131072-point pruned forward", (260, 65536), c64, 2 ** 17, 0,
         2 ** 17, 0, 0),
        ("131072-point inverse", (256, 2 ** 17), c64, 2 ** 17, 1, 2 ** 17,
         0, 0),
        ("2^20-point pruned forward", (32, 2 ** 19), c64, 2 ** 20, 0,
         2 ** 20, 0, 0),
        ("2^20-point inverse", (32, 2 ** 20), c64, 2 ** 20, 1, 2 ** 20, 0,
         0),
        ("NODE real forward", (4225, 128), f64, 128, 0, 65, 0, 0),
        ("NODE forward", (8320, 128), c128, 128, 0, 128, 0, 0),
        ("NODE inverse", (8320, 128), c128, 128, 1, 128, 0, 0),
        ("NODE_SEMI_E fused DCT-I", (4225, 256), f64, 256, 0, 129, 0, 129),
    ]
    # the short rows: LONG_XL_UUU (32768x16x16) and LONG_UUU (4096x64x64)
    # on their short directions, in the order a solve calls them
    short = [
        ("LONG_XL_UUU real pruned forward", (524288, 16), f32, 32, 0, 17,
         0, 0),
        ("LONG_XL_UUU pruned forward x Green", (1114112, 16), c64, 32, 0,
         32, 1114112, 0),
        ("LONG_XL_UUU inverse, 1114112 rows", (1114112, 16), c64, 16, 1,
         16, 0, 0),
        ("LONG_XL_UUU inverse, 524288 rows", (524288, 16), c64, 16, 1, 16,
         0, 0),
        ("LONG_UUU real pruned forward", (262144, 64), f32, 128, 0, 65, 0,
         0),
        ("LONG_UUU pruned forward x Green", (532480, 64), c64, 128, 0, 128,
         532480, 0),
        ("LONG_UUU inverse, 532480 rows", (532480, 64), c64, 64, 1, 64, 0,
         0),
        ("LONG_UUU inverse, 262144 rows", (262144, 64), c64, 64, 1, 64, 0,
         0),
    ]
    # at least 2^20 rows, and 2^24 points: more bytes than the L2 cache
    # holds, so that back-to-back calls read device memory
    for rdt, cdt in ((f32, c64), (f64, c128)):
        n = 2
        while n <= SHORT_N:
            rows = max(2 ** 20, 2 ** 24 // n)
            short.append((f"{n}-point forward, {cdt}", (rows, n), cdt, n,
                          0, n, 0, 0))
            n *= 2
    return cases, short


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trees", nargs="+", type=Path,
                    help="other checkouts, the parent first")
    ap.add_argument("--only", choices=("short", "long"), default=None)
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain versions (kernels/ref.py)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("compare_stockham.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.fft_stockham import kernel_twiddles

    out_dir = ROOT / "build" / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {}
    for i, tree in enumerate(args.trees):
        name = tree.resolve().name
        trees[name if name not in trees else f"{name}{i}"] = tree.resolve()
    if "this" in trees:
        raise SystemExit("name no other tree 'this'")
    others = list(trees)
    parent = others[0]
    trees["this"] = ROOT
    procs, libs = {}, {}
    for label, tree in trees.items():
        src = tree / "src/repro_torch/kernels/csrc/fft_stockham.cu"
        so = out_dir / f"libstockham_{label}.so"
        procs[label] = (src, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    P, I = ctypes.c_void_p, ctypes.c_int
    for label, (src, so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        if label == "this":
            # registers and spills of the short-row kernels
            lines = out.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and "short" in line:
                    print(f"ptxas {line.split(chr(39))[1]}: " + "; ".join(
                        s.split("info    : ")[-1].strip()
                        for s in lines[i + 1:i + 4]
                        if "registers" in s or "spill" in s))
        scratch = "void* scratch" in src.read_text()
        lib = ctypes.CDLL(str(so))
        fns = {}
        for dt, name in ((torch.float32, "repro_fft_stockham_f32"),
                         (torch.float64, "repro_fft_stockham_f64")):
            fn = getattr(lib, name)
            fn.argtypes = ([P, I, P, P, P, P, P] + ([P] if scratch else [])
                           + [I] * 8 + [P])
            fn.restype = ctypes.c_int
            fns[dt] = fn
        libs[label] = (fns, scratch)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; parent: {trees[parent]}; others: "
          + ", ".join(f"{k} = {trees[k]}" for k in others[1:]))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases, short = _cases(torch)
    cases = {"long": cases, "short": short,
             None: cases + short}[args.only]

    def loop_ms(fn, reps=REPS):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    order = others + ["this", "this"] + others[::-1]
    for label, shape, dt, nf, inverse, k, grows, r2r in cases:
        rows, n_in = shape
        rdt = ref._rdt(torch.empty(0, dtype=dt))
        cdt = ref._cdt(rdt)
        x = torch.randn(shape, dtype=dt, device=dev)
        g = (torch.randn((grows, k), dtype=rdt, device=dev) if grows
             else None)
        ab = torch.randn((2, r2r), dtype=rdt, device=dev) if r2r else None
        tw = kernel_twiddles(nf, cdt, dev)
        scratch = (torch.empty(rows * nf, dtype=cdt, device=dev)
                   if nf > ref.ONE_PASS_N else None)
        if scratch is not None and not all(s for _, s in libs.values()):
            print(f"{label}: skipped, a tree has no long-row path")
            continue
        outs = {}

        def call(tag):
            fns, takes_scratch = libs[tag]
            fn = fns[rdt]
            out = outs.setdefault(tag, torch.empty(
                (rows, k), dtype=rdt if r2r else cdt, device=dev))
            ptrs = [x.data_ptr(), int(x.is_complex()), out.data_ptr(),
                    None if g is None else g.data_ptr(),
                    None if ab is None else ab[0].data_ptr(),
                    None if ab is None else ab[1].data_ptr(), tw.data_ptr()]
            if takes_scratch:
                ptrs.append(None if scratch is None else scratch.data_ptr())
            args_ = ptrs + [rows, n_in, nf, inverse, 4, 0, k, grows or 1,
                            stream]

            def run():
                err = fn(*args_)
                if err:
                    raise RuntimeError(f"{tag}: CUDA error {err}")
            return run
        runs = {tag: call(tag) for tag in trees}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        for tag in others:
            if not torch.equal(outs[tag], outs["this"]):
                d = (outs[tag] - outs["this"]).abs().max().item()
                print(f"  {label}: {tag}'s output differs from this one's "
                      f"by up to {d:.3e}")
        times = {tag: [] for tag in trees}
        for _ in range(ROUNDS):
            for tag in order:
                times[tag].append(loop_ms(runs[tag]))
        med = {t: statistics.median(v) for t, v in times.items()}
        # the least time: each input and output once at the HBM rate
        byts = sum(t.numel() * t.element_size()
                   for t in (x, outs["this"], g, ab) if t is not None)
        bound = byts / HBM * 1e3
        print(f"{label}: x {shape} {dt}, {nf} points; bound {bound:.4f} ms "
              f"({byts / 1e6:.1f} MB) -> "
              + ", ".join(f"{t} {med[t]:.4f} ms ({med[t] / med[parent]:.3f}"
                          f" of {parent}, {bound / med[t]:.0%} of bound)"
                          for t in others[1:] + ["this"])
              + f"; {parent} {med[parent]:.4f} ms ({bound / med[parent]:.0%}"
              f" of bound)")
        for tag, v in times.items():
            print(f"    {tag:8s} " + " ".join(f"{t:.4f}" for t in v))
        lib = _library_call(torch, x, nf, inverse, k, r2r)
        if lib is not None:
            what, fn = lib
            t_lib = statistics.median(loop_ms(fn) for _ in range(ROUNDS))
            line = (f"    torch.fft (cuFFT) {what} {t_lib:.4f} ms, "
                    f"{bound / t_lib:.0%} of the bound; this / cuFFT "
                    f"{med['this'] / t_lib:.3f}")
            if nf > 32768:
                # the two-pass floor: the bound plus the scratch buffer of
                # rows * N complex values written and read once
                z = 2 * rows * nf * torch.empty(0, dtype=cdt).element_size()
                line += (f"; two-pass floor "
                         f"{(byts + z) / HBM * 1e3:.4f} ms")
            print(line + (" (the FFT alone, no Green multiply)" if grows
                          else ""))
        if args.plain:
            fn = _plain_call(ref, x, nf, inverse, k, g, ab)
            fn()
            t_plain = statistics.median(loop_ms(fn, 1) for _ in range(ROUNDS))
            print(f"    plain version (kernels/ref.py) {t_plain:.4f} ms")
        del scratch, outs
    return 0


def _plain_call(ref, x, nf, inverse, k, g, ab):
    """The plain version of the kernel call (``kernels/ref.py``), as a
    thunk."""
    pad = nf if x.shape[1] < nf else None
    if g is not None:
        return lambda: ref.fft_stockham_scale(x, g, pad_to=pad)
    if ab is not None:
        return lambda: ref.fft_stockham_twiddle(x, ab[0], ab[1], pad_to=pad)
    return lambda: ref.fft_stockham(x, inverse=bool(inverse), pad_to=pad,
                                    keep=k)


def _library_call(torch, x, nf, inverse, k, r2r):
    """The ``torch.fft`` call computing the same transform as the kernel
    call (label, thunk), or None: ``rfft`` for a real input keeping the
    half spectrum, ``fft`` / ``ifft`` with ``n=nf`` for a complex one
    keeping every bin; none for a post-twiddle or another window."""
    if r2r:
        return None
    if not x.is_complex():
        if k != nf // 2 + 1:
            return None
        return f"rfft(n={nf})", lambda: torch.fft.rfft(x, n=nf)
    if k != nf:
        return None
    name = "ifft" if inverse else "fft"
    fn = getattr(torch.fft, name)
    return f"{name}(n={nf})", lambda: fn(x, n=nf)


if __name__ == "__main__":
    sys.exit(main())
