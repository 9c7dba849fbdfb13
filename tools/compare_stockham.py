#!/usr/bin/env python3
"""The Stockham kernel of this checkout against another checkout's, in
turns, on one NVIDIA GPU.

    git archive <commit> | tar -x -C build/other
    python3 tools/compare_stockham.py build/other

Builds ``src/repro_torch/kernels/csrc/fft_stockham.cu`` of both trees,
binds each with the C signature its source declares (with the long
rows' scratch pointer or without it), and times the calls of
chip_smoke.py's solves, in the order other, this, this, other, three
times over: float32, the one-pass calls of (U,U,U) 256^3 (the pruned
real forward, the pruned complex forward, the pruned forward fused with
the Green multiply, the two inverse shapes) and SEMI_E's fused DCT-II;
the 8192-point calls of LONG_UUU (the pruned forward, and the same call
fused with a Green plane, which no solve runs) and LONG_SEMI (the fused
DCT-II and the inverse), pruned forwards of the same bytes as LONG_UUU's
at 16384 and 32768 points, and the long rows' pruned forward and
inverse at the same bytes at 65536 (LONG_XL_UUU's forward; 520 and 512
rows), 131072 (LONG_XXL_UUU's; 260 and 256) and 2^20 points (32 and
32); float64, the NODE HEJ4 n=64 calls (the real and complex 128-point
forwards, the inverse, and the semi-even case's fused DCT-I on 256
points).  Each time is the device time of 20 back-to-back calls between
one event pair after a device sleep; the script prints every time, the
ratio of the medians and each build's share of the call's bound (its
input and output bytes once at the HBM rate), and for the complex calls
above 32768 points the ``torch.fft`` call of the same transform (cuFFT),
timed as the kernels are.  Every long-row call is given a scratch buffer,
which a tree takes where its rows run in two passes, and the wrapper's
twiddle table (``kernel_twiddles``: the 4096-point table after the
length-N one, which a tree that reads the long table alone ignores).
Both builds' outputs are compared before timing (long rows only with a
tree whose source takes a scratch pointer).  Exits 2 without a CUDA
device.
"""
from __future__ import annotations

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


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("compare_stockham.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.fft_stockham import kernel_twiddles

    out_dir = ROOT / "build" / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"other": other, "this": ROOT}
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
    print(f"card: {smi}; other: {other}")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
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
            args = ptrs + [rows, n_in, nf, inverse, 4, 0, k, grows or 1,
                           stream]

            def run():
                err = fn(*args)
                if err:
                    raise RuntimeError(f"{tag}: CUDA error {err}")
            return run
        runs = {tag: call(tag) for tag in ("other", "this")}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        if not torch.equal(outs["other"], outs["this"]):
            d = (outs["other"] - outs["this"]).abs().max().item()
            print(f"  {label}: outputs differ by up to {d:.3e}")
        times = {"other": [], "this": []}
        for _ in range(ROUNDS):
            for tag in ("other", "this", "this", "other"):
                times[tag].append(loop_ms(runs[tag]))
        med = {t: statistics.median(v) for t, v in times.items()}
        # the least time: each input and output once at the HBM rate
        byts = sum(t.numel() * t.element_size()
                   for t in (x, outs["this"], g, ab) if t is not None)
        bound = byts / HBM * 1e3
        print(f"{label}: x {shape} {dt}, {nf} points -> other "
              f"{med['other']:.4f} ms, this {med['this']:.4f} ms, this / "
              f"other {med['this'] / med['other']:.3f}; bound {bound:.4f} "
              f"ms ({byts / 1e6:.1f} MB): other {bound / med['other']:.0%}, "
              f"this {bound / med['this']:.0%} of it")
        for tag, v in times.items():
            print(f"    {tag:5s} " + " ".join(f"{t:.4f}" for t in v))
        if nf > 32768 and not grows and not r2r:
            lib = torch.fft.ifft if inverse else torch.fft.fft
            t_lib = statistics.median(
                loop_ms(lambda: lib(x, n=nf)) for _ in range(ROUNDS))
            # the two-pass floor: the bound plus the scratch buffer of rows
            # * N complex values written and read once
            z = 2 * rows * nf * torch.empty(0, dtype=cdt).element_size()
            print(f"    torch.fft (cuFFT) {t_lib:.4f} ms, {bound / t_lib:.0%}"
                  f" of the bound; two-pass floor "
                  f"{(byts + z) / HBM * 1e3:.4f} ms")
        del scratch, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
