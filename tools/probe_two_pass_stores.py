#!/usr/bin/env python3
"""Where the two-pass Stockham FFT's time goes, on one NVIDIA GPU.

    python3 tools/probe_two_pass_stores.py

Builds ``src/repro_torch/kernels/csrc/fft_stockham.cu`` three times: as it
is; with the row pass's epilogue storing each kernel row's kept bins
contiguously (the same bytes in the same buffer, at the wrong places:
what the strided stores would cost if they were not strided; exact for
the windows timed here, which start at bin 0 and hold a multiple of N1
bins); and returning after the column pass (pass 1 alone).  Rows of up
to 32768 points run on a thread-block cluster and take no column pass,
so the probe times the two-pass path at 65536 points (N1 = 16), float32,
at the bytes of chip_smoke.py's LONG_UUU and LONG_SEMI calls: the pruned
forward of 520 complex rows, the fused DCT-II window of 512 real rows
and the inverse of 512 complex rows; and the first at the Green epilogue
(a (520, 65536) plane).  A source edit whose text is not found where it
is expected stops the probe (a RuntimeError, exit 1) before anything is
timed.  Each time is the device
time of 20 back-to-back calls between one event pair, the median of 5
rounds taken in turn.  Pass 2 is the whole call less pass 1; the strided
stores cost the whole call less the contiguous variant.  Each call's
plain PyTorch version (``kernels/ref.py``) is timed beside it, the median
of 3 single calls after one warm-up call, and for the complex forward
and inverse the ``torch.fft`` call of the same transform (cuFFT), timed as
the kernel is.  Exits 2 without a CUDA device.
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

# (label, variant source edits) applied to the kernel's source text
VARIANTS = {
    "as built": [],
    "contiguous stores": [("if ((unsigned)b < k) out[b] =",
                           "if ((unsigned)b < k) out[(b >> e.lg_n1) + (b & "
                           "((1 << e.lg_n1) - 1)) * (e.k >> e.lg_n1)] =", 3)],
    "pass 1 only": [("  x = scratch;\n",
                     "  if (rows > 0) return 0;\n  x = scratch;\n", 1)],
}


def build(nvcc, flags, out_dir):
    src = (ROOT / "src/repro_torch/kernels/csrc/fft_stockham.cu").read_text()
    procs = {}
    for i, (label, edits) in enumerate(VARIANTS.items()):
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
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("probe_two_pass_stores.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref

    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(_build._nvcc(), _build.NVCC_FLAGS, out_dir)
    fns = {}
    for label, lib in libs.items():
        fn = lib.repro_fft_stockham_f32
        fn.argtypes = _build._SIGNATURES["repro_fft_stockham_f32"]
        fn.restype = ctypes.c_int
        fns[label] = fn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    n = 65536
    tw = ref.twiddles(n, torch.complex64, dev)
    null = None
    cases = []
    x = torch.randn((520, n // 2), dtype=torch.complex64, device=dev)
    cases.append(("pruned forward", x, n, 0, n, None, None))
    g = torch.randn((520, n), dtype=torch.float32, device=dev)
    cases.append(("pruned forward x Green", x, n, 0, n, None, g))
    x = torch.randn((512, n), dtype=torch.float32, device=dev)
    ab = torch.randn((2, n // 2), dtype=torch.float32, device=dev)
    cases.append(("fused DCT-II", x, n, 0, n // 2, ab, None))
    x = torch.randn((512, n), dtype=torch.complex64, device=dev)
    cases.append(("inverse", x, n, 1, n, None, None))

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
        real_out = ab is not None
        out = torch.empty((rows, k), device=dev,
                          dtype=torch.float32 if real_out else
                          torch.complex64)
        scratch = torch.empty(rows * nf, dtype=torch.complex64, device=dev)
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
        runs = {v: call(fn) for v, fn in fns.items()}
        for run in runs.values():
            run()
        times = {v: [] for v in runs}
        for _ in range(ROUNDS):
            for v, run in runs.items():
                times[v].append(loop_ms(run))
        med = {v: statistics.median(t) for v, t in times.items()}
        byts = sum(t.numel() * t.element_size()
                   for t in (x, out, ab, g) if t is not None)
        whole, contig, p1 = (med["as built"], med["contiguous stores"],
                             med["pass 1 only"])
        print(f"{label}: x {tuple(x.shape)} {x.dtype}, {nf} points, "
              f"{byts / 1e6:.1f} MB, bound {byts / 3.35e12 * 1e3:.4f} ms")
        print(f"  whole call {whole:.4f} ms; pass 1 {p1:.4f} ms, pass 2 "
              f"{whole - p1:.4f} ms; contiguous stores {contig:.4f} ms, so "
              f"the strided stores cost {whole - contig:.4f} ms "
              f"({(whole - contig) / whole:.0%} of the call)")
        for v, t in times.items():
            print(f"    {v:18s} " + " ".join(f"{u:.4f}" for u in t))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
