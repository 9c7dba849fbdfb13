#!/usr/bin/env python3
"""Drive the repro_torch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc
     (one process per source, all started together);
  3. every kernel against its plain PyTorch version on the card: float32
     and float64, forward / inverse / pruned pad_to / kept bins, radix 2
     and 4, batch 1 and 13, every N = 2, 4, ..., 4096 (each pass radix of
     the register core) with all three epilogues (the Green plane on
     every bin, the rfft half spectrum and start 1 with an odd k; the
     twiddle tables on every bin and the DCT-I/DCT-II/DST-II windows),
     inputs at an address that is not 16-byte aligned (read in place, the
     kernel launched), ragged and
     batched scale shapes (B in {1, 3} on aligned and ragged planes),
     twiddle_pack on a strided half-spectrum window at the
     (E,E),(O,O),(E,O) 384^3 path's shape; the two-pass Stockham path at
     N in {8192, 16384, 65536}: forward, inverse, pruned pad_to, kept
     bins, the Green epilogue at start 0 and 1 (grows dividing the rows),
     the DCT-I/DCT-II/DST-II twiddle windows, batch 1 and 13, radix 2 and
     4, and one row of 2^24 points; one 16384-point float64 row against
     torch.fft.fft;
  4. the main path: PoissonSolver.solve on the "cuda" engine, CELL, CHAT2,
     float32, for (U,U,U) and (P,P,P) at 256^3, (U,P,U) at 128^3 (its
     host Green assembly at 256^3 costs 10 s), (U,U,U) at 128^3 with B=2, semi-unbounded (U,E),(U,U),(U,U) at 256^3 and
     (U,U),(U,U),(O,U) at 128^3, the wall-bounded (E,E),(O,O),(E,O)
     at 384^3, and the elongated LONG_UUU (U,U,U) 4096x64x64 and
     LONG_SEMI (U,E),(U,U),(U,U) 2048x64x64, whose x direction needs an
     8192-point FFT (two passes), each against the "torch" (cuFFT) engine
     on the card, with the launch counts of all five kernels, and of the
     two-pass calls, read around each solve;
  5. the analytic checks: NODE (U,U,U) HEJ4 n=64 float64 Gaussian blob
     (spectral_scale), and NODE (U,E),(U,U),(U,U) HEJ4 n=64 float64 blob
     and its even image (the DCT-I on fft_stockham_twiddle);
  6. every kernel call of the recorded solves replayed at its shape
     against the plain version, and times with CUDA events (medians after
     warm-up; a kernel call is timed from a start event the device reaches
     only after the host has queued the call, and a kernel under 0.1 ms
     per call, with its plain version and library call, as 50
     back-to-back calls between one event pair over rotating input sets):
     each kernel's time per solve at its
     path's shapes beside its plain version, one equivalent PyTorch call
     where there is one, and its bound, also spectral_scale at the SYM384
     shape and the two-pass calls of LONG_UUU and LONG_SEMI; the whole
     solve on both engines, the device memory a solve allocates above
     what is resident, and a torch.profiler breakdown of its device time
     by kernel with the idle share that leaves.
The last two lines are the kernels' JSON record and the device JSON.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import collections
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# device-memory rate (bytes/s) and non-tensor peak rates (flop/s) of the
# card, from NVIDIA's data sheets; the SXM part unless the name says other
_HBM = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
_PEAK_F32 = {"H100 PCIe": 51e12, "H100 NVL": 60e12}
_PEAK_F64 = {"H100 PCIe": 26e12, "H100 NVL": 30e12}

REPLACES = {
    "fft_stockham": "src/repro/kernels/fft_stockham.py:202",
    "fft_stockham_scale": "src/repro/kernels/fft_stockham.py:260",
    "spectral_scale": "src/repro/kernels/spectral_scale.py:46",
    "twiddle_pack": "src/repro/kernels/twiddle_pack.py:32",
    "fft_stockham_twiddle": "src/repro/kernels/fft_stockham.py:231",
}
SOURCES = {
    "fft_stockham": "src/repro_torch/kernels/csrc/fft_stockham.cu",
    "fft_stockham_scale": "src/repro_torch/kernels/csrc/fft_stockham.cu",
    "spectral_scale": "src/repro_torch/kernels/csrc/spectral_scale.cu",
    "twiddle_pack": "src/repro_torch/kernels/csrc/twiddle_pack.cu",
    "fft_stockham_twiddle": "src/repro_torch/kernels/csrc/fft_stockham.cu",
}
# cells per direction of the lead cases, timed repetitions per measurement
N = 256
REPS = 15
# launches per solve of each run, worked out from its plan (kernels not
# named launch 0 times).  DFT CELL directions: a pruned forward (1), the
# last one fused with the Green multiply (fft_stockham_scale), a pruned
# parity-split inverse (2).  A semi-unbounded CELL direction of n cells:
# the fused DCT-II / DST-II of length 2n (extension 4n, a power of two)
# and the Stockham irfft of its DCT-III / DST-III.  (E,E),(O,O),(E,O) at
# 384: two twiddle_packs after the library rfft of length 768, DCT-IV on
# the library FFT of length 192, the Green multiply on a real field.
# NODE: unpruned n+1-point DFT directions (1 each way), the Green
# multiply apart; the semi-even DCT-I (extension 4n) fused both ways.
EXPECTED = {
    "UUU": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "UPU": {"fft_stockham": 7, "fft_stockham_scale": 1},
    "PPP": {"fft_stockham": 5, "fft_stockham_scale": 1},
    "UUU_B2": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "SEMI_E": {"fft_stockham": 6, "fft_stockham_scale": 1,
               "fft_stockham_twiddle": 1},
    "SEMI_O": {"fft_stockham": 6, "fft_stockham_scale": 1,
               "fft_stockham_twiddle": 1},
    "SYM384": {"spectral_scale": 1, "twiddle_pack": 2},
    "LONG_UUU": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "LONG_SEMI": {"fft_stockham": 6, "fft_stockham_scale": 1,
                  "fft_stockham_twiddle": 1},
    "NODE_UUU": {"fft_stockham": 6, "spectral_scale": 1},
    "NODE_SEMI_E": {"fft_stockham": 4, "spectral_scale": 1,
                    "fft_stockham_twiddle": 2},
}
# of those, the calls whose rows are longer than one pass takes: the
# pruned 8192-point forward of LONG_UUU's x direction; LONG_SEMI's fused
# DCT-II on the 8192-point extension and the inverse of its DCT-III
EXPECTED_TWO_PASS = {
    "LONG_UUU": {"fft_stockham": 1},
    "LONG_SEMI": {"fft_stockham": 1, "fft_stockham_twiddle": 1},
}
# the run whose launches, shapes and times each kernel's record reports
TIMED_ON = {"fft_stockham": "UUU", "fft_stockham_scale": "UUU",
            "spectral_scale": "NODE_UUU", "twiddle_pack": "SYM384",
            "fft_stockham_twiddle": "SEMI_E"}
# further runs whose calls are timed and printed (not in the record): the
# second spectral_scale shape, and the two-pass calls
ALSO_TIMED = {"spectral_scale": ("SYM384",),
              "fft_stockham": ("LONG_UUU", "LONG_SEMI"),
              "fft_stockham_twiddle": ("LONG_SEMI",)}
# a kernel under SHORT_MS per call is timed as LOOP back-to-back calls
SHORT_MS = 0.1
LOOP = 50
# device sleep (clock cycles, about 1 ms) ahead of each timed kernel call
AHEAD_CYCLES = 2_000_000
# relative E_inf of the NODE semi-even HEJ4 n=64 float64 case on the
# reference, repro.core.solver.PoissonSolver(engine="xla") on the CPU
# (the validation case of tests/test_validation.py); the port is held to
# 1.5 times it
SEMI_E_REF_EINF = 2.7204477288238545e-3


def _rate(table, name, default):
    for key, v in table.items():
        if key in name:
            return v
    return default


def main() -> int:
    t_start = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch finds no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import transforms
    from repro_torch.core.bc import BCType, DataLayout
    from repro_torch.core.green import GreenKind
    from repro_torch.core.solver import PoissonSolver
    from repro_torch.kernels import (LAUNCHES, TWO_PASS, _build, ops, ref,
                                     reset_launches)
    from repro_torch.kernels.fft_stockham import (ONE_PASS_N, fft_stockham,
                                                  fft_stockham_scale,
                                                  fft_stockham_twiddle)
    from repro_torch.kernels.spectral_scale import spectral_scale
    from repro_torch.kernels.twiddle_pack import twiddle_pack
    wrappers = {"fft_stockham": fft_stockham,
                "fft_stockham_scale": fft_stockham_scale,
                "spectral_scale": spectral_scale,
                "twiddle_pack": twiddle_pack,
                "fft_stockham_twiddle": fft_stockham_twiddle}

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    hbm = _rate(_HBM, name, 3.35e12)
    peak = {torch.float32: _rate(_PEAK_F32, name, 67e12),
            torch.float64: _rate(_PEAK_F64, name, 34e12)}
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; bound rates: HBM "
          f"{hbm / 1e12} TB/s, fp32 {peak[torch.float32] / 1e12} TFLOP/s, "
          f"fp64 {peak[torch.float64] / 1e12} TFLOP/s")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    # ptxas's registers and spills of each kernel instantiation, under
    # its demangled name where c++filt is there to demangle it
    cxxfilt = shutil.which("c++filt")
    for line in "\n".join(_build.BUILD_LOG).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            if cxxfilt:
                fn = subprocess.run([cxxfilt, fn], capture_output=True,
                                    text=True).stdout.strip()
                m = re.search(r"(\w+<[^()]*>)\(", fn)
                fn = m.group(1) if m else fn
            print(f"  {fn}:")
        elif "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(shape, dtype):
        """Seeded standard normals on the card (complex: both parts)."""
        if dtype.is_complex:
            rdt = torch.float64 if dtype == torch.complex128 else \
                torch.float32
            re = torch.randn(shape, generator=gen, dtype=rdt)
            im = torch.randn(shape, generator=gen, dtype=rdt)
            return torch.complex(re, im).to(dev)
        return torch.randn(shape, generator=gen, dtype=dtype).to(dev)

    errs = {k: 0.0 for k in LAUNCHES}

    def hold(kname, got, want, rtol, atol):
        """Kernel result against the plain version, |d| <= atol+rtol|w|."""
        sync()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{kname}: {tuple(got.shape)} {got.dtype} "
                                 f"vs {tuple(want.shape)} {want.dtype}")
        d = (got - want).abs()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{kname}: non-finite output")
        bad = d > atol + rtol * want.abs()
        if bad.any():
            raise AssertionError(f"{kname}: max |err| {d.max().item():.3e} "
                                 f"beyond atol {atol:.1e} + rtol {rtol:.0e}")
        errs[kname] = max(errs[kname], d.max().item())
        return d.max().item()

    def fft_tol(dtype, n):
        if dtype in (torch.float64, torch.complex128):
            return 1e-10, 1e-10 * math.sqrt(n)
        return 1e-4, 1e-3 * math.sqrt(n)

    def scale_tol(dtype):
        if dtype in (torch.float64, torch.complex128):
            return 1e-10, 1e-12
        return 2e-6, 1e-6

    # -- 3. kernels against their plain versions -------------------------
    t0 = time.perf_counter()
    checks = 0
    for rdt, cdt in ((torch.float32, torch.complex64),
                     (torch.float64, torch.complex128)):
        # every one-pass length, each pass radix the register core takes
        for n in [2 ** e for e in range(1, 13)]:
            rtol, atol = fft_tol(rdt, n)
            for radix in (2, 4):
                for batch in (1, 13):
                    cases = [
                        dict(x=randn((batch, n), cdt)),
                        dict(x=randn((batch, n), cdt), inverse=True),
                        dict(x=randn((batch, n // 2), cdt), pad_to=n),
                        dict(x=randn((batch, n // 2), rdt), pad_to=n,
                             keep=n // 2 + 1),
                        dict(x=randn((batch, n), rdt), keep=n // 2 + 1),
                        dict(x=randn((batch, n), cdt), inverse=True,
                             keep=max(1, n // 2)),
                    ]
                    for kw in cases:
                        x = kw.pop("x")
                        hold("fft_stockham",
                             fft_stockham(x, max_radix=radix, **kw),
                             ref.fft_stockham(x, max_radix=radix, **kw),
                             rtol, atol)
                        checks += 1
                    # the Green epilogue: every bin, the rfft half
                    # spectrum, and start 1 with an odd k
                    for pad, rows, grows, start, k in (
                            (None, 2 * batch, batch, 0, n),
                            (n, 2 * batch, batch, 0, n // 2 + 1),
                            (None, batch, 1, 1, n - 1),
                            (n, batch, batch, 1, n // 2 + 1)):
                        if start + k > n:
                            continue
                        x = randn((rows, n // 2 if pad else n), cdt)
                        g = randn((grows, k), rdt)
                        hold("fft_stockham_scale",
                             fft_stockham_scale(x, g, start=start,
                                                pad_to=pad, max_radix=radix),
                             ref.fft_stockham_scale(x, g, start=start,
                                                    pad_to=pad,
                                                    max_radix=radix),
                             rtol, atol)
                        checks += 1
                    # the twiddle epilogue: every bin, the DCT-II [0, N/2),
                    # DCT-I [0, N/2+1), DST-II [1, N/2+1) windows and one
                    # past the Nyquist bin (start 1, odd k)
                    for start, k in ((0, n), (0, n // 2), (0, n // 2 + 1),
                                     (1, n // 2), (1, n // 2 + 1)):
                        if start + k > n:
                            continue
                        a, b = randn((k,), rdt), randn((k,), rdt)
                        for pad in (None, n):
                            x = randn((batch, n // 2 if pad else n), rdt)
                            kw = dict(start=start, pad_to=pad,
                                      max_radix=radix)
                            hold("fft_stockham_twiddle",
                                 fft_stockham_twiddle(x, a, b, **kw),
                                 ref.fft_stockham_twiddle(x, a, b, **kw),
                                 rtol, atol)
                            checks += 1
        # inputs whose base address is not 16-byte aligned (contiguous
        # views one element into a buffer; a complex128 element is 16
        # bytes, so only its float64 view can be): the kernel reads them
        # in place, and the call launches it
        for dt, n, kw in ((cdt, 4096, {}), (cdt, 512, dict(pad_to=1024)),
                          (rdt, 4096, dict(keep=2049)),
                          (rdt, 512, dict(pad_to=1024, keep=513))):
            x = randn((13 * n + 1,), dt)[1:].view(13, n)
            before = LAUNCHES["fft_stockham"]
            got = fft_stockham(x, **kw)
            launched = LAUNCHES["fft_stockham"] - before
            if (x.element_size() < 16 and x.data_ptr() % 16 == 0
                    or launched != 1):
                raise AssertionError(f"misaligned {dt} N={n}: address "
                                     f"{x.data_ptr() % 16} mod 16, "
                                     f"launches {launched}")
            hold("fft_stockham", got, ref.fft_stockham(x, **kw),
                 *fft_tol(rdt, kw.get("pad_to", n)))
            checks += 1
        x = randn((13 * 1024 + 1,), rdt)[1:].view(13, 1024)
        a, b = randn((513,), rdt), randn((513,), rdt)
        hold("fft_stockham_twiddle", fft_stockham_twiddle(x, a, b),
             ref.fft_stockham_twiddle(x, a, b), *fft_tol(rdt, 1024))
        checks += 1
        # the two-pass path (rows above ONE_PASS_N points); its largest
        # error per length, against the spectrum's largest value
        for n in (8192, 16384, 65536):
            rtol, atol = fft_tol(rdt, n)
            worst = [0.0, 0.0]

            def hold2(kname, got, want):
                d = hold(kname, got, want, rtol, atol)
                if d >= worst[0]:
                    worst[:] = [d, want.abs().max().item()]
            for radix in (2, 4):
                for batch in (1, 13):
                    cases = [
                        dict(x=randn((batch, n), cdt)),
                        dict(x=randn((batch, n), cdt), inverse=True),
                        dict(x=randn((batch, n // 2), cdt), pad_to=n),
                        dict(x=randn((batch, n // 2), rdt), pad_to=n,
                             keep=n // 2 + 1),
                        dict(x=randn((batch, n), rdt), keep=n // 2 + 1),
                        dict(x=randn((batch, n), cdt), inverse=True,
                             keep=n // 2),
                    ]
                    for kw in cases:
                        x = kw.pop("x")
                        hold2("fft_stockham",
                              fft_stockham(x, max_radix=radix, **kw),
                              ref.fft_stockham(x, max_radix=radix, **kw))
                        checks += 1
                for pad, rows, grows, start, k in (
                        (None, 26, 13, 0, n), (n, 26, 13, 0, n // 2 + 1),
                        (None, 13, 1, 1, n - 1),
                        (n, 13, 13, 1, n // 2 + 1)):
                    x = randn((rows, n // 2 if pad else n), cdt)
                    g = randn((grows, k), rdt)
                    hold2("fft_stockham_scale",
                          fft_stockham_scale(x, g, start=start, pad_to=pad,
                                             max_radix=radix),
                          ref.fft_stockham_scale(x, g, start=start,
                                                 pad_to=pad,
                                                 max_radix=radix))
                    checks += 1
                for start, k in ((0, n // 2), (0, n // 2 + 1), (1, n // 2),
                                 (1, n // 2 + 1)):
                    a, b = randn((k,), rdt), randn((k,), rdt)
                    for pad in (None, n):
                        for batch in (1, 13):
                            x = randn((batch, n // 2 if pad else n), rdt)
                            kw = dict(start=start, pad_to=pad,
                                      max_radix=radix)
                            hold2("fft_stockham_twiddle",
                                  fft_stockham_twiddle(x, a, b, **kw),
                                  ref.fft_stockham_twiddle(x, a, b, **kw))
                            checks += 1
            print(f"  two-pass {rdt} N={n}: max |err| {worst[0]:.3e} "
                  f"against a largest |value| {worst[1]:.3e}")
        # the longest row the kernel takes: 4096-point column FFTs, one or
        # two columns per block
        x = randn((1, 2 ** 24), cdt)
        d = hold("fft_stockham", fft_stockham(x), ref.fft_stockham(x),
                 *fft_tol(rdt, 2 ** 24))
        print(f"  two-pass {rdt} N={2 ** 24}: max |err| {d:.3e}")
        checks += 1
        del x
        for shape in ((8, 128), (7, 130), (129, 384), (3, 16, 256),
                      (2, 129, 384), (1, 7, 130), (3, 7, 130),
                      (1, 129, 384), (3, 129, 384)):
            g = randn(shape[-2:], rdt)
            for dt in (rdt, cdt):
                x = randn(shape, dt)
                hold("spectral_scale", spectral_scale(x, g, 0.37),
                     ref.spectral_scale(x, g, 0.37), *scale_tol(rdt))
                checks += 1
        # contiguous, then the DCT-II / DST-II windows [0, 384) and
        # [1, 385) of the 385-bin half spectrum of the 384^3 path's
        # length-768 rfft, read in place at row pitch 385
        packs = [randn(shape, cdt) for shape in ((8, 128), (64, 257),
                                                 (5, 96))]
        half = randn((384 * 384, 385), cdt)
        packs += [half[:, :384], half[:, 1:]]
        for x in packs:
            a, b = randn((x.shape[1],), rdt), randn((x.shape[1],), rdt)
            hold("twiddle_pack", twiddle_pack(x, a, b),
                 ref.twiddle_pack(x, a, b), *scale_tol(rdt))
            checks += 1
        del half, packs
    # an absolute reference: the two-pass path against cuFFT in float64
    x = randn((1, 16384), torch.complex128)
    d = hold("fft_stockham", fft_stockham(x), torch.fft.fft(x),
             *fft_tol(torch.float64, 16384))
    print(f"  two-pass float64 N=16384 against torch.fft.fft: max |err| "
          f"{d:.3e}")
    checks += 1
    print(f"kernels vs plain versions: {checks} checks passed in "
          f"{time.perf_counter() - t0:.2f} s; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # -- 4. main path ---------------------------------------------------------
    U = (BCType.UNB, BCType.UNB)
    P = (BCType.PER, BCType.PER)
    E, O = BCType.EVEN, BCType.ODD
    # case: (bcs, cells per direction (or per axis), batch)
    runs = {
        "UUU": ((U, U, U), N, None),
        "UPU": ((U, P, U), N // 2, None),
        "PPP": ((P, P, P), N, None),
        "UUU_B2": ((U, U, U), N // 2, 2),
        "SEMI_E": (((BCType.UNB, E), U, U), N, None),
        "SEMI_O": ((U, U, (O, BCType.UNB)), N // 2, None),
        "SYM384": (((E, E), (O, O), (E, O)), 384, None),
        # elongated domains: a free-space jet or wake (16.7 M cells, the
        # doubled volume of (U,U,U) 256^3) and a wall with free space
        # beside it, resolved finely wall-normal
        "LONG_UUU": ((U, U, U), (4096, 64, 64), None),
        "LONG_SEMI": (((BCType.UNB, E), U, U), (2048, 64, 64), None),
    }
    rng = np.random.default_rng(0)
    solvers = {}
    launches = {}
    # (run, call descriptor) -> calls per solve; a descriptor holds the
    # kernel, x's shape, strides, offset and dtype, the other tensor
    # arguments' shapes and the scalar arguments: what a replay needs
    calls = {}

    def describe(kname, x, a, kw):
        args = tuple(("t", tuple(v.shape)) if torch.is_tensor(v)
                     else ("v", v) for v in a)
        return (kname, (tuple(x.shape), x.stride(), x.storage_offset(),
                        x.dtype), args, tuple(sorted(kw.items())))

    def run_counted(run, fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after, each kernel call recorded under ``run``; the counts
        must be EXPECTED[run] exactly, and the two-pass calls among them
        EXPECTED_TWO_PASS[run] (none where the run has no entry)."""
        saved = {k: getattr(ops, k) for k in wrappers}

        def recording(kname):
            def call(x, *a, **kw):
                key = (run, describe(kname, x, a, kw))
                calls[key] = calls.get(key, 0) + 1
                return saved[kname](x, *a, **kw)
            return call
        for k in wrappers:
            setattr(ops, k, recording(k))
        try:
            sync()
            reset_launches()
            out = fn()
            sync()
            counts = dict(LAUNCHES)
            two = {k: v for k, v in TWO_PASS.items() if v}
        finally:
            for k, v in saved.items():
                setattr(ops, k, v)
        got = {k: v for k, v in counts.items() if v}
        if got != EXPECTED[run]:
            raise AssertionError(f"{run}: launches {got}, expected "
                                 f"{EXPECTED[run]}")
        if two != EXPECTED_TWO_PASS.get(run, {}):
            raise AssertionError(f"{run}: two-pass calls {two}, expected "
                                 f"{EXPECTED_TWO_PASS.get(run, {})}")
        for k, r in TIMED_ON.items():
            if r == run:
                launches[k] = counts[k]
        return out, counts

    for case, (bcs, nn, batch) in runs.items():
        t0 = time.perf_counter()
        grid = nn if isinstance(nn, tuple) else (nn,) * 3
        sc = PoissonSolver(grid, 1.0, bcs, engine="cuda", device=dev)
        st = PoissonSolver(grid, 1.0, bcs, engine="torch", device=dev,
                           green=sc._green_nat)
        t_plan = time.perf_counter() - t0
        shape = ((batch,) if batch else ()) + sc.input_shape
        f = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
        u, counts = run_counted(case, lambda: sc.solve(f))
        ut = st.solve(f)
        sync()
        if u.shape != f.shape or u.dtype != f.dtype:
            raise AssertionError(f"{case}: output {tuple(u.shape)} "
                                 f"{u.dtype}")
        if not torch.isfinite(u).all():
            raise AssertionError(f"{case}: non-finite solution")
        rel = ((u - ut).abs().max() / ut.abs().max()).item()
        if rel > 1e-5:
            raise AssertionError(f"{case}: cuda vs torch engine relative "
                                 f"max |diff| {rel:.3e} > 1e-5")
        tag = (f"{case} " + ("x".join(map(str, nn)) if isinstance(nn, tuple)
                             else f"n={nn}")
               + (f" B={batch}" if batch else ""))
        # the directions whose (power-of-two) FFT takes two passes
        long_dirs = []
        for d, p in enumerate(sc.plan.dirs):
            nf = (p.n_fft if p.kind is None
                  else transforms.fft_length(p.kind, p.n_fft))
            if transforms._pow2(nf) and nf > ONE_PASS_N:
                long_dirs.append(f"direction {d} ({p.category}, {nf} "
                                 "points)")
        print(f"main path {tag}: plan+green {t_plan:.2f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} }, two-pass "
              f"{EXPECTED_TWO_PASS.get(case, {})} for "
              f"{', '.join(long_dirs) or 'no direction'}, max|u| "
              f"{ut.abs().max().item():.4e}, cuda vs torch engine relative "
              f"max |diff| {rel:.3e}")
        solvers[tag] = (sc, st, f)

    # -- 5. analytic checks (NODE, HEJ4, float64) -----------------------------
    from scipy.special import erf
    na, L = 64, 1.0
    xs = np.meshgrid(*([np.arange(na + 1) * (L / na)] * 3), indexing="ij")

    def blob_potential(c, s):
        """lap(u) = exp(-|x-c|^2 / (2 s^2)) in free space:
        u = -Q erf(r / (sqrt(2) s)) / (4 pi r), Q = (2 pi)^(3/2) s^3."""
        r = np.sqrt(sum((x - ci) ** 2 for x, ci in zip(xs, c)))
        q = (2.0 * np.pi) ** 1.5 * s ** 3
        rs = np.where(r > 1e-12, r, 1.0)
        u = -q * erf(rs / (np.sqrt(2.0) * s)) / (4.0 * np.pi * rs)
        return np.where(r > 1e-12, u,
                        -q * 2.0 / (np.sqrt(2.0 * np.pi) * s) / (4 * np.pi))

    def analytic(run, bcs, c, s, images, bound):
        rhs = np.exp(-sum((x - ci) ** 2 for x, ci in zip(xs, c))
                     / (2.0 * s * s))
        uref = blob_potential(c, s)
        for ci, sign in images:
            uref = uref + sign * blob_potential(ci, s)
        sq = PoissonSolver((na,) * 3, L, bcs, layout=DataLayout.NODE,
                           green_kind=GreenKind.HEJ4, engine="cuda",
                           device=dev)
        uq, counts = run_counted(run, lambda: sq.solve(rhs))
        e_inf = np.abs(uq.cpu().numpy() - uref).max() / np.abs(uref).max()
        if not e_inf <= bound:
            raise AssertionError(f"{run} HEJ4 Gaussian: relative E_inf "
                                 f"{e_inf:.4e} > {bound:.4e}")
        print(f"analytic {run} HEJ4 n={na} float64: relative E_inf "
              f"{e_inf:.4e} (bound {bound:.4e}), launches "
              f"{ {k: v for k, v in counts.items() if v} }")

    # the quickstart blob (s = 0.1, the reference's quickstart bound), and
    # the paper's semi-unbounded case: blob s = L/10 at the centre, even
    # end at x = L, exact solution with the image at 2L - 0.5
    analytic("NODE_UUU", (U, U, U), (0.5, 0.5, 0.5), 0.1, (), 2e-2)
    analytic("NODE_SEMI_E", ((BCType.UNB, E), U, U), (0.5, 0.5, 0.5), 0.1,
             (((2.0 * L - 0.5, 0.5, 0.5), 1.0),), 1.5 * SEMI_E_REF_EINF)

    # -- 6. replays and times -------------------------------------------------
    def time_ms(fn, ahead=False):
        """Median of REPS event-timed calls after 3 warm-up calls.  With
        ``ahead`` the device sleeps about a millisecond before each start
        event, so the host has queued the call when the event fires: the
        time is the call's device time, without the host's launch gap
        (kernel replays).  Without it that gap counts (whole solves)."""
        for _ in range(3):
            fn()
        sync()
        ts = []
        for _ in range(REPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            if ahead:
                torch.cuda._sleep(AHEAD_CYCLES)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)

    def loop_ms(fns):
        """Device time per call of LOOP back-to-back calls between one
        event pair, taking the closures ``fns`` (one per input set) in
        turn and keeping their last outputs alive, so that no call finds
        its operands or its output buffer in L2 from the call before.  The
        device sleeps while the host queues the calls; if it woke before
        they were all queued, the sleep doubles and the loop runs again."""
        kept = collections.deque(maxlen=len(fns))
        for f in fns:
            kept.append(f())
        sync()
        cycles = 20_000_000
        while True:
            torch.cuda._sleep(cycles)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            for i in range(LOOP):
                kept.append(fns[i % len(fns)]())
            e.record()
            woke = s.query()
            e.synchronize()
            if not woke or cycles >= 320_000_000:
                return s.elapsed_time(e) / LOOP
            cycles *= 2

    def nbytes(t):
        return t.numel() * t.element_size()

    def fresh(shape, stride, offset, dtype):
        """Seeded normals laid out as the recorded argument was (a window
        of a wider tensor keeps its strides and offset)."""
        span = offset + sum((n - 1) * st for n, st in zip(shape, stride)) + 1
        return randn((span,), dtype).as_strided(shape, stride, offset)

    def library_call(kname, x, targs, kw, nf):
        """One PyTorch call computing the same function, or None."""
        if kname == "fft_stockham":
            fn = (torch.fft.ifft if kw.get("inverse")
                  else torch.fft.rfft if not x.is_complex()
                  else torch.fft.fft)
            return lambda: fn(x, n=nf)
        if kname == "spectral_scale":
            return lambda: torch.mul(x, targs[0])
        if kname == "twiddle_pack":
            ab = torch.stack(targs, dim=-1)
            return lambda: torch.linalg.vecdot(torch.view_as_real(x), ab)
        return None      # no single call computes FFT x Green or twiddle

    per = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, by_bytes=0.0,
                   by_ops=0.0) for k in LAUNCHES}
    lib_none = set()
    by_desc = {}
    for (run, desc), count in calls.items():
        by_desc.setdefault(desc, {})[run] = count
    t0 = time.perf_counter()
    for (kname, xd, args, kw), counts in by_desc.items():
        kw = dict(kw)
        x = fresh(*xd)
        rdt = x.real.dtype if x.is_complex() else x.dtype
        targs = [randn(v, rdt) if kind == "t" else v for kind, v in args]
        kern = lambda: wrappers[kname](x, *targs, **kw)   # noqa: E731
        plain = lambda: getattr(ref, kname)(x, *targs, **kw)  # noqa: E731
        out = kern()
        ins = nbytes(x) + sum(nbytes(v) for v in targs if torch.is_tensor(v))
        byts = ins + nbytes(out)
        if kname in ("spectral_scale", "twiddle_pack"):
            hold(kname, out, plain(), *scale_tol(rdt))
            # a * re + b * im: 3 per value; the scale: 1 per component
            flops = out.numel() * (3 if kname == "twiddle_pack" else
                                   2 if out.is_complex() else 1)
            nf = x.shape[-1]
        else:
            nf = kw.get("pad_to") or x.shape[-1]
            hold(kname, out, plain(), *fft_tol(rdt, nf))
            flops = x.shape[0] * 5 * nf * math.log2(nf)
        count = counts.get(TIMED_ON[kname])
        also = [r for r in ALSO_TIMED.get(kname, ()) if r in counts
                and (kname == "spectral_scale" or nf > ONE_PASS_N)]
        if count is None and not also:
            continue
        library = library_call(kname, x, targs, kw, nf)
        t_k = time_ms(kern, ahead=True)
        t_p = time_ms(plain, ahead=True)
        t_l = time_ms(library, ahead=True) if library is not None else None
        how = "median of single calls"
        if t_k < SHORT_MS:
            # fresh input sets that together exceed twice the L2 cache
            sets = [(x, targs)] + [
                (fresh(*xd), [randn(v, rdt) if kind == "t" else v
                              for kind, v in args])
                for _ in range(min(15, math.ceil(100e6 / byts)))]

            def over(fn):
                return [lambda xx=xx, tt=tt: fn(xx, *tt, **kw)
                        for xx, tt in sets]
            t_k = loop_ms(over(wrappers[kname]))
            t_p = loop_ms(over(getattr(ref, kname)))
            if library is not None:
                t_l = loop_ms([library_call(kname, xx, tt, kw, nf)
                               for xx, tt in sets])
            how = f"{LOOP} calls in a row over {len(sets)} input sets"
            del sets
        b_bytes = byts / hbm * 1e3
        b_ops = flops / peak[rdt] * 1e3
        runs_of = ", ".join(f"x{c} per {r}" for r, c in counts.items()
                            if r == TIMED_ON[kname] or r in also)
        print(f"  {kname} ({runs_of} solve"
              f"{'; two passes' if nf > ONE_PASS_N else ''}): x "
              f"{tuple(x.shape)} stride {x.stride()} {x.dtype} {kw} -> "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
              f"{'n/a' if t_l is None else f'{t_l:.4f} ms'}, bound "
              f"{max(b_bytes, b_ops):.4f} ms ({byts / 1e6:.1f} MB; "
              f"{max(b_bytes, b_ops) / t_k:.0%} of it); {how}")
        if count is None:
            continue
        p = per[kname]
        p["ms"] += count * t_k
        p["plain_ms"] += count * t_p
        p["by_bytes"] += count * b_bytes
        p["by_ops"] += count * b_ops
        if t_l is None:
            lib_none.add(kname)
        else:
            p["library_ms"] += count * t_l
    print(f"replays: {len(by_desc)} kernel calls of the recorded solves "
          f"held against their plain versions and timed in "
          f"{time.perf_counter() - t0:.2f} s")

    def where_the_time_goes(label, fn, solve_ms):
        """Device time by kernel over one profiled solve, and the idle
        share of the (unprofiled, event-timed) solve it leaves."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        # device-side events only (kernels, copies): the CPU ops that
        # launched them carry the same device time again
        agg = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                a = agg.setdefault(e.name, [0.0, 0])
                a[0] += e.time_range.elapsed_us() / 1e3
                a[1] += 1
        rows = sorted(((ms, c, k) for k, (ms, c) in agg.items()),
                      reverse=True)
        busy = sum(r[0] for r in rows)
        if busy <= 0:
            print(f"  {label}: device time not measured (the profiler saw "
                  "no device activity)")
            return
        top = "; ".join(f"{ms:.3f} ms x{c} {k[:60]}"
                        for ms, c, k in rows[:6] if ms > 0)
        # the Stockham kernels' instantiations (one per row length) summed
        fft = [(ms, c) for ms, c, k in rows
               if "stockham_kernel" in k or "column_kernel" in k]
        print(f"  {label}: device busy {busy:.3f} ms of {solve_ms:.3f} ms "
              f"(idle share {max(0.0, 1 - busy / solve_ms):.1%}); Stockham "
              f"kernels {sum(ms for ms, _ in fft):.3f} ms "
              f"x{sum(c for _, c in fft)}; {top}")

    for tag, (sc, st, f) in solvers.items():
        t_c = time_ms(lambda: sc.solve(f))
        t_t = time_ms(lambda: st.solve(f))
        # what one solve allocates above the resident solvers, Green
        # planes and inputs of every case
        sync()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sc.solve(f)
        sync()
        mem = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        print(f"solve {tag} float32: cuda engine {t_c:.3f} ms, torch "
              f"engine (cuFFT) {t_t:.3f} ms, cuda-engine solve memory "
              f"{mem:.3f} GiB above {resident / 2 ** 30:.3f} GiB resident")
        where_the_time_goes(f"{tag} cuda engine", lambda: sc.solve(f), t_c)
        where_the_time_goes(f"{tag} torch engine", lambda: st.solve(f), t_t)

    kernels = []
    for kname in LAUNCHES:
        p = per[kname]
        bound = max(p["by_bytes"], p["by_ops"])
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": bound,
            "bound_by": ("bytes" if p["by_bytes"] >= p["by_ops"]
                         else "operations"),
            "library_ms": None if kname in lib_none else p["library_ms"]})
    print(f"chip_smoke.py: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
