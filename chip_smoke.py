#!/usr/bin/env python3
"""Drive the repro_torch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
  3. every kernel against its plain PyTorch version on the card: float32
     and float64, forward / inverse / pruned pad_to / kept bins, radix 2
     and 4, N in {8, 64, 512, 4096}, ragged and batched scale shapes;
  4. the main path: PoissonSolver.solve on the "cuda" engine, CELL, CHAT2,
     float32, for (U,U,U), (U,P,U) and (P,P,P) at 256^3 and (U,U,U) at
     128^3 with B=2, each against the "torch" (cuFFT) engine on the card,
     with the launch counts of both FFT kernels read around each solve;
     then every kernel call of the (U,U,U) solve replayed at its shape
     against the plain version;
  5. the analytic check: NODE (U,U,U) HEJ4 n=64 float64 Gaussian blob,
     which runs spectral_scale;
  6. times with CUDA events (medians after warm-up): each kernel's time per
     solve at the main path's shapes beside its plain version, one
     equivalent PyTorch call where there is one, and its bound; the whole
     solve on both engines, the device memory a solve allocates above
     what is resident, and a torch.profiler breakdown of its device time
     by kernel with the idle share that leaves.
The last two lines are the kernels' JSON record and the device JSON.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import math
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
}
SOURCES = {
    "fft_stockham": "src/repro_torch/kernels/csrc/fft_stockham.cu",
    "fft_stockham_scale": "src/repro_torch/kernels/csrc/fft_stockham.cu",
    "spectral_scale": "src/repro_torch/kernels/csrc/spectral_scale.cu",
}
# cells per direction of the lead cases, timed repetitions per measurement
N = 256
REPS = 15
# expected (fft_stockham, fft_stockham_scale) launches per CELL solve
EXPECTED = {"UUU": (8, 1), "UPU": (7, 1), "PPP": (5, 1)}


def _rate(table, name, default):
    for key, v in table.items():
        if key in name:
            return v
    return default


def main() -> int:
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

    from repro_torch.core.bc import BCType, DataLayout
    from repro_torch.core.green import GreenKind
    from repro_torch.core.solver import PoissonSolver
    from repro_torch.kernels import LAUNCHES, _build, ops, ref, reset_launches
    from repro_torch.kernels.fft_stockham import (fft_stockham,
                                                  fft_stockham_scale)
    from repro_torch.kernels.spectral_scale import spectral_scale

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
    for line in "\n".join(_build.BUILD_LOG).splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
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
        for n in (8, 64, 512, 4096):
            rtol, atol = fft_tol(rdt, n)
            for radix in (2, 4):
                cases = [
                    dict(x=randn((13, n), cdt)),
                    dict(x=randn((13, n), cdt), inverse=True),
                    dict(x=randn((13, n // 2), cdt), pad_to=n),
                    dict(x=randn((13, n // 2), rdt), pad_to=n,
                         keep=n // 2 + 1),
                    dict(x=randn((13, n), rdt), keep=n // 2 + 1),
                    dict(x=randn((13, n), cdt), inverse=True,
                         keep=max(1, n // 2)),
                ]
                for kw in cases:
                    x = kw.pop("x")
                    hold("fft_stockham",
                         fft_stockham(x, max_radix=radix, **kw),
                         ref.fft_stockham(x, max_radix=radix, **kw),
                         rtol, atol)
                    checks += 1
                for pad, grows, start, k in ((None, 13, 0, n),
                                             (n, 13, 0, n // 2 + 1),
                                             (None, 1, 1, n - 1)):
                    x = randn((26, n // 2 if pad else n), cdt)
                    g = randn((grows, k), rdt)
                    hold("fft_stockham_scale",
                         fft_stockham_scale(x, g, start=start, pad_to=pad,
                                            max_radix=radix),
                         ref.fft_stockham_scale(x, g, start=start,
                                                pad_to=pad,
                                                max_radix=radix),
                         rtol, atol)
                    checks += 1
        for shape in ((8, 128), (7, 130), (129, 384), (3, 16, 256),
                      (2, 129, 384)):
            g = randn(shape[-2:], rdt)
            for dt in (rdt, cdt):
                x = randn(shape, dt)
                hold("spectral_scale", spectral_scale(x, g, 0.37),
                     ref.spectral_scale(x, g, 0.37), *scale_tol(rdt))
                checks += 1
    print(f"kernels vs plain versions: {checks} checks passed in "
          f"{time.perf_counter() - t0:.2f} s; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # -- 4. main path ---------------------------------------------------------
    U = (BCType.UNB, BCType.UNB)
    P = (BCType.PER, BCType.PER)
    lead = {"UUU": (U, U, U), "UPU": (U, P, U), "PPP": (P, P, P)}
    n = N
    rng = np.random.default_rng(0)
    solvers = {}
    launches = {}
    recorded = []

    def recording(fn, kname):
        def call(x, *a, **kw):
            recorded.append((kname, x, a, kw))
            return fn(x, *a, **kw)
        return call

    runs = [(case, n, None) for case in lead] + [("UUU", n // 2, 2)]
    for case, nn, batch in runs:
        t0 = time.perf_counter()
        sc = PoissonSolver((nn,) * 3, 1.0, lead[case], engine="cuda",
                           device=dev)
        st = PoissonSolver((nn,) * 3, 1.0, lead[case], engine="torch",
                           device=dev, green=sc._green_nat)
        t_plan = time.perf_counter() - t0
        shape = ((batch,) if batch else ()) + sc.input_shape
        f = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
        first = case == "UUU" and batch is None
        if first:
            saved = (ops.fft_stockham, ops.fft_stockham_scale,
                     ops.spectral_scale)
            ops.fft_stockham = recording(saved[0], "fft_stockham")
            ops.fft_stockham_scale = recording(saved[1],
                                               "fft_stockham_scale")
            ops.spectral_scale = recording(saved[2], "spectral_scale")
        sync()
        reset_launches()
        u = sc.solve(f)
        sync()
        counts = dict(LAUNCHES)
        if first:
            (ops.fft_stockham, ops.fft_stockham_scale,
             ops.spectral_scale) = saved
            launches["fft_stockham"] = counts["fft_stockham"]
            launches["fft_stockham_scale"] = counts["fft_stockham_scale"]
        want = EXPECTED[case]
        if (counts["fft_stockham"], counts["fft_stockham_scale"]) != want:
            raise AssertionError(f"{case}: launches {counts}, expected "
                                 f"fft_stockham/_scale = {want}")
        if counts["spectral_scale"]:
            raise AssertionError(f"{case}: spectral_scale ran on a CELL "
                                 "plan the FFT epilogue should fuse")
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
        tag = f"{case} n={nn}" + (f" B={batch}" if batch else "")
        print(f"main path {tag}: plan+green {t_plan:.2f} s, launches "
              f"{counts}, max|u| {ut.abs().max().item():.4e}, cuda vs "
              f"torch engine relative max |diff| {rel:.3e}")
        solvers[tag] = (sc, st, f)

    # replay every kernel call of the (U,U,U) solve at its own shape
    calls = {}
    for kname, x, a, kw in recorded:
        key = (kname, tuple(x.shape), x.dtype,
               tuple((k, tuple(v.shape) if torch.is_tensor(v) else v)
                     for k, v in sorted(kw.items())),
               tuple(tuple(v.shape) for v in a if torch.is_tensor(v)))
        ent = calls.setdefault(key, [kname, x, a, kw, 0])
        ent[4] += 1
    recorded.clear()

    # -- 5. analytic check (NODE, HEJ4, spectral_scale) ----------------------
    from scipy.special import erf
    na, L, a = 64, 1.0, 50.0
    h = L / na
    xs = np.meshgrid(*([np.arange(na + 1) * h] * 3), indexing="ij")
    r = np.sqrt(sum((c - 0.5) ** 2 for c in xs))
    rhs = np.exp(-a * r * r)
    sq = PoissonSolver((na,) * 3, L, (U, U, U), layout=DataLayout.NODE,
                       green_kind=GreenKind.HEJ4, engine="cuda", device=dev)
    sync()
    reset_launches()
    uq = sq.solve(rhs)
    sync()
    counts = dict(LAUNCHES)
    launches["spectral_scale"] = counts["spectral_scale"]
    if counts["spectral_scale"] < 1:
        raise AssertionError(f"NODE solve: spectral_scale never launched "
                             f"({counts})")
    Q = (np.pi / a) ** 1.5
    rs = np.where(r > 1e-12, r, 1.0)
    uref = -Q * erf(np.sqrt(a) * rs) / (4 * np.pi * rs)
    uref = np.where(r > 1e-12, uref, -Q * np.sqrt(a) / (2 * np.pi ** 1.5))
    e_inf = np.abs(uq.cpu().numpy() - uref).max() / np.abs(uref).max()
    if not e_inf < 2e-2:
        raise AssertionError(f"NODE HEJ4 Gaussian: relative E_inf "
                             f"{e_inf:.3e} >= 2e-2")
    print(f"analytic NODE (U,U,U) HEJ4 n={na} float64: relative E_inf "
          f"{e_inf:.3e}, launches {counts}")
    # the NODE solve's Green multiply, replayed at its shape
    saved = ops.spectral_scale
    ops.spectral_scale = recording(saved, "spectral_scale")
    sq.solve(rhs)
    ops.spectral_scale = saved
    for kname, x, a_, kw in recorded:
        key = (kname, tuple(x.shape), x.dtype)
        ent = calls.setdefault(key, [kname, x, a_, kw, 0])
        ent[4] += 1

    # -- 6. times -----------------------------------------------------------
    def time_ms(fn):
        for _ in range(3):
            fn()
        sync()
        ts = []
        for _ in range(REPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)

    def nbytes(t):
        return t.numel() * t.element_size()

    per = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   by_bytes=0.0, by_ops=0.0) for k in LAUNCHES}
    lib_none = {"fft_stockham_scale"}
    for kname, x0, a, kw, count in calls.values():
        x = randn(tuple(x0.shape), x0.dtype)
        rdt = x.real.dtype if x.is_complex() else x.dtype
        if kname == "spectral_scale":
            g = randn(tuple(a[0].shape), rdt)
            sc_ = a[1] if len(a) > 1 else kw.get("scale", 1.0)
            kern = lambda: spectral_scale(x, g, sc_)   # noqa: E731
            plain = lambda: ref.spectral_scale(x, g, sc_)   # noqa: E731
            library = lambda: torch.mul(x, g)   # noqa: E731
            out = kern()
            hold(kname, out, plain(), *scale_tol(rdt))
            byts = nbytes(x) + nbytes(g) + nbytes(out)
            flops = out.numel() * (2 if x.is_complex() else 1)
        else:
            n_in = x.shape[-1]
            nf = kw.get("pad_to") or n_in
            if kname == "fft_stockham":
                kern = lambda: fft_stockham(x, **kw)   # noqa: E731
                plain = lambda: ref.fft_stockham(x, **kw)   # noqa: E731
                fn_lib = (torch.fft.ifft if kw.get("inverse")
                          else torch.fft.rfft if not x.is_complex()
                          else torch.fft.fft)
                library = lambda: fn_lib(x, n=nf)   # noqa: E731
                byts_extra = 0
            else:
                g = randn(tuple(a[0].shape), rdt)
                kern = lambda: fft_stockham_scale(x, g, **kw)  # noqa: E731
                plain = lambda: ref.fft_stockham_scale(  # noqa: E731
                    x, g, **kw)
                library = None
                byts_extra = nbytes(g)
            out = kern()
            hold(kname, out, plain(), *fft_tol(rdt, nf))
            byts = nbytes(x) + nbytes(out) + byts_extra
            flops = x.shape[0] * 5 * nf * math.log2(nf)
        t_k = time_ms(kern)
        t_p = time_ms(plain)
        t_l = time_ms(library) if library is not None else None
        b_bytes = byts / hbm * 1e3
        b_ops = flops / peak[rdt] * 1e3
        print(f"  {kname} x{count} per solve: x {tuple(x.shape)} {x.dtype} "
              f"{ {k: v for k, v in kw.items()} } -> kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, library "
              f"{'n/a' if t_l is None else f'{t_l:.4f} ms'}, bound "
              f"{max(b_bytes, b_ops):.4f} ms ({byts / 1e6:.1f} MB)")
        p = per[kname]
        p["ms"] += count * t_k
        p["plain_ms"] += count * t_p
        p["by_bytes"] += count * b_bytes
        p["by_ops"] += count * b_ops
        if t_l is None:
            lib_none.add(kname)
        else:
            p["library_ms"] += count * t_l

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
        print(f"  {label}: device busy {busy:.3f} ms of {solve_ms:.3f} ms "
              f"(idle share {max(0.0, 1 - busy / solve_ms):.1%}); {top}")

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
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
