#!/usr/bin/env python3
"""Design variants of the Stockham cluster kernel, on one NVIDIA GPU.

    python3 tools/probe_cluster_variants.py

Builds ``src/repro_torch/kernels/csrc/fft_stockham.cu`` as it is and
once per variant (source edits, ``VARIANTS``): 2 and 3 blocks per SM at
every cluster size (``ClusterBlocks``, the blocks per SM that the
float32 cluster kernel's ``__launch_bounds__`` asks registers for; as
built, 4).  Prints ptxas's registers and spills of each
build's float32 ``cluster_kernel`` and times each build, float32, at the
calls of chip_smoke.py's LONG_UUU and LONG_SEMI solves on 8192 points
(the pruned forward of 4160 complex rows, the same fused with a (4160,
8192) Green plane, the fused DCT-II window of 4096 real rows, the
inverse of 4096 complex rows) and at the pruned forward of the same
bytes on 16384 and 32768 points.  Each time is the device time of 20
back-to-back calls between one event pair after a device sleep, the
median of 5 rounds taken in turn over the builds; each call's share of
its bound (input and output bytes once at the HBM rate) is printed
beside it.  Every build's output is compared with the as-built one's
before timing.  A source edit whose text is not found where it is
expected stops the probe (a RuntimeError, exit 1) before anything is
timed.  Exits 2 without a CUDA device.
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
_BLOCKS = ("template <typename T> struct ClusterBlocks { static constexpr "
           "int value = 4; };")
# label: [(text, replacement, occurrences)]
VARIANTS = {"as built": []}
VARIANTS.update({f"{b} blocks": [(_BLOCKS, _BLOCKS.replace("4", str(b)), 1)]
                 for b in (2, 3)})


def build(nvcc, flags, out_dir):
    src = (ROOT / "src/repro_torch/kernels/csrc/fft_stockham.cu").read_text()
    texts = {}
    for label, edits in VARIANTS.items():
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{label}: expected {count} x {old!r} in "
                                   "fft_stockham.cu")
            text = text.replace(old, new)
        texts[label] = text
    procs = {}
    for i, (label, text) in enumerate(texts.items()):
        cu = out_dir / f"stockham_cluster_variant{i}.cu"
        cu.write_text(text)
        so = out_dir / f"libstockham_cluster_variant{i}.so"
        procs[label] = (so, subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {label} variant:\n{out}")
        # ptxas's report of the float32 cluster kernels
        for chunk in out.split("Compiling entry function")[1:]:
            name = chunk.split("'")[1]
            if "cluster_kernelIf" in name:
                regs = [ln.split("ptxas info")[-1].strip(" :")
                        for ln in chunk.splitlines()
                        if "registers" in ln or "spill" in ln]
                print(f"{label}: cluster_kernel<float, "
                      f"{name.split('cluster_kernelIfLi')[1][0]}>: "
                      + "; ".join(regs))
        libs[label] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("probe_cluster_variants.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref

    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    libs = build(_build._nvcc(), _build.NVCC_FLAGS, out_dir)
    fns = {}
    for label, lib in libs.items():
        fn = lib.repro_fft_stockham_f32
        fn.argtypes = _build._SIGNATURES["repro_fft_stockham_f32"]
        fn.restype = ctypes.c_int
        fns[label] = fn

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    f32, c64 = torch.float32, torch.complex64
    # label, x, n_fft, inverse, kept bins, twiddle tables, Green plane
    cases = []
    x = torch.randn((4160, 4096), dtype=c64, device=dev)
    cases.append(("LONG_UUU pruned forward", x, 8192, 0, 8192, None, None))
    g = torch.randn((4160, 8192), dtype=f32, device=dev)
    cases.append(("LONG_UUU pruned forward x Green", x, 8192, 0, 8192, None,
                  g))
    x = torch.randn((4096, 8192), dtype=f32, device=dev)
    ab = torch.randn((2, 4096), dtype=f32, device=dev)
    cases.append(("LONG_SEMI fused DCT-II", x, 8192, 0, 4096, ab, None))
    x = torch.randn((4096, 8192), dtype=c64, device=dev)
    cases.append(("LONG_SEMI inverse", x, 8192, 1, 8192, None, None))
    for n in (16384, 32768):
        x = torch.randn((4160 * 8192 // n, n // 2), dtype=c64, device=dev)
        cases.append((f"{n}-point pruned forward", x, n, 0, n, None, None))

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
        tw = ref.twiddles(nf, c64, dev)
        outs = {}

        def call(v, fn):
            out = outs.setdefault(v, torch.empty(
                (rows, k), dtype=f32 if ab is not None else c64,
                device=dev))

            def run():
                err = fn(x.data_ptr(), int(x.is_complex()), out.data_ptr(),
                         None if g is None else g.data_ptr(),
                         None if ab is None else ab[0].data_ptr(),
                         None if ab is None else ab[1].data_ptr(),
                         tw.data_ptr(), None, rows, n_in, nf, inverse, 4, 0,
                         k, rows if g is not None else 1, stream)
                if err:
                    raise RuntimeError(f"{v}: CUDA error {err}")
            return run
        runs = {v: call(v, fn) for v, fn in fns.items()}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        first = next(iter(outs))
        for v, o in outs.items():
            if not torch.equal(o, outs[first]):
                d = (o - outs[first]).abs().max().item()
                print(f"  {label}: {v} differs from {first} by up to "
                      f"{d:.3e}")
        times = {v: [] for v in runs}
        for _ in range(ROUNDS):
            for v, run in runs.items():
                times[v].append(loop_ms(run))
        byts = sum(t.numel() * t.element_size()
                   for t in (x, outs[first], ab, g) if t is not None)
        bound = byts / HBM * 1e3
        print(f"{label}: x {tuple(x.shape)} {x.dtype}, {nf} points, "
              f"{byts / 1e6:.1f} MB, bound {bound:.4f} ms")
        for v, t in times.items():
            med = statistics.median(t)
            print(f"    {v:18s} {med:.4f} ms ({bound / med:.0%} of bound): "
                  + " ".join(f"{u:.4f}" for u in t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
