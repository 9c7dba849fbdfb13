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
  6. Biot-Savart (lap(u) = curl(w), the vortex-method path), CELL, CHAT2,
     float32 at 256^3, "cuda" against "torch" within 1e-5 relative with
     exact launch counts: BS_TUBE (the paper's vortex tube BCs, the
     sequential per-component pipeline on fft_stockham and
     fft_stockham_twiddle) and BS_UUU (all nine BC pairs unbounded, the
     batched 3-wide pipeline with spectral_scale for the Green multiply);
     BS_TUBE_NODE_HEJ4, the tube at NODE n=64 HEJ4 float64 against its
     analytic velocity;
  7. the runtime on the card: a get_solver hit (same instance, same bits),
     verify="residual" on (P,P,P) 256^3 float32 with a smooth analytic
     field, an armed inf fault at the Green stage tripping the guard and
     walking one rung (engine:cuda->torch), an armed cuda.* build
     fault degrading to "torch", and a real (not injected) launch
     failure raising SolveError with no rung taken.  These are the only
     phases where a
     degradation is expected: every other solve asserts no degradation
     and no retry;
  8. the pencil-distributed solve (DistributedPoissonSolver over a
     DeviceMesh, CELL, CHAT2, float32 unless marked): DIST1_UUU, (U,U,U)
     at 256^3 on a one-rank NCCL mesh (1, 1) -- pack, collective, unpack
     and the kernels on the pencil at full size -- under a2a, pipelined:2,
     fused and overlap:2, and DIST1_SEMI, (U,E),(U,U),(U,U) at 128^3 under
     a2a and overlap:2, each within 1e-5 relative of the single-process
     "cuda" solve, and DIST1_NODE, NODE (U,U,U) n=64 float64 (the Green
     multiply on spectral_scale) under a2a and overlap:2 within 1e-10,
     with exact launch counts and no degradation; each
     strategy's median solve_local beside the single-process solve, the
     memory a solve_local allocates above what is resident, its
     aten::copy_ count (and one switch's alone) and a profiled solve_local
     with its idle share; then DIST4_GLOO, four gloo ranks on the one card
     (NCCL refuses two ranks on one device; gloo stages CUDA tensors
     through the host, so its times are no communication figure), mesh
     (2, 2): (U,U,U) 128^3 under the four strategies and comm="auto"
     (brute; every rank must choose the same winner), NODE
     (E,E),(O,E),(P,P) n=64 float64 (the uneven 65-point split, within
     1e-10) under a2a and overlap:2, and a pod batch of two fields on mesh
     (2, 1, 2), launch counts summed over the ranks;
  9. every kernel call of the recorded solves (the distributed ones
     included) replayed at its shape
     against the plain version, and times with CUDA events (medians after
     warm-up; a kernel call is timed from a start event the device reaches
     only after the host has queued the call, and a kernel under 0.1 ms
     per call, with its plain version and library call, as 50
     back-to-back calls between one event pair over rotating input sets):
     each kernel's time per solve at its
     path's shapes beside its plain version, one equivalent PyTorch call
     where there is one, and its bound, also spectral_scale at the SYM384
     shape and the two-pass calls of LONG_UUU and LONG_SEMI; the whole
     solve (Biot-Savart included) on both engines, the device memory a
     solve allocates above what is resident, and a torch.profiler
     breakdown of its device time by kernel with the idle share that
     leaves.
The last two lines are the kernels' JSON record (with each kernel's
launches in every distributed run, ``dist_launches``) and the device JSON.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import json
import math
import pickle
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
    # Biot-Savart runs the natural-layout stages (no FFT x Green fusion:
    # the curl sits between the last forward FFT and the Green multiply).
    # BS_TUBE, three sequential components: each forward is its z
    # DCT-II / DST-II (fused, 2n-point extension) and two pruned DFTs (1
    # each); each velocity backward is two pruned parity-split DFT
    # inverses (2 each) and the z DCT-III / DST-III (1 Stockham irfft):
    # 3 x 2 + 3 x 5 = 21 and 3.  Its Green multiply is a plain torch
    # multiply, as the reference's.  BS_UUU, one 3-wide pipeline: 3
    # pruned forwards, one Green multiply, 3 x 2 inverses
    "BS_TUBE": {"fft_stockham": 21, "fft_stockham_twiddle": 3},
    "BS_UUU": {"fft_stockham": 9, "spectral_scale": 1},
    # the tube at NODE: unpruned DFTs (1 each way), DST-I on its 64-point
    # rfft, DCT-I fused: forwards 3 x 2 DFTs + 2 DST-I, backwards 3 x 2
    # DFTs + 1 DST-I = 15; DCT-I 1 forward + 2 backward = 3
    "BS_TUBE_NODE_HEJ4": {"fft_stockham": 15, "fft_stockham_twiddle": 3},
    # the runtime phase's clean (P,P,P) 256^3 solves: the PPP pattern
    "GET_SOLVER": {"fft_stockham": 5, "fft_stockham_scale": 1},
    "VERIFY_PPP": {"fft_stockham": 5, "fft_stockham_scale": 1},
    # the distributed phase runs the same kernels on each rank's pencil:
    # the single-process counts per rank, except that overlap:2 runs the
    # transform after each switch once per chunk (the last forward one
    # excepted: it is fused with the Green multiply on the whole block).
    # (U,U,U): forwards 1 + 2, backwards 2 + 2 x 2 + 2 x 2 = 13
    "DIST1_UUU/a2a:1": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "DIST1_UUU/pipelined:2": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "DIST1_UUU/fused:1": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "DIST1_UUU/overlap:2": {"fft_stockham": 13, "fft_stockham_scale": 1},
    "DIST1_SEMI/a2a:1": {"fft_stockham": 6, "fft_stockham_scale": 1,
                         "fft_stockham_twiddle": 1},
    "DIST1_SEMI/overlap:2": {"fft_stockham": 10, "fft_stockham_scale": 1,
                             "fft_stockham_twiddle": 1},
    # NODE: the NODE_UUU counts; under overlap:2 the last forward FFT is
    # not fused (the Green multiply runs apart), so four of the six
    # transforms run once per chunk
    "DIST1_NODE/a2a:1": {"fft_stockham": 6, "spectral_scale": 1},
    "DIST1_NODE/overlap:2": {"fft_stockham": 10, "spectral_scale": 1},
    # four gloo ranks: summed over the ranks, each the one-rank count
    "DIST4_GLOO_UUU/a2a:1": {"fft_stockham": 32, "fft_stockham_scale": 4},
    "DIST4_GLOO_UUU/pipelined:2": {"fft_stockham": 32,
                                   "fft_stockham_scale": 4},
    "DIST4_GLOO_UUU/fused:1": {"fft_stockham": 32, "fft_stockham_scale": 4},
    "DIST4_GLOO_UUU/overlap:2": {"fft_stockham": 52, "fft_stockham_scale": 4},
    "DIST4_GLOO_POD/a2a:1": {"fft_stockham": 32, "fft_stockham_scale": 4},
    # NODE (E,E),(O,E),(P,P) n=64, per rank the single-process plan's 2
    # Stockham, 1 FFT x Green (the periodic r2c) and 3 twiddle launches
    # (the r2r kinds on power-of-two extensions); overlap:2 runs the three
    # transforms its chunked stages carry (forward d1, backward d1 and d0)
    # once per chunk
    "DIST4_GLOO_NODE/a2a:1": {"fft_stockham": 8, "fft_stockham_scale": 4,
                              "fft_stockham_twiddle": 12},
    "DIST4_GLOO_NODE/overlap:2": {"fft_stockham": 12,
                                  "fft_stockham_scale": 4,
                                  "fft_stockham_twiddle": 20},
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
# other spectral_scale shapes, and the two-pass calls
ALSO_TIMED = {"spectral_scale": ("SYM384", "BS_UUU"),
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
# absolute L_inf velocity error of the vortex tube at NODE n=64, HEJ4,
# spectral derivatives, float64 on the reference,
# repro.core.biot_savart.BiotSavartSolver (engine="xla") on the CPU
# (``linf(64, HEJ4, 0, NODE)`` of tests/test_biot_savart.py); the port is
# held to 1.5 times it
BS_TUBE_REF_LINF = 3.2254603631041157e-3


KERNELS = ("fft_stockham", "fft_stockham_scale", "spectral_scale",
           "twiddle_pack", "fft_stockham_twiddle")


def _describe(kname, x, a, kw):
    """A kernel call's descriptor: the kernel, x's shape, strides, offset
    and dtype, the other tensor arguments' shapes and the scalar
    arguments -- what a replay needs."""
    import torch
    args = tuple(("t", tuple(v.shape)) if torch.is_tensor(v)
                 else ("v", v) for v in a)
    return (kname, (tuple(x.shape), x.stride(), x.storage_offset(),
                    x.dtype), args, tuple(sorted(kw.items())))


@contextlib.contextmanager
def _recorded(run, calls):
    """Every kernel call through ``repro_torch.kernels.ops`` inside the
    block is recorded as ``calls[(run, descriptor)] += 1``."""
    from repro_torch.kernels import ops
    saved = {k: getattr(ops, k) for k in KERNELS}

    def recording(kname):
        def call(x, *a, **kw):
            key = (run, _describe(kname, x, a, kw))
            calls[key] = calls.get(key, 0) + 1
            return saved[kname](x, *a, **kw)
        return call
    for k in KERNELS:
        setattr(ops, k, recording(k))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)


# the distributed phase: the one-rank mesh's backend, how the four gloo
# ranks start, the process groups' timeout, and the comm strategies run
DIST_BACKEND = "nccl"
DIST_START = "spawn"
GROUP_TIMEOUT_S = 300
DIST_STRATEGIES = ("a2a:1", "pipelined:2", "fused:1", "overlap:2")


def _dist4_rank(rank, world, d):
    """One of the four gloo ranks of DIST4_GLOO on the one card: (U,U,U)
    under every strategy and comm="auto", the NODE uneven split in
    float64 and the pod batch, each against the parent's single-process
    solve.  Writes its launch counts, kernel calls, errors and times to
    ``<d>/rank<rank>.pkl``."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.bc import BCType, DataLayout
    from repro_torch.core.comm import cfg_label, label_to_cfg
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    from repro_torch.kernels import LAUNCHES, reset_launches

    d = Path(d)
    with open(d / "params.json") as fh:
        prm = json.load(fh)
    dev = torch.device(prm["device"])
    cuda = dev.type == "cuda"
    if cuda:
        # every rank on the one card
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dist.init_process_group(
        "gloo", init_method=f"file://{d}/gloo", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))

    def load(key, dtype=None):
        t = torch.from_numpy(np.load(d / f"{key}.npy"))
        return t.to(dev) if dtype is None else t.to(dev, dtype)

    out = {"runs": {}, "calls": {}}

    def counted(run, fn, want):
        with _recorded(run, out["calls"]):
            sync()
            reset_launches()
            u = fn()
            sync()
        rel = ((u - want).abs().max() / want.abs().max()).item()
        if not torch.isfinite(u).all() or u.shape != want.shape:
            raise AssertionError(f"{run}: rank {rank} output {u.shape}")
        out["runs"][run] = {"counts": {k: v for k, v in LAUNCHES.items()
                                       if v}, "rel": rel}
        return u

    def median_ms(fn):
        fn()
        ts = []
        for _ in range(prm["reps"]):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    U = (BCType.UNB, BCType.UNB)
    E, O, P = BCType.EVEN, BCType.ODD, (BCType.PER, BCType.PER)
    n4 = prm["n4"]
    f4, u4, g4 = load("f4"), load("u4"), np.load(d / "g4.npy")
    mesh = init_device_mesh(dev.type, (2, 2), mesh_dim_names=("data", "model"))
    kw = dict(mesh=mesh, device=dev)
    for lbl in prm["strategies"]:
        run = f"DIST4_GLOO_UUU/{lbl}"
        ds = DistributedPoissonSolver((n4,) * 3, 1.0, (U, U, U),
                                      comm=label_to_cfg(lbl),
                                      _green_cache=g4, **kw)
        counted(run, lambda: ds.solve(f4), u4)
        if ds.stats["degradations"] or ds.stats["retries"]:
            raise AssertionError(f"{run}: {ds.stats}")
        x = ds.shard_input(f4)
        out["runs"][run]["ms"] = median_ms(lambda: ds.solve_local(x))
    ds = DistributedPoissonSolver((n4,) * 3, 1.0, (U, U, U), comm="auto",
                                  autotune_search="brute", _green_cache=g4,
                                  **kw)
    u = ds.solve(f4)
    out["winner"] = cfg_label(ds.comm)
    out["timed"] = dict(ds.autotune_results)
    out["auto_rel"] = ((u - u4).abs().max() / u4.abs().max()).item()
    # the node-centered uneven split: 65 points over 2 ranks a direction
    fn, un, gn = load("fn"), load("un"), np.load(d / "gn.npy")
    for lbl in ("a2a:1", "overlap:2"):
        run = f"DIST4_GLOO_NODE/{lbl}"
        ds = DistributedPoissonSolver(
            (64,) * 3, 1.0, ((E, E), (O, E), P), DataLayout.NODE,
            comm=label_to_cfg(lbl), dtype=torch.float64, _green_cache=gn,
            **kw)
        counted(run, lambda: ds.solve(fn), un)
        if out["runs"][run]["rel"] > 1e-10:
            raise AssertionError(f"{run}: {out['runs'][run]['rel']:.3e}")
    # the pod batch: two fields over the "pod" axis of a (2, 1, 2) mesh
    mesh3 = init_device_mesh(dev.type, (2, 1, 2),
                             mesh_dim_names=("pod", "data", "model"))
    ds = DistributedPoissonSolver((n4,) * 3, 1.0, (U, U, U), mesh=mesh3,
                                  batch_axis="pod", device=dev,
                                  _green_cache=g4)
    counted("DIST4_GLOO_POD/a2a:1", lambda: ds.solve(torch.stack(
        [f4, 2.0 * f4])), torch.stack([u4, 2.0 * u4]))
    for run, res in out["runs"].items():
        if res["rel"] > 1e-5:
            raise AssertionError(f"{run}: rank {rank} relative max |diff| "
                                 f"{res['rel']:.3e} > 1e-5")
    with open(d / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


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

    def run_counted(run, fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after, each kernel call recorded under ``run``; the counts
        must be EXPECTED[run] exactly, and the two-pass calls among them
        EXPECTED_TWO_PASS[run] (none where the run has no entry)."""
        with _recorded(run, calls):
            sync()
            reset_launches()
            out = fn()
            sync()
            counts = dict(LAUNCHES)
            two = {k: v for k, v in TWO_PASS.items() if v}
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

    def clean(run, *solvers):
        """No retry and no degradation behind a main-path solve: the
        ladder's torch.fft rung must never hide a kernel."""
        for s in solvers:
            if s.stats["degradations"] or s.stats["retries"]:
                raise AssertionError(f"{run}: degradations "
                                     f"{s.stats['degradations']}, retries "
                                     f"{s.stats['retries']}")

    def close(what, u, want, rtol=1e-5):
        """``u`` against ``want``: shape, dtype, finite, within ``rtol`` of
        max |want| relative (the cuda engine's float32 output against the
        torch engine's, a distributed solve against the single-process
        one)."""
        sync()
        if u.shape != want.shape or u.dtype != want.dtype:
            raise AssertionError(f"{what}: output {tuple(u.shape)} {u.dtype}"
                                 f", expected {tuple(want.shape)} "
                                 f"{want.dtype}")
        if not torch.isfinite(u).all():
            raise AssertionError(f"{what}: non-finite solution")
        rel = ((u - want).abs().max() / want.abs().max()).item()
        if rel > rtol:
            raise AssertionError(f"{what}: relative max |diff| {rel:.3e} > "
                                 f"{rtol}")
        return rel

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
        clean(case, sc, st)
        rel = close(f"{case} cuda vs torch engine", u, ut)
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
        clean(run, sq)
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

    # -- 6. Biot-Savart -------------------------------------------------------
    from scipy.special import expn
    from repro_torch.core.biot_savart import BiotSavartSolver
    # vorticity BCs bcs[c][d]: the paper's vortex tube (x, y unbounded; z
    # odd for w_x, w_y and even for w_z), and all nine pairs unbounded
    tube = [[U, U, (O, O)], [U, U, (O, O)], [U, U, (E, E)]]
    bs_runs = {"BS_TUBE": (tube, False), "BS_UUU": ([[U, U, U]] * 3, True)}
    for case, (bcs, batched) in bs_runs.items():
        t0 = time.perf_counter()
        bc = BiotSavartSolver((N,) * 3, 1.0, bcs, engine="cuda", device=dev)
        bt = BiotSavartSolver((N,) * 3, 1.0, bcs, engine="torch",
                              device=dev, greens=bc.greens)
        t_plan = time.perf_counter() - t0
        if bc.batched != batched:
            raise AssertionError(f"{case}: batched {bc.batched}")
        f = torch.from_numpy(rng.standard_normal(bc.input_shape).astype(
            np.float32)).to(dev)
        u, counts = run_counted(case, lambda: bc.solve(f))
        rel = close(f"{case} cuda vs torch engine", u, bt.solve(f))
        n_green = len({id(g) for g in bc.greens})
        tag = f"{case} n={N}"
        print(f"biot-savart {tag} ({'batched' if batched else 'sequential'}"
              f"): plan+green {t_plan:.2f} s ({n_green} Green's function"
              f"{'s' if n_green > 1 else ''} assembled), launches "
              f"{ {k: v for k, v in counts.items() if v} }, cuda vs torch "
              f"engine relative max |diff| {rel:.3e}")
        solvers[tag] = (bc, bt, f)

    def tube_fields(n, length=1.0):
        """The vortex tube at NODE (tests/test_biot_savart.py): radius
        0.3 L about the z axis through the centre, compact vorticity -w_z
        and its exact azimuthal velocity."""
        rad, e21 = 0.3 * length, expn(2, 1.0)
        x1 = np.arange(n + 1) * (length / n)
        x, y, _ = np.meshgrid(x1, x1, x1, indexing="ij")
        dx, dy = x - 0.5 * length, y - 0.5 * length
        r = np.hypot(dx, dy)
        s2 = (r / rad) ** 2
        inside = s2 < 0.999999
        s2c = np.where(inside, s2, 0.0)
        wz = np.where(inside, (1.0 / (2.0 * np.pi)) * (2.0 / rad ** 2) / e21
                      * np.exp(-1.0 / (1.0 - s2c)), 0.0)
        rs = np.where(r > 1e-12, r, 1.0)
        with np.errstate(over="ignore"):
            arg = 1.0 / np.where(inside, 1.0 - s2c, 1.0)
        bracket = np.where(inside, 1.0 - (1.0 - s2c) * expn(2, arg) / e21,
                           1.0)
        ut = np.where(r > 1e-12, bracket / (2.0 * np.pi * rs), 0.0)
        ux = np.where(r > 1e-12, -dy / rs * ut, 0.0)
        uy = np.where(r > 1e-12, dx / rs * ut, 0.0)
        zero = np.zeros_like(wz)
        return np.stack([zero, zero, -wz]), np.stack([ux, uy, zero])

    f_t, u_exact = tube_fields(na, L)
    sq = BiotSavartSolver((na,) * 3, L, tube, layout=DataLayout.NODE,
                          green_kind=GreenKind.HEJ4, engine="cuda",
                          device=dev)
    uq, counts = run_counted("BS_TUBE_NODE_HEJ4", lambda: sq.solve(f_t))
    linf = np.abs(uq.cpu().numpy() - u_exact).max()
    if not linf <= 1.5 * BS_TUBE_REF_LINF:
        raise AssertionError(f"BS_TUBE_NODE_HEJ4: L_inf {linf:.4e} > "
                             f"{1.5 * BS_TUBE_REF_LINF:.4e}")
    print(f"analytic BS_TUBE_NODE_HEJ4 n={na} float64: velocity L_inf "
          f"{linf:.4e} (reference {BS_TUBE_REF_LINF:.4e}, bound "
          f"{1.5 * BS_TUBE_REF_LINF:.4e}), launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    del sq, uq

    # -- 7. the runtime: plan cache, health guard, degradation ladder --------
    from repro_torch.core.solver import (clear_solver_cache, get_solver,
                                         solver_cache_info)
    from repro_torch.runtime import faults
    clear_solver_cache()
    ppp = (P, P, P)
    g1 = get_solver((N,) * 3, 1.0, ppp, device=dev)
    g2 = get_solver((N,) * 3, 1.0, ppp, device=dev)
    info = solver_cache_info()
    if g2 is not g1 or info["hits"] != 1 or info["misses"] != 1:
        raise AssertionError(f"get_solver: same instance {g2 is g1}, "
                             f"cache {info}")
    # a smooth periodic field: u = sin(2 pi x) sin(4 pi y) cos(2 pi z)
    xc = (np.arange(N) + 0.5) / N
    xg, yg, zg = np.meshgrid(xc, xc, xc, indexing="ij", sparse=True)
    sol = np.sin(2 * np.pi * xg) * np.sin(4 * np.pi * yg) * \
        np.cos(2 * np.pi * zg)
    rhs = torch.from_numpy((-24.0 * np.pi ** 2 * sol).astype(
        np.float32)).to(dev)
    u1, _ = run_counted("GET_SOLVER", lambda: g1.solve(rhs))
    u2 = g2.solve(rhs)
    clean("GET_SOLVER", g1)
    if not torch.equal(u1, u2):
        raise AssertionError("get_solver: a second solve changed the bits")
    e_sol = np.abs(u1.cpu().numpy() - sol).max() / np.abs(sol).max()
    if not e_sol < 1e-5:
        raise AssertionError(f"(P,P,P) sine field: relative E_inf {e_sol}")
    gv = get_solver((N,) * 3, 1.0, ppp, device=dev, verify="residual")
    uv, _ = run_counted("VERIFY_PPP", lambda: gv.solve(rhs))
    clean("VERIFY_PPP", gv)
    if not torch.equal(uv, u1):
        raise AssertionError("verify='residual' changed the solution")
    res = gv.stats["last_residual"]
    print(f"runtime: get_solver hit (cache {solver_cache_info()}), the same "
          f"bits on a second solve; (P,P,P) n={N} sine field relative "
          f"E_inf {e_sol:.3e}; verify='residual' passed, last_residual "
          f"{res:.4e}")
    # an inf written into the Green stage's input on the cuda engine: the
    # guard trips and the ladder walks one rung, to the torch engine
    sf = PoissonSolver((N,) * 3, 1.0, ppp, engine="cuda", device=dev,
                       verify="residual")
    with faults.FaultPlan([dict(kind="inf", stage="green")]) as plan:
        uf = sf.solve(rhs)
    trail = [d["action"] for d in sf.stats["degradations"]]
    rel = ((uf - u1).abs().max() / u1.abs().max()).item()
    if (not plan.log or trail != ["engine:cuda->torch"]
            or sf.stats["verify_failures"] != 1 or rel > 1e-5):
        raise AssertionError(f"inf at green: fired {plan.log}, trail "
                             f"{trail}, stats {sf.stats}, rel {rel:.3e}")
    print(f"runtime: inf at 'green' fired {len(plan.log)}x, tripped at "
          f"{sf.stats['degradations'][0]['stage']}, trail {trail}, "
          f"within {rel:.3e} of the clean cuda solve")
    # every hand-kernel fail point armed for good (a kernel that cannot
    # be built): the solve degrades to torch.fft and equals its solve
    sl = PoissonSolver((N,) * 3, 1.0, ppp, engine="cuda", device=dev)
    with faults.FaultPlan([dict(kind="pallas_lowering", stage="cuda.*",
                                count=-1)]) as plan:
        ul = sl.solve(rhs)
    trail = [d["action"] for d in sl.stats["degradations"]]
    want = PoissonSolver((N,) * 3, 1.0, ppp, engine="torch", device=dev,
                         green=sl._green_nat).solve(rhs)
    if (trail != ["engine:cuda->torch"] or sl._cfg["engine"] != "torch"
            or not torch.equal(ul, want)):
        raise AssertionError(f"cuda.* fault: trail {trail}, config "
                             f"{sl._cfg}, equal {torch.equal(ul, want)}")
    print(f"runtime: cuda.* build fault fired at {plan.log[0]['stage']}, "
          f"trail {trail}, equal to the torch engine's solve")
    # a kernel that really fails to launch, with no fault armed: the solve
    # raises SolveError and never gives way to torch.fft
    from repro_torch.kernels import ops
    from repro_torch.runtime import SolveError
    sr = PoissonSolver((32,) * 3, 1.0, ppp, engine="cuda", device=dev)
    real_scale = ops.fft_stockham_scale

    def failing_scale(*a, **kw):
        raise RuntimeError("fft_stockham_scale: launch failed")

    ops.fft_stockham_scale = failing_scale
    try:
        sr.solve(torch.ones(sr.input_shape, device=dev))
        raised = None
    except SolveError as e:
        raised = e
    finally:
        ops.fft_stockham_scale = real_scale
    if (raised is None or raised.degradations or sr.stats["degradations"]
            or sr._cfg["engine"] != "cuda"):
        raise AssertionError(f"real launch failure: raised {raised!r}, "
                             f"stats {sr.stats}, config {sr._cfg}")
    print(f"runtime: a real launch failure raised SolveError at stage "
          f"{raised.stage!r}, no rung taken")
    del g1, g2, gv, sf, sl, sr, u1, u2, uv, uf, ul, want, rhs
    clear_solver_cache()

    # -- timing helpers (phases 8 and 9) -------------------------------------
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
        n_copy = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                a = agg.setdefault(e.name, [0.0, 0])
                a[0] += e.time_range.elapsed_us() / 1e3
                a[1] += 1
            elif e.name == "aten::copy_":
                n_copy += 1
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
              f"x{sum(c for _, c in fft)}; aten::copy_ x{n_copy}; {top}")

    # -- 8. the distributed solve --------------------------------------------
    # DIST1: a one-rank NCCL mesh, the whole distributed pipeline (pack,
    # collective, unpack, the kernels on every pencil) at full size
    import tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.comm import label_to_cfg
    from repro_torch.core.engine import relayout
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group(
        DIST_BACKEND, init_method=f"file://{tmp.name}/one_rank", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh1 = init_device_mesh(dev.type, (1, 1),
                             mesh_dim_names=("data", "model"))
    dist_launches = {}

    def copies(fn):
        """aten::copy_ calls the host issues in ``fn()``."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            sync()
        return sum(e.name == "aten::copy_" for e in prof.events())

    semi = ((BCType.UNB, E), U, U)
    sp_semi = PoissonSolver((N // 2,) * 3, 1.0, semi, engine="cuda",
                            device=dev)
    f_semi = torch.from_numpy(rng.standard_normal(
        sp_semi.input_shape).astype(np.float32)).to(dev)
    # NODE (U,U,U) float64: the Green multiply apart (spectral_scale)
    sp_node = PoissonSolver((64,) * 3, 1.0, (U, U, U),
                            layout=DataLayout.NODE, engine="cuda",
                            device=dev)
    f_node = torch.from_numpy(rng.standard_normal(sp_node.input_shape)).to(
        dev)
    sp_uuu, _, f_uuu = solvers[f"UUU n={N}"]
    # case: (bcs, cells, layout, single-process solver, field, strategies,
    # relative tolerance)
    dist1 = {"DIST1_UUU": ((U, U, U), N, DataLayout.CELL, sp_uuu, f_uuu,
                           DIST_STRATEGIES, 1e-5),
             "DIST1_SEMI": (semi, N // 2, DataLayout.CELL, sp_semi, f_semi,
                            ("a2a:1", "overlap:2"), 1e-5),
             "DIST1_NODE": ((U, U, U), 64, DataLayout.NODE, sp_node, f_node,
                            ("a2a:1", "overlap:2"), 1e-10)}
    nat = (0, 1, 2)
    for case, (bcs, nn, layout, sp, f, labels, rtol) in dist1.items():
        u_sp = sp.solve(f)
        t_sp = time_ms(lambda: sp.solve(f))
        print(f"{case} {layout.name} n={nn} {f.dtype}, one-rank "
              f"{DIST_BACKEND} mesh (1, 1); "
              f"single-process cuda solve {t_sp:.3f} ms, aten::copy_ "
              f"x{copies(lambda: sp.solve(f))} per solve; card: {smi}")
        where_the_time_goes(f"{case} single-process", lambda: sp.solve(f),
                            t_sp)
        for lbl in labels:
            run = f"{case}/{lbl}"
            ds = DistributedPoissonSolver(
                (nn,) * 3, 1.0, bcs, layout, mesh=mesh1,
                comm=label_to_cfg(lbl), dtype=f.dtype, device=dev,
                _green_cache=sp._green_nat)
            u, counts = run_counted(run, lambda: ds.solve(f))
            clean(run, ds)
            rel = close(f"{run} against the single-process solve", u, u_sp,
                        rtol)
            dist_launches[run] = {k: v for k, v in counts.items() if v}
            x = ds.shard_input(f)
            t_loc = time_ms(lambda: ds.solve_local(x))
            sync()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ds.solve_local(x)
            sync()
            mem = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
            # the first forward switch alone, at its shape: the copies the
            # strategy itself makes
            d0 = ds.plan.order[0]
            lay = ds.schedule.layouts.fwd
            y0 = ds.schedule.fwd_last(relayout(x, nat, lay[0]), d0)
            strat = ds._strategy(ds.comm)
            n_sw = copies(lambda: strat.switch(
                y0, "data", 0, 2, valid_extent=ds._S[d0],
                permute=tuple(lay[0].index(d) for d in lay[1])))
            print(f"  {run}: launches {dist_launches[run]}, relative max "
                  f"|diff| {rel:.3e} from the single-process solve; "
                  f"solve_local {t_loc:.3f} ms against {t_sp:.3f} ms "
                  f"single-process ({t_loc - t_sp:+.3f} ms for the "
                  f"switches); memory {mem:.3f} GiB above "
                  f"{resident / 2 ** 30:.3f} GiB resident; aten::copy_ "
                  f"x{copies(lambda: ds.solve_local(x))} per solve_local, "
                  f"x{n_sw} in one switch alone")
            where_the_time_goes(f"{run} solve_local",
                                lambda: ds.solve_local(x), t_loc)
            del ds, x, y0, u
    dist.destroy_process_group()
    del sp_semi, f_semi, sp_node, f_node, u_sp

    # DIST4: four gloo ranks on the one card (NCCL refuses two ranks on one
    # device); gloo stages CUDA tensors through the host, so these runs
    # prove the exchange on the card and are not a communication figure
    n4 = N // 2
    s4 = PoissonSolver((n4,) * 3, 1.0, (U, U, U), engine="cuda", device=dev)
    f4 = rng.standard_normal(s4.input_shape).astype(np.float32)
    node_bcs = ((E, E), (O, E), P)
    sn = PoissonSolver((64,) * 3, 1.0, node_bcs, layout=DataLayout.NODE,
                       engine="cuda", device=dev)
    fn = rng.standard_normal(sn.input_shape)
    d4 = Path(tmp.name)
    for key, arr in (("f4", f4), ("g4", s4._green_nat), ("fn", fn),
                     ("gn", sn._green_nat),
                     ("u4", s4.solve(torch.from_numpy(f4).to(dev)).cpu()),
                     ("un", sn.solve(torch.from_numpy(fn).to(dev)).cpu())):
        np.save(d4 / f"{key}.npy", np.asarray(arr))
    with open(d4 / "params.json", "w") as fh:
        json.dump({"device": str(dev), "n4": n4, "reps": REPS,
                   "strategies": DIST_STRATEGIES}, fh)
    del s4, sn
    print(f"DIST4_GLOO: 4 gloo ranks on one card, spawning "
          f"({time.perf_counter() - t0:.1f} s into the phase)")
    mp.start_processes(_dist4_rank, args=(4, str(d4)), nprocs=4,
                       start_method=DIST_START)
    ranks = []
    for r in range(4):
        # written by this script's own ranks just above
        with open(d4 / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    tmp.cleanup()
    for run in ranks[0]["runs"]:
        total = collections.Counter()
        for res in ranks:
            total.update(res["runs"][run]["counts"])
        got = {k: v for k, v in total.items() if v}
        if got != EXPECTED[run]:
            raise AssertionError(f"{run}: launches summed over the ranks "
                                 f"{got}, expected {EXPECTED[run]}")
        dist_launches[run] = got
        rel = max(res["runs"][run]["rel"] for res in ranks)
        ms = max(res["runs"][run].get("ms", 0.0) for res in ranks)
        print(f"  {run}: launches over the 4 ranks {got}, relative max "
              f"|diff| {rel:.3e} from the single-process solve"
              + (f"; solve_local {ms:.3f} ms (host-staged by gloo, not a "
                 "communication figure)" if ms else ""))
    winners = {res["winner"] for res in ranks}
    if len(winners) != 1:
        raise AssertionError(f"DIST4 comm='auto': ranks chose {winners}")
    print(f"  DIST4_GLOO_UUU comm='auto' (brute, {len(ranks[0]['timed'])} "
          f"candidates): every rank chose {winners.pop()}, relative max "
          f"|diff| {max(res['auto_rel'] for res in ranks):.3e}; agreed "
          f"times (host-staged) "
          + ", ".join(f"{k} {v * 1e3:.2f} ms"
                      for k, v in sorted(ranks[0]["timed"].items(),
                                         key=lambda kv: kv[1])))
    for res in ranks:
        for key, c in res["calls"].items():
            calls[key] = calls.get(key, 0) + c
    print(f"distributed phase: {len(dist_launches)} runs in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 9. replays and times -------------------------------------------------
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
            "library_ms": None if kname in lib_none else p["library_ms"],
            "dist_launches": {r: c[kname] for r, c in dist_launches.items()
                              if kname in c}})
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
