#!/usr/bin/env python3
"""Whole ``PoissonSolver.solve`` calls of this checkout against another
checkout's, in turns, on one NVIDIA GPU.

    git archive <commit> | tar -x -C build/other
    python3 tools/compare_solve.py build/other

Each turn is a fresh process that imports ``repro_torch`` from one tree
(building that tree's kernels on its first turn) and times the
``"cuda"``-engine solves of ``chip_smoke.py``'s 128^3 float32 cases,
where the host's launch gaps are a large share of the solve and any
per-solve host cost of the Python layers shows: (U,U,U), (U,P,U),
(P,P,P), (U,U,U) with B=2 and SEMI_O (U,U),(U,U),(O,U).  Two times per
case: the median of 15 CUDA-event-timed single solves after 3 warm-ups
("single", launch gaps included), and the time per solve of 100 solves
back to back between one event pair ("stream": where the host cannot
keep ahead of the device, its cost per solve).  Two host times, from the
host's clock with the device idle before each call (the median of 42):
the whole ``solve`` call ("host", the enqueue time of one solve), and
the bare scheduled pipeline ``_solve_scheduled`` of the same solver
("host-pipeline"), in alternation.  Their difference is the host cost of
what ``solve`` wraps around the pipeline (argument checks and, in a tree
with the resilient runtime, the degradation ladder), measured inside one
process.  The turns run other, this, this, other, three times over; the
script prints every time, each tree's median per case and their ratio,
and each tree's median ``host - host-pipeline``.  Exits 2 without a CUDA
device.

    python3 tools/compare_solve.py --host build/other

times the host alone, with no device: the same turns of CPU-tensor 8^3
solves on the ``"torch"`` engine, one thread, 4000 alternating pairs of
``solve`` and its bare pipeline a turn; it prints each tree's median
pipeline time and median ``solve - pipeline`` ("wrap"), in
microseconds, and this tree's minus the other's.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 128
REPS = 15
STREAM = 100
HOST_REPS = 42
CPU_REPS = 4000
ROUNDS = 3


def _alternate(s, f, reps, sync):
    """Host times of ``s.solve(f)`` and of its bare scheduled pipeline,
    in alternation (each goes first on every other turn, so neither gains
    from the order), each after ``sync()``: two lists of seconds."""
    whole, bare = [], []
    calls = ((whole, lambda: s.solve(f)),
             (bare, lambda: s._solve_scheduled(f).to(f.dtype).contiguous()))
    for i in range(reps):
        for sink, call in (calls if i % 2 == 0 else calls[::-1]):
            sync()
            t0 = time.perf_counter()
            call()
            sink.append(time.perf_counter() - t0)
    sync()
    return whole, bare


def host_worker(tree: str) -> int:
    """The host cost of ``solve`` alone: CPU-tensor solves at 8^3 on the
    ``"torch"`` engine, one thread, where a solve is a few hundred
    microseconds of Python and small torch calls and nothing waits on a
    device.  Prints the median pipeline time and the median of
    ``solve - pipeline`` over alternating pairs, in microseconds."""
    sys.path.insert(0, str(Path(tree) / "src"))
    import numpy as np
    import torch
    from repro_torch.core.bc import BCType
    from repro_torch.core.solver import PoissonSolver

    torch.set_num_threads(1)
    U, P = (BCType.UNB,) * 2, (BCType.PER,) * 2
    out = {}
    for case, bcs in (("UUU", (U, U, U)), ("PPP", (P, P, P))):
        s = PoissonSolver((8,) * 3, 1.0, bcs, engine="torch", device="cpu")
        f = torch.from_numpy(np.random.default_rng(0).standard_normal(
            s.input_shape).astype(np.float32))
        _alternate(s, f, 100, lambda: None)
        whole, bare = _alternate(s, f, CPU_REPS, lambda: None)
        out[f"{case} pipeline"] = 1e6 * statistics.median(bare)
        out[f"{case} wrap"] = 1e6 * statistics.median(
            w - b for w, b in zip(whole, bare))
    print(json.dumps(out))
    return 0


def worker(tree: str) -> int:
    sys.path.insert(0, str(Path(tree) / "src"))
    import numpy as np
    import torch
    from repro_torch.core.bc import BCType
    from repro_torch.core.solver import PoissonSolver
    from repro_torch.kernels import _build

    _build.build()
    _build.library()
    U, P = (BCType.UNB,) * 2, (BCType.PER,) * 2
    cases = {"UUU": ((U, U, U), None), "UPU": ((U, P, U), None),
             "PPP": ((P, P, P), None), "UUU_B2": ((U, U, U), 2),
             "SEMI_O": ((U, U, (BCType.ODD, BCType.UNB)), None)}
    rng = np.random.default_rng(0)
    out = {}
    for case, (bcs, batch) in cases.items():
        s = PoissonSolver((N,) * 3, 1.0, bcs, device="cuda")
        shape = ((batch,) if batch else ()) + s.input_shape
        f = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
        for _ in range(3):
            s.solve(f)
        torch.cuda.synchronize()
        ts = []
        for _ in range(REPS):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            s.solve(f)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(STREAM):
            s.solve(f)
        b.record()
        b.synchronize()
        out[f"{case} single"] = statistics.median(ts)
        out[f"{case} stream"] = a.elapsed_time(b) / STREAM
        whole, bare = _alternate(s, f, HOST_REPS, torch.cuda.synchronize)
        out[f"{case} host"] = 1e3 * statistics.median(whole)
        out[f"{case} host-pipeline"] = 1e3 * statistics.median(bare)
    print(json.dumps(out))
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] in ("--worker", "--host-worker"):
        run = worker if sys.argv[1] == "--worker" else host_worker
        return run(sys.argv[2])
    import torch
    host = sys.argv[1:2] == ["--host"]
    if len(sys.argv) != 2 + host or not (host
                                         or torch.cuda.is_available()):
        print("usage: compare_solve.py [--host] <other tree> (without "
              "--host, on a CUDA device)", file=sys.stderr)
        return 2
    trees = {"other": str(Path(sys.argv[-1]).resolve()), "this": str(ROOT)}
    if torch.cuda.is_available():
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(f"card: {smi}")
    times = {k: [] for k in trees}
    unit = "us" if host else "ms"
    for _ in range(ROUNDS):
        for who in ("other", "this", "this", "other"):
            res = subprocess.run([sys.executable, __file__,
                                  "--host-worker" if host else "--worker",
                                  trees[who]], capture_output=True,
                                 text=True, check=True)
            got = json.loads(res.stdout.strip().splitlines()[-1])
            times[who].append(got)
            print(f"{who}: " + ", ".join(f"{k} {v:.4f} {unit}"
                                         for k, v in got.items()))
    if host:
        for case in times["this"][0]:
            med = {w: statistics.median(t[case] for t in times[w])
                   for w in trees}
            print(f"{case}, CPU 8^3: this {med['this']:.2f} us, other "
                  f"{med['other']:.2f} us, this - other "
                  f"{med['this'] - med['other']:.2f} us")
        return 0
    for case in times["this"][0]:
        med = {w: statistics.median(t[case] for t in times[w])
               for w in trees}
        print(f"{case}, n={N}: this {med['this']:.4f} ms, other "
              f"{med['other']:.4f} ms, this/other "
              f"{med['this'] / med['other']:.3f}")
    for case in (k[:-5] for k in times["this"][0] if k.endswith(" host")):
        wrap = {w: statistics.median(t[f"{case} host"]
                                     - t[f"{case} host-pipeline"]
                                     for t in times[w]) for w in trees}
        print(f"{case}, n={N}: solve's host time around the pipeline: "
              f"this {1e3 * wrap['this']:.1f} us, other "
              f"{1e3 * wrap['other']:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
