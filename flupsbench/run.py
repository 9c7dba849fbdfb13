"""Run one cell of the benchmark of ``repro_torch`` and print its result.

    python3 flupsbench/run.py --workload <name> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; a mix of more
than one rank starts the other ranks itself (``spawn``; NCCL, one card
each, the rendezvous in a fresh directory under ``TMPDIR``) and runs rank
0 in this process.  With ``--trace 0`` the last line of standard output
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
ones, read from a profiled stretch of the window.  The numbers compared
with the plain reference come last, on standard error and in the result.

Exits 2, printing no result, without enough CUDA cards, and 1, printing
no result, without the program or when JAX, Flax or the JAX package
``repro`` is loaded in this process once the window has closed (looked
for again just before the result is printed, after the reference and
the metric readers have run).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
# every build and kernel cache at a fixed place inside the checkout (the
# hand kernels' library goes to build/kernels, kernels/_build.py)
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def say(msg: str):
    print(msg, file=sys.stderr, flush=True)


def cards(fields: str) -> str:
    """``nvidia-smi``'s reading of ``fields`` on each card, one card's
    after another."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return "; ".join(out.stdout.strip().splitlines()) or \
            f"not read ({out.stderr.strip()})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


# the cards' state beside a run's numbers: a slower clock or a warmer card
# shows here, a slower host does not
CARD_STATE = "temperature.gpu,clocks.sm,clocks.mem"


def run_ranks(cell, seeds, seconds, trace, device_type, root=ROOT, t0=None,
              patch=None):
    """Drive ``cell`` on the ranks its traffic names: ``[Run, ...]`` of
    rank 0 (one per seed).  More than one rank: ranks 1.. are spawned, and
    all are joined before this returns."""
    import torch
    from flupsbench import stepper
    world = int(cell.traffic["ranks"])
    if world == 1:
        device = torch.device(device_type)
        if device.type == "cuda":
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        return stepper.drive(cell, seeds, seconds, trace, device, t0=t0,
                             patch=patch)
    import multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="flupsbench-")
    init = f"file://{os.path.join(tmp, 'rendezvous')}"
    ctx = mp.get_context("spawn")
    args = (world, init, str(root), cell.name, list(seeds), seconds, trace,
            device_type)
    procs = [ctx.Process(target=stepper.rank_entry,
                         args=(r, *args, None, patch))
             for r in range(1, world)]
    try:
        for p in procs:
            p.start()
        return stepper.rank_entry(0, *args, t0, patch)
    finally:
        for p in procs:
            p.join(timeout=120)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            say(f"flupsbench: ranks exited with {bad}")


def is_correct(checks: dict) -> bool:
    """Every number compared is within its limit (and there is one)."""
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())


def result(cell, run, trace: bool, world: int, root=ROOT) -> dict:
    """The result line of rank 0's ``run``."""
    from flupsbench import catalog
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = catalog.reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = run.checks
    correct = is_correct(checks)
    device = {"platform": "gpu" if run.device_kind != "cpu" else "cpu",
              "kind": run.device_kind, "count": world,
              "memory_peak_bytes": run.peak_bytes}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.stretch is not None:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.traced_s
        out["breakdown"] = {"device_ops": run.stretch.top_ops(),
                            "idle_gaps": run.stretch.idle_gaps()}
    out["checks"] = checks
    return out


def report(cell, run, trace: bool, world: int, root=ROOT) -> int:
    """Print the result line of rank 0's ``run``, the numbers compared on
    standard error before it; 1, and nothing printed, if JAX, Flax or the
    JAX package is loaded by now (a reference or a metric reader may have
    loaded it after the window's own look)."""
    from flupsbench import stepper
    out = result(cell, run, trace, world, root)
    found = stepper.forbidden_modules()
    if found:
        say(f"flupsbench: {', '.join(found)} loaded in the process that "
            "reports: no result")
        return 1
    for name, c in out["checks"].items():
        say(f"{name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        say(f"flupsbench: no program at {ROOT / 'src' / 'repro_torch'}")
        return 1
    from flupsbench import catalog
    cell = catalog.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"flupsbench: {args.workload} needs {cell.chips} CUDA card(s); "
            f"this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    world = int(cell.traffic["ranks"])
    say(f"flupsbench: {args.workload} seed {args.seed}, {args.seconds} s, "
        f"trace {args.trace}; cards (name, power.limit, {CARD_STATE}): "
        f"{cards('name,power.limit,' + CARD_STATE)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if world > 1:
        peer = [[int(torch.cuda.can_device_access_peer(i, j)) if i != j
                 else 1 for j in range(world)] for i in range(world)]
        say(f"flupsbench: {world} ranks on {torch.cuda.device_count()} "
            f"cards, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
            f"peer access {peer}")
    runs = run_ranks(cell, [args.seed], args.seconds, bool(args.trace),
                     "cuda", t0=T0)
    run = runs[0]
    say(f"flupsbench: after the window and the comparison, {CARD_STATE}: "
        f"{cards(CARD_STATE)}")
    for e in run.errors:
        say(f"flupsbench: failed {e}")
    if world > 1:
        say(f"flupsbench: census, rank 0 sends {run.census_bytes} bytes of "
            "all-to-all a step")
    from flupsbench.stats import percentile
    if run.steps:
        q = [percentile(run.steps, p) * 1e3 for p in (0, 5, 50, 95, 100)]
        say(f"flupsbench: {len(run.steps)} steps, ms min {q[0]:.4f} p5 "
            f"{q[1]:.4f} p50 {q[2]:.4f} p95 {q[3]:.4f} max {q[4]:.4f}")
    if run.host:
        say(f"flupsbench: host enqueue of {len(run.host)} untraced steps, "
            f"ms mean {1e3 * sum(run.host) / len(run.host):.4f} p50 "
            f"{1e3 * percentile(run.host, 50):.4f}")
    if run.stretch is not None:
        kinds = {}
        for _, k, s, e in run.stretch.ops:
            kinds[k] = kinds.get(k, 0) + 1
        say(f"flupsbench: traced {run.stretch.steps} steps, device ops by "
            f"kind {kinds}")
    return report(cell, run, bool(args.trace), world)


if __name__ == "__main__":
    sys.exit(main())
