"""Readings a correctness limit is set from, in one process per cell: the
program on many seeds (one build, one Green's function; each seed its own
ring, warm-up and short window, then the same comparison a run makes) and
the control on a few: the plain reference kept in the configuration's
``control_store`` precision, put in the program's place, driven by the
same window and judged by the same comparison (``stepper.control``).

    python3 flupsbench/calibrate.py --workload <name> --seconds 1 \
        --seeds 1 2 3 ... --controls 7 8 9

One JSON line a seed, the program's first and then the control's, each
with the numbers compared and ``correct``.  Not run by the benchmark's
own runs; exits 1, printing nothing, if JAX, Flax or the JAX package was
loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run as entry  # flupsbench/run.py: sets the paths and the caches


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    from flupsbench import catalog, stepper
    cell = catalog.cell(args.workload)
    lines = []
    for what, seeds, patch in (("program", args.seeds, None),
                               ("control", args.controls,
                                stepper.control(cell))):
        if not seeds:
            continue
        t0 = time.perf_counter()
        runs = entry.run_ranks(cell, seeds, args.seconds, False, "cuda",
                               patch=patch)
        for seed, run in zip(seeds, runs):
            lines.append({"workload": args.workload, "side": what,
                          "seed": seed, "attempted": run.attempted,
                          "failed": run.failed, "errors": run.errors,
                          "correct": entry.is_correct(run.checks),
                          **{k: v["value"] for k, v in run.checks.items()}})
        lines.append({"workload": args.workload, "side": what,
                      "seconds": time.perf_counter() - t0})
    found = stepper.forbidden_modules()
    if found:
        entry.say(f"flupsbench: {', '.join(found)} loaded: no readings")
        return 1
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
