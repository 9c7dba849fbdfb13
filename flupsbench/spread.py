"""Spreads of a set of runs, the measure the bounds are set from.

    python3 flupsbench/spread.py <result file> ... [--set 6]

Each file holds a run's standard output; its last line is the result.
Files are taken in order, ``--set`` of them to a set.  For each set and
metric: the median, the spread ((Q3 - Q1) / median, ``stats.spread``) and
the same without the run farthest from the median; then, per metric, the
wider spread of the sets, and whether every run was correct.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from flupsbench.stats import spread  # noqa: E402


def _last(path):
    lines = [ln for ln in Path(path).read_text().splitlines() if ln.strip()]
    return json.loads(lines[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("files", nargs="+")
    p.add_argument("--set", type=int, default=6)
    args = p.parse_args(argv)
    res = [_last(f) for f in args.files]
    print(f"correct {sum(r['correct'] for r in res)} of {len(res)}; failed "
          f"steps {sum(r['failed'] for r in res)} of "
          f"{sum(r['attempted'] for r in res)}")
    sets = [res[i:i + args.set] for i in range(0, len(res), args.set)]
    widest = {}
    for k, s in enumerate(sets):
        for m in s[0]["metrics"]:
            v = [r["metrics"][m]["value"] for r in s if m in r["metrics"]]
            med = statistics.median(v)
            trim = sorted(v, key=lambda x: abs(x - med))[:-1]
            sp = spread(v) if len(v) > 1 else 0.0
            sp_t = spread(trim) if len(trim) > 1 else 0.0
            widest[m] = max(widest.get(m, 0.0), sp)
            print(f"set {k} {m}: median {med!r} spread {sp:.5f} "
                  f"(without the farthest {sp_t:.5f}) values {v}")
    for m, sp in widest.items():
        print(f"{m}: widest spread {sp:.5f}, five times {5 * sp:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
