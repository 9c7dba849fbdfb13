"""Render EXPERIMENTS.md-style sections from the dry-run JSONL records.

    PYTHONPATH=src python -m repro_torch.launch.report > results/roofline.md

Counterpart of ``repro.launch.report``, on the port's records
(``launch.dryrun``): the "fits" column holds a rank's argument and
temporary bytes against one card's memory, and the time column is the
step's trace time (there is no compile).
"""
from __future__ import annotations

import argparse
import glob
import json

HBM_PER_CHIP = 80e9   # NVIDIA H100 SXM5 80GB: data sheet


def load(patterns):
    recs = {}
    order = []
    paths = []
    for pattern in patterns.split():
        paths.extend(sorted(glob.glob(pattern)))
    for path in paths:
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                mesh = dict(r.get("mesh", []))
                key = (r["arch"], r["shape"],
                       "multi" if "pod" in mesh else "single")
                if key not in recs:
                    order.append(key)
                recs[key] = r
    return recs, order


def dryrun_table(recs, order, mesh_sel):
    lines = [
        "| arch | shape | status | trace s | args GB/dev | temp GB/dev "
        f"| fits {HBM_PER_CHIP / 1e9:.0f}G | coll count | coll GB/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in order:
        arch, shape, mesh = key
        if mesh != mesh_sel:
            continue
        r = recs[key]
        if r.get("status") != "ok":
            lines.append(f"| {arch} | {shape} | FAIL |" + " - |" * 6)
            continue
        m = r.get("memory", {})
        args_gb = m.get("argument_size_in_bytes", 0) / 1e9
        temp_gb = m.get("temp_size_in_bytes", 0) / 1e9
        fits = "yes" if (args_gb + temp_gb) * 1e9 < HBM_PER_CHIP else "NO"
        c = r.get("cost", {})
        coll_b = c.get("coll_bytes", 0) / 1e9
        coll_n = int(c.get("coll_count", 0))
        lines.append(
            f"| {arch} | {shape} | ok | {r['t_lower_s']} | "
            f"{args_gb:.1f} | {temp_gb:.1f} | {fits} | {coll_n} | "
            f"{coll_b:.2f} |")
    return "\n".join(lines)


def roofline_table(recs, order, mesh_sel="single"):
    lines = [
        "| arch | shape | t_comp s | t_mem s | t_coll s | dominant | "
        "MODEL_FLOPs | MODEL/counted | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in order:
        arch, shape, mesh = key
        if mesh != mesh_sel:
            continue
        r = recs[key]
        if r.get("status") != "ok":
            continue
        rf = r.get("roofline", {})
        uf = rf.get("useful_flops_frac")
        frac = rf.get("roofline_frac")
        lines.append(
            f"| {arch} | {shape} | {rf.get('t_compute_s', 0):.3g} | "
            f"{rf.get('t_memory_s', 0):.3g} | "
            f"{rf.get('t_collective_s', 0):.3g} | {rf.get('dominant')} | "
            f"{rf.get('model_flops', 0):.3g} | "
            f"{uf and round(uf, 3)} | {frac and round(frac, 4)} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--glob",
        default="results/dryrun/baseline_*.jsonl results/dryrun/z*.jsonl")
    args = ap.parse_args(argv)
    recs, order = load(args.glob)
    n_ok = sum(1 for r in recs.values() if r.get("status") == "ok")
    print(f"## Dry-run summary ({n_ok}/{len(recs)} cells ok)\n")
    for mesh in ("single", "multi"):
        keys = [k for k in order if k[2] == mesh]
        if not keys:
            continue
        print(f"### {mesh}-pod mesh\n")
        print(dryrun_table(recs, order, mesh))
        print()
    print("## Roofline (single-pod)\n")
    print(roofline_table(recs, order))


if __name__ == "__main__":
    main()
