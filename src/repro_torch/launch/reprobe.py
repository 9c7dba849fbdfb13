"""Re-run the cost probes for existing dry-run records and write updated
records.

Counterpart of ``repro.launch.reprobe``.  Keeps each record's ``memory``
and trace time; only ``cost`` and ``roofline`` are recomputed (one traced
step of the cell, ``launch.flops_probe.probed_costs``).

    PYTHONPATH=src python -m repro_torch.launch.reprobe \\
        --in results/dryrun/baseline_single.jsonl \\
        --out results/dryrun/zcorr_single.jsonl [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.core.comm import CommConfig
from repro_torch.launch.dryrun import roofline
from repro_torch.launch.flops_probe import probed_costs
from repro_torch.launch.mesh import link_bandwidth, make_production_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    recs = [json.loads(line) for line in open(args.inp) if line.strip()]
    meshes = {}
    done = set()
    if os.path.exists(args.out):
        for line in open(args.out):
            r = json.loads(line)
            done.add((r["arch"], r["shape"]))
    with open(args.out, "a") as f:
        for r in recs:
            if r.get("status") != "ok" or (r["arch"], r["shape"]) in done:
                continue
            multi = "pod" in dict(r["mesh"])
            if multi not in meshes:
                meshes[multi] = make_production_mesh(multi_pod=multi,
                                                     device=args.device)
            mesh = meshes[multi]
            comm = CommConfig(strategy=r.get("comm", "a2a"))
            remat = None if r["arch"] == "flups-poisson" else args.remat
            try:
                corr = probed_costs(r["arch"], r["shape"], mesh, comm,
                                    remat=remat, device=args.device)
            except Exception as e:
                print(f"[reprobe] FAIL {r['arch']}/{r['shape']}: {e}",
                      flush=True)
                continue
            r["cost"] = corr
            r["roofline"] = roofline(corr, r["n_chips"],
                                     link_bandwidth(mesh),
                                     r.get("model_flops", 0.0))
            r["reprobed"] = True
            f.write(json.dumps(r) + "\n")
            f.flush()
            print(f"[reprobe] OK {r['arch']}/{r['shape']} "
                  f"{'multi' if multi else 'single'} "
                  f"coll={corr['coll_bytes'] / 1e9:.1f}GB "
                  f"dom={r['roofline']['dominant']}", flush=True)


if __name__ == "__main__":
    main()
