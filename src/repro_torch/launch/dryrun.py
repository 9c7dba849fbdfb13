"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake ranks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-0.6b --shape decode_32k --mesh single --device cpu

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell on 512 fake host devices.  Here this process is rank 0 of a
``"fake"`` process group (``launch.mesh``) and runs the cell's step
(``launch.cells``) eagerly on fake tensors under the counters
(``launch.flops_probe.measure``): nothing is allocated, computed or sent,
and nothing is compiled.  Nothing is set process-wide at import.

Outputs one JSON record per cell to ``results/dryrun/<tag>.jsonl`` with
the reference's keys: ``memory`` (per rank), ``cost``, ``collectives_raw``
and ``op_census`` (from the step's trace, ``launch.hlo_stats``) and
``roofline`` (the H100 constants of ``launch.mesh``).  ``t_lower_s`` is
the step's trace time; there is no compile time.  A failing cell writes
``status: "fail"`` with its error and the run goes on.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ALL_ARCHS, arch_shapes
from repro_torch.core.comm import CommConfig
from repro_torch.launch import hlo_stats
from repro_torch.launch.cells import build_cell
from repro_torch.launch.flops_probe import costs, held_bytes, measure
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, link_bandwidth,
                                     make_production_mesh)

MEMORY_NOTE = ("eager torch, no generated code; argument: the bytes this "
               "rank holds (a train cell's state, a serving cell's "
               "parameters, by the training layout rule: FSDP over data, "
               "tensor and expert parallelism over model; a decode "
               "cell's caches by cache_specs), "
               "spec_argument: the reference's sharded layout; temp: the "
               "peak of the live bytes the step allocates, less its "
               "outputs")


def roofline_terms(flops, bytes_acc, coll_bytes, n_chips, link_bw):
    """The three roofline times (seconds), whole-step totals: FLOPs and
    bytes over every card's peak rate, one card's collective bytes over
    its link bandwidth."""
    t_comp = flops / (n_chips * PEAK_FLOPS_BF16)
    t_mem = bytes_acc / (n_chips * HBM_BW)
    t_coll = coll_bytes / link_bw
    return t_comp, t_mem, t_coll


def roofline(cost, n_chips, link_bw, model_flops) -> dict:
    """The record's ``roofline`` from per-device ``cost``."""
    total_flops = cost["flops"] * n_chips
    t_comp, t_mem, t_coll = roofline_terms(
        total_flops, cost["bytes"] * n_chips, cost["coll_bytes"], n_chips,
        link_bw)
    dominant = max(("compute", t_comp), ("memory", t_mem),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant, "link_bw": link_bw,
        "model_flops": model_flops,
        "hlo_flops_total": total_flops,
        "useful_flops_frac": (model_flops / total_flops) if total_flops
        else None,
        "roofline_frac": (model_flops / (n_chips * PEAK_FLOPS_BF16)) /
        max(t_comp, t_mem, t_coll) if total_flops else None,
    }


def run_cell(arch, shape_name, mesh, comm, remat=None, extra_cfg=None,
             device="cuda"):
    n_chips = mesh.size()
    cell = build_cell(arch, shape_name, mesh, comm=comm, remat=remat,
                      extra_cfg=extra_cfg, device=device)
    with cell.mode:
        m = measure(cell.fn, *cell.args)
        out_bytes = held_bytes(m.out) if m.out is not None else 0
        arg_bytes = held_bytes(*cell.args)
    rec = dict(cell.meta)
    rec.update({"comm": comm.strategy, "n_chips": n_chips,
                "device": device, "t_lower_s": round(m.seconds, 2),
                "t_compile_s": None})
    rec["memory"] = {
        "argument_size_in_bytes": arg_bytes,
        "spec_argument_size_in_bytes": cell.spec_bytes,
        "output_size_in_bytes": min(out_bytes, m.end_bytes),
        "temp_size_in_bytes": max(m.peak_bytes - min(out_bytes,
                                                      m.end_bytes), 0),
        "note": MEMORY_NOTE}
    rec["cost_raw"] = {"flops": m.flops, "bytes_accessed": m.bytes}
    rec["collectives_raw"] = hlo_stats.collective_stats(m.trace)
    rec["op_census"] = hlo_stats.op_census(m.trace)
    rec["kernels"] = dict(m.trace.kernels)
    rec["cost"] = costs(m)
    rec["roofline"] = roofline(rec["cost"], n_chips, link_bandwidth(mesh),
                               cell.meta.get("model_flops", 0.0))
    return rec


def _parse_set(items) -> dict:
    extra = {}
    for kv in items:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                v = {"true": True, "false": False}.get(v.lower(), v)
        extra[k] = v
    return extra


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--comm", default="a2a",
                    choices=["a2a", "pipelined", "fused", "overlap"])
    ap.add_argument("--chunks", type=int, default=2,
                    help="pipelined/overlap granularity (paper's n_batch)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides, e.g. --set attn_block=2048")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (the card's by default; "
                    "'cpu' needs no card)")
    args = ap.parse_args(argv)

    extra = _parse_set(args.set)
    archs = list(ALL_ARCHS) if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    comm = CommConfig(strategy=args.comm, n_chunks=args.chunks)
    os.makedirs(args.out, exist_ok=True)
    tag = args.tag or f"{args.arch}_{args.shape}_{args.mesh}_{args.comm}"
    tag = tag.replace("/", "_").replace(",", "+")[:120]
    path = os.path.join(args.out, tag + ".jsonl")

    wrote = 0
    with open(path, "a") as f:
        for multi in meshes:
            mesh = make_production_mesh(multi_pod=multi, device=args.device)
            for arch in archs:
                shapes = ([s.name for s in arch_shapes(arch)]
                          or ["solve"])
                if args.shape != "all":
                    shapes = [s for s in shapes if s in
                              args.shape.split(",")]
                label_mesh = "multi" if multi else "single"
                for shape_name in shapes:
                    label = f"{arch}/{shape_name}/{label_mesh}"
                    t0 = time.perf_counter()
                    try:
                        rec = run_cell(arch, shape_name, mesh, comm,
                                       remat=args.remat,
                                       extra_cfg=extra or None,
                                       device=args.device)
                        rec["status"] = "ok"
                        rec["extra_cfg"] = extra
                        print(f"[dryrun] OK  {label}  "
                              f"trace={rec['t_lower_s']}s  "
                              f"dominant={rec['roofline']['dominant']}",
                              flush=True)
                    except Exception as e:
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": list(zip(mesh.mesh_dim_names,
                                                mesh.shape)),
                               "mesh_multi": multi, "status": "fail",
                               "error": f"{type(e).__name__}: {e}",
                               "trace": traceback.format_exc()[-2000:]}
                        print(f"[dryrun] FAIL {label}: {e}", flush=True)
                    rec["wall_s"] = round(time.perf_counter() - t0, 2)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    wrote += 1
    print(f"[dryrun] wrote {wrote} records to {path}")
    return path


if __name__ == "__main__":
    main()
