#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, and how long each takes, for
the FSDP gather and reduce-scatter of a mesh train step.

    python3 tools/probe_fsdp_collectives.py [--numel N] [--reps R]

Four gloo ranks on the one card, a (2, 2) mesh: over the ``"data"`` axis
(two ranks) each of ``all_gather`` (a list), ``all_gather_into_tensor``,
``reduce_scatter`` (a list), ``reduce_scatter_tensor`` and ``all_reduce``
on a float32 CUDA tensor of N elements a rank (default 2^22), checked
against the expected values, then timed (R calls, the device synchronised
around each); an unsupported call prints its error.  Prints the torch and
CUDA versions and the card's name and power limit; needs a card.
"""
from __future__ import annotations

import argparse
import datetime
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _calls(n, world, rank):
    """{name: fn() -> (result, expected)} over a group of ``world``."""
    x = torch.full((n,), float(rank + 1), device="cuda")

    def gather_list(g):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=g)
        return torch.cat(parts)

    def gather_tensor(g):
        out = torch.empty(world * n, device="cuda")
        dist.all_gather_into_tensor(out, x, group=g)
        return out

    def scatter_list(g):
        out = torch.empty_like(x)
        dist.reduce_scatter(out, [x.clone() for _ in range(world)], group=g)
        return out

    def scatter_tensor(g):
        out = torch.empty_like(x)
        dist.reduce_scatter_tensor(out, x.repeat(world), group=g)
        return out

    def reduce(g):
        y = x.clone()
        dist.all_reduce(y, group=g)
        return y
    return {"all_gather": gather_list,
            "all_gather_into_tensor": gather_tensor,
            "reduce_scatter": scatter_list,
            "reduce_scatter_tensor": scatter_tensor,
            "all_reduce": reduce}


def _rank(rank, world, d, n, reps):
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{d}/rdv", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    g = mesh.get_group("data")
    members = [dist.get_global_rank(g, i) for i in range(2)]
    total = float(sum(r + 1 for r in members))
    want = {"all_gather": torch.cat([torch.full((n,), float(r + 1))
                                     for r in members]),
            "reduce_scatter": torch.full((n,), total),
            "all_reduce": torch.full((n,), total)}
    want["all_gather_into_tensor"] = want["all_gather"]
    want["reduce_scatter_tensor"] = want["reduce_scatter"]
    for name, fn in _calls(n, 2, rank).items():
        try:
            got = fn(g)
        except (RuntimeError, ValueError, NotImplementedError) as e:
            msg = str(e).splitlines()[0][:160]
            if rank == 0:
                print(f"  {name}: unsupported ({type(e).__name__}: {msg})",
                      flush=True)
            continue
        ok = torch.equal(got.cpu(), want[name])
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        times.sort()
        if rank == 0:
            print(f"  {name}: {'ok' if ok else 'WRONG'}; ms median "
                  f"{times[len(times) // 2]:.3f} min {times[0]:.3f} "
                  f"({n} float32 a rank, {4 * n / 2 ** 20:.1f} MiB)",
                  flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--numel", type=int, default=1 << 22)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_fsdp_collectives: needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(4, d, a.numel, a.reps), nprocs=4,
                           start_method="spawn")


if __name__ == "__main__":
    main()
