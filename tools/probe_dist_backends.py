#!/usr/bin/env python3
"""Which torch.distributed backends take CUDA tensors in the collectives
the pencil solver issues, on the one card of this machine.

    python3 tools/probe_dist_backends.py

Checks, each printed with its outcome: a one-rank NCCL group with a
(1, 1) ``DeviceMesh`` (``all_to_all_single`` sync and async, on float32
and complex64, ``all_gather``, a MAX ``all_reduce``), then four gloo ranks
on the one card with a (2, 2) mesh (the same collectives on CUDA tensors,
checked against the tiled exchange's expected blocks).  NCCL refuses two
ranks on one device, so several ranks on one card can talk only through
gloo, which stages CUDA tensors through the host.  Exits non-zero when
a check fails; needs a card.
"""
from __future__ import annotations

import datetime
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _collectives(rank: int, world: int, tag: str):
    from torch.distributed.device_mesh import init_device_mesh
    side = 1 if world == 1 else 2
    mesh = init_device_mesh("cuda", (side, side),
                            mesh_dim_names=("data", "model"))
    g = mesh.get_group("model")
    p = dist.get_world_size(g)
    me = dist.get_rank(g)
    for dtype in (torch.float32, torch.complex64):
        x = (torch.arange(4 * p, device="cuda") + 100 * rank).to(dtype)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=g)
        w = dist.all_to_all_single(torch.empty_like(x), x, group=g,
                                   async_op=True)
        w.wait()
        # block k of y came from group rank k's chunk ``me``
        want = torch.cat([torch.arange(4 * me, 4 * me + 4, device="cuda")
                          + 100 * (rank - me + k) for k in range(p)])
        assert torch.equal(y.real.float(), want.float()), (tag, y, want)
    parts = [torch.empty(2, device="cuda") for _ in range(p)]
    dist.all_gather(parts, torch.full((2,), float(rank), device="cuda"),
                    group=g)
    t = torch.tensor([float(rank)], device="cuda", dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    assert t.item() == world - 1
    print(f"{tag} rank {rank}: all_to_all_single (sync, async; float32, "
          f"complex64), all_gather, all_reduce MAX on CUDA tensors: ok",
          flush=True)


def _gloo_rank(rank: int, world: int, d: str):
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{d}/gloo", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    try:
        _collectives(rank, world, "gloo x4")
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dist_backends.py: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; nccl available "
          f"{dist.is_nccl_available()}, gloo available "
          f"{dist.is_gloo_available()}")
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"file://{d}/nccl", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=120))
        try:
            _collectives(0, 1, "nccl x1")
        finally:
            dist.destroy_process_group()
        mp.start_processes(_gloo_rank, args=(4, d), nprocs=4,
                           start_method="spawn")
    print("probe_dist_backends.py: every check passed")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    sys.exit(main())
