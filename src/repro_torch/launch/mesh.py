"""Production mesh construction and the card's roofline constants.

Counterpart of ``repro.launch.mesh``.  Nothing happens at import: the
callers create meshes with the functions below.  The reference builds its
production meshes from 512 fake host devices (``XLA_FLAGS``); the port's
stand on a ``"fake"`` process group (``torch.testing``'s ``FakeStore``):
this process is rank 0 of 256 or 512 ranks whose collectives return at
once, so a step traced on fake tensors issues what rank 0 would.

  single pod:  (16, 16)     -> ("data", "model"),          256 ranks
  multi  pod:  (2, 16, 16)  -> ("pod", "data", "model"),   512 ranks

The roofline constants are an H100 SXM5's, from NVIDIA's data sheet;
``chip_smoke.py`` (phase 8h) prints a rate measured on the card beside
each.  A rank is one card, eight cards to a node, ranks in row-major mesh
order: an axis whose ranks all sit in one node moves its collectives
over NVLink, any other over the node's network.  Both axes of (16, 16)
span nodes ("model" two of them, "data" sixteen), so every collective of
the production meshes is billed at ``INTER_NODE_BW`` (``link_bandwidth``:
a mesh's slowest axis).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_local_mesh", "link_bandwidth",
           "PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW", "INTER_NODE_BW",
           "GPUS_PER_NODE"]

# hardware constants for the roofline (NVIDIA H100 SXM5 80GB, per card)
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense BF16 tensor core: data sheet
HBM_BW = 3.35e12             # B/s, HBM3: data sheet
NVLINK_BW = 450e9            # B/s one direction (900 GB/s total): data sheet
# B/s one direction: one 400 Gb/s NDR InfiniBand adapter per card, the
# DGX H100 / HGX H100 data sheets' eight ConnectX-7 per eight cards
INTER_NODE_BW = 50e9
GPUS_PER_NODE = 8            # HGX H100 8-GPU board: data sheet
PRODUCTION_RANKS = 512       # the fake group's size: both meshes fit


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The (16, 16) or (2, 16, 16) production mesh on ``device``'s type,
    over the first 256 or 512 ranks of the default process group: a
    ``"fake"`` one of 512 ranks (the reference's 512 host devices), made
    here when none exists."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=PRODUCTION_RANKS)
    n = math.prod(shape)
    if dist.get_world_size() < n:
        raise RuntimeError(f"the process group has {dist.get_world_size()} "
                           f"ranks; this mesh needs {n}")
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_local_mesh(n_data=1, n_model=1, device: str = "cuda"):
    """A small (n_data, n_model) mesh on the process group that exists
    (for CPU validation runs: a fake or gloo group of that many ranks)."""
    return init_device_mesh(device, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def link_bandwidth(mesh) -> float:
    """The per-card bandwidth (B/s, one direction) the roofline bills
    every collective of ``mesh`` at: its slowest axis of more than one
    rank's -- ``NVLINK_BW`` for an axis whose ranks sit in one node,
    else ``INTER_NODE_BW``; ``NVLINK_BW`` when no axis has more than
    one rank."""
    bw = NVLINK_BW
    for i, n in enumerate(mesh.shape):
        # the axis's ranks span its size times its rank stride
        if n > 1 and math.prod(mesh.shape[i:]) > GPUS_PER_NODE:
            bw = INTER_NODE_BW
    return bw
