"""The least bytes a solve must move through device memory, from the
configuration alone, and the peaks they are divided by.

A solve reads each right-hand side once and writes each solution once:
``2 * batch * n_pts^3 * itemsize`` bytes, whatever implements it.  That
is the compulsory traffic of a roofline (each input byte read once, each
output byte written once).  The Green's function is not counted: a kernel
may compute it on the fly.  Intermediate arrays are not counted either:
how large the one that has to leave the chip is depends on the design (a
pencil pipeline round-trips the whole doubled spectrum, a design that
transforms one direction in a first pass and the other two plane by plane
on a thread-block cluster moves less), so no count of it bounds every
implementation.  On a mesh each rank is held to its share.
"""
from __future__ import annotations

import json
from pathlib import Path

from flupsbench.fftconv import grid_points

ITEMSIZE = {"float32": 4, "float64": 8}
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def compulsory_bytes(config: dict, batch: int, world: int = 1) -> float:
    """Bytes one rank of ``world`` reads and writes at least in a solve of
    ``batch`` fields."""
    return (2 * batch * grid_points(config) ** 3
            * ITEMSIZE[config["dtype"]] / world)


def hbm_bytes_per_s(device_kind: str):
    """The card's peak device-memory bandwidth, or None for a card the
    table does not hold."""
    with open(PEAKS) as fh:
        row = json.load(fh).get(device_kind)
    return None if row is None else float(row["hbm_bytes_per_s"])
