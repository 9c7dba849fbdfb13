"""Plain reference of the fully unbounded Poisson solve, lap(u) = f in free
space, by Hockney and Eastwood's doubled-domain convolution with the
second-order Green's function (FLUPS's CHAT2): G(r) = -1 / (4 pi r), and
at r = 0 its mean over the cell centred there, -C / (4 pi h), C being the
mean of 1/|x| over the unit cube centred on 0,

    C = 3 ln(2 + sqrt 3) - pi / 2  (= 2.38007748...),

times the quadrature weight h^3.  Sampled on the 2n-point periodic grid
(offsets min(j, 2n - j) h), transformed, multiplied with the zero-padded
right-hand side's transform and transformed back, the first n (CELL) or
n + 1 (NODE) points of each direction are u.
"""
from __future__ import annotations

import math

import torch

from flupsbench.fftconv import convolve, grid_points, keep

SELF_MEAN = 3.0 * math.log(2.0 + math.sqrt(3.0)) - math.pi / 2.0


def _check(config: dict):
    if config["green"] != "chat2" or any(
            b != ["unbounded", "unbounded"] for b in config["bcs"]):
        raise ValueError("free_space: CHAT2 on three unbounded directions "
                         f"only, not {config['green']} on {config['bcs']}")


def green_hat(config: dict, device, work=torch.float64, store=None):
    """The transformed Green's function on the doubled domain, real,
    shape ``(2n, 2n, n + 1)``."""
    _check(config)
    n, L = config["n"], float(config["L"])
    h, m = L / n, 2 * n
    j = torch.arange(m, device=device, dtype=work)
    d = torch.minimum(j, m - j) * h
    r = torch.sqrt(d[:, None, None] ** 2 + d[None, :, None] ** 2
                   + d[None, None, :] ** 2)
    r[0, 0, 0] = 1.0
    g = -1.0 / (4.0 * math.pi * r)
    g[0, 0, 0] = -SELF_MEAN / (4.0 * math.pi * h)
    g *= h ** 3
    # an even kernel: its spectrum is real
    return keep(torch.fft.rfftn(keep(g, store)).real, store)


def solve(config: dict, f: torch.Tensor, store=None, work=torch.float64):
    """u for each field of ``f`` (``(B, *grid)``), in ``work``."""
    n = config["n"]
    if tuple(f.shape[-3:]) != (grid_points(config),) * 3:
        raise ValueError(f"free_space: f has shape {tuple(f.shape)}")
    ghat = green_hat(config, f.device, work, store)
    return torch.stack([convolve(fi.to(work), ghat, (2 * n,) * 3, store)
                        for fi in f])
