"""Plain reference of the fully periodic Poisson solve on the box [0, L)^3:
u_hat(k) = -f_hat(k) / |k|^2 with k = 2 pi m / L, and u_hat(0) = 0 (the
mean of u is zero), the spectral-exact symbol FLUPS calls CHAT2 on a
periodic direction.
"""
from __future__ import annotations

import math

import torch

from flupsbench.fftconv import convolve, keep


def _check(config: dict):
    if config["green"] != "chat2" or config["layout"] != "cell" or any(
            b != ["periodic", "periodic"] for b in config["bcs"]):
        raise ValueError("periodic: CHAT2 on three periodic CELL "
                         f"directions only, not {config['green']} "
                         f"{config['layout']} on {config['bcs']}")


def green_hat(config: dict, device, work=torch.float64, store=None):
    """-1 / |k|^2 on the grid's real-to-complex half, shape
    ``(n, n, n // 2 + 1)``; 0 at k = 0."""
    _check(config)
    n, L = config["n"], float(config["L"])
    k = 2.0 * math.pi * torch.fft.fftfreq(n, d=L / n, device=device,
                                          dtype=work)
    kr = 2.0 * math.pi * torch.fft.rfftfreq(n, d=L / n, device=device,
                                            dtype=work)
    k2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + kr[None, None, :] ** 2
    k2[0, 0, 0] = 1.0
    g = -1.0 / k2
    g[0, 0, 0] = 0.0
    return keep(g, store)


def solve(config: dict, f: torch.Tensor, store=None, work=torch.float64):
    """u for each field of ``f`` (``(B, n, n, n)``), in ``work``."""
    n = config["n"]
    if tuple(f.shape[-3:]) != (n,) * 3:
        raise ValueError(f"periodic: f has shape {tuple(f.shape)}")
    ghat = green_hat(config, f.device, work, store)
    return torch.stack([convolve(fi.to(work), ghat, (n,) * 3, store)
                        for fi in f])
