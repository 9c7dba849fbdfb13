"""The traffic generator: the ring of right-hand sides a time stepper cycles
through, made on the device from the seed.

Each field is a sum of ``blobs`` Gaussian sources (centres uniform in the
middle 40% of the box, widths 3-8% of it, amplitudes of either sign, 0.5
to 1) plus uniform noise of amplitude ``noise``, which puts energy in every
mode.  A fully periodic problem takes the field's mean out (it has no
solution otherwise).  Every seed gives the same sizes and the same amount
of work; only the values differ.
"""
from __future__ import annotations

import torch

from flupsbench.fftconv import grid_points


def _coords(config: dict, device) -> torch.Tensor:
    """The grid's coordinates along one direction (nodes j h, or cell
    centres (j + 1/2) h), float32."""
    n, L = config["n"], float(config["L"])
    shift = 0.0 if config["layout"] == "node" else 0.5
    return (torch.arange(grid_points(config), device=device,
                         dtype=torch.float32) + shift) * (L / n)


def field(config: dict, traffic: dict, gen: torch.Generator, device):
    """One right-hand side, ``(n_pts,) * 3``, float32, drawn from ``gen``."""
    L = float(config["L"])
    k = int(traffic["blobs"])

    def uniform(lo, hi, size):
        return lo + (hi - lo) * torch.rand(size, generator=gen, device=device)

    x = _coords(config, device)
    centre = uniform(0.3 * L, 0.7 * L, (3, k))
    width = uniform(0.03 * L, 0.08 * L, (3, k))
    amp = uniform(0.5, 1.0, (k,)) * torch.where(
        torch.rand(k, generator=gen, device=device) < 0.5, -1.0, 1.0)
    # separable blobs: g[d, b, i] = exp(-((x_i - c_db) / w_db)^2 / 2)
    g = torch.exp(-0.5 * ((x[None, None, :] - centre[:, :, None])
                          / width[:, :, None]) ** 2)
    n = x.numel()
    yz = (g[1][:, :, None] * g[2][:, None, :]).reshape(k, n * n)
    f = ((g[0] * amp[:, None]).T @ yz).reshape(n, n, n)
    noise = float(traffic["noise"])
    f += noise * (2.0 * torch.rand((n, n, n), generator=gen, device=device)
                  - 1.0)
    if all(b == ["periodic", "periodic"] for b in config["bcs"]):
        f -= f.mean()
    return f


def ring(config: dict, traffic: dict, seed: int, device, batch: int):
    """``traffic["ring"]`` right-hand sides of ``batch`` fields each: the
    same ring for the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [torch.stack([field(config, traffic, gen, device)
                         for _ in range(batch)])
            for _ in range(int(traffic["ring"]))]
