"""The plain references against analytic solutions (float64, CPU)."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from flupsbench.references import free_space, periodic


def _cfg(n, layout, kind):
    return {"n": n, "L": 1.0, "layout": layout, "green": "chat2",
            "bcs": [[kind, kind]] * 3}


def test_self_cell_mean_is_the_cube_average():
    # mean of 1/|x| over the unit cube centred on 0 = 3 I, with
    # I = int_0^1 int_0^1 (1 + s^2 + t^2)^(-1/2) ds dt (the cube cut into
    # three pyramids by its largest coordinate; the integrand is smooth)
    q, w = np.polynomial.legendre.leggauss(64)
    s = 0.5 * (q + 1.0)
    i = 0.25 * np.einsum("i,j,ij->", w, w,
                         1.0 / np.sqrt(1.0 + s[:, None] ** 2 + s[None] ** 2))
    assert free_space.SELF_MEAN == pytest.approx(3.0 * i, rel=1e-13)


def _gaussian_charge(n):
    """A unit Gaussian charge at the box's centre on the n + 1 nodes, and
    its free-space potential -erf(r / s) / (4 pi r)."""
    s = 0.1
    x = torch.arange(n + 1, dtype=torch.float64) / n - 0.5
    r = torch.sqrt(x[:, None, None] ** 2 + x[None, :, None] ** 2
                   + x[None, None, :] ** 2)
    f = torch.exp(-(r / s) ** 2) / (math.pi ** 1.5 * s ** 3)
    rs = torch.where(r > 0, r, torch.ones_like(r))
    u = torch.where(r > 0, -torch.erf(rs / s) / (4 * math.pi * rs),
                    torch.full_like(r, -1.0 / (2 * math.pi ** 1.5 * s)))
    return f, u


def test_free_space_node_converges_to_the_gaussian_potential():
    errs = []
    for n in (32, 64):
        f, want = _gaussian_charge(n)
        got = free_space.solve(_cfg(n, "node", "unbounded"), f[None])[0]
        errs.append(float((got - want).abs().max() / want.abs().max()))
    assert errs[1] < 1e-2
    assert errs[1] < errs[0] / 3.0          # second order: a ratio of 4


def test_periodic_cell_is_spectral_exact():
    n = 32
    x = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    f = (torch.sin(2 * math.pi * x)[:, None, None]
         * torch.sin(4 * math.pi * x)[None, :, None]
         * torch.cos(2 * math.pi * x)[None, None, :])
    want = -f / ((2 * math.pi) ** 2 * 6.0)
    got = periodic.solve(_cfg(n, "cell", "periodic"), f[None])[0]
    assert float((got - want).abs().max()) < 1e-14


@pytest.mark.parametrize("mod,kind,layout", [
    (free_space, "periodic", "node"), (periodic, "unbounded", "cell"),
    (periodic, "periodic", "node")])
def test_a_reference_refuses_what_it_does_not_solve(mod, kind, layout):
    with pytest.raises(ValueError):
        mod.green_hat(_cfg(8, layout, kind), "cpu")
