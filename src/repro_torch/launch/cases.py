"""The paper's analytical validation fields (Section IV / Appendix B), on
the host in float64 numpy.

The same fields as the reference's validation tests build: case A
(even-even x, odd-even y, periodic z), case B (fully unbounded, a
compact bump in each direction) and the launcher's all-periodic field.
Each returns ``(rhs, sol)`` on the ``n``^3-cell unit cube, node- or
cell-centered.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bc import DataLayout

L = 1.0


def grids(n, layout):
    """Physical coordinates per direction for an n^3-cell cubic domain."""
    h = L / n
    if layout == DataLayout.NODE:
        x = np.arange(n + 1) * h
    else:
        x = (np.arange(n) + 0.5) * h
    return np.meshgrid(x, x, x, indexing="ij")


def case_a(n, layout):
    """Even-even x, odd-even y, periodic z (Appendix B-A)."""
    x, y, z = grids(n, layout)
    kx, ky, kz = np.pi / L, 2.5 * np.pi / L, 8 * np.pi / L
    sol = np.cos(kx * x) * np.sin(ky * y) * np.sin(kz * z)
    rhs = -(kx**2 + ky**2 + kz**2) * sol
    return rhs, sol


def _bump(s):
    """exp(10(1 - 1/(1-s^2))) with compact support |s|<1."""
    inside = np.abs(s) < 0.99999
    ss = np.where(inside, s, 0.0)
    val = np.exp(10.0 * (1.0 - 1.0 / (1.0 - ss * ss)))
    return np.where(inside, val, 0.0)


def _bump_d2(s):
    """second derivative of _bump wrt s (analytical)."""
    inside = np.abs(s) < 0.99999
    ss = np.where(inside, s, 0.0)
    one = 1.0 - ss * ss
    f = np.exp(10.0 * (1.0 - 1.0 / one))
    d2 = f * ((20.0 * ss / one**2) ** 2
              - 20.0 * (1.0 + 3.0 * ss * ss) / one**3)
    return np.where(inside, d2, 0.0)


def case_b(n, layout):
    """Fully unbounded (Appendix B-B): a product of compact bumps."""
    x, y, z = grids(n, layout)
    sx, sy, sz = 2 * x / L - 1, 2 * y / L - 1, 2 * z / L - 1
    fx, fy, fz = _bump(sx), _bump(sy), _bump(sz)
    d2x, d2y, d2z = (_bump_d2(sx) * (2 / L) ** 2,
                     _bump_d2(sy) * (2 / L) ** 2,
                     _bump_d2(sz) * (2 / L) ** 2)
    sol = fx * fy * fz
    rhs = d2x * fy * fz + fx * d2y * fz + fx * fy * d2z
    return rhs, sol


def case_per(n, layout):
    """A simple all-periodic field: sin(2 pi x) sin(4 pi y) cos(2 pi z)."""
    x, y, z = grids(n, layout)
    sol = np.sin(2 * np.pi * x) * np.sin(4 * np.pi * y) * \
        np.cos(2 * np.pi * z)
    rhs = -(4 + 16 + 4) * np.pi ** 2 * sol
    return rhs, sol


def validation_case(bcs: str, n, layout):
    """``(rhs, sol)`` of the launcher's BC mix: ``unb`` case B, ``per``
    the periodic field, ``mix`` case A."""
    return {"unb": case_b, "per": case_per, "mix": case_a}[bcs](n, layout)
