"""Numerical health guards: NaN/Inf detection and a cheap residual check.

Counterpart of ``repro.runtime.health``, on tensors.  ``verify="nan"``
guards the solve OUTPUT for finiteness; ``verify="residual"``
additionally checks the relative 7-point finite-difference Laplacian
residual ``||lap_h(u) - f|| / ||f||`` on the INTERIOR of the grid.  The
residual is a consistency gate, not an accuracy gate: the solver is
spectral, the FD stencil is 2nd order, so a healthy solve sits at
discretization level (percent-ish on coarse grids) while a corrupted one
(NaN anywhere, a stage fed garbage, a wrong-layout Green multiply) lands
at NaN or O(1) -- the default ``rtol=0.5`` separates the two decisively
without false-failing coarse healthy solves.

When the output is non-finite, ``locate_nonfinite_stage`` re-runs the
reference (natural-layout) pipeline with a finiteness check after every
stage -- the per-stage NaN/Inf guard -- and the resulting stage name
becomes the ``HealthError`` provenance the ladder and ``SolveError``
report.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["HealthError", "check_finite", "fd_residual", "check_solution",
           "locate_nonfinite_stage"]


class HealthError(RuntimeError):
    """A numerical health guard tripped; carries stage provenance."""

    def __init__(self, msg: str, *, stage: str = "verify", detail=None):
        super().__init__(msg)
        self.stage = stage
        self.detail = detail
        self.transient = False


def _finite(x) -> bool:
    return bool(torch.isfinite(torch.as_tensor(x)).all())


def check_finite(name: str, x):
    if not _finite(x):
        raise HealthError(f"non-finite values at {name}", stage=name)


def fd_residual(u, f, plan) -> float:
    """Relative interior FD-Laplacian residual of ``u`` against ``f``.

    Works on user-shaped tensors (leading batch axes allowed); only the
    interior of each grid axis enters, so boundary conventions (overwritten
    Dirichlet zeros, node-periodic duplicated points) never pollute it.
    """
    u = torch.as_tensor(u)
    f = torch.as_tensor(f).to(u.device)
    ndim = len(plan.dirs)
    off = u.ndim - ndim

    def shifted(x, d, s):
        sl = [slice(None)] * x.ndim
        for dd in range(ndim):
            lo, hi = 1, x.shape[off + dd] - 1
            if dd == d:
                lo, hi = lo + s, hi + s
            sl[off + dd] = slice(lo, hi)
        return x[tuple(sl)]

    lap = None
    for d, p in enumerate(plan.dirs):
        h2 = p.h * p.h
        term = (shifted(u, d, 1) - 2.0 * shifted(u, d, 0)
                + shifted(u, d, -1)) / h2
        lap = term if lap is None else lap + term
    f_int = shifted(f, -1, 0)
    num = torch.linalg.vector_norm(lap - f_int)
    den = torch.linalg.vector_norm(f_int)
    return float(num / torch.clamp(den, min=np.finfo(np.float32).tiny))


def check_solution(u, f, plan, mode: str = "nan", rtol: float = 0.5,
                   stats: dict = None, locate=None):
    """The opt-in solve verifier.  ``mode``: "nan" (finiteness only) or
    "residual" (finiteness + FD residual below ``rtol``).  ``locate``, when
    given, maps a non-finite output to its first-bad-stage provenance."""
    if mode not in ("nan", "residual"):
        raise ValueError(f"verify mode {mode!r}: expected 'nan' or "
                         "'residual'")
    if not _finite(u):
        if stats is not None:
            stats["verify_failures"] = stats.get("verify_failures", 0) + 1
        stage = "verify.nan"
        if locate is not None:
            try:
                stage = "verify.nan@" + locate()
            except Exception:  # diagnosis is best-effort
                pass
        raise HealthError("solve output contains NaN/Inf", stage=stage)
    if mode == "residual":
        r = fd_residual(u, f, plan)
        if not np.isfinite(r) or r > rtol:
            if stats is not None:
                stats["verify_failures"] = \
                    stats.get("verify_failures", 0) + 1
            raise HealthError(
                f"FD residual {r:.3g} exceeds rtol={rtol} "
                f"(corrupted solve)", stage="verify.residual", detail=r)
        if stats is not None:
            stats["last_residual"] = r


def locate_nonfinite_stage(plan, sched, f, green) -> str:
    """Per-stage NaN/Inf guard: walk the reference (natural-layout)
    pipeline and return the first stage whose output is non-finite.
    ``green`` is the NATURAL-layout transformed Green's function (numpy
    float64 or a tensor).  Used for provenance only -- numerically it is
    the baseline pipeline, which all scheduled variants are equivalent
    to."""
    from repro_torch.core.engine import bwd_1d, fwd_1d, materialize_doubling

    if not _finite(f):
        return "input"
    y = materialize_doubling(f, plan.dirs)
    for d in plan.order:
        y = fwd_1d(y, plan.dirs[d], sched)
        if not _finite(y):
            return f"fwd.{d}"
    g = torch.as_tensor(green).to(device=y.device,
                                  dtype=y.real.dtype if y.is_complex()
                                  else y.dtype)
    y = sched.green_multiply(y, g)
    if not _finite(y):
        return "green"
    for d in reversed(plan.order):
        y = bwd_1d(y, plan.dirs[d], sched)
        if not _finite(y):
            return f"bwd.{d}"
    return "output"
