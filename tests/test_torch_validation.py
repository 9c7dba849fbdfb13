"""The port's analytical validation (paper section IV): the convergence
orders of ``tests/test_validation.py`` on the same closed-form Gaussian
blobs, grids and thresholds, solved by the port's ``get_solver`` on the
CPU in float64.

The fully unbounded and semi-unbounded HEJ4/HEJ6 orders are ``slow``, as
their reference counterparts are; the periodic CHAT2 / HEJ orders and the
batched analytic solve are not.  The CHAT2 unbounded and semi-unbounded
orders are in ``tests/test_torch_solver.py``.
"""
import numpy as np
import pytest

from repro.core.bc import DataLayout
from repro.core.green import GreenKind
from repro_torch.core import bc as tbc
from repro_torch.core.solver import clear_solver_cache, get_solver
from repro_torch.runtime import resilience

import test_validation as val

LAYOUTS = [DataLayout.NODE, DataLayout.CELL]


@pytest.fixture(autouse=True)
def _fresh_port_runtime():
    clear_solver_cache()
    resilience.reset_warn_once()
    yield
    clear_solver_cache()
    resilience.reset_warn_once()


def _solver(case, n, layout, green, engine):
    _, bcs = val.CASES[case]
    port_bcs = tuple((tbc.BCType(a.value), tbc.BCType(b.value))
                     for a, b in bcs)
    return get_solver((n,) * 3, val.L, port_bcs,
                      layout=tbc.DataLayout[layout.name], green_kind=green,
                      engine=engine, device="cpu")


def linf_error(case, n, layout, green, engine):
    fn, _ = val.CASES[case]
    rhs, sol = fn(n, layout)
    u = _solver(case, n, layout, green, engine).solve(rhs.astype(np.float64))
    return float(np.max(np.abs(u.numpy() - sol)))


def observed_order(case, layout, green, ns, engine="cuda"):
    """Least-squares slope of log(err) against log(n) over the grids."""
    errs = [linf_error(case, n, layout, green, engine) for n in ns]
    p = -np.polyfit(np.log(ns), np.log(errs), 1)[0]
    return p, errs


@pytest.mark.slow
@pytest.mark.parametrize("layout", LAYOUTS)
def test_unbounded_hej4_order(layout):
    p, errs = observed_order("unb", layout, GreenKind.HEJ4, (32, 48, 64))
    assert p > 3.15, (p, errs)


@pytest.mark.slow
@pytest.mark.parametrize("layout", LAYOUTS)
def test_unbounded_hej6_order(layout):
    p, errs = observed_order("unb", layout, GreenKind.HEJ6, (48, 64, 96))
    assert p > 5.2, (p, errs)


@pytest.mark.slow
@pytest.mark.parametrize("layout", LAYOUTS)
def test_semi_unbounded_hej4_order(layout):
    p, errs = observed_order("semi-even", layout, GreenKind.HEJ4,
                             (32, 48, 64))
    assert p > 3.15, (p, errs)


@pytest.mark.slow
@pytest.mark.parametrize("layout", LAYOUTS)
def test_semi_unbounded_hej6_order(layout):
    p, errs = observed_order("semi-even", layout, GreenKind.HEJ6,
                             (48, 64, 96))
    assert p > 5.2, (p, errs)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_periodic_chat2_spectral(layout):
    """CHAT2 is the exact inverse symbol on periodic boxes: the error is
    pure rhs-sampling aliasing, decaying super-algebraically."""
    p, errs = observed_order("per", layout, GreenKind.CHAT2, (8, 12, 16))
    assert p > 2.0, (p, errs)
    assert errs[-1] < 1e-6, errs


@pytest.mark.parametrize("green,thresh", [
    (GreenKind.HEJ4, 3.3),
    (GreenKind.HEJ6, 5.2),
])
def test_periodic_hej_orders(green, thresh):
    p, errs = observed_order("per-wide", DataLayout.NODE, green,
                             (24, 32, 48))
    assert p > thresh, (p, errs)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_batched_solve_matches_analytical(engine):
    n, layout = 24, DataLayout.NODE
    fn, _ = val.CASES["unb"]
    rhs, sol = fn(n, layout)
    s = _solver("unb", n, layout, GreenKind.CHAT2, engine)
    scales = np.array([1.0, -2.0, 0.5])
    fb = np.stack([a * rhs for a in scales])
    ub = s.solve(fb.astype(np.float64)).numpy()
    ref_err = float(np.max(np.abs(ub[0] - sol)))
    for a, u in zip(scales, ub):
        assert np.max(np.abs(u - a * sol)) <= abs(a) * ref_err * (1 + 1e-10)
