"""The port's plan layer against the reference: ``make_plan`` fields equal
(enums by value, float tuples exactly) and ``build_green`` bit-equal, over
BC mixes (symmetric and semi-unbounded included) x CELL/NODE x Green kinds
x doubling x order policy."""
import enum

import numpy as np
import pytest

from repro.core import solver as rsolver
from repro.core.bc import BCType, DataLayout
from repro.core.green import GreenKind
from repro_torch.core import bc as tbc
from repro_torch.core import solver as tsolver

E, O, P, U = BCType.EVEN, BCType.ODD, BCType.PER, BCType.UNB

MIXES = {
    "UUU": ((U, U), (U, U), (U, U)),
    "UPU": ((U, U), (P, P), (U, U)),
    "PPP": ((P, P), (P, P), (P, P)),
    "sym_per": ((E, E), (O, E), (P, P)),
    "semi": ((U, E), (U, U), (O, U)),
    "sym": ((E, O), (O, O), (E, E)),
}


def _port_bcs(bcs):
    return tuple((tbc.BCType(a.value), tbc.BCType(b.value)) for a, b in bcs)


def _norm(v):
    """Field value in a framework-neutral form: enums by value, DirBCs as
    (left, right) values, everything else as is."""
    if isinstance(v, enum.Enum):
        return v.value
    if hasattr(v, "left") and hasattr(v, "right"):
        return (v.left.value, v.right.value)
    return v


def _fields(plan):
    dirs = []
    for p in plan.dirs:
        d = {k: _norm(getattr(p, k)) for k in p.__dataclass_fields__}
        d.update(h=p.h, valid_in=p.valid_in,
                 is_unbounded_like=p.is_unbounded_like)
        dirs.append(d)
    return dict(dirs=dirs, order=plan.order, green_kind=plan.green_kind,
                eps_factor=plan.eps_factor, doubling=plan.doubling,
                input_shape=plan.input_shape)


@pytest.mark.parametrize("order_policy", ["layout", "natural"])
@pytest.mark.parametrize("doubling", ["deferred", "upfront"])
@pytest.mark.parametrize("kind", [GreenKind.CHAT2, GreenKind.HEJ4,
                                  GreenKind.LGF2])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", list(MIXES))
def test_plan_and_green_match_reference(mix, layout, kind, doubling,
                                        order_policy):
    bcs = MIXES[mix]
    shape, L = (8, 6, 4), (1.0, 0.75, 1.5)
    ref_plan = rsolver.make_plan(shape, L, bcs, DataLayout[layout], kind,
                                 doubling=doubling,
                                 order_policy=order_policy)
    port_plan = tsolver.make_plan(shape, L, _port_bcs(bcs),
                                  tbc.DataLayout[layout], kind,
                                  doubling=doubling,
                                  order_policy=order_policy)
    assert _fields(port_plan) == _fields(ref_plan)
    want = rsolver.build_green(ref_plan)
    got = tsolver.build_green(port_plan)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mix", ["UUU", "PPP"])
def test_plan_rejects_unknown_modes(mix):
    bcs = _port_bcs(MIXES[mix])
    with pytest.raises(ValueError):
        tsolver.make_plan((8, 8, 8), 1.0, bcs, doubling="lazy")
    with pytest.raises(ValueError):
        tsolver.make_plan((8, 8, 8), 1.0, bcs, order_policy="random")
