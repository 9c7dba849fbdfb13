"""The port's spectral differentiation (``repro_torch.core.spectral``)
against ``repro.core.spectral`` on the same numpy inputs.

``fd_symbol``, ``swap_bc`` and ``SWAP`` are plan-time numpy / enum code and
must agree bit for bit.  ``apply_derivative`` runs on tensors: every r2r
kind pair (CELL: DCT-II/DST-II, DCT-IV/DST-IV; NODE: DCT-I/DST-I,
DCT-III/DST-III; the semi-unbounded doubled-domain kinds) on complex and
real spectral storage, and the periodic and unbounded DFT directions
(complex), each at spectral and FD orders 2/4/6, float64 within 1e-13 of
the reference's largest value.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import solver as rsolver
from repro.core import spectral as rsp
from repro.core.bc import BCType as RB, DataLayout as RL
from repro_torch.core import solver as tsolver
from repro_torch.core import spectral as tsp
from repro_torch.core.bc import BCType as TB, DataLayout as TL
from repro_torch.core.solver import clear_solver_cache
from repro_torch.runtime import resilience

SHAPE = (6, 8, 10)
L = (1.0, 1.3, 0.7)


@pytest.fixture(autouse=True)
def _fresh_port_runtime():
    clear_solver_cache()
    resilience.reset_warn_once()
    yield
    clear_solver_cache()
    resilience.reset_warn_once()


def _plans(bc_dir, d, layout):
    """(reference, port) plans with ``bc_dir`` along ``d`` and unbounded
    elsewhere."""
    bcs = [("UNB", "UNB")] * 3
    bcs[d] = bc_dir
    ref = rsolver.make_plan(SHAPE, L, [(RB[a], RB[b]) for a, b in bcs],
                            RL[layout])
    port = tsolver.make_plan(SHAPE, L, [(TB[a], TB[b]) for a, b in bcs],
                             TL[layout])
    return ref, port


def _swapped(bc_dir):
    sw = {"EVEN": "ODD", "ODD": "EVEN"}
    return tuple(sw.get(b, b) for b in bc_dir)


@pytest.mark.parametrize("order", [0, 2, 4, 6])
def test_fd_symbol_bit_equal(order):
    omega = np.linspace(-40.0, 40.0, 97)
    for h in (0.01, 1.0 / 7.0, 0.3):
        np.testing.assert_array_equal(tsp.fd_symbol(omega, h, order),
                                      rsp.fd_symbol(omega, h, order))


def test_fd_symbol_rejects_unknown_order():
    with pytest.raises(ValueError):
        tsp.fd_symbol(np.ones(3), 0.1, 3)


def test_swap_bc_and_swap_table_bit_equal():
    for b in TB:
        assert tsp.swap_bc(b).value == rsp.swap_bc(RB(b.value)).value
    assert {k.value: v.value for k, v in tsp.SWAP.items()} == \
        {k.value: v.value for k, v in rsp.SWAP.items()}


# (BC pair along the differentiated direction, layout): every r2r kind
R2R = [(("EVEN", "EVEN"), "CELL"), (("ODD", "ODD"), "CELL"),
       (("EVEN", "ODD"), "CELL"), (("ODD", "EVEN"), "CELL"),
       (("EVEN", "EVEN"), "NODE"), (("ODD", "ODD"), "NODE"),
       (("EVEN", "ODD"), "NODE"), (("ODD", "EVEN"), "NODE"),
       (("UNB", "EVEN"), "CELL"), (("ODD", "UNB"), "NODE")]


def _assert_close(got, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(want).max()


@pytest.mark.parametrize("order", [0, 2, 4, 6])
@pytest.mark.parametrize("storage", ["complex", "real"])
@pytest.mark.parametrize("d", [0, 2])
@pytest.mark.parametrize("bc_dir,layout", R2R)
def test_apply_derivative_r2r(bc_dir, layout, d, storage, order):
    rf, pf = _plans(bc_dir, d, layout)
    rt, pt = _plans(_swapped(bc_dir), d, layout)
    assert pf.dirs[d].kind.value == rf.dirs[d].kind.value
    assert tsp.SWAP[pf.dirs[d].kind] == pt.dirs[d].kind
    rng = np.random.default_rng(d + 10 * order)
    shape = tuple(p.n_out for p in pf.dirs)
    y = rng.standard_normal(shape)
    if storage == "complex":
        y = y + 1j * rng.standard_normal(shape)
    want = rsp.apply_derivative(jnp.asarray(y), rf.dirs[d], rt.dirs[d],
                                order)
    got = tsp.apply_derivative(torch.from_numpy(y), pf.dirs[d], pt.dirs[d],
                               order)
    _assert_close(got, want)


@pytest.mark.parametrize("order", [0, 2, 4, 6])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("d", [0, 1, 2])
@pytest.mark.parametrize("bc_dir", [("PER", "PER"), ("UNB", "UNB")])
def test_apply_derivative_dft(bc_dir, d, layout, order):
    """Periodic / unbounded directions (the first executed DFT direction is
    the r2c one, the others c2c): multiply by i * symbol."""
    rf, pf = _plans(bc_dir, d, layout)
    shape = tuple(p.n_out for p in pf.dirs)
    rng = np.random.default_rng(d + 3 * order)
    y = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    want = rsp.apply_derivative(jnp.asarray(y), rf.dirs[d], rf.dirs[d],
                                order)
    got = tsp.apply_derivative(torch.from_numpy(y), pf.dirs[d], pf.dirs[d],
                               order)
    _assert_close(got, want)


def test_apply_derivative_keeps_complex64():
    _, pf = _plans(("PER", "PER"), 1, "CELL")
    shape = tuple(p.n_out for p in pf.dirs)
    y = torch.ones(shape, dtype=torch.complex64)
    assert tsp.apply_derivative(y, pf.dirs[1], pf.dirs[1]).dtype == \
        torch.complex64
    _, pe = _plans(("EVEN", "EVEN"), 1, "CELL")
    _, po = _plans(("ODD", "ODD"), 1, "CELL")
    yr = torch.ones(tuple(p.n_out for p in pe.dirs), dtype=torch.float32)
    assert tsp.apply_derivative(yr, pe.dirs[1], po.dirs[1]).dtype == \
        torch.float32


def test_apply_derivative_rejects_a_family_that_is_not_the_swap():
    _, pe = _plans(("EVEN", "EVEN"), 0, "CELL")
    shape = tuple(p.n_out for p in pe.dirs)
    with pytest.raises(ValueError):
        tsp.apply_derivative(torch.zeros(shape), pe.dirs[0], pe.dirs[0])
