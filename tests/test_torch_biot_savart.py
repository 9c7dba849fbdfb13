"""The port's ``BiotSavartSolver`` (device="cpu", float64) against
``repro.core.biot_savart.BiotSavartSolver`` on the same numpy inputs.

Both engines: on the CPU the "cuda" engine runs the kernels' plain
versions (the Stockham algorithm in torch), so these tests hold both
Biot-Savart pipelines -- the sequential per-component one and the batched
uniform-plan one with its ``spectral_scale`` Green multiply -- against the
reference end to end.  Bound: max |u_port - u_ref| < 1e-10.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.core.bc import BCType, DataLayout
from repro.core.biot_savart import BiotSavartSolver as RefBS
from repro.core.green import GreenKind
from repro_torch.core import bc as tbc
from repro_torch.core.biot_savart import BiotSavartSolver
from repro_torch.core.solver import clear_solver_cache
from repro_torch.kernels import ops
from repro_torch.runtime import resilience

import test_biot_savart as ref_tests

E, O, P, U = BCType.EVEN, BCType.ODD, BCType.PER, BCType.UNB
TUBE = ref_tests.BCS
# all nine pairs unbounded: one plan for every component (batched); the
# periodic box (P,P) in every direction batches too
UNIFORM = {"UUU": [[(U, U)] * 3] * 3, "PPP": [[(P, P)] * 3] * 3}
BCS = {"tube": TUBE, **UNIFORM,
       # x periodic, y unbounded, z symmetric: a sequential mix
       "mixed": [[(P, P), (U, U), (E, E)], [(P, P), (U, U), (E, E)],
                 [(P, P), (U, U), (O, O)]]}
N = 16


@pytest.fixture(autouse=True)
def _fresh_port_runtime():
    clear_solver_cache()
    resilience.reset_warn_once()
    yield
    clear_solver_cache()
    resilience.reset_warn_once()


def _port_bcs(bcs):
    return [[(tbc.BCType(a.value), tbc.BCType(b.value)) for a, b in row]
            for row in bcs]


def _rhs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@lru_cache(maxsize=None)
def _reference(case, layout, green, fd_order, n=N):
    s = RefBS((n,) * 3, 1.0, BCS[case], layout=DataLayout[layout],
              green_kind=green, fd_order=fd_order)
    f = _rhs(s.input_shape)
    return f, np.asarray(s.solve(f)), s.batched, s.greens


def _port(case, layout, green, fd_order, engine, n=N, **kw):
    return BiotSavartSolver((n,) * 3, 1.0, _port_bcs(BCS[case]),
                            layout=tbc.DataLayout[layout], green_kind=green,
                            fd_order=fd_order, engine=engine, device="cpu",
                            **kw)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("case,layout,green,fd_order", [
    ("tube", "CELL", GreenKind.CHAT2, 0),
    ("tube", "NODE", GreenKind.CHAT2, 0),
    ("tube", "CELL", GreenKind.CHAT2, 2),
    ("tube", "NODE", GreenKind.HEJ4, 6),
    ("UUU", "CELL", GreenKind.CHAT2, 0),
    ("UUU", "NODE", GreenKind.HEJ4, 2),
    ("PPP", "CELL", GreenKind.CHAT2, 6),
    ("mixed", "NODE", GreenKind.CHAT2, 2),
])
def test_matches_reference(case, layout, green, fd_order, engine):
    f, want, batched, _ = _reference(case, layout, green, fd_order)
    s = _port(case, layout, green, fd_order, engine)
    assert s.batched == batched == (case in UNIFORM)
    assert s.input_shape == f.shape
    got = s.solve(f)
    assert got.dtype == torch.float64 and tuple(got.shape) == f.shape
    assert np.abs(got.numpy() - want).max() < 1e-10


@pytest.mark.parametrize("case,want", [
    # three sequential components: fused DCT-II / DST-II and two pruned
    # DFTs forward, two parity-split DFT inverses and one Stockham irfft
    # backward, the Green multiply in plain torch
    ("tube", dict(fft_stockham=21, fft_stockham_twiddle=3)),
    # one 3-wide pipeline: 3 forwards, one spectral_scale, 3 x 2 inverses
    ("UUU", dict(fft_stockham=9, spectral_scale=1)),
])
def test_cuda_engine_kernel_calls_per_solve(monkeypatch, case, want):
    calls = dict.fromkeys(("fft_stockham", "fft_stockham_scale",
                           "spectral_scale", "fft_stockham_twiddle",
                           "twiddle_pack"), 0)
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    s = _port(case, "CELL", GreenKind.CHAT2, 0, "cuda")
    s.solve(_rhs(s.input_shape))
    assert {k: v for k, v in calls.items() if v} == want


def test_float32_solve_matches_float64():
    s = _port("UUU", "CELL", GreenKind.CHAT2, 0, "cuda")
    f = _rhs(s.input_shape)
    u32 = s.solve(f.astype(np.float32))
    assert u32.dtype == torch.float32
    u64 = s.solve(f).numpy()
    assert np.abs(u32.numpy() - u64).max() < 1e-5 * np.abs(u64).max()


@pytest.mark.parametrize("case,layout", [("tube", "CELL"), ("UUU", "NODE")])
def test_greens_carried_from_reference(case, layout):
    f, want, _, greens = _reference(case, layout, GreenKind.CHAT2, 0)
    own = _port(case, layout, GreenKind.CHAT2, 0, "cuda")
    carried = _port(case, layout, GreenKind.CHAT2, 0, "cuda",
                    greens=[np.asarray(g) for g in greens])
    for a, b in zip(carried.greens, own.greens):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(carried.solve(f), own.solve(f))


def test_equal_velocity_plans_share_one_green():
    """The tube's w_x and w_y velocity plans are equal: one assembly, the
    same values as the reference's per-component arrays."""
    _, _, _, greens = _reference("tube", "CELL", GreenKind.CHAT2, 0)
    s = _port("tube", "CELL", GreenKind.CHAT2, 0, "torch")
    assert s.uplans[0] == s.uplans[1] != s.uplans[2]
    assert s.greens[0] is s.greens[1]
    assert s.greens[2] is not s.greens[0]
    for mine, ref in zip(s.greens, greens):
        np.testing.assert_array_equal(mine, np.asarray(ref))


def test_greens_with_wrong_shape_raise():
    with pytest.raises(ValueError):
        _port("tube", "CELL", GreenKind.CHAT2, 0, "cuda",
              greens=[np.zeros((4, 4, 4))] * 3)
    with pytest.raises(ValueError):
        _port("tube", "CELL", GreenKind.CHAT2, 0, "cuda",
              greens=[np.zeros((4, 4, 4))] * 2)


def test_incompatible_bcs_raise():
    bad = [row[:] for row in TUBE]
    bad[0][2] = (E, E)  # w_x even in z clashes with w_y odd
    with pytest.raises(ValueError):
        BiotSavartSolver((16, 16, 16), 1.0, _port_bcs(bad), device="cpu")


def test_solve_rejects_wrong_shape():
    s = _port("PPP", "CELL", GreenKind.CHAT2, 0, "torch")
    with pytest.raises(ValueError):
        s.solve(np.zeros((3, 8, 8, 8)))


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BiotSavartSolver((8, 8, 8), 1.0, _port_bcs(TUBE))


def test_vortex_tube_cell_layout():
    """The reference's CELL-layout tube check (tests/test_biot_savart.py),
    on the port's default engine."""
    f, u_ref = ref_tests.tube_fields(48, DataLayout.CELL)
    s = BiotSavartSolver((48,) * 3, ref_tests.L, _port_bcs(TUBE),
                         layout=tbc.DataLayout.CELL, device="cpu")
    err = float(np.max(np.abs(s.solve(f).numpy() - u_ref)))
    assert err < 4e-3, err
