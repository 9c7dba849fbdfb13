"""The port's PoissonSolver (device="cpu", float64) against the reference
``repro.core.solver.PoissonSolver`` on the same numpy inputs.

On the CPU the "cuda" engine runs the kernels' plain versions (the
Stockham algorithm in torch), so these tests hold the kernels' algorithm
and every wrapper's reshaping, padding and cropping against the reference
end to end.  Bound: max |u_port - u_ref| < 1e-10 (the reference's own
distributed-vs-single bound in tests/test_distributed.py).
"""
import subprocess
import sys
import textwrap
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.core import solver as rsolver
from repro.core.bc import BCType, DataLayout
from repro.core.green import GreenKind
from repro_torch.core import bc as tbc
from repro_torch.core import transforms as tr
from repro_torch.core.solver import (PoissonSolver, _check_kernel_lengths,
                                     make_plan)
from repro_torch.kernels import ops

import test_validation as val
from test_poisson import case_b

E, O, P, U = BCType.EVEN, BCType.ODD, BCType.PER, BCType.UNB
MIXES = {"UUU": ((U, U), (U, U), (U, U)),
         "UPU": ((U, U), (P, P), (U, U)),
         "PPP": ((P, P), (P, P), (P, P))}
# mixes with symmetric (even/odd) and semi-unbounded directions: those of
# tests/test_torch_plan.py and the paper's semi-unbounded validation cases
R2R_MIXES = {"sym_per": ((E, E), (O, E), (P, P)),
             "semi": ((U, E), (U, U), (O, U)),
             "sym": ((E, O), (O, O), (E, E)),
             "semi_even": ((U, E), (U, U), (U, U)),
             "semi_odd": ((U, U), (U, U), (O, U))}
MIXES.update(R2R_MIXES)
N = 8


def _port_bcs(bcs):
    return tuple((tbc.BCType(a.value), tbc.BCType(b.value)) for a, b in bcs)


def _rhs(shape, batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(((batch,) if batch else ()) + shape)


# 2-D grids: the mixes whose Green's function the reference assembles in
# two dimensions (at most one unbounded-like direction)
MIXES_2D = {"PP": ((P, P), (P, P)), "UP": ((U, U), (P, P)),
            "EO_P": ((E, O), (P, P)), "semi_P": ((U, E), (P, P))}
ALL_MIXES = {**MIXES, **MIXES_2D}


def _grid(mix, n, shape):
    """The grid of ``mix``: ``shape`` when given, else n cells per axis
    (two axes for the 2-D mixes)."""
    if shape is not None:
        return tuple(shape)
    return (n,) * len(ALL_MIXES[mix])


@lru_cache(maxsize=None)
def _reference(mix, layout, doubling, relayout, batch, engine="xla",
               n=N, kind=GreenKind.CHAT2, shape=None, L=1.0, eps=2.0,
               order_policy="layout"):
    s = rsolver.PoissonSolver(_grid(mix, n, shape), L,
                              ALL_MIXES[mix],
                              layout=DataLayout[layout], green_kind=kind,
                              eps_factor=eps, engine=engine,
                              doubling=doubling, relayout=relayout,
                              order_policy=order_policy)
    f = _rhs(s.input_shape, batch)
    return f, np.asarray(s.solve(f)), s._green_nat


def _port(mix, layout, engine, doubling="deferred", relayout="scheduled",
          n=N, kind=GreenKind.CHAT2, shape=None, L=1.0, eps=2.0,
          order_policy="layout", **kw):
    return PoissonSolver(_grid(mix, n, shape), L,
                         _port_bcs(ALL_MIXES[mix]),
                         layout=tbc.DataLayout[layout], green_kind=kind,
                         eps_factor=eps, engine=engine, doubling=doubling,
                         relayout=relayout, order_policy=order_policy,
                         device="cpu", **kw)


def _matches(mix, layout, batch=None, **kw):
    """The port's solve on both engines within 1e-10 of the reference's
    (float64); the cuda-engine solver assembles its Green's function
    (bit-equal to the reference's), the torch-engine one carries it."""
    f, want, green = _reference(mix, layout, "deferred", "scheduled", batch,
                                **kw)
    sc = _port(mix, layout, "cuda", **kw)
    np.testing.assert_array_equal(sc._green_nat, green)
    st = _port(mix, layout, "torch", green=sc._green_nat, **kw)
    for s in (sc, st):
        got = s.solve(f)
        assert got.dtype == torch.float64 and tuple(got.shape) == f.shape
        assert np.abs(got.numpy() - want).max() < 1e-10


OTHER_KINDS = [k for k in GreenKind.ALL if k != GreenKind.CHAT2]


@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", ["UUU", "UPU", "PPP", "sym_per", "semi"])
@pytest.mark.parametrize("kind", OTHER_KINDS)
def test_green_kinds_match_reference(kind, mix, layout):
    """The seven Green kinds besides CHAT2 (LGF2, HEJ0-HEJ10)."""
    _matches(mix, layout, kind=kind)


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", list(MIXES))
def test_order_policy_natural_matches_reference(mix, layout, batch):
    _matches(mix, layout, batch, order_policy="natural")


@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("shape,L", [
    ((8, 12, 16), 1.0),                  # anisotropic, one L
    ((16, 8, 4), (1.0, 0.5, 0.25)),      # per-direction L, equal h
    ((8, 8, 12), (1.0, 2.0, 0.75)),      # per-direction L, unequal h
])
def test_anisotropic_grids_match_reference(shape, L, mix, layout):
    _matches(mix, layout, shape=shape, L=L)


@pytest.mark.parametrize("kind", [GreenKind.HEJ2, GreenKind.HEJ6])
@pytest.mark.parametrize("mix", ["UUU", "PPP", "semi"])
def test_eps_factor_matches_reference(mix, kind):
    """A non-default regularization width (eps = 3 h): the HEJ kernels'
    only free parameter."""
    _matches(mix, "CELL", kind=kind, eps=3.0)


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", list(MIXES_2D))
def test_2d_grids_match_reference(mix, layout, batch):
    _matches(mix, layout, batch, shape=(8, 12), L=(1.0, 1.5))


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("relayout", ["scheduled", "baseline"])
@pytest.mark.parametrize("doubling", ["deferred", "upfront"])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", ["UUU", "UPU", "PPP"])
def test_solve_matches_reference_xla(mix, layout, doubling, relayout, batch,
                                     engine):
    f, want, _ = _reference(mix, layout, doubling, relayout, batch)
    s = _port(mix, layout, engine, doubling, relayout)
    got = s.solve(f)
    assert got.dtype == torch.float64 and tuple(got.shape) == f.shape
    assert np.abs(got.numpy() - want).max() < 1e-10


@pytest.mark.parametrize("n", [8, 12])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("relayout", ["scheduled", "baseline"])
@pytest.mark.parametrize("doubling", ["deferred", "upfront"])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", list(R2R_MIXES))
def test_r2r_solve_matches_reference_xla(mix, layout, doubling, relayout,
                                         batch, engine, n):
    """Symmetric and semi-unbounded directions: n=8 takes the fused
    fft_stockham_twiddle and Stockham paths on the cuda engine, n=12 the
    library FFT + twiddle_pack path."""
    f, want, _ = _reference(mix, layout, doubling, relayout, batch, n=n)
    s = _port(mix, layout, engine, doubling, relayout, n=n)
    got = s.solve(f)
    assert got.dtype == torch.float64 and tuple(got.shape) == f.shape
    assert np.abs(got.numpy() - want).max() < 1e-10


@pytest.mark.parametrize("mix,layout", [("UUU", "CELL"), ("UPU", "CELL"),
                                        ("PPP", "NODE"), ("UUU", "NODE"),
                                        ("semi_even", "CELL"),
                                        ("semi_odd", "NODE"),
                                        ("sym", "CELL")])
def test_cuda_engine_matches_reference_pallas(mix, layout):
    f, want, _ = _reference(mix, layout, "deferred", "scheduled", None,
                            engine="pallas")
    got = _port(mix, layout, "cuda").solve(f).numpy()
    assert np.abs(got - want).max() < 1e-10


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("doubling", ["deferred", "upfront"])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", ["UUU", "UPU", "PPP"])
def test_scheduled_equals_baseline_bit_for_bit_on_torch(mix, layout,
                                                        doubling, batch):
    a = _port(mix, layout, "torch", doubling, "scheduled", n=16)
    b = _port(mix, layout, "torch", doubling, "baseline", n=16)
    f = _rhs(a.input_shape, batch, seed=1)
    assert torch.equal(a.solve(f), b.solve(f))


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("doubling", ["deferred", "upfront"])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", list(R2R_MIXES))
def test_r2r_scheduled_equals_baseline_bit_for_bit_on_torch(mix, layout,
                                                            doubling, batch):
    a = _port(mix, layout, "torch", doubling, "scheduled", n=16)
    b = _port(mix, layout, "torch", doubling, "baseline", n=16)
    f = _rhs(a.input_shape, batch, seed=1)
    assert torch.equal(a.solve(f), b.solve(f))


def test_analytic_unbounded_case_b_matches_reference_error():
    """Fully unbounded bump (tests/test_poisson.py CASES["B"]), CELL,
    CHAT2: the port's error equals the reference's, which converges at
    second order (the reference test asserts an order above 1.55)."""
    errs = []
    for n in (16, 32):
        rhs, sol = case_b(n, DataLayout.CELL)
        ref = rsolver.PoissonSolver((n,) * 3, 1.0, MIXES["UUU"])
        e_ref = np.abs(np.asarray(ref.solve(rhs)) - sol).max()
        u = _port("UUU", "CELL", "cuda", n=n).solve(rhs).numpy()
        e = np.abs(u - sol).max()
        assert abs(e - e_ref) < 1e-12, (e, e_ref)
        errs.append(e)
    assert np.log(errs[0] / errs[1]) / np.log(2.0) > 1.55, errs


@pytest.mark.parametrize("relayout", ["scheduled", "baseline"])
@pytest.mark.parametrize("mix,layout", [("UUU", "CELL"), ("UPU", "NODE")])
def test_green_carried_from_reference(mix, layout, relayout):
    f, want, green = _reference(mix, layout, "deferred", relayout, None)
    own = _port(mix, layout, "cuda", relayout=relayout)
    carried = _port(mix, layout, "cuda", relayout=relayout, green=green)
    np.testing.assert_array_equal(carried._green_nat, own._green_nat)
    assert torch.equal(carried.solve(f), own.solve(f))


def test_green_with_wrong_shape_raises():
    with pytest.raises(ValueError):
        _port("UUU", "CELL", "cuda", green=np.zeros((4, 4, 4)))


@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("case", ["semi-even", "semi-odd"])
def test_semi_unbounded_chat2_order2(case, layout):
    """The paper's semi-unbounded validation (Fig. 7,
    tests/test_validation.py): a Gaussian blob and its mirror image
    through the bounded end, CHAT2, on the cuda engine; n=24 takes the
    twiddle_pack path.  Observed order over n = 16, 24, 32 above 1.55."""
    fn, bcs = val.CASES[case]
    lay = DataLayout[layout]
    ns = (16, 24, 32)
    errs = []
    for n in ns:
        rhs, sol = fn(n, lay)
        s = PoissonSolver((n,) * 3, val.L, _port_bcs(bcs),
                          layout=tbc.DataLayout[layout], device="cpu")
        errs.append(float(np.abs(s.solve(rhs).numpy() - sol).max()))
    p = -np.polyfit(np.log(ns), np.log(errs), 1)[0]
    assert p > 1.55, (p, errs)
    assert errs[0] > errs[1] > errs[2], errs


@pytest.mark.parametrize("bcs,shape", [
    (((P, P), (P, P), (P, P)), (4, 4, 8192)),          # DFT, length 8192
    (((U, U), (U, U), (U, U)), (4, 4, 4096)),          # unbounded, 2n = 8192
    (((P, P), (P, P), (U, E)), (4, 4, 2048)),          # semi DCT-II, 4n
])
def test_cuda_engine_refuses_a_fft_beyond_the_kernel_at_construction(bcs,
                                                                     shape):
    """Direction 2 needs an 8192-point FFT, beyond one pass of the Stockham
    kernel: the cuda engine solves it in two passes (on the CPU their plain
    version) and matches the reference within 1e-10 in float64.  The same
    BCs at 4096 times the length need 2^25 points, beyond the kernel's
    MAX_N = 2^24: the cuda engine raises when it is built, naming the
    direction and the length, instead of in the middle of a solve (and
    never routes to torch.fft)."""
    ref = rsolver.PoissonSolver(shape, 1.0, bcs, engine="xla")
    f = _rhs(ref.input_shape, None)
    want = np.asarray(ref.solve(f))
    s = PoissonSolver(shape, 1.0, _port_bcs(bcs), device="cpu")
    assert max(_fft_lengths(s.plan)) == 8192
    got = s.solve(f).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-10
    # the torch engine takes the same plan
    t = PoissonSolver(shape, 1.0, _port_bcs(bcs), engine="torch",
                      device="cpu", green=s._green_nat)
    assert np.abs(t.solve(f).numpy() - want).max() < 1e-10
    long = shape[:2] + (shape[2] * 4096,)
    with pytest.raises(ValueError,
                       match=rf"direction 2 .* length {2 ** 25}\b"):
        PoissonSolver(long, 1.0, _port_bcs(bcs), device="cpu")


def _fft_lengths(plan):
    return [p.n_fft if p.kind is None else tr.fft_length(p.kind, p.n_fft)
            for p in plan.dirs]


@pytest.mark.parametrize("n,accepted", [(2 ** 22, True), (2 ** 23, False)])
def test_cuda_engine_takes_ffts_up_to_max_n(n, accepted):
    """A semi-unbounded direction of n cells FFTs 4n points: n = 2^22 is
    the kernel's MAX_N = 2^24 exactly and passes the construction check;
    n = 2^23 needs 2^25 points and is refused, the message naming the
    direction and the length.  (The check reads the plan only; no Green's
    function is built.)"""
    plan = make_plan((2, 2, n), 1.0, _port_bcs(((P, P), (P, P), (U, E))))
    assert max(_fft_lengths(plan)) == 4 * n
    if accepted:
        _check_kernel_lengths(plan)
    else:
        with pytest.raises(ValueError,
                           match=rf"direction 2 .* length {4 * n}\b.*"
                                 rf"at most {2 ** 24}"):
            _check_kernel_lengths(plan)


def test_cuda_engine_takes_long_non_power_of_two_lengths():
    """Lengths that are not powers of two take torch.fft on the cuda
    engine, however long."""
    s = PoissonSolver((4, 4, 6000), 1.0, _port_bcs(MIXES["PPP"]),
                      device="cpu")
    u = s.solve(_rhs(s.input_shape, None))
    assert bool(torch.isfinite(u).all())


def test_float32_solve_keeps_precision_and_matches_float64():
    s = _port("UUU", "CELL", "cuda")
    f = _rhs(s.input_shape, None)
    u32 = s.solve(f.astype(np.float32))
    assert u32.dtype == torch.float32
    u64 = s.solve(f).numpy()
    assert np.abs(u32.numpy() - u64).max() < 1e-5 * np.abs(u64).max()
    # the Green's function was cast once per working dtype
    assert set(s._green) == {torch.float64, torch.float32}


def test_solve_rejects_wrong_shape():
    s = _port("PPP", "CELL", "torch")
    with pytest.raises(ValueError):
        s.solve(np.zeros((4, 4, 4)))


# launches per CELL solve the reference's structure gives (8 + 1, 7 + 1,
# 5 + 1) and the NODE (U,U,U) path that does not fuse the Green multiply
@pytest.mark.parametrize("mix,layout,want", [
    ("UUU", "CELL", (8, 1, 0)), ("UPU", "CELL", (7, 1, 0)),
    ("PPP", "CELL", (5, 1, 0)), ("UUU", "NODE", (6, 0, 1)),
])
def test_cuda_engine_kernel_calls_per_solve(monkeypatch, mix, layout, want):
    calls = {"fft_stockham": 0, "fft_stockham_scale": 0,
             "spectral_scale": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    s = _port(mix, layout, "cuda")
    s.solve(_rhs(s.input_shape, None))
    assert tuple(calls.values()) == want


# the five kernel wrappers' calls per solve on the r2r mixes: (fft_stockham,
# fft_stockham_scale, spectral_scale, fft_stockham_twiddle, twiddle_pack).
# semi CELL n=8: the fused DCT-II / DST-II forward, its DCT-III / DST-III
# inverse on the Stockham kernel, then the (U,U,U) DFT pattern of two
# directions; sym n=12 (no power-of-two length): two twiddle_packs after
# the library rfft, DCT-IV on the library FFT, the Green multiply on a real
# field; NODE semi-even: two fused DCT-Is and the unpruned NODE DFTs
@pytest.mark.parametrize("bcs,layout,n,want", [
    (R2R_MIXES["semi_even"], "CELL", 8, (6, 1, 0, 1, 0)),
    (R2R_MIXES["semi_odd"], "CELL", 8, (6, 1, 0, 1, 0)),
    (((E, E), (O, O), (E, O)), "CELL", 12, (0, 0, 1, 0, 2)),
    (R2R_MIXES["semi_even"], "NODE", 8, (4, 0, 1, 2, 0)),
])
def test_cuda_engine_r2r_kernel_calls_per_solve(monkeypatch, bcs, layout, n,
                                                want):
    calls = dict.fromkeys(("fft_stockham", "fft_stockham_scale",
                           "spectral_scale", "fft_stockham_twiddle",
                           "twiddle_pack"), 0)
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    s = PoissonSolver((n,) * 3, 1.0, _port_bcs(bcs),
                      layout=tbc.DataLayout[layout], device="cpu")
    s.solve(_rhs(s.input_shape, None))
    assert tuple(calls.values()) == want


@pytest.mark.parametrize("mix", list(R2R_MIXES))
def test_torch_engine_calls_no_kernel_on_r2r_mixes(monkeypatch, mix):
    def boom(*a, **kw):
        raise AssertionError("the torch engine must not reach a kernel")
    for name in ("fft_stockham", "fft_stockham_scale", "spectral_scale",
                 "fft_stockham_twiddle", "twiddle_pack"):
        monkeypatch.setattr(ops, name, boom)
    for layout in ("CELL", "NODE"):
        s = _port(mix, layout, "torch")
        s.solve(_rhs(s.input_shape, None))


def test_torch_engine_calls_no_kernel(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("the torch engine must not reach a kernel")
    for name in ("fft_stockham", "fft_stockham_scale", "spectral_scale"):
        monkeypatch.setattr(ops, name, boom)
    for layout in ("CELL", "NODE"):
        s = _port("UUU", layout, "torch")
        s.solve(_rhs(s.input_shape, None))


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoissonSolver((8, 8, 8), 1.0, _port_bcs(MIXES["PPP"]))


def test_port_imports_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "repro" or m.startswith("repro."))
        assert not loaded, loaded
        print(len([m for m in sys.modules if m.startswith("repro_torch")]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 36
