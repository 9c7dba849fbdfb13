"""FFT-based Poisson solver (the flups pipeline), single process, PyTorch.

The solve is the paper's algorithm:

  forward:  for each direction (r2r dirs first, then semi-unbounded r2r,
            then the DFT dirs -- the first DFT dir is real-to-complex):
            bring the direction to the last axis, pad / slice per the BC
            convention (section II), 1-D transform;
  multiply: pointwise with the transformed Green's function (+ quadrature
            weight h per unbounded-ish direction and the r2r normalization);
  backward: inverse transforms in reverse order, crop, write back the
            convention-overwritten boundary values.

The plan layer (``make_plan``, ``build_green``) is pure Python + numpy and
reproduces ``repro.core.solver`` exactly, for every BC mix; ``PoissonSolver``
solves every BC mix the reference accepts (unbounded, periodic, even/odd
symmetric and semi-unbounded directions, CELL and NODE) under the
resilient runtime's degradation ladder and health guards; ``get_solver``
is the reference's construct-or-fetch plan cache.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import scipy.fft as sfft
import torch

from repro_torch.runtime import faults, health, resilience

from .bc import BCType, DataLayout, DirBC, TransformKind, r2r_kind
from . import transforms as tr
from . import green as gr
from .engine import (RELAYOUT_MODES, as_engine, build_schedule,
                     crop_doubling, folded_normfact, materialize_doubling,
                     relayout as _relayout, schedule_layouts)

__all__ = ["Plan1D", "PoissonPlan", "PoissonSolver", "make_plan",
           "build_green", "get_solver", "clear_solver_cache",
           "solver_cache_info", "set_solver_cache_capacity",
           "evict_solver_instance", "evict_solver_entries"]


@dataclass(frozen=True)
class Plan1D:
    dim: int
    bc: DirBC
    layout: DataLayout
    n: int                  # number of cells; node layout owns n+1 points
    L: float
    category: str           # "sym" | "semi" | "per" | "unb"
    kind: TransformKind | None
    dft: str | None         # "r2c" | "c2c" | None
    n_pts: int              # points in the user array along this dim
    in_start: int           # first user point handed to the transform
    n_in: int               # number of user points handed to the transform
    n_fft: int              # transform length (after padding)
    n_out: int              # spectral storage size
    flip: bool
    koffset: int            # storage index -> mode index offset
    normfact: float
    modes: tuple            # omega per storage index (length n_out)
    zero_left: bool = False   # backward writes 0 at user index 0
    zero_right: bool = False  # backward writes 0 at the last user index
    per_dup: bool = False     # node-periodic: copy u_0 into u_N
    # Hockney-doubling execution mode of this direction (PoissonPlan
    # ``doubling``): False = deferred/pruned (default; the transform pads
    # n_in -> n_fft itself), True = the zero extension is materialized UP
    # FRONT in the user array (dense textbook Hockney).
    pre_padded: bool = False

    @property
    def h(self) -> float:
        return self.L / self.n

    @property
    def is_unbounded_like(self) -> bool:
        return self.category in ("semi", "unb")

    @property
    def valid_in(self) -> int:
        """Live physical extent of this axis outside the 1-D transform."""
        return self.n_fft if self.pre_padded else self.n_pts


def _sym_plan(dim, bc, layout, n, L) -> Plan1D:
    kind = r2r_kind(bc, layout)
    if layout == DataLayout.NODE:
        n_pts = n + 1
        table = {
            TransformKind.DST1: (1, n - 1, True, True),
            TransformKind.DST3: (1, n, True, False),
            TransformKind.DCT3: (0, n, False, True),
            TransformKind.DCT1: (0, n + 1, False, False),
        }
        in_start, n_in, zl, zr = table[kind]
    else:
        n_pts, in_start, n_in, zl, zr = n, 0, n, False, False
    half = kind in (TransformKind.DCT3, TransformKind.DCT4,
                    TransformKind.DST3, TransformKind.DST4)
    koff = 1 if kind in (TransformKind.DST1, TransformKind.DST2) else 0
    k = np.arange(n_in) + koff
    modes = (k + 0.5) * np.pi / L if half else k * np.pi / L
    return Plan1D(dim, bc, layout, n, L, "sym", kind, None, n_pts,
                  in_start, n_in, n_in, n_in, False, koff,
                  tr.r2r_normfact(kind, n_in), tuple(modes), zl, zr)


def _per_plan(dim, bc, layout, n, L, dft) -> Plan1D:
    n_pts = n + 1 if layout == DataLayout.NODE else n
    if dft == "r2c":
        n_out = n // 2 + 1
        modes = 2.0 * np.pi * np.arange(n_out) / L
    else:
        n_out = n
        modes = 2.0 * np.pi * np.fft.fftfreq(n) * n / L
    return Plan1D(dim, bc, layout, n, L, "per", None, dft, n_pts, 0, n, n,
                  n_out, False, 0, 1.0, tuple(modes),
                  per_dup=(layout == DataLayout.NODE))


def _unb_plan(dim, bc, layout, n, L, dft) -> Plan1D:
    n_pts = n + 1 if layout == DataLayout.NODE else n
    n_in = n_pts
    n_fft = 2 * n
    if dft == "r2c":
        n_out = n + 1
        modes = 2.0 * np.pi * np.arange(n_out) / (2.0 * L)
    else:
        n_out = n_fft
        modes = 2.0 * np.pi * np.fft.fftfreq(n_fft) * n_fft / (2.0 * L)
    return Plan1D(dim, bc, layout, n, L, "unb", None, dft, n_pts, 0, n_in,
                  n_fft, n_out, False, 0, 1.0, tuple(modes))


def _semi_plan(dim, bc, layout, n, L) -> Plan1D:
    """Semi-unbounded: doubled domain + same-symmetry r2r at both ends."""
    flip = bc.right != BCType.UNB          # symmetry end on the right
    sym = bc.right if flip else bc.left
    pair = DirBC(sym, sym)
    kind = r2r_kind(pair, layout)          # on the doubled domain
    if layout == DataLayout.NODE:
        n_pts = n + 1
        if kind == TransformKind.DST1:     # odd: interior of doubled domain
            in_start, n_in, n_fft = 1, n, 2 * n - 1
            zl, zr = True, False
        else:                              # DCT1 on 2n+1 points
            in_start, n_in, n_fft = 0, n + 1, 2 * n + 1
            zl = zr = False
    else:
        n_pts, in_start, n_in, n_fft = n, 0, n, 2 * n
        zl = zr = False
    koff = 1 if kind in (TransformKind.DST1, TransformKind.DST2) else 0
    modes = (np.arange(n_fft) + koff) * np.pi / (2.0 * L)
    return Plan1D(dim, bc, layout, n, L, "semi", kind, None, n_pts,
                  in_start, n_in, n_fft, n_fft, flip, koff,
                  tr.r2r_normfact(kind, n_fft), tuple(modes), zl, zr)


DOUBLING_MODES = ("deferred", "upfront")
ORDER_POLICIES = ("layout", "natural")


def _choose_order(groups, ndim: int, policy: str):
    """Execution order of the dims, grouped by BC category (sym, then
    semi, then DFT -- the grouping is a correctness constraint; the order
    WITHIN each group is free).

    ``policy="natural"`` keeps ascending order.  ``policy="layout"``
    (default) picks, among all grouping-consistent orders, the one whose
    ``schedule_layouts`` needs the fewest edge relayouts -- single-category
    plans run ``(2, 0, 1)``, which starts and ends the scheduled pipeline
    in the user's natural layout.  Ties break to the lexicographically
    smallest order.
    """
    if policy == "natural":
        return tuple(d for g in groups for d in g)
    from itertools import permutations, product
    nat = tuple(range(ndim))
    best = None
    for combo in product(*[tuple(permutations(g)) for g in groups]):
        order = tuple(d for g in combo for d in g)
        lay = schedule_layouts(order, ndim)
        cost = int(lay.fwd[0] != nat) + int(lay.bwd[-1] != nat)
        if best is None or (cost, order) < best:
            best = (cost, order)
    return best[1]


@dataclass(frozen=True)
class PoissonPlan:
    dirs: tuple            # Plan1D per logical dim (0..2)
    order: tuple           # execution order of dims (forward)
    green_kind: str
    eps_factor: float
    # Hockney-doubling placement for the fully-unbounded directions:
    # "deferred" (pruned: the zero extension exists only inside that
    # direction's own 1-D transform) or "upfront" (dense: the input is
    # padded to 2n in every unbounded direction before the first transform)
    doubling: str = "deferred"

    @property
    def input_shape(self):
        return tuple(p.n_pts for p in self.dirs)


def make_plan(shape, L, bcs, layout=DataLayout.CELL,
              green_kind=gr.GreenKind.CHAT2, eps_factor=2.0,
              doubling: str = "deferred",
              order_policy: str = "layout") -> PoissonPlan:
    """``shape`` = cells per dim; ``bcs`` = 3 (left,right) BCType pairs."""
    if doubling not in DOUBLING_MODES:
        raise ValueError(f"doubling must be one of {DOUBLING_MODES}")
    if order_policy not in ORDER_POLICIES:
        raise ValueError(f"order_policy must be one of {ORDER_POLICIES}")
    ndim = len(shape)
    bcs = tuple(DirBC(*b) if not isinstance(b, DirBC) else b for b in bcs)
    for b in bcs:
        b.validate()
    sym_dims, semi_dims, dft_dims = [], [], []
    for d, b in enumerate(bcs):
        if b.is_unbounded or b.is_periodic:
            dft_dims.append(d)
        elif b.is_semi_unbounded:
            semi_dims.append(d)
        else:
            sym_dims.append(d)
    order = _choose_order([g for g in (sym_dims, semi_dims, dft_dims) if g],
                          ndim, order_policy)
    plans = [None] * ndim
    # the real-to-complex direction is the first DFT direction the solve
    # EXECUTES (order-dependent: everything before it is real r2r)
    first_dft = next((d for d in order if d in dft_dims), None)
    for d, b in enumerate(bcs):
        Ld = L[d] if isinstance(L, (tuple, list)) else L
        if b.is_periodic:
            dft = "r2c" if d == first_dft else "c2c"
            plans[d] = _per_plan(d, b, layout, shape[d], Ld, dft)
        elif b.is_unbounded:
            dft = "r2c" if d == first_dft else "c2c"
            plans[d] = _unb_plan(d, b, layout, shape[d], Ld, dft)
        elif b.is_semi_unbounded:
            plans[d] = _semi_plan(d, b, layout, shape[d], Ld)
        else:
            plans[d] = _sym_plan(d, b, layout, shape[d], Ld)
    if doubling == "upfront":
        import dataclasses as _dc
        # dense Hockney applies to the fully-unbounded dirs only, so
        # periodic-only plans are identical across both modes
        plans = [_dc.replace(p, pre_padded=True) if p.category == "unb"
                 else p for p in plans]
    return PoissonPlan(tuple(plans), order, green_kind, eps_factor, doubling)


# ---------------------------------------------------------------------------
# Green's function assembly (numpy, plan time)
# ---------------------------------------------------------------------------

def _green_phys_coord(p: Plan1D) -> np.ndarray:
    """Physical sample offsets (units of h index) for an unbounded-ish dir."""
    if p.category == "unb":
        j = np.arange(p.n_fft)
        return np.minimum(j, p.n_fft - j).astype(np.float64)
    # semi: node-sampled kernel on [0, 2L]: DCT-I grid with 2n+1 points
    return np.arange(2 * p.n + 1, dtype=np.float64)


def _green_dct1_align(gh: np.ndarray, axis: int, p: Plan1D) -> np.ndarray:
    """DCT-I transform of the kernel along a semi dir + koffset alignment."""
    gh = sfft.dct(gh, type=1, axis=axis, norm=None)
    sl = [slice(None)] * gh.ndim
    sl[axis] = slice(p.koffset, p.koffset + p.n_out)
    return gh[tuple(sl)]


def build_green(plan: PoissonPlan) -> np.ndarray:
    """Transformed Green's function aligned with the rhs spectral storage,
    in natural layout, float64.

    The combined normalization of every backward r2r transform (the product
    of the per-direction ``normfact``) is folded in here, once at plan
    time: the backward pass then runs unnormalized transforms and the solve
    performs a single pointwise multiply total.
    """
    dirs = plan.dirs
    norm = folded_normfact(plan)
    unb = [p for p in dirs if p.is_unbounded_like]
    n_unb = len(unb)
    kind = plan.green_kind
    hs = [p.h for p in dirs]
    h_ref = float(np.min([p.h for p in unb])) if unb else float(np.min(hs))

    if n_unb == 0:
        w = [np.asarray(p.modes) for p in dirs]
        grids = np.meshgrid(*w, indexing="ij")
        w2 = sum(g * g for g in grids)
        gh = gr.spectral_symbol(kind, w2, h_ref, w_axes=w,
                                eps_factor=plan.eps_factor)
        return gh * norm

    # physical axes for unbounded-ish dirs, mode axes for spectral dirs
    axes_coord = []
    for p in dirs:
        if p.is_unbounded_like:
            axes_coord.append(("phys", _green_phys_coord(p) * p.h))
        else:
            axes_coord.append(("mode", np.asarray(p.modes)))
    shape = tuple(len(c[1]) for c in axes_coord)
    g = np.zeros(shape, dtype=np.float64)

    phys_dims = [d for d, p in enumerate(dirs) if p.is_unbounded_like]
    mode_dims = [d for d, p in enumerate(dirs) if not p.is_unbounded_like]

    def bcast(arr1d, d):
        sh = [1] * len(dirs)
        sh[d] = len(arr1d)
        return np.asarray(arr1d).reshape(sh)

    if n_unb == 3:
        if kind == gr.GreenKind.LGF2:
            idx = [np.abs(np.rint(axes_coord[d][1] / dirs[d].h)).astype(int)
                   for d in range(3)]
            ii = [bcast(ix, d) for d, ix in enumerate(idx)]
            ii = np.broadcast_arrays(*ii)
            g = gr.lgf3_on_grid(tuple(ii), h_ref)
        else:
            r2 = sum(bcast(axes_coord[d][1], d) ** 2 for d in range(3))
            g = gr.kernel_3unb(kind, np.sqrt(r2), h_ref,
                               eps_factor=plan.eps_factor)
    elif n_unb == 2:
        (dm,) = mode_dims
        modes = np.asarray(axes_coord[dm][1])
        r2 = sum(bcast(axes_coord[d][1], d) ** 2 for d in phys_dims)
        r = np.sqrt(np.squeeze(r2, axis=dm))          # (n1, n2) radial grid
        gk = gr.kernel_2unb_batch(kind, modes, r, h_ref,
                                  eps_factor=plan.eps_factor)  # (nkz, n1, n2)
        g = np.moveaxis(gk, 0, dm)
    elif n_unb == 1:
        (dp,) = phys_dims
        x = axes_coord[dp][1]
        g = np.zeros(shape)
        # generic: iterate over mode combinations (cheap: O(N^2) combos)
        it = np.ndindex(*[shape[d] if d != dp else 1 for d in range(len(dirs))])
        for idx in it:
            kperp2 = 0.0
            for d in mode_dims:
                kperp2 += axes_coord[d][1][idx[d]] ** 2
            sl = list(idx)
            sl[dp] = slice(None)
            g[tuple(sl)] = gr.kernel_1unb(kind, kperp2, x, h_ref,
                                          eps_factor=plan.eps_factor)
    else:
        raise AssertionError

    # quadrature weight: h per unbounded-ish direction
    for d in phys_dims:
        g = g * dirs[d].h

    # transform along unbounded-ish dirs
    for d in phys_dims:
        p = dirs[d]
        if p.category == "unb":
            gh = np.fft.fft(g, axis=d)
            g = gh.real  # kernel is even-symmetric -> real spectrum
            if p.dft == "r2c":
                sl = [slice(None)] * g.ndim
                sl[d] = slice(0, p.n_out)
                g = g[tuple(sl)]
        else:  # semi
            g = _green_dct1_align(g, d, p)
    return g * norm


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------

def _resolve_device(device) -> torch.device:
    """The solver's device: the card unless the caller names another.
    With no card present and no device named, raise -- never run on the
    CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "PoissonSolver runs on the GPU by default, and torch finds no "
            "CUDA device; pass device='cpu' to solve on the CPU")
    return dev


def _check_kernel_lengths(plan):
    """Raise when a direction needs a power-of-two FFT longer than the
    Stockham kernel takes (``MAX_N`` = 2^24 points, in two passes above
    4096): the cuda engine sends every power-of-two length to that kernel,
    and never to ``torch.fft`` behind the caller's back."""
    from repro_torch.kernels.fft_stockham import MAX_N
    for p in plan.dirs:
        n = p.n_fft if p.kind is None else tr.fft_length(p.kind, p.n_fft)
        if tr._pow2(n) and n > MAX_N:
            raise ValueError(
                f"direction {p.dim} ({p.category}, {p.n} cells) needs a "
                f"power-of-two FFT of length {n}; the cuda engine's Stockham "
                f"kernel takes at most {MAX_N} points: use engine='torch'")


VERIFY_MODES = (None, "nan", "residual")


def _check_verify(verify):
    """Accept the ported health-guard modes; the reference's ABFT modes
    raise (they must never run unchecked)."""
    if verify in ("abft", "abft-stages"):
        raise NotImplementedError(
            f"verify={verify!r} needs runtime/abft.py, not ported yet "
            "(ROADMAP queue 1 item 6)")
    if verify not in VERIFY_MODES:
        raise ValueError(f"verify must be one of {VERIFY_MODES}, "
                         f"got {verify!r}")


class PoissonSolver:
    """u = solve(f): FFT-based solution of lap(u) = f with mixed BCs.

    ``engine``: "cuda" (default: the hand-written kernels) or "torch"
    (``torch.fft``, cuFFT on the card).  The cuda engine runs every
    power-of-two FFT on the Stockham kernel (lengths above 4096 in its
    two-pass form) and raises here when the plan needs one longer than the
    kernel's ``MAX_N`` = 2^24 points.  ``device``: where the solve runs;
    None means ``torch.device("cuda")`` and raises when there is no card.
    ``green``: an optional precomputed Green's function in natural layout
    (the array ``build_green`` returns, e.g. carried from another solver);
    by default it is assembled here.

    ``solve`` accepts ``f`` of shape ``(*grid)`` (one rhs) or ``(B, *grid)``
    (B right-hand sides sharing this plan, solved in one pipeline -- the
    same transform count with bigger row batches).  The plan, schedule and
    Green's function are shared by every call; the Green's function is
    moved to the device once and cast once per working dtype.

    Resilience (DESIGN.md #10): every ``solve`` runs under the graceful-
    degradation ladder -- on failure the solver retries transient errors
    with bounded backoff, then steps its config down one rung at a time
    (``cuda -> torch``, ``scheduled -> baseline``, ``deferred ->
    upfront``), rebuilding the pipeline each rung; the trail lands in
    ``self.stats["degradations"]`` and a terminal failure raises
    ``repro_torch.runtime.SolveError`` with stage provenance.  The
    ``cuda -> torch`` rung is taken only for a failure an armed fault plan
    injected: a kernel that really fails to build or launch, or returns
    non-finite values, raises ``SolveError`` and never hides behind
    cuFFT.  ``verify`` ("nan" | "residual", default off) arms the
    numerical health guards on every solve; a tripped guard walks the
    same ladder.  The reference's ABFT modes ("abft", "abft-stages") and
    its ``abft_rtol`` are not ported yet and raise
    ``NotImplementedError``.
    """

    def __init__(self, shape, L, bcs, layout=DataLayout.CELL,
                 green_kind=gr.GreenKind.CHAT2, eps_factor=2.0,
                 engine="cuda", doubling="deferred", relayout="scheduled",
                 order_policy="layout", device=None, green=None,
                 verify=None, verify_rtol=0.5, abft_rtol=None):
        if relayout not in RELAYOUT_MODES:
            raise ValueError(f"relayout must be one of {RELAYOUT_MODES}")
        _check_verify(verify)
        if abft_rtol is not None:
            raise NotImplementedError(
                "abft_rtol needs runtime/abft.py, not ported yet (ROADMAP "
                "queue 1 item 6)")
        self.device = _resolve_device(device)
        self._base = dict(shape=tuple(shape), L=L, bcs=bcs, layout=layout,
                          green_kind=green_kind, eps_factor=eps_factor,
                          order_policy=order_policy)
        self.verify = verify
        self.verify_rtol = float(verify_rtol)
        self.stats = {"solves": 0, "retries": 0, "verify_failures": 0,
                      "degradations": []}
        self._green_nat = None if green is None else np.asarray(
            green, dtype=np.float64)
        self._configure({"engine": as_engine(engine).name,
                         "doubling": doubling, "relayout": relayout})

    def _configure(self, cfg: dict):
        """(Re)build the pipeline for one runtime config -- the degradation
        ladder's rebuild hook (the constructor builds through it too): the plan,
        the schedule and the device Green's function.  The host Green's
        function (natural layout, float64) depends on no knob of the
        config, so it is assembled (or checked, when carried) once."""
        b = self._base
        plan = make_plan(b["shape"], b["L"], b["bcs"], b["layout"],
                         b["green_kind"], b["eps_factor"],
                         doubling=cfg["doubling"],
                         order_policy=b["order_policy"])
        engine = as_engine(cfg["engine"])
        if engine.use_cuda:
            _check_kernel_lengths(plan)
        want = tuple(p.n_out for p in plan.dirs)
        if self._green_nat is None:
            self._green_nat = build_green(plan)
        elif self._green_nat.shape != want:
            raise ValueError(f"green has shape {self._green_nat.shape}, the "
                             f"plan's spectral storage is {want}")
        self._cfg = dict(cfg)
        self.plan = plan
        self.engine = engine
        self.schedule = build_schedule(plan, engine)
        self.relayout = cfg["relayout"]
        # ONE device copy, in the layout the selected pipeline multiplies
        # in: natural for baseline, the spectral layout for scheduled
        g = self._green_nat
        if self.relayout == "scheduled":
            g = np.transpose(g, self.schedule.layouts.spectral)
        self._green = {torch.float64: torch.from_numpy(
            np.ascontiguousarray(g)).to(self.device)}

    @property
    def input_shape(self):
        return self.plan.input_shape

    def _green_as(self, dtype):
        """The device Green's function in the working precision ``dtype``
        (cast once per dtype, then reused)."""
        g = self._green.get(dtype)
        if g is None:
            g = self._green[dtype] = self._green[torch.float64].to(dtype)
        return g

    def _solve_impl(self, f):
        """Baseline pipeline: every direction transformed in natural
        layout through the moveaxis adapters."""
        plan = self.plan
        sched = self.schedule
        green = self._green_as(f.dtype)
        y = materialize_doubling(f, plan.dirs)   # no-op when deferred
        for d in plan.order:
            y = sched.fwd_chunk(y, d)
        y = sched.green_multiply(y, green)
        for d in reversed(plan.order):
            y = sched.bwd_chunk(y, d)
        if y.is_complex():
            y = y.real
        return crop_doubling(y, plan.dirs)

    def _solve_scheduled(self, f):
        """Layout-scheduled pipeline: one composed transpose per direction
        change, transforms always on the minor-most axis, the Green
        multiplied in the spectral layout, and -- on the cuda engine -- the
        last forward FFT running the Green multiply as its epilogue.
        Bit-exact vs the baseline pipeline on the torch engine (transposes
        only reorder rows; the per-row math is identical)."""
        plan = self.plan
        sched = self.schedule
        lay = sched.layouts
        nat = tuple(range(len(plan.dirs)))
        green = self._green_as(f.dtype)
        y = materialize_doubling(f, plan.dirs)   # no-op when deferred
        cur = nat
        for i, d in enumerate(plan.order[:-1]):
            y = _relayout(y, cur, lay.fwd[i])
            cur = lay.fwd[i]
            y = sched.fwd_last(y, d)
        d_last = plan.order[-1]
        y = _relayout(y, cur, lay.spectral)
        y = sched.fwd_last_green(y, d_last, green)
        cur = lay.spectral
        for i, d in enumerate(reversed(plan.order)):
            y = _relayout(y, cur, lay.bwd[i])
            cur = lay.bwd[i]
            y = sched.bwd_last(y, d)
        y = _relayout(y, cur, nat)
        if y.is_complex():
            y = y.real
        return crop_doubling(y, plan.dirs)

    def solve(self, f, verify=None):
        """Solve lap(u) = f.  ``f``: a numpy array or a tensor of shape
        ``(*grid)`` or ``(B, *grid)``, float32 or float64; it is moved to
        the solver's device.  Returns a contiguous tensor of ``f``'s shape
        and dtype on the solver's device.  ``verify`` overrides the
        constructor's health-guard mode for this call ("nan" | "residual"
        | None)."""
        if isinstance(f, np.ndarray):
            f = torch.from_numpy(np.ascontiguousarray(f))
        f = torch.as_tensor(f).to(self.device)
        if f.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"solve takes float32 or float64, got {f.dtype}")
        grid = self.input_shape
        if (f.ndim not in (len(grid), len(grid) + 1)
                or tuple(f.shape[f.ndim - len(grid):]) != grid):
            raise ValueError(f"f has shape {tuple(f.shape)}; the plan takes "
                             f"{grid} or (B, *{grid})")
        verify = self.verify if verify is None else verify
        _check_verify(verify)
        self.stats["solves"] += 1
        fired = 0

        def attempt():
            nonlocal fired
            fired = faults.firings()
            faults.fail_point("solve.dispatch")
            if self.relayout == "scheduled":
                u = self._solve_scheduled(f)
            else:
                u = self._solve_impl(f)
            u = u.to(f.dtype).contiguous()
            if verify:
                health.check_solution(
                    u, f, self.plan, mode=verify, rtol=self.verify_rtol,
                    stats=self.stats,
                    locate=lambda: health.locate_nonfinite_stage(
                        self.plan, self.schedule, f, self._green_nat))
            return u

        def may_degrade(e, action):
            # the kernels give way to torch.fft only for a fault an armed
            # plan injected into this attempt
            return (not action.startswith("engine:")
                    or isinstance(e, faults.InjectedFault)
                    or faults.firings() > fired)

        return resilience.run_with_ladder(
            attempt, config=self._cfg, reconfigure=self._configure,
            stats=self.stats, may_degrade=may_degrade)


# ---------------------------------------------------------------------------
# global plan/solver cache
# ---------------------------------------------------------------------------
#
# A CFD-style code (e.g. a vortex-method time-stepper) constructs the SAME
# solver over and over: identical shape/L/bcs/layout/green/engine/device.
# Planning is not free -- Green's function assembly is O(N^3) numpy work
# (seconds at 256^3) and the device copy is an O(N^3) upload.  ``get_solver``
# memoizes fully-constructed solvers in a module-level LRU keyed by the
# complete plan identity, so repeated construction costs a dict lookup.

_SOLVER_CACHE: OrderedDict = OrderedDict()
_SOLVER_CACHE_LOCK = threading.Lock()
# key -> in-flight construction (single-flight): N concurrent misses for
# the same key build the solver ONCE; the other N-1 callers park on the
# building thread's event and are handed the same instance ("coalesced")
_SOLVER_BUILDS: dict = {}
_SOLVER_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0,
                       "coalesced": 0, "build_failures": 0}
_SOLVER_CACHE_CAPACITY = 16


class _SolverBuild:
    """One in-flight get_solver construction: the building thread fills
    ``result``/``exc`` and sets ``done``; coalesced waiters block on it."""

    __slots__ = ("done", "result", "exc")

    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.exc = None


def _freeze(v):
    """Canonical hashable form of one get_solver argument."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


def get_solver(shape, L, bcs, layout=DataLayout.CELL,
               green_kind=gr.GreenKind.CHAT2, eps_factor=2.0,
               engine="cuda", doubling="deferred", relayout="scheduled",
               order_policy="layout", *, device=None, mesh=None, **kw):
    """Construct-or-fetch a solver from the global plan cache.

    Returns a ``PoissonSolver``, or a ``DistributedPoissonSolver`` when
    ``mesh`` (a ``DeviceMesh``) is given: the distributed keywords
    (``comm``, ``axes``, ``batch_axis``, ``dtype``, the autotune knobs,
    ...) pass through ``kw`` and are part of the key, as is the mesh,
    which hashes by its ranks, layout, device type and axis names.  The
    key is every constructor argument, the device (None resolves to the
    card, and raises without one), and the armed fault plan's token.
    For the single-process solver ``kw`` takes the health-guard arguments
    (``verify``, ``verify_rtol``; ``abft_rtol`` raises until ABFT is
    ported).  Entries are evicted least-recently-used beyond
    ``set_solver_cache_capacity`` (default 16 solvers).

    Construction is SINGLE-FLIGHT per key: when N threads miss the same
    key concurrently, exactly one of them builds -- the rest park on the
    building thread and receive the same instance (``coalesced`` in
    ``solver_cache_info``).  A failed build re-raises in every parked
    caller and leaves no cache entry behind, so the next request retries
    cleanly.  Every rank of a mesh calls ``get_solver`` alike: a miss
    constructs the distributed solver, which is collective.
    """
    if mesh is None:
        unknown = set(kw) - {"verify", "verify_rtol", "abft_rtol"}
        if unknown:
            raise TypeError(f"unexpected single-process solver kwargs: "
                            f"{sorted(unknown)}")
        dev = _resolve_device(device)
    else:
        from repro_torch.distributed.pencil import \
            _resolve_device as _mesh_device
        dev = _mesh_device(device)
    key = ("dist" if mesh is not None else "single", _freeze(shape),
           _freeze(L), _freeze(bcs),
           _freeze(layout), _freeze(green_kind), float(eps_factor),
           as_engine(engine), str(doubling), str(relayout),
           str(order_policy), str(dev), _freeze(mesh), _freeze(kw),
           # solvers built under an armed fault plan must never be served
           # to fault-free callers (their config may have degraded)
           ("faults", faults.plan_token()))
    owner = False
    with _SOLVER_CACHE_LOCK:
        s = _SOLVER_CACHE.get(key)
        if s is not None:
            _SOLVER_CACHE.move_to_end(key)
            _SOLVER_CACHE_STATS["hits"] += 1
            return s
        build = _SOLVER_BUILDS.get(key)
        if build is None:
            build = _SOLVER_BUILDS[key] = _SolverBuild()
            _SOLVER_CACHE_STATS["misses"] += 1
            owner = True
        else:
            # another thread is already constructing this key: park on its
            # build instead of duplicating the plan and Green work
            _SOLVER_CACHE_STATS["coalesced"] += 1
    if not owner:
        build.done.wait()
        if build.exc is not None:
            raise build.exc
        return build.result
    try:
        if mesh is not None:
            from repro_torch.distributed.pencil import \
                DistributedPoissonSolver
            s = DistributedPoissonSolver(
                shape, L, bcs, layout, green_kind, mesh=mesh,
                eps_factor=eps_factor, engine=engine, doubling=doubling,
                relayout=relayout, order_policy=order_policy, device=dev,
                **kw)
        else:
            s = PoissonSolver(shape, L, bcs, layout, green_kind, eps_factor,
                              engine=engine, doubling=doubling,
                              relayout=relayout, order_policy=order_policy,
                              device=dev, **kw)
    except BaseException as e:
        with _SOLVER_CACHE_LOCK:
            _SOLVER_BUILDS.pop(key, None)
            _SOLVER_CACHE_STATS["build_failures"] += 1
        build.exc = e
        build.done.set()
        raise
    with _SOLVER_CACHE_LOCK:
        _SOLVER_CACHE[key] = s
        _SOLVER_CACHE.move_to_end(key)
        while len(_SOLVER_CACHE) > _SOLVER_CACHE_CAPACITY:
            _SOLVER_CACHE.popitem(last=False)
            _SOLVER_CACHE_STATS["evictions"] += 1
        _SOLVER_BUILDS.pop(key, None)
    build.result = s
    build.done.set()
    return s


def clear_solver_cache():
    """Drop every cached solver and reset cache stats.  Also resets the
    process-wide warn-once state (``comm`` + ``resilience``): a fresh
    cache means fresh plans, and their one-shot warnings must be able to
    fire again -- long-lived processes and test fixtures both call this
    as THE runtime reset hook."""
    from . import comm as _comm
    with _SOLVER_CACHE_LOCK:
        _SOLVER_CACHE.clear()
        for k in _SOLVER_CACHE_STATS:
            _SOLVER_CACHE_STATS[k] = 0
    _comm.reset_warn_once()
    resilience.reset_warn_once()


def evict_solver_instance(solver) -> int:
    """Drop the cache entries holding exactly ``solver`` (identity, not
    equality), so the cache cannot keep its Green's function alive behind
    the caller's back.  Returns the eviction count."""
    with _SOLVER_CACHE_LOCK:
        stale = [k for k, v in _SOLVER_CACHE.items() if v is solver]
        for k in stale:
            del _SOLVER_CACHE[k]
            _SOLVER_CACHE_STATS["evictions"] += 1
    return len(stale)


def evict_solver_entries(mesh) -> int:
    """Drop every cached solver planned against ``mesh`` (elastic
    recovery: after a rank loss the old mesh's solvers hold dead process
    groups and must never be served again).  Returns the eviction
    count."""
    frozen = _freeze(mesh)
    with _SOLVER_CACHE_LOCK:
        stale = [k for k in _SOLVER_CACHE if k[0] == "dist" and frozen in k]
        for k in stale:
            del _SOLVER_CACHE[k]
            _SOLVER_CACHE_STATS["evictions"] += 1
    return len(stale)


def solver_cache_info() -> dict:
    with _SOLVER_CACHE_LOCK:
        return dict(_SOLVER_CACHE_STATS, size=len(_SOLVER_CACHE),
                    capacity=_SOLVER_CACHE_CAPACITY)


def set_solver_cache_capacity(n: int):
    global _SOLVER_CACHE_CAPACITY
    if n < 1:
        raise ValueError(f"solver cache capacity must be >= 1, got {n}")
    with _SOLVER_CACHE_LOCK:
        _SOLVER_CACHE_CAPACITY = int(n)
        while len(_SOLVER_CACHE) > _SOLVER_CACHE_CAPACITY:
            _SOLVER_CACHE.popitem(last=False)
            _SOLVER_CACHE_STATS["evictions"] += 1
