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
symmetric and semi-unbounded directions, CELL and NODE).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.fft as sfft
import torch

from .bc import BCType, DataLayout, DirBC, TransformKind, r2r_kind
from . import transforms as tr
from . import green as gr
from .engine import (RELAYOUT_MODES, as_engine, build_schedule,
                     crop_doubling, folded_normfact, materialize_doubling,
                     relayout as _relayout, schedule_layouts)

__all__ = ["Plan1D", "PoissonPlan", "PoissonSolver", "make_plan",
           "build_green"]


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
    """

    def __init__(self, shape, L, bcs, layout=DataLayout.CELL,
                 green_kind=gr.GreenKind.CHAT2, eps_factor=2.0,
                 engine="cuda", doubling="deferred", relayout="scheduled",
                 order_policy="layout", device=None, green=None):
        if relayout not in RELAYOUT_MODES:
            raise ValueError(f"relayout must be one of {RELAYOUT_MODES}")
        self.device = _resolve_device(device)
        self.plan = make_plan(tuple(shape), L, bcs, layout, green_kind,
                              eps_factor, doubling=doubling,
                              order_policy=order_policy)
        self.engine = as_engine(engine)
        if self.engine.use_cuda:
            _check_kernel_lengths(self.plan)
        self.schedule = build_schedule(self.plan, self.engine)
        self.relayout = relayout
        want = tuple(p.n_out for p in self.plan.dirs)
        if green is None:
            g = build_green(self.plan)
        else:
            g = np.asarray(green, dtype=np.float64)
            if g.shape != want:
                raise ValueError(f"green has shape {g.shape}, the plan's "
                                 f"spectral storage is {want}")
        self._green_nat = g          # natural layout, float64, host
        # ONE device copy, in the layout the selected pipeline multiplies
        # in: natural for baseline, the spectral layout for scheduled
        if relayout == "scheduled":
            g = np.ascontiguousarray(
                np.transpose(g, self.schedule.layouts.spectral))
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

    def solve(self, f):
        """Solve lap(u) = f.  ``f``: a numpy array or a tensor of shape
        ``(*grid)`` or ``(B, *grid)``, float32 or float64; it is moved to
        the solver's device.  Returns a contiguous tensor of ``f``'s shape
        and dtype on the solver's device."""
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
        if self.relayout == "scheduled":
            u = self._solve_scheduled(f)
        else:
            u = self._solve_impl(f)
        return u.to(f.dtype).contiguous()
