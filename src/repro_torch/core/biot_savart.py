"""Biot-Savart solver:  lap(u) = curl(f)  (paper section V).

Counterpart of ``repro.core.biot_savart``.  Forward-transform the three
components of ``f`` (each with its own BCs), evaluate the curl in spectral
space (DCT<->DST swaps + i*omega factors), multiply by the Green's
function assembled on the *velocity* plans, and transform backward with
the velocity plans.

The velocity BCs are derived from the vorticity BCs by the swap algebra:
component c of ``curl f`` differentiates f_b along a (cyclic), flipping
even<->odd along the differentiated direction only.  Both curl terms must
land in the same basis -- checked at plan time; this is the compatibility
condition on the user-provided vorticity BCs.

Two pipelines, as in the reference: when every component shares one plan
(e.g. the fully unbounded vortex workload) the component axis is the
batch axis of ONE forward -> curl -> Green -> backward pipeline, whose
Green multiply is the schedule's (``spectral_scale`` on the cuda engine);
otherwise each component runs its own transforms and the Green multiply
is a plain torch multiply.  The transforms are the natural-layout stage
API (``engine.fwd_1d`` / ``bwd_1d``): the curl sits between the last
forward direction and the Green multiply, so the FFT x Green epilogue
never applies.
"""
from __future__ import annotations

import numpy as np
import torch

from .bc import DataLayout, DirBC
from . import green as gr
from .engine import as_engine, build_schedule, bwd_1d, fwd_1d
from .solver import (_check_kernel_lengths, _resolve_device, build_green,
                     make_plan)
from .spectral import apply_derivative, swap_bc

__all__ = ["BiotSavartSolver"]

_CYCLIC = ((0, 1, 2), (1, 2, 0), (2, 0, 1))  # (c, a, b): u_c = d_a f_b - d_b f_a


def _swap_dir(bcs_dir: DirBC) -> DirBC:
    return DirBC(swap_bc(bcs_dir.left), swap_bc(bcs_dir.right))


class BiotSavartSolver:
    """u = solve(f): lap(u) = curl(f) with per-component BCs.

    ``bcs``: (3, 3) nested sequence -- bcs[c][d] is the (left, right) BC
    pair of vorticity component c along direction d.  ``engine``: "cuda"
    (default, the hand-written kernels) or "torch".  ``device``: None
    means the card (and raises without one).  ``greens``: optional list of
    the three velocity components' Green's functions in natural layout
    (float64, as ``repro``'s ``BiotSavartSolver.greens`` holds them); by
    default they are assembled here, once per distinct velocity plan.
    """

    def __init__(self, shape, L, bcs, layout=DataLayout.CELL,
                 green_kind=gr.GreenKind.CHAT2, fd_order: int = 0,
                 eps_factor: float = 2.0, engine="cuda", device=None,
                 greens=None):
        self.fd_order = fd_order
        self.engine = as_engine(engine)
        self.device = _resolve_device(device)
        bcs = [[DirBC(*b) if not isinstance(b, DirBC) else b for b in row]
               for row in bcs]
        self.fplans = [make_plan(shape, L, bcs[c], layout, green_kind,
                                 eps_factor) for c in range(3)]
        # velocity BCs from term d_a f_b; cross-checked against d_b f_a
        self.uplans = []
        for c, a, b in _CYCLIC:
            bc1 = [_swap_dir(bcs[b][d]) if d == a else bcs[b][d]
                   for d in range(3)]
            bc2 = [_swap_dir(bcs[a][d]) if d == b else bcs[a][d]
                   for d in range(3)]
            if bc1 != bc2:
                raise ValueError(
                    f"incompatible vorticity BCs for velocity component {c}: "
                    f"{bc1} vs {bc2}")
            self.uplans.append(make_plan(shape, L, bc1, layout, green_kind,
                                         eps_factor))
        if self.engine.use_cuda:
            for p in self.fplans + self.uplans:
                _check_kernel_lengths(p)
        self.greens = self._greens(greens)
        self.fscheds = [build_schedule(p, self.engine) for p in self.fplans]
        self.uscheds = [build_schedule(p, self.engine) for p in self.uplans]
        # uniform per-component plans (e.g. the fully-unbounded vortex
        # workload): the 3 components become ONE batched solve -- a single
        # forward/backward transform pipeline with batch axis 3 and one
        # Green multiply, instead of 3 sequential component solves
        self.batched = (all(p == self.fplans[0] for p in self.fplans)
                        and all(p == self.uplans[0] for p in self.uplans))
        # device copies, one per distinct array, cast once per dtype
        self._dev = {}

    def _greens(self, greens):
        """The three natural-layout float64 Green's functions: carried
        (checked against the velocity plans' spectral shapes) or assembled,
        equal velocity plans sharing one array."""
        if greens is not None:
            if len(greens) != 3:
                raise ValueError(f"greens takes 3 arrays, got {len(greens)}")
            out = []
            for c, (g, p) in enumerate(zip(greens, self.uplans)):
                g = np.asarray(g, dtype=np.float64)
                want = tuple(q.n_out for q in p.dirs)
                if g.shape != want:
                    raise ValueError(f"greens[{c}] has shape {g.shape}, the "
                                     f"velocity plan's spectral storage is "
                                     f"{want}")
                out.append(g)
            return out
        built = {}
        for p in self.uplans:
            if p not in built:
                built[p] = build_green(p)
        return [built[p] for p in self.uplans]

    def _green_as(self, c, dtype):
        """Velocity component ``c``'s Green's function on the device, in
        the real ``dtype``."""
        key = (id(self.greens[c]), dtype)
        g = self._dev.get(key)
        if g is None:
            g = self._dev[key] = torch.from_numpy(
                np.ascontiguousarray(self.greens[c])).to(self.device,
                                                         dtype)
        return g

    @property
    def input_shape(self):
        return (3,) + self.fplans[0].input_shape

    def _fwd(self, f, plan, sched):
        y = f
        for d in plan.order:
            y = fwd_1d(y, plan.dirs[d], sched)
        return y

    def _bwd(self, y, plan, sched, dtype):
        for d in reversed(plan.order):
            y = bwd_1d(y, plan.dirs[d], sched)
        if y.is_complex():
            y = y.real
        return y.to(dtype)

    def _solve_impl(self, f):
        fh = [self._fwd(f[c], self.fplans[c], self.fscheds[c])
              for c in range(3)]
        out = []
        for c, a, b in _CYCLIC:
            up = self.uplans[c]
            t1 = apply_derivative(fh[b], self.fplans[b].dirs[a],
                                  up.dirs[a], self.fd_order)
            t2 = apply_derivative(fh[a], self.fplans[a].dirs[b],
                                  up.dirs[b], self.fd_order)
            uhat = t1 - t2
            rdt = uhat.real.dtype if uhat.is_complex() else uhat.dtype
            uhat = uhat * self._green_as(c, rdt)
            out.append(self._bwd(uhat, up, self.uscheds[c], f.dtype))
        return torch.stack(out)

    def _solve_impl_batched(self, f):
        """Uniform-plan path: the component axis is the batch axis of one
        forward -> curl -> Green -> backward pipeline."""
        sched = self.fscheds[0]
        fh = self._fwd(f, self.fplans[0], sched)        # (3, *spectral)
        terms = []
        for c, a, b in _CYCLIC:
            t1 = apply_derivative(fh[b], self.fplans[0].dirs[a],
                                  self.uplans[0].dirs[a], self.fd_order)
            t2 = apply_derivative(fh[a], self.fplans[0].dirs[b],
                                  self.uplans[0].dirs[b], self.fd_order)
            terms.append(t1 - t2)
        # drop each spectral field once consumed: the 3-wide field and its
        # curl terms are the solve's peak memory
        del fh
        uhat = torch.stack(terms)
        del terms
        rdt = uhat.real.dtype if uhat.is_complex() else uhat.dtype
        uhat = self.uscheds[0].green_multiply(uhat, self._green_as(0, rdt))
        return self._bwd(uhat, self.uplans[0], self.uscheds[0], f.dtype)

    def solve(self, f):
        """``f``: the vorticity, a numpy array or tensor of shape
        ``input_shape`` = ``(3, *grid)``, float32 or float64, moved to the
        solver's device.  Returns the velocity, a contiguous tensor of the
        same shape and dtype on the device."""
        if isinstance(f, np.ndarray):
            f = torch.from_numpy(np.ascontiguousarray(f))
        f = torch.as_tensor(f).to(self.device)
        if f.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"solve takes float32 or float64, got {f.dtype}")
        if tuple(f.shape) != self.input_shape:
            raise ValueError(f"f has shape {tuple(f.shape)}; the solver "
                             f"takes {self.input_shape}")
        if self.batched:
            u = self._solve_impl_batched(f)
        else:
            u = self._solve_impl(f)
        return u.contiguous()
