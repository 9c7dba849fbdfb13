"""Pluggable transform engine: the single hot path of the solver.

The paper's pipeline is (per direction) 1-D transform -> pointwise Green
multiply -> inverse transforms; this module decides HOW each stage executes:

  engine="cuda"   (default) the hand-written CUDA kernels take over the hot
                  loops: ``fft_stockham`` for power-of-two (r)FFTs,
                  ``fft_stockham_scale`` for the last forward direction
                  fused with the Green multiply, ``spectral_scale`` for
                  the Green multiply wherever fusion does not apply,
                  ``fft_stockham_twiddle`` for the DCT/DST forward kinds
                  on power-of-two extensions (rfft and post-twiddle in one
                  kernel) and ``twiddle_pack`` for their post-twiddle on
                  other lengths.  Non-power-of-two FFT lengths take
                  ``torch.fft``.
  engine="torch"  ``torch.fft`` (cuFFT on the card) and plain elementwise
                  torch ops.

A plan is compiled once into a ``TransformSchedule``.  The combined
normalization of every backward transform is folded into the Green's
function by ``build_green``, so the backward pass emits no standalone
normalization multiply.

Layout scheduling: data layout is a plan-time quantity.  A
``LayoutSchedule`` assigns every stage the axis permutation it runs in
(active dim minor-most); the scheduled pipeline calls the ``fwd_last`` /
``bwd_last`` stage API and pays one composed transpose per direction
change.  ``fwd_last_green`` fuses the Green multiply into the last forward
direction's FFT kernel.  The ``fwd_1d``/``bwd_1d`` moveaxis adapters are
the natural-layout API of the baseline pipeline.

Every op is rank-polymorphic: leading axes beyond the plan's grid rank are
batch axes (``B`` right-hand sides sharing one plan).

Fault hooks (``repro_torch.runtime.faults``) sit at the reference's
places: ``taint("fwd.<d>")`` / ``taint("bwd.<d>")`` on each direction's
input, ``taint("green")`` on the Green multiply's, and on the cuda engine
the fail points ``cuda.fwd.<d>``, ``cuda.bwd.<d>`` and ``cuda.green`` --
the port's names for the reference's ``pallas.*``.  With no plan armed
each stage pays one check (``faults.armed()``) and builds no stage name.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.runtime import abft as _abft
from repro_torch.runtime import faults as _faults

from . import trace as _trace

__all__ = ["TransformEngine", "TransformSchedule", "LayoutSchedule",
           "as_engine", "build_schedule", "schedule_layouts", "relayout",
           "on_last_axis", "folded_normfact", "fwd_1d", "bwd_1d",
           "materialize_doubling", "crop_doubling", "ENGINES",
           "RELAYOUT_MODES"]

RELAYOUT_MODES = ("scheduled", "baseline")

ENGINES = ("torch", "cuda")


@dataclass(frozen=True)
class TransformEngine:
    """Execution backend selection for the transform + pointwise stages.

    ``max_radix``: Stockham FFT radix cap (4 = mixed radix-4/2, the
    default; 2 = pure radix-2).  Only the CUDA kernels consume it.
    """

    name: str = "cuda"
    max_radix: int = 4

    def __post_init__(self):
        if self.name not in ENGINES:
            raise ValueError(
                f"unknown engine {self.name!r}; expected one of {ENGINES}")
        if self.max_radix not in (2, 4):
            raise ValueError(f"max_radix must be 2 or 4, "
                             f"got {self.max_radix!r}")

    @property
    def use_cuda(self) -> bool:
        return self.name == "cuda"


def as_engine(engine) -> TransformEngine:
    """Accept ``"torch"`` / ``"cuda"`` / TransformEngine / None."""
    if engine is None:
        return TransformEngine()
    if isinstance(engine, TransformEngine):
        return engine
    return TransformEngine(str(engine))


# ---------------------------------------------------------------------------
# per-direction 1-D ops (last axis; natural-layout callers go through the
# ``on_last_axis`` moveaxis adapter)
# ---------------------------------------------------------------------------

def _batch_ndim(x, sched) -> int:
    """Leading batch axes of ``x`` relative to the schedule's grid rank."""
    if sched is None or not sched.dirs:
        return 0
    bnd = x.ndim - len(sched.dirs)
    assert 0 <= bnd, (tuple(x.shape), len(sched.dirs))
    return bnd


def on_last_axis(x, axis, fn):
    """Run ``fn`` on ``x`` with ``axis`` moved minor-most (materialized
    contiguous, as the reference's moveaxis is), restoring the axis
    afterwards as a view.  The contiguous copy also keeps ``torch.fft``
    bit-identical to the scheduled pipeline: MKL computes a strided last
    axis with other rounding than a contiguous one."""
    last = axis % x.ndim == x.ndim - 1
    if _trace.active() and not last:
        _trace.emit("transpose", bytes=_trace.nbytes(x), into="moveaxis")
    y = fn(torch.movedim(x, axis, -1).contiguous())
    if _trace.active() and not last:
        _trace.emit("transpose", bytes=_trace.nbytes(y), into="moveaxis")
    return torch.movedim(y, -1, axis)


def _fwd_last(x, p, sched=None):
    """Forward 1-D transform of direction ``p`` applied to the LAST axis
    of ``x``.

    Valid-extent contract: the incoming axis carries ``p.valid_in`` live
    points (``n_pts`` deferred, ``n_fft`` when the plan pre-padded the
    Hockney doubling up front) and the outgoing axis carries ``p.n_out``.
    """
    from . import transforms as tr
    engine = sched.engine if sched is not None else None
    if _faults.armed():
        x = _faults.taint(f"fwd.{p.dim}", x)
        if engine is not None and engine.use_cuda:
            _faults.fail_point(f"cuda.fwd.{p.dim}")
    if p.pre_padded:
        # dense up-front doubling: the zero extension is already in the
        # array, the transform is a plain full-length one
        if p.category in ("sym", "semi"):
            raise AssertionError("pre_padded is a DFT-direction mode")
        return tr._rfft(x, engine) if p.dft == "r2c" else tr._cfft(x, engine)
    if p.flip:
        x = torch.flip(x, (-1,))
    x = x[..., p.in_start:p.in_start + p.n_in]
    if p.category in ("sym", "semi"):
        if p.n_fft > p.n_in:      # semi: zero-extend to the doubled domain
            x = tr._zpad(x, p.n_fft)
        return tr.r2r_forward(x, p.kind, engine=engine)
    if p.dft == "r2c":
        # pruned forward: the length-n_fft spectrum from the n_in nonzero
        # inputs (the kernel skips the zero tail; torch.fft pads)
        return tr._rfft_padded(x, p.n_fft, engine)
    return tr._cfft_padded(x, p.n_fft, engine)


def _bwd_last(y, p, sched=None):
    """Inverse 1-D transform of direction ``p`` on the LAST axis; emits
    ``p.valid_in`` points (the ``n_pts`` user axis under deferred doubling,
    the full ``n_fft`` reconstruction when the plan padded up front)."""
    # no normalization multiply here: every direction's normfact is folded
    # into the Green's function at plan time (build_green)
    from . import transforms as tr
    engine = sched.engine if sched is not None else None
    if _faults.armed():
        y = _faults.taint(f"bwd.{p.dim}", y)
        if engine is not None and engine.use_cuda:
            _faults.fail_point(f"cuda.bwd.{p.dim}")
    if p.category in ("sym", "semi"):
        x = tr.r2r_backward(y, p.kind, engine=engine)
        x = x[..., :p.n_in]       # semi: crop the doubled domain
    elif p.pre_padded:
        # dense mode keeps the doubled extent; cropped once at solve end
        return (tr._irfft(y, p.n_fft, engine) if p.dft == "r2c"
                else tr._cfft(y, engine, inverse=True))
    elif p.dft == "r2c":
        # pruned backward: reconstruct only the n_in retained samples
        x = tr._irfft_crop(y, p.n_fft, p.n_in, engine)
    else:
        x = tr._icfft_crop(y, p.n_in, engine)
    # place into the user-sized axis
    left = p.in_start
    right = p.n_pts - p.in_start - p.n_in - (1 if p.per_dup else 0)
    if left or right:
        out = x.new_zeros(x.shape[:-1] + (left + p.n_in + right,))
        out[..., left:left + p.n_in] = x
        x = out
    if p.per_dup:  # node-periodic: duplicate the first point at the end
        x = torch.cat([x, x[..., :1]], dim=-1)
    if p.flip:
        x = torch.flip(x, (-1,))
    return x


def fwd_1d(x, p, sched=None):
    """Forward 1-D transform of direction ``p`` (a ``Plan1D``) in NATURAL
    layout (the axis is moved minor-most and back).  Batched arrays
    require ``sched``, which knows the grid rank."""
    return on_last_axis(x, _batch_ndim(x, sched) + p.dim,
                        lambda v: _fwd_last(v, p, sched))


def bwd_1d(y, p, sched=None):
    """Inverse 1-D transform of direction ``p`` in natural layout."""
    return on_last_axis(y, _batch_ndim(y, sched) + p.dim,
                        lambda v: _bwd_last(v, p, sched))


# ---------------------------------------------------------------------------
# layout scheduling: data layout as a plan-time quantity
# ---------------------------------------------------------------------------

def to_last(perm, d):
    """The permutation ``perm`` with logical dim ``d`` shuffled minor-most
    and every other dim left in place (one transpose away from ``perm``)."""
    return tuple(x for x in perm if x != d) + (d,)


def switch_layout(perm, a, b):
    """Layout after the stage change retiring active dim ``a`` for ``b``:
    ``a`` goes MAJOR-most and ``b`` MINOR-most (where the next 1-D
    transform consumes it).  One transpose away from any ``(.., .., a)``
    stage layout."""
    rest = [d for d in perm if d not in (a, b)]
    return (a, *rest, b)


@dataclass(frozen=True)
class LayoutSchedule:
    """Plan-time axis-permutation schedule of one solve.

    ``fwd[i]`` / ``bwd[i]`` is the grid-axis permutation the block is in
    DURING forward/backward stage ``i`` (executed in pipeline order):
    ``perm[a]`` is the logical dim stored at array axis ``a`` (batch axes
    lead and are never permuted).  Every stage keeps its active dim
    minor-most.  ``bwd[0] == spectral``: the first backward stage reuses
    the spectral layout, so the Green multiply and both last-direction
    transforms share it.
    """

    fwd: tuple
    bwd: tuple

    @property
    def spectral(self):
        """Layout of the pointwise Green multiply (== ``fwd[-1]``)."""
        return self.fwd[-1]


def schedule_layouts(order, ndim: int = 3) -> LayoutSchedule:
    """The minimal-relayout schedule: stage 0 moves only the first active
    dim minor-most; every later stage is the ``switch_layout`` of the
    direction pair it sits between."""
    perm = to_last(tuple(range(ndim)), order[0])
    fwd = [perm]
    for a, b in zip(order, order[1:]):
        perm = switch_layout(perm, a, b)
        fwd.append(perm)
    bwd = [perm]                      # spectral layout reused by bwd[0]
    rev = tuple(reversed(order))
    for a, b in zip(rev, rev[1:]):
        perm = switch_layout(perm, a, b)
        bwd.append(perm)
    return LayoutSchedule(tuple(fwd), tuple(bwd))


def relayout(x, src, dst):
    """One composed transpose taking the grid layout ``src`` to ``dst``,
    materialized contiguous (returns ``x`` unchanged when the layouts
    agree).  Leading batch axes pass through untouched."""
    src, dst = tuple(src), tuple(dst)
    if src == dst:
        return x
    off = x.ndim - len(src)
    axes = tuple(range(off)) + tuple(off + src.index(d) for d in dst)
    if _trace.active():
        _trace.emit("transpose", bytes=_trace.nbytes(x), into="edge")
    return x.permute(axes).contiguous()


def materialize_doubling(x, dirs):
    """Zero-pad every ``pre_padded`` direction of a user-shaped array from
    ``n_pts`` to ``n_fft`` (the dense up-front Hockney doubling; a no-op on
    deferred plans).  Leading batch axes pass through."""
    off = x.ndim - len(dirs)
    for d, p in enumerate(dirs):
        a = off + d
        if p.pre_padded and x.shape[a] < p.n_fft:
            shape = list(x.shape)
            shape[a] = p.n_fft
            out = x.new_zeros(shape)
            out.narrow(a, 0, x.shape[a]).copy_(x)
            x = out
    return x


def crop_doubling(x, dirs):
    """Crop every ``pre_padded`` direction back to its user extent (the
    final slice of a dense solve; a no-op on deferred plans)."""
    off = x.ndim - len(dirs)
    for d, p in enumerate(dirs):
        if p.pre_padded and x.shape[off + d] > p.n_pts:
            x = x.narrow(off + d, 0, p.n_pts)
    return x


@dataclass(frozen=True)
class TransformSchedule:
    """Plan-time constants for one solve: the folded normalization
    (quadrature h weights stay in build_green) and the layout schedule of
    the scheduled pipeline.  The r2r twiddle tables are cached per
    (kind, length, dtype, device) by ``transforms.device_tables``."""

    engine: TransformEngine
    norm: float          # prod of r2r normfacts, folded into the Green
    dirs: tuple = ()     # per logical dim: the plan's Plan1D
    order: tuple = ()    # the plan's forward execution order
    layouts: LayoutSchedule = None   # per-stage axis permutations

    # Every stage takes an optional ABFT collector (DESIGN.md #13): with
    # ``col=None`` (the default everywhere) the plain stage runs and no
    # checksum is computed, so the verify-off pipelines are unchanged.
    # With a collector the stage runs under its linearity / Parseval
    # sandwich with selective recompute (``repro_torch.runtime.abft``).

    def fwd_chunk(self, x, d: int, col=None, tol=None):
        """Forward 1-D transform of logical direction ``d`` in NATURAL
        layout (moveaxis round trip -- the baseline pipeline)."""
        if col is not None:
            return _abft.checked_fwd_chunk(x, d, self, col, tol)
        return fwd_1d(x, self.dirs[d], self)

    def bwd_chunk(self, x, d: int, col=None, tol=None):
        """Inverse 1-D transform of logical direction ``d``."""
        if col is not None:
            return _abft.checked_bwd_chunk(x, d, self, col, tol)
        return bwd_1d(x, self.dirs[d], self)

    def fwd_last(self, x, d: int, col=None, tol=None):
        """Forward 1-D transform of direction ``d`` on the LAST axis (the
        scheduled pipeline guarantees the active axis is minor-most)."""
        if col is not None:
            return _abft.checked_fwd_last(x, d, self, col, tol)
        return _fwd_last(x, self.dirs[d], self)

    def bwd_last(self, x, d: int, col=None, tol=None):
        """Inverse 1-D transform of direction ``d`` on the LAST axis."""
        if col is not None:
            return _abft.checked_bwd_last(x, d, self, col, tol)
        return _bwd_last(x, self.dirs[d], self)

    def green_multiply(self, yhat, green, col=None, tol=None):
        """The fused pointwise pass (Green x normalization in one multiply).
        ``green`` is real, of the field's precision, in the field's layout
        without its batch axes."""
        if col is not None:
            return _abft.checked_green(yhat, green, self, col, tol)
        if _faults.armed():
            yhat = _faults.taint("green", yhat)
            if self.engine.use_cuda:
                _faults.fail_point("cuda.green")
        if _trace.active():
            _trace.emit("green", bytes=_trace.nbytes(yhat))
        if self.engine.use_cuda:
            from repro_torch.kernels import ops
            return ops.green_multiply(yhat, green)
        if yhat.is_complex():
            return yhat * green
        return yhat * green.to(yhat.dtype)

    def can_fuse_green(self, d: int) -> bool:
        """True when the forward transform of ``d`` can run the Green
        multiply as an FFT-kernel epilogue: a power-of-two DFT direction
        whose live extent is either the full FFT length or its pruned half
        (the Hockney zero-tail first stage composes with the epilogue)."""
        p = self.dirs[d]
        n = p.n_fft
        return (self.engine.use_cuda
                and p.category in ("per", "unb")
                and n >= 2 and (n & (n - 1)) == 0
                and not p.flip and p.in_start == 0
                and (p.n_in == n or n == 2 * p.n_in))

    def fwd_last_green(self, x, d: int, green, col=None, tol=None):
        """Forward transform of the LAST forward direction fused with the
        Green multiply: on the cuda engine the multiply runs in the FFT
        kernel's epilogue (one HBM round trip for transform + pointwise);
        anywhere else it is the plain transform followed by
        ``green_multiply``.  ``green`` must be in the same layout as ``x``
        with the spectral ``d`` axis minor-most."""
        if col is not None:
            # the checksum sandwich needs the spectral field BEFORE the
            # Green multiply, so checking bypasses the fused epilogue
            return self.green_multiply(self.fwd_last(x, d, col, tol), green,
                                       col, tol)
        p = self.dirs[d]
        want_cplx = p.dft == "c2c"
        if not self.can_fuse_green(d) or x.is_complex() != want_cplx:
            return self.green_multiply(self.fwd_last(x, d), green)
        if _faults.armed():
            x = _faults.taint(f"fwd.{p.dim}", x)
            x = _faults.taint("green", x)
            _faults.fail_point(f"cuda.fwd.{p.dim}")
            _faults.fail_point("cuda.green")
        from repro_torch.kernels import ops
        n_live = p.n_fft if p.pre_padded else p.n_in
        x = x[..., :n_live]
        pad_to = None if n_live == p.n_fft else p.n_fft
        assert green.shape[-1] == p.n_out, (tuple(green.shape), p.n_out)
        fused = ops.rfft_green if p.dft == "r2c" else ops.fft1d_green
        y = fused(x, green, pad_to=pad_to, max_radix=self.engine.max_radix)
        if _trace.active():
            _trace.emit("green", bytes=_trace.nbytes(y), fused=True)
        return y


def folded_normfact(plan) -> float:
    """The combined backward normalization of a plan -- the single factor
    ``build_green`` folds into the Green's function (every direction, DFT
    included; their normfact is 1.0)."""
    norm = 1.0
    for p in plan.dirs:
        norm *= p.normfact
    return norm


def build_schedule(plan, engine=None) -> TransformSchedule:
    """Compile a ``PoissonPlan`` into its per-direction transform schedule."""
    return TransformSchedule(as_engine(engine), folded_normfact(plan),
                             plan.dirs, plan.order,
                             schedule_layouts(plan.order, len(plan.dirs)))
