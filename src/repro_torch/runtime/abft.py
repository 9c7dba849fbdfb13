"""Algorithm-based fault tolerance for the FFT Poisson solve (DESIGN.md #13).

Counterpart of ``repro.runtime.abft``, on tensors.  ``verify="nan"`` and
``verify="residual"`` catch non-finite or grossly wrong solutions; a
silent flip -- one wrong-but-FINITE value landing in a transform stage or
in a packed collective payload -- sails through both.  This module uses
the solve's algebraic structure to detect, LOCALIZE and selectively
repair such corruption:

Per-stage linearity checksum
    Every 1-D transform ``T`` is linear along its active axis, so it
    commutes with summing the block's rows: ``sum_rows T(x) ==
    T(sum_rows x)``.  Each checked stage snapshots the row sum BEFORE the
    stage runs, re-applies the 1-D primitive to that single reference row
    (under ``faults.suppressed()``, so an armed fault spec cannot corrupt
    both sides alike; on the ``"cuda"`` engine a one-row kernel launch),
    and compares.

Parseval energy (forward stages)
    ``sum w_out |y|^2 == scale * sum w_in |x|^2`` with the per-kind
    endpoint weights: a quadratic invariant independent of the linear
    checksum.

Green-multiply invariant
    ``sum(green_multiply(yhat, green)) == sum(yhat * green)``, the
    reference side one multiply-reduce (``kernels.ops.green_checksum``).

Checksum-carrying collectives
    ``core.comm.CommStrategy(abft=(col, tol))`` ships one checksum per
    destination rank of every packed payload through a sidecar
    ``all_to_all_single`` and re-reduces each received block
    (``wire_checksums`` / ``wire_verify``); a mismatch there attributes
    the corruption to the wire.

Localize -> recompute -> escalate
    A checked compute stage retries ITSELF when its checksum trips: torch
    runs eagerly, so the mismatch is read on the host (one ``.item()``
    per checked stage) and only a tripped stage re-executes, from its
    still-live input.  Fault-plan hits are consumed in call order, so a
    ``count``-limited (transient) spec does not re-fire on the retry
    while a ``count=-1`` (persistent) one does.  ``verify_report`` turns
    the stage report into ``stats["integrity"]`` records and raises
    ``IntegrityError`` for surviving corruption (transient when only the
    wire is implicated), which the degradation ladder takes.

Two-phase guard (``verify="abft"``)
    Every solve runs the cheap end-to-end Freivalds sandwich ``<r, S f>
    == <S^T r, f>`` with a fixed probe ``r`` (``lite_probe``) and the
    plan-time weight ``w = S^T r``; only a trip re-dispatches through the
    fully checked pipeline.  ``verify="abft-stages"`` runs the checked
    pipeline on every solve.

With ``col=None`` nothing here runs: the verify-off path is unchanged.
"""
from __future__ import annotations

import functools
import math
import zlib

import numpy as np
import torch

from repro_torch.runtime import faults as _faults

__all__ = ["IntegrityError", "Collector", "tol_for", "checked_fwd_chunk",
           "checked_bwd_chunk", "checked_fwd_last", "checked_bwd_last",
           "checked_green", "wire_checksums", "wire_verify",
           "verify_report", "DEFAULT_RETRIES", "lite_probe",
           "lite_probe_axes", "lite_mismatch", "lite_mismatch_ab",
           "LITE_HEADROOM"]

# inline recompute attempts per checked stage before the host escalates
DEFAULT_RETRIES = 1

# headroom multiplier on tol_for for the end-to-end linearity sandwich:
# both sides are O(N)-term reductions through the whole pipeline, so its
# noise floor sits well above a single stage's
LITE_HEADROOM = 50.0

_TINY = 1e-30


class IntegrityError(RuntimeError):
    """Corruption detected by an ABFT invariant.  ``stage`` carries the
    provenance (``verify.abft@<check>``); ``transient`` follows the wire
    vs compute attribution (wire -> retry-worthy, compute -> ladder)."""

    def __init__(self, msg: str, *, stage=None, mismatch=None,
                 transient: bool = False):
        super().__init__(msg)
        self.stage = stage
        self.mismatch = mismatch
        self.transient = transient


def tol_for(dtype) -> float:
    """Relative checksum tolerance for a data dtype (numpy or torch):
    well above the roundoff of the block-sized reductions, well below the
    relative signature of any meaningful corruption."""
    if isinstance(dtype, torch.dtype):
        eps = torch.finfo(dtype).eps
    else:
        eps = np.finfo(np.dtype(dtype)).eps
    return 1e-8 if eps < 1e-10 else 3e-4


class Collector:
    """Accumulator of named mismatch scalars for one checked solve.

    Stages append ``(name, 0-d float32 tensor)`` pairs as they run;
    ``stacked()`` is the report vector and ``names`` its provenance.  A
    collective's wire check reserves its slot when it is issued
    (``slot``) and fills it once the payload has landed (``fill``), so
    the report's order is the issue order whatever the strategy's
    waits."""

    __slots__ = ("names", "vals", "_stages")

    def __init__(self):
        self.names: list[str] = []
        self.vals: list = []
        self._stages: dict[str, int] = {}

    def unique(self, name: str) -> str:
        """Reserve a unique stage name (chunked stages check the same
        logical stage several times: ``fwd.1``, ``fwd.1#1``, ...)."""
        k = self._stages.get(name, 0)
        self._stages[name] = k + 1
        return f"{name}#{k}" if k else name

    def add(self, name: str, val):
        self.names.append(name)
        self.vals.append(torch.as_tensor(val).to(torch.float32))

    def slot(self, name: str) -> int:
        """Append ``name`` with its value still to come; returns the
        index ``fill`` takes."""
        self.names.append(name)
        self.vals.append(None)
        return len(self.vals) - 1

    def fill(self, i: int, val):
        self.vals[i] = torch.as_tensor(val).to(torch.float32)

    def stacked(self):
        if not self.vals:
            return torch.zeros((1,), dtype=torch.float32)
        dev = self.vals[0].device
        return torch.stack([v.to(dev) for v in self.vals])


# ---------------------------------------------------------------------------
# mismatch arithmetic
# ---------------------------------------------------------------------------

def _floor(x, rows: float):
    """Cancellation-proof checksum scale: the expected magnitude of a sum
    of ``rows`` entries drawn at the block's rms (one norm reduction, no
    temporary block)."""
    rms = torch.linalg.vector_norm(x) / math.sqrt(max(x.numel(), 1))
    return rms * math.sqrt(rows)


def _mismatch(got, ref, floor):
    num = (got - ref).abs().max()
    den = torch.maximum(torch.maximum(ref.abs().max(), got.abs().max()),
                        torch.as_tensor(floor, dtype=num.dtype,
                                        device=num.device))
    return (num / (den + _TINY)).to(torch.float32)


def _bad(m, tol: float):
    return torch.logical_or(m > tol, ~torch.isfinite(m))


def _rows_sum(x, axis: int):
    axes = tuple(a for a in range(x.ndim) if a != axis % x.ndim)
    return x.sum(dim=axes) if axes else x


# ---------------------------------------------------------------------------
# Parseval energy weights
# ---------------------------------------------------------------------------

def _r2r_energy_weights(kind, m: int):
    """Endpoint weights + scale of ``sum w_out y^2 = scale * sum w_in x^2``
    for the unnormalized scipy r2r conventions (scale = 1/normfact)."""
    from repro_torch.core import transforms as tr
    name, t = kind.name[:3].lower(), int(kind.name[3])
    win = np.ones(m)
    wout = np.ones(m)
    if t == 1 and name == "dct":
        win[0] = win[-1] = 0.5
        wout = win.copy()
    elif t == 2:
        wout[0 if name == "dct" else -1] = 0.5
    elif t == 3:
        win[0 if name == "dct" else -1] = 0.5
    return win, wout, 1.0 / tr.r2r_normfact(kind, m)


def _parseval_weights(p):
    """``(w_in_live, w_out, scale)`` for direction ``p``'s forward
    transform, or ``(None, None, None)`` when no exact energy identity
    covers its storage (cropped c2c spectra)."""
    if p.category in ("sym", "semi"):
        win, wout, scale = _r2r_energy_weights(p.kind, p.n_fft)
        return win[:p.n_in], wout[:p.n_out], scale
    n_live = p.n_fft if p.pre_padded else p.n_in
    if p.dft == "r2c":
        if p.n_out != p.n_fft // 2 + 1:
            return None, None, None
        wout = np.full(p.n_out, 2.0)
        wout[0] = 1.0
        if p.n_fft % 2 == 0:
            wout[-1] = 1.0
    else:
        if p.n_out != p.n_fft:
            return None, None, None
        wout = np.ones(p.n_out)
    return np.ones(n_live), wout, float(p.n_fft)


@functools.lru_cache(maxsize=256)
def _energy_tables(p, dtype, device):
    """The weights of ``_parseval_weights(p)`` as tensors of ``dtype`` on
    ``device`` (built once per direction and precision)."""
    win, wout, scale = _parseval_weights(p)
    if win is None:
        return None
    return (torch.as_tensor(win, dtype=dtype).to(device),
            torch.as_tensor(wout, dtype=dtype).to(device), scale)


def _axis_energy(x, axis: int):
    """``sum |x|^2`` over every axis but ``axis``: one vector of
    ``x.shape[axis]`` per-position energies, from one norm reduction."""
    other = tuple(a for a in range(x.ndim) if a != axis)
    if not other:
        return x.abs() ** 2
    return torch.linalg.vector_norm(x, dim=other) ** 2


def _energy_mismatch(x, y, p, axis: int):
    """Forward-stage Parseval check on the (already repaired) output."""
    rdt = x.real.dtype if x.is_complex() else x.dtype
    tabs = _energy_tables(p, rdt, x.device)
    if tabs is None:
        return None
    win, wout, scale = tabs
    ex = _axis_energy(x, axis)
    if not p.pre_padded:
        if p.flip:
            ex = torch.flip(ex, (0,))
        ex = ex[p.in_start:p.in_start + p.n_in]
    e_in = torch.dot(ex, win)
    e_out = torch.dot(_axis_energy(y, axis), wout)
    ref = scale * e_in
    den = torch.clamp(torch.maximum(ref, e_out), min=_TINY)
    return ((e_out - ref).abs() / den).to(torch.float32)


# ---------------------------------------------------------------------------
# checked stages (snapshot -> stage -> verify -> retry when tripped)
# ---------------------------------------------------------------------------

def _checked_1d(x, p, sched, axis: int, fwd: bool, name: str, col, tol,
                retries: int):
    from repro_torch.core import engine as _eng
    prim = _eng._fwd_last if fwd else _eng._bwd_last
    axis = axis % x.ndim
    if axis == x.ndim - 1:
        def apply(v):
            return prim(v, p, sched)
    else:
        def apply(v):
            return _eng.on_last_axis(v, axis, lambda w: prim(w, p, sched))
    if col is None:
        return apply(x)
    name = col.unique(name)
    rows = float(x.numel() // x.shape[axis])
    s_in = _rows_sum(x, axis)          # BEFORE the stage (and its taints)
    y = apply(x)
    with _faults.suppressed():         # reference row: no fault touches it
        ref = prim(s_in[None], p, sched)[0]
    floor = _floor(x, rows)
    m = _mismatch(_rows_sum(y, axis), ref, floor)
    col.add(name, m)
    for _ in range(max(int(retries), 0)):
        # selective recompute: only this stage re-executes, from its
        # still-live input, and only when its checksum tripped
        if not bool(_bad(m, tol)):     # the eager retry's one host read
            break
        y = apply(x)
        m = _mismatch(_rows_sum(y, axis), ref, floor)
    col.add(name + ".post", m)
    if fwd:
        em = _energy_mismatch(x, y, p, axis)
        if em is not None:
            col.add(name + ".energy", em)
    return y


def checked_fwd_chunk(x, d: int, sched, col, tol, retries=DEFAULT_RETRIES):
    """Natural-layout forward stage (the baseline pipeline) under the ABFT
    sandwich; chunk-safe like ``TransformSchedule.fwd_chunk``."""
    from repro_torch.core.engine import _batch_ndim
    p = sched.dirs[d]
    return _checked_1d(x, p, sched, _batch_ndim(x, sched) + p.dim, True,
                       f"fwd.{p.dim}", col, tol, retries)


def checked_bwd_chunk(x, d: int, sched, col, tol, retries=DEFAULT_RETRIES):
    from repro_torch.core.engine import _batch_ndim
    p = sched.dirs[d]
    return _checked_1d(x, p, sched, _batch_ndim(x, sched) + p.dim, False,
                       f"bwd.{p.dim}", col, tol, retries)


def checked_fwd_last(x, d: int, sched, col, tol, retries=DEFAULT_RETRIES):
    """Layout-scheduled forward stage (active axis minor-most)."""
    p = sched.dirs[d]
    return _checked_1d(x, p, sched, x.ndim - 1, True, f"fwd.{p.dim}", col,
                       tol, retries)


def checked_bwd_last(x, d: int, sched, col, tol, retries=DEFAULT_RETRIES):
    p = sched.dirs[d]
    return _checked_1d(x, p, sched, x.ndim - 1, False, f"bwd.{p.dim}", col,
                       tol, retries)


def checked_green(yhat, green, sched, col, tol, retries=DEFAULT_RETRIES):
    """Green multiply with its linearity invariant + selective recompute."""
    if col is None:
        return sched.green_multiply(yhat, green)
    from repro_torch.kernels.ops import green_checksum
    name = col.unique("green")

    def apply(v):
        return sched.green_multiply(v, green)

    y = apply(yhat)
    with _faults.suppressed():
        ref = green_checksum(yhat, green)
    floor = _floor(y, float(y.numel()))
    m = _mismatch(y.sum(), ref, floor)
    col.add(name, m)
    for _ in range(max(int(retries), 0)):
        if not bool(_bad(m, tol)):     # the eager retry's one host read
            break
        y = apply(yhat)
        m = _mismatch(y.sum(), ref, floor)
    col.add(name + ".post", m)
    return y


# ---------------------------------------------------------------------------
# checksum-carrying collectives (used by repro_torch.core.comm)
# ---------------------------------------------------------------------------

def wire_checksums(x, split_axis: int, parts: int):
    """Length-``parts`` checksum row of a packed payload: entry ``r`` is
    the full reduction of the sub-slab destined to rank ``r``.  Computed
    on the PREPARED payload (after crop, pad and permute), so it
    certifies exactly the bytes the collective moves."""
    sa = split_axis % x.ndim
    m = x.shape[sa]
    if m % parts:
        raise ValueError(f"split axis of length {m} does not divide over "
                         f"{parts} ranks")
    return _rows_sum(x.unflatten(sa, (parts, m // parts)), sa)


def _wire_mismatch(blocked, cs_recv, axis: int, parts: int):
    """Mismatch of the received blocks (the source rank's axis at
    ``axis`` of ``blocked``) against their shipped checksums."""
    got = _rows_sum(blocked, axis)
    floor = _floor(blocked, float(blocked.numel() // parts))
    return _mismatch(got, cs_recv.to(got.dtype), floor)


def wire_verify(y, cs_recv, concat_axis: int, parts: int, col, name: str,
                tol):
    """Receive-side verification: re-reduce each source rank's gathered
    slab of ``y`` (its concat axis holds the ``parts`` received blocks,
    source-rank major) and compare with its shipped checksum.
    Detect-only (the remedy for wire corruption is re-sending, i.e. the
    transient-retry path); returns ``y`` unchanged."""
    ca = concat_axis % y.ndim
    n = y.shape[ca]
    if n % parts:
        raise ValueError(f"concat axis of length {n} does not divide over "
                         f"{parts} ranks")
    blocked = y.unflatten(ca, (parts, n // parts))
    col.add(col.unique(name), _wire_mismatch(blocked, cs_recv, ca, parts))
    return y


# ---------------------------------------------------------------------------
# end-to-end linearity sandwich (the cheap always-on tier)
# ---------------------------------------------------------------------------

def lite_probe(shape, dtype):
    """Deterministic unit-variance probe field ``r`` (numpy) for the
    Freivalds sandwich, seeded from the shape (stable across processes;
    bit-equal to the reference's).  ``dtype``: numpy or torch."""
    seed = zlib.crc32(repr(tuple(shape)).encode())
    rng = np.random.default_rng(seed)
    return rng.standard_normal(tuple(shape)).astype(_np_dtype(dtype))


def lite_probe_axes(grid_shape, dtype):
    """Separable (rank-1) probe ``r = q0 (x) q1 (x) q2`` for the
    distributed sandwich: per-axis numpy factors with ``|q| in [0.5,
    1.5]``, so every entry of the outer product has magnitude >= 0.125
    and no single-site corruption can hide in a small probe weight.  The
    rank-1 structure lets ``<r, u>`` run as three chained contractions
    reading ``u`` once.  Deterministic per grid shape."""
    seed = zlib.crc32(repr(("r1",) + tuple(grid_shape)).encode())
    rng = np.random.default_rng(seed)
    dt = _np_dtype(dtype)
    return [np.asarray(rng.uniform(0.5, 1.5, m) * rng.choice([-1.0, 1.0], m),
                       dtype=dt) for m in grid_shape]


def _np_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).replace("torch.", ""))
    return np.dtype(dtype)


def lite_mismatch_ab(a, b, floor) -> float:
    """Relative mismatch of the split sandwich: ``a = <r, u>`` against
    ``b = <w, f>`` (per report row), ``floor`` = ``||w||*||f||/sqrt(N)``,
    the natural scale of both dots.  Any non-finite value reads as
    corruption (inf)."""
    a = np.atleast_1d(np.asarray(a, np.float64)).ravel()
    b = np.atleast_1d(np.asarray(b, np.float64)).ravel()
    fl = np.broadcast_to(np.atleast_1d(np.asarray(floor, np.float64)).ravel(),
                         a.shape)
    worst = 0.0
    for av, bv, fv in zip(a, b, fl):        # batched: every report row
        if not (np.isfinite(av) and np.isfinite(bv) and np.isfinite(fv)):
            return float("inf")
        den = max(abs(av), abs(bv), fv, _TINY)
        worst = max(worst, abs(av - bv) / den)
    return worst


def lite_mismatch(triple) -> float:
    """Relative mismatch of the sandwich: ``triple = (<r,u>, <w,f>,
    ||u||^2)`` (rows of them when batched).  The norm term floors the
    denominator so a pair of dots that happen to cancel cannot turn
    roundoff into a false alarm; any non-finite value reads as
    corruption."""
    t = np.asarray(triple, dtype=np.float64).reshape(-1, 3)
    worst = 0.0
    for a, b, uu in t:
        if not (np.isfinite(a) and np.isfinite(b) and np.isfinite(uu)):
            return float("inf")
        den = max(abs(a), abs(b), float(np.sqrt(max(uu, 0.0))), _TINY)
        worst = max(worst, abs(a - b) / den)
    return worst


# ---------------------------------------------------------------------------
# host-side report verification
# ---------------------------------------------------------------------------

def _is_bad(v: float, tol: float) -> bool:
    return (not np.isfinite(v)) or v > tol


def verify_report(names, report, *, tol: float, stats=None,
                  describe: str = "solve"):
    """Inspect one solve's stacked mismatch report (numpy or tensor).

    Appends structured records to ``stats["integrity"]``:
    ``action="recompute"`` for stages whose retry repaired the
    corruption, ``action="escalate"`` for surviving mismatches.  Raises
    ``IntegrityError`` when any check is still tripped after repair --
    transient iff every surviving mismatch is wire-attributed.  Returns
    the repair records."""
    if torch.is_tensor(report):
        report = report.detach().cpu().numpy()
    rep = np.asarray(report, dtype=np.float64)
    if rep.ndim > 1:                       # pod-batched solves: worst slot
        rep = rep.reshape(-1, rep.shape[-1]).max(axis=0)
    vals = dict(zip(names, rep))
    records, failures = [], []
    for nm in names:
        v = float(vals[nm])
        if nm.endswith(".post"):
            continue
        if nm.endswith(".energy"):
            # quadratic invariant: double the roundoff sensitivity of the
            # linear checksum -> 10x headroom on the same tolerance
            if _is_bad(v, 10.0 * tol):
                failures.append((nm, v, "energy"))
            continue
        if nm.startswith("wire."):
            if _is_bad(v, tol):
                failures.append((nm, v, "wire"))
            continue
        post = vals.get(nm + ".post")
        if post is None:
            if _is_bad(v, tol):
                failures.append((nm, v, "compute"))
        elif _is_bad(v, tol) and not _is_bad(float(post), tol):
            records.append({"stage": nm, "kind": "compute",
                            "mismatch": v, "post": float(post),
                            "action": "recompute", "attempts": 1})
        elif _is_bad(v, tol):
            failures.append((nm, v, "compute"))
    if stats is not None and (records or failures):
        ledger = stats.setdefault("integrity", [])
        ledger.extend(records)
        ledger.extend({"stage": nm, "kind": kind, "mismatch": v,
                       "action": "escalate"} for nm, v, kind in failures)
    if failures:
        if stats is not None:
            stats["verify_failures"] = stats.get("verify_failures", 0) + 1
        nm, v, kind = max(
            failures,
            key=lambda t: t[1] if np.isfinite(t[1]) else np.inf)
        raise IntegrityError(
            f"{describe}: ABFT {kind} checksum mismatch at {nm} "
            f"(mismatch {v:.3e}, tol {tol:.1e})",
            stage=f"verify.abft@{nm}", mismatch=v,
            transient=all(k == "wire" for _, _, k in failures))
    return records
