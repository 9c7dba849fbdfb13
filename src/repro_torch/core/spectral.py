"""Spectral differentiation with the DCT<->DST swap rules (paper section V).

Counterpart of ``repro.core.spectral``.  Applying d/dx in a symmetric
direction flips the boundary condition (even <-> odd) and therefore the
transform family used on the way back:

  * forward DST, multiply by +omega, backward as DCT coefficients
  * forward DCT, multiply by -omega, backward as DST coefficients

(the +/- comes from the DST output representing (0 - i f~) and the DCT
output (f~ + 0i) as complex numbers, see the paper).  Integer-mode types
(DCT1/DST1, DCT2/DST2) shift storage by one (mode k lives at k - koffset);
half-mode types (DCT3/4, DST3/4) map index-to-index.  Periodic/unbounded
(complex DFT) directions multiply by i*omega.

Finite-difference symbols (paper eqs. 12-14) replace omega by

  order 2:  sin(w h) / h
  order 4:  (4/3 sin(w h) - 1/6 sin(2 w h)) / h
  order 6:  (3/2 sin(w h) - 3/10 sin(2 w h) + 1/30 sin(3 w h)) / h

``fd_symbol`` is plan-time numpy; ``apply_derivative`` works on tensors on
the field's device, with the symbol built once per call in the field's
precision.
"""
from __future__ import annotations

import numpy as np
import torch

from .bc import BCType, TransformKind
from .engine import on_last_axis
from .solver import Plan1D

__all__ = ["SWAP", "fd_symbol", "swap_bc", "apply_derivative"]

_DCT_KINDS = (TransformKind.DCT1, TransformKind.DCT2,
              TransformKind.DCT3, TransformKind.DCT4)
_DST_KINDS = (TransformKind.DST1, TransformKind.DST2,
              TransformKind.DST3, TransformKind.DST4)

SWAP = {
    TransformKind.DCT1: TransformKind.DST1,
    TransformKind.DST1: TransformKind.DCT1,
    TransformKind.DCT2: TransformKind.DST2,
    TransformKind.DST2: TransformKind.DCT2,
    TransformKind.DCT3: TransformKind.DST3,
    TransformKind.DST3: TransformKind.DCT3,
    TransformKind.DCT4: TransformKind.DST4,
    TransformKind.DST4: TransformKind.DCT4,
}


def swap_bc(bc: BCType) -> BCType:
    if bc == BCType.EVEN:
        return BCType.ODD
    if bc == BCType.ODD:
        return BCType.EVEN
    return bc  # periodic / unbounded unchanged


def fd_symbol(omega: np.ndarray, h: float, order: int) -> np.ndarray:
    """Modified wavenumber for the chosen differentiation order (0=spectral)."""
    if order == 0:
        return omega
    s1 = np.sin(omega * h)
    if order == 2:
        return s1 / h
    s2 = np.sin(2.0 * omega * h)
    if order == 4:
        return (4.0 / 3.0 * s1 - 1.0 / 6.0 * s2) / h
    s3 = np.sin(3.0 * omega * h)
    if order == 6:
        return (1.5 * s1 - 0.3 * s2 + s3 / 30.0) / h
    raise ValueError(f"unsupported FD order {order}")


def _real_dtype(t):
    return t.real.dtype if t.is_complex() else t.dtype


def apply_derivative(yhat, p_from: Plan1D, p_to: Plan1D, fd_order: int = 0):
    """d/dx_d in spectral space: map ``yhat`` (transformed with ``p_from``)
    into the storage/basis of ``p_to`` along dimension ``p_from.dim``.

    For complex (DFT) directions ``p_to`` must equal ``p_from`` in size;
    for r2r directions ``p_to.kind`` must be the swapped family.
    """
    d = p_from.dim
    if p_from.category in ("per", "unb"):
        if p_to.n_out != p_from.n_out:
            raise ValueError(f"DFT direction {d}: {p_from.n_out} modes in, "
                             f"{p_to.n_out} out")
        w = fd_symbol(np.asarray(p_from.modes), p_from.h, fd_order)
        shape = [1] * yhat.ndim
        shape[d] = len(w)
        sym = torch.from_numpy((1j * w).reshape(shape)).to(
            device=yhat.device, dtype=yhat.dtype)
        return yhat * sym

    if p_to.kind != SWAP[p_from.kind]:
        raise ValueError(f"direction {d}: {p_to.kind} is not the swap of "
                         f"{p_from.kind}")
    sign = 1.0 if p_from.kind in _DST_KINDS else -1.0
    # mode k sits at storage index k - koffset
    w_to = fd_symbol(np.asarray(p_to.modes), p_to.h, fd_order)
    # overlapping mode range
    mode_lo = max(p_from.koffset, p_to.koffset)
    mode_hi = min(p_from.koffset + p_from.n_out, p_to.koffset + p_to.n_out)
    src = slice(mode_lo - p_from.koffset, mode_hi - p_from.koffset)
    dst = slice(mode_lo - p_to.koffset, mode_hi - p_to.koffset)
    fac = torch.from_numpy(sign * w_to[dst]).to(device=yhat.device,
                                                dtype=_real_dtype(yhat))

    def swap_last(y):
        # gather the input coefficient for each output mode
        out = y.new_zeros(y.shape[:-1] + (p_to.n_out,))
        out[..., dst] = y[..., src] * fac
        return out

    return on_last_axis(yhat, d, swap_last)
