"""Legacy full-complex r2r transforms (the pre-half-spectrum reference).

Counterpart of ``repro.core.transforms_ref``.  Every DCT/DST here runs a
FULL-length complex FFT (``torch.fft``) on the real (anti)symmetric
extension -- 2x the FLOPs and bytes of the half-spectrum algorithm in
``repro_torch.core.transforms``.  Kept as a second oracle for the
equivalence tests; nothing in the solvers calls this module.  All eight
kinds work on the LAST axis, keep the input's dtype and device, and follow
``scipy.fft``'s unnormalized ("backward") conventions.
"""
from __future__ import annotations

import math

import torch

from .bc import TransformKind

__all__ = [
    "dct1", "dct2", "dct3", "dct4",
    "dst1", "dst2", "dst3", "dst4",
    "r2r_forward", "r2r_backward", "r2r_normfact",
]


def _cdt(x):
    return torch.complex128 if x.dtype == torch.float64 else torch.complex64


def _ar(x, start, stop):
    """Float64 indices ``[start, stop)`` on ``x``'s device."""
    return torch.arange(start, stop, dtype=torch.float64, device=x.device)


def _expi(x, ang):
    """``exp(i * ang)`` of float64 angles, complex in ``x``'s precision."""
    return torch.polar(torch.ones_like(ang), ang).to(_cdt(x))


def _zeros_ext(c, m2):
    """``c`` zero-extended along the last axis to ``m2`` entries."""
    out = c.new_zeros(c.shape[:-1] + (m2,))
    out[..., :c.shape[-1]] = c
    return out


# ---------------------------------------------------------------------------
# DCT types
# ---------------------------------------------------------------------------

def dct1(x):
    """DCT-I: y_k = x_0 + (-1)^k x_{M-1} + 2 sum_{n=1}^{M-2} x_n cos(pi k n/(M-1))."""
    m = x.shape[-1]
    z = torch.cat([x, torch.flip(x[..., 1:m - 1], (-1,))], dim=-1)
    return torch.fft.fft(z, dim=-1).real[..., :m].to(x.dtype)


def dct2(x):
    """DCT-II: y_k = 2 sum_n x_n cos(pi k (2n+1) / (2M))."""
    m = x.shape[-1]
    z = torch.cat([x, torch.flip(x, (-1,))], dim=-1)          # len 2M
    tw = _expi(x, -math.pi * _ar(x, 0, m) / (2 * m))
    return (tw * torch.fft.fft(z, dim=-1)[..., :m]).real.to(x.dtype)


def dct3(x):
    """DCT-III: y_k = x_0 + 2 sum_{n=1}^{M-1} x_n cos(pi n (2k+1) / (2M))."""
    m = x.shape[-1]
    c = x * _expi(x, -math.pi * _ar(x, 0, m) / (2 * m))
    y = 2.0 * torch.fft.fft(_zeros_ext(c, 2 * m), dim=-1).real[..., :m] \
        - x[..., 0:1]
    return y.to(x.dtype)


def dct4(x):
    """DCT-IV: y_k = 2 sum_n x_n cos(pi (2k+1)(2n+1) / (4M))."""
    m = x.shape[-1]
    k = _ar(x, 0, m)
    c = x * _expi(x, -math.pi * k / (2 * m))
    f = torch.fft.fft(_zeros_ext(c, 2 * m), dim=-1)[..., :m]
    y = 2.0 * (_expi(x, -math.pi * (2 * k + 1) / (4 * m)) * f).real
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# DST types
# ---------------------------------------------------------------------------

def dst1(x):
    """DST-I: y_k = 2 sum_n x_n sin(pi (k+1)(n+1) / (M+1))."""
    m = x.shape[-1]
    zeros = x.new_zeros(x.shape[:-1] + (1,))
    # odd extension, length 2(M+1): [0, x, 0, -rev(x)]
    z = torch.cat([zeros, x, zeros, -torch.flip(x, (-1,))], dim=-1)
    return (-torch.fft.fft(z, dim=-1).imag[..., 1:m + 1]).to(x.dtype)


def dst2(x):
    """DST-II: y_k = 2 sum_n x_n sin(pi (k+1)(2n+1) / (2M))."""
    m = x.shape[-1]
    z = torch.cat([x, -torch.flip(x, (-1,))], dim=-1)         # len 2M
    fj = torch.fft.fft(z, dim=-1)[..., 1:m + 1]
    tw = 1j * _expi(x, -math.pi * _ar(x, 1, m + 1) / (2 * m))
    return (tw * fj).real.to(x.dtype)


def dst3(x):
    """DST-III: y_k = (-1)^k x_{M-1} + 2 sum_{n=0}^{M-2} x_n sin(pi (n+1)(2k+1)/(2M))."""
    m = x.shape[-1]
    # w_m coefficients: w_0 = 0, w_j = x_{j-1} (j=1..M-1), w_M = x_{M-1}/2
    zeros = x.new_zeros(x.shape[:-1] + (1,))
    w = torch.cat([zeros, x[..., :-1], 0.5 * x[..., -1:]], dim=-1)
    wp = w * _expi(x, math.pi * _ar(x, 0, m + 1) / (2 * m))
    y = 2.0 * (2 * m) * torch.fft.ifft(_zeros_ext(wp, 2 * m),
                                       dim=-1).imag[..., :m]
    return y.to(x.dtype)


def dst4(x):
    """DST-IV: y_k = 2 sum_n x_n sin(pi (2k+1)(2n+1) / (4M))."""
    m = x.shape[-1]
    k = _ar(x, 0, m)
    c = x * _expi(x, math.pi * k / (2 * m))
    f = (2 * m) * torch.fft.ifft(_zeros_ext(c, 2 * m), dim=-1)[..., :m]
    y = 2.0 * (_expi(x, math.pi * (2 * k + 1) / (4 * m)) * f).imag
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# dispatch + normalization
# ---------------------------------------------------------------------------

_FWD = {
    TransformKind.DCT1: dct1, TransformKind.DCT2: dct2,
    TransformKind.DCT3: dct3, TransformKind.DCT4: dct4,
    TransformKind.DST1: dst1, TransformKind.DST2: dst2,
    TransformKind.DST3: dst3, TransformKind.DST4: dst4,
}

_INV = {
    TransformKind.DCT1: dct1, TransformKind.DCT2: dct3,
    TransformKind.DCT3: dct2, TransformKind.DCT4: dct4,
    TransformKind.DST1: dst1, TransformKind.DST2: dst3,
    TransformKind.DST3: dst2, TransformKind.DST4: dst4,
}


def r2r_normfact(kind: TransformKind, m: int) -> float:
    """1 / (forward o backward) amplification for size-m transforms."""
    if kind in (TransformKind.DCT1,):
        return 1.0 / (2.0 * (m - 1))
    if kind in (TransformKind.DST1,):
        return 1.0 / (2.0 * (m + 1))
    return 1.0 / (2.0 * m)


def r2r_forward(x, kind: TransformKind):
    return _FWD[kind](x)


def r2r_backward(y, kind: TransformKind):
    """Unnormalized inverse; caller multiplies by ``r2r_normfact``."""
    return _INV[kind](y)
