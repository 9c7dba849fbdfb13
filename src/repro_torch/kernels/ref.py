"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, step for step: the same
radix-4/2 Stockham stages, the same pruned first stage, the same twiddle
table and the same epilogues.  The wrappers run these on CPU tensors (the
tests), and ``chip_smoke.py`` holds each kernel against its plain version
on the card.  None of them calls ``torch.fft``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["twiddles", "fft_stockham", "fft_stockham_scale",
           "fft_stockham_twiddle", "spectral_scale", "twiddle_pack"]


def _cdt(rdt):
    return torch.complex128 if rdt == torch.float64 else torch.complex64


def _rdt(x):
    """Real dtype of the same precision as ``x``."""
    return x.real.dtype if x.is_complex() else x.dtype


@lru_cache(maxsize=None)
def twiddles(n: int, cdtype, device) -> torch.Tensor:
    """Forward twiddle table ``W[t] = exp(-2 pi i t / n)``, t < n, computed
    in float64 and cast once to ``cdtype`` on ``device`` (the inverse
    transform conjugates it).  Shared by the kernels and the plain
    versions, so both multiply by the same twiddle values."""
    ang = -2.0 * np.pi * np.arange(n) / n
    w = np.cos(ang) + 1j * np.sin(ang)
    return torch.from_numpy(w).to(device=device, dtype=cdtype)


def _minus_i(z, inverse):
    """``-i z`` (forward) or ``+i z`` (inverse), exactly."""
    if inverse:
        return torch.complex(-z.imag, z.real)
    return torch.complex(z.imag, -z.real)


def fft_stockham(x, inverse=False, pad_to=None, max_radix=4, keep=None):
    """Batched complex FFT along the last axis of ``x`` (batch, N): the
    radix-4 DIF Stockham stages with one radix-2 step for the odd log2
    factor (``max_radix=2``: radix-2 only).  A real ``x`` stands for a zero
    imaginary part.  ``inverse`` flips the sign and scales by 1/N.
    ``pad_to = 2N`` (forward only) transforms ``x`` zero-extended to 2N:
    the first stage, whose upper operand is zero, becomes a copy and a
    twiddle.  ``keep`` returns only bins ``[0, keep)``."""
    b, n_in = x.shape
    n = n_in if pad_to is None else pad_to
    cdt = _cdt(_rdt(x))
    w = twiddles(n, cdt, x.device)
    if inverse:
        w = w.conj()
    X = x.to(cdt)
    m, l = n, 1
    if n_in < n:
        # pruned first stage: x1 == 0, so e = x0 and d = x0 * w^j
        X = torch.stack([X, X * w[:n_in]], dim=-1).reshape(b, n)
        m, l = n // 2, 2
    while m > 1:
        if m % 4 == 0 and max_radix >= 4:
            # quarters (A, B, C, D) of each length-m sub-transform:
            #   y0 = (A+C) + (B+D)          y1 = ((A-C) -+ i(B-D)) W^j
            #   y2 = ((A+C) - (B+D)) W^2j   y3 = ((A-C) +- i(B-D)) W^3j
            q = m // 4
            A, B, C, D = X.reshape(b, 4, q, l).unbind(1)
            t0, t1, t2 = A + C, A - C, B + D
            u3 = _minus_i(B - D, inverse)
            j = torch.arange(q, device=x.device) * (n // m)
            w1, w2, w3 = (w[s * j][:, None] for s in (1, 2, 3))
            ys = [t0 + t2, (t1 + u3) * w1, (t0 - t2) * w2, (t1 - u3) * w3]
            X = torch.stack(ys, dim=2).reshape(b, n)
            m, l = q, 4 * l
        else:
            half = m // 2
            x0, x1 = X.reshape(b, 2, half, l).unbind(1)
            j = torch.arange(half, device=x.device) * (n // m)
            X = torch.stack([x0 + x1, (x0 - x1) * w[j][:, None]],
                            dim=2).reshape(b, n)
            m, l = half, 2 * l
    if inverse:
        X = X / n
    return X if keep is None else X[:, :keep].contiguous()


def fft_stockham_scale(x, g, start=0, pad_to=None, max_radix=4):
    """Forward FFT of ``x`` (rows, N), then bins ``[start, start+k)`` times
    the real Green plane ``g`` (grows, k): row ``r`` takes Green row
    ``r % grows`` (the leading ``rows // grows`` batch shares one plane)."""
    y = fft_stockham(x, pad_to=pad_to, max_radix=max_radix)
    grows, k = g.shape
    y = y[:, start:start + k].reshape(-1, grows, k)
    out = torch.complex(y.real * g, y.imag * g)
    return out.reshape(-1, k)


def fft_stockham_twiddle(x, a, b, start=0, pad_to=None, max_radix=4):
    """Forward FFT of ``x`` (rows, N), then the real post-twiddle
    ``a * Re + b * Im`` of bins ``[start, start+k)``, ``a``/``b`` (k,)."""
    y = fft_stockham(x, pad_to=pad_to, max_radix=max_radix)
    return twiddle_pack(y[:, start:start + a.shape[0]], a, b)


def twiddle_pack(x, a, b):
    """``a * Re(x) + b * Im(x)`` of a complex ``x`` (rows, k), with the
    real (k,) tables ``a``/``b`` broadcast along rows."""
    return a * x.real + b * x.imag


def spectral_scale(x, green, scale: float):
    """``x * (green * scale)`` for a real or complex ``x`` of shape
    (rows, lanes) or (B, rows, lanes), with ``green`` (rows, lanes) shared
    across B."""
    gs = green * scale
    if x.is_complex():
        return torch.complex(x.real * gs, x.imag * gs)
    return x * gs
