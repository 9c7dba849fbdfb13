"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, with the same
arithmetic: the same radix-4/2 Stockham stages in the same order, the same
two-pass split of long rows, the same pruned first stage, the same twiddle
table and the same epilogues.  The plain version runs the stages one at a
time over whole rows; the CUDA kernel groups the same stages into passes
held in registers (two radix-4 stages per pass), which changes where the
values live between stages, not the values.  The wrappers run these on
CPU tensors (the tests), and ``chip_smoke.py`` holds each kernel against
its plain version on the card.  None of them calls ``torch.fft``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["ONE_PASS_N", "twiddles", "cmul", "fft_stockham",
           "fft_stockham_scale", "fft_stockham_twiddle", "spectral_scale",
           "twiddle_pack"]


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


def cmul(z, w):
    """``z * w`` in real arithmetic, one rounding per product and sum:
    PyTorch's CPU complex product rounds differently in its vector loops
    and their scalar tail, which would make a row's bits depend on where
    it sits in the batch."""
    wr = torch.view_as_real(w)
    wi = torch.stack((-w.imag, w.real), dim=-1)
    zr = torch.view_as_real(z)
    return torch.view_as_complex(zr[..., 0:1] * wr + zr[..., 1:2] * wi)


def _minus_i(z, inverse):
    """``-i z`` (forward) or ``+i z`` (inverse), exactly."""
    if inverse:
        return torch.complex(-z.imag, z.real)
    return torch.complex(z.imag, -z.real)


# longest row one block of the kernel transforms (in shared memory); longer
# rows take the four-step split, N = N1 * ONE_PASS_N
ONE_PASS_N = 4096


def _rows_fft(X, n, inverse, max_radix, w, stride):
    """Unnormalized length-``n`` FFTs of the complex rows of ``X``
    (b, n_in), ``n_in`` = n or n/2 (the pruned zero tail): the radix-4 DIF
    Stockham stages with one radix-2 step for the odd log2 factor.  ``w``
    is the (conjugated for the inverse) table of a length ``n * stride``
    transform, read at ``stride`` for ``W_n``."""
    b, n_in = X.shape
    dev = X.device
    m, l = n, 1
    if n_in < n:
        # pruned first stage: x1 == 0, so e = x0 and d = x0 * w^j
        wj = w[torch.arange(n_in, device=dev) * stride]
        X = torch.stack([X, cmul(X, wj)], dim=-1).reshape(b, n)
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
            j = torch.arange(q, device=dev) * (n // m * stride)
            w1, w2, w3 = (w[s * j][:, None] for s in (1, 2, 3))
            ys = [t0 + t2, cmul(t1 + u3, w1), cmul(t0 - t2, w2),
                  cmul(t1 - u3, w3)]
            X = torch.stack(ys, dim=2).reshape(b, n)
            m, l = q, 4 * l
        else:
            half = m // 2
            x0, x1 = X.reshape(b, 2, half, l).unbind(1)
            j = torch.arange(half, device=dev) * (n // m * stride)
            X = torch.stack([x0 + x1, cmul(x0 - x1, w[j][:, None])],
                            dim=2).reshape(b, n)
            m, l = half, 2 * l
    return X


def fft_stockham(x, inverse=False, pad_to=None, max_radix=4, keep=None):
    """Batched complex FFT along the last axis of ``x`` (batch, N): the
    radix-4 DIF Stockham stages with one radix-2 step for the odd log2
    factor (``max_radix=2``: radix-2 only).  A real ``x`` stands for a zero
    imaginary part.  ``inverse`` flips the sign and scales by 1/N.
    ``pad_to = 2N`` (forward only) transforms ``x`` zero-extended to 2N:
    the first stage, whose upper operand is zero, becomes a copy and a
    twiddle.  ``keep`` returns only bins ``[0, keep)``.

    Lengths above ``ONE_PASS_N`` take the kernel's four-step split (on a
    thread-block cluster up to 65536 points, in two passes above), N = N1
    N2 with N2 = ONE_PASS_N: the N1-point FFTs of the stride-N2 columns (the
    pruned first stage on the columns for ``pad_to``), the inter-pass
    twiddle ``W_N^(n2 k1)``, the N2-point FFTs of the rows ``(r, k1)``, and
    bin ``k1 + N1 k2`` read from row ``(r, k1)``, position ``k2``."""
    b, n_in = x.shape
    n = n_in if pad_to is None else pad_to
    dev = x.device
    w = twiddles(n, _cdt(_rdt(x)), dev)
    if inverse:
        w = w.conj()
    X = x.to(w.dtype)
    if n <= ONE_PASS_N:
        X = _rows_fft(X, n, inverse, max_radix, w, 1)
    else:
        n2 = ONE_PASS_N
        n1 = n // n2
        cols = X.reshape(b, n_in // n2, n2).transpose(1, 2)
        Y = _rows_fft(cols.reshape(b * n2, n_in // n2), n1, inverse,
                      max_radix, w, n2)
        t = (torch.arange(n2, device=dev)[:, None]
             * torch.arange(n1, device=dev)[None, :])
        Z = cmul(Y.reshape(b, n2, n1), w[t]).transpose(1, 2)
        V = _rows_fft(Z.reshape(b * n1, n2), n2, inverse, max_radix, w, n1)
        X = V.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
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
