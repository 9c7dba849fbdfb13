"""Public wrappers around the kernels: reshapes, dtype plumbing, and the
small torch glue of the pruned inverses.

Counterparts of ``repro.kernels.ops``.  Every wrapper keeps the input's
precision (float64 in gives complex128 / float64 out), flattens leading
axes into kernel rows, and makes its input contiguous before the kernel:
the FFT kernels take no strides.  ``post_twiddle`` is the exception: the
``twiddle_pack`` kernel reads a last-axis window of a half spectrum where
it lies.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import ref
from .fft_stockham import (fft_stockham, fft_stockham_scale,
                           fft_stockham_twiddle)
from .spectral_scale import spectral_scale
from .twiddle_pack import twiddle_pack

__all__ = ["green_checksum", "green_multiply", "post_twiddle",
           "dct2_post_twiddle", "rfft_twiddle", "fft1d", "rfft_kernel", "irfft_kernel",
           "ifft_pruned", "irfft_pruned", "fft1d_green", "rfft_green"]


def _rows(shape):
    return math.prod(shape[:-1])


def green_checksum(fhat, green):
    """Reference side of the ABFT Green-multiply invariant (DESIGN.md #13):
    ``sum(fhat * green)`` for a (batched) spectral field ``fhat`` and its
    real Green plane, as one matrix-vector product over the batch rows
    (a complex ``fhat`` read as interleaved real pairs), so the product
    block is never materialized.  Plain torch, as the reference's is
    plain ``jnp``: no kernel of its own."""
    g = green.reshape(-1).to(ref._rdt(fhat))
    m = g.numel()
    if fhat.is_complex():
        f = torch.view_as_real(fhat.contiguous()).reshape(-1, m, 2)
        re, im = torch.matmul(g, f).sum(0).unbind(-1)
        return torch.complex(re, im)
    return torch.matmul(fhat.contiguous().reshape(-1, m), g).sum()


def green_multiply(fhat, green, scale: float = 1.0):
    """Complex (or real) spectral field times real Green + norm factor:
    the solve's only O(N^3) pointwise pass, one ``spectral_scale`` kernel.
    ``fhat`` may carry leading batch axes over a shared ``green``; the
    kernel then indexes the one Green plane for every batch entry."""
    shp = fhat.shape
    bnd = fhat.ndim - green.ndim
    grows, lanes = _rows(green.shape), green.shape[-1]
    kshape = ((math.prod(shp[:bnd]), grows, lanes) if bnd
              else (grows, lanes))
    g2 = green.reshape(grows, lanes).to(ref._rdt(fhat)).contiguous()
    out = spectral_scale(fhat.contiguous().reshape(kshape), g2, scale)
    return out.reshape(shp)


def post_twiddle(f, a, b):
    """Generic r2r post-twiddle ``y = a * Re(f) + b * Im(f)`` over the last
    axis of a complex ``f`` (..., k), one ``twiddle_pack`` kernel.  ``f``
    may be a last-axis window of a contiguous half spectrum
    (``rfft(z)[..., 1:m+1]``): the kernel reads it in place at its row
    pitch.  ``a``/``b``: (k,) tables (cast to ``f``'s precision)."""
    shp = f.shape
    rows, k = _rows(shp), shp[-1]
    rdt = ref._rdt(f)
    # a view whenever the leading axes are uniformly pitched, as a window
    # of a contiguous tensor is; anything else becomes contiguous here
    f2 = f.reshape(rows, k)
    if k > 1 and f2.stride(1) != 1:
        f2 = f2.contiguous()
    y = twiddle_pack(f2, a.to(rdt).contiguous(), b.to(rdt).contiguous())
    return y.reshape(shp)


def dct2_post_twiddle(fhat_half):
    """DCT-II from the rfft of the symmetric extension (the inner step of
    ``transforms.dct2``): ``y_k = cos_k Re_k + sin_k Im_k`` over the first
    M modes of ``fhat_half`` (..., M)."""
    m = fhat_half.shape[-1]
    th = torch.from_numpy(np.pi * np.arange(m) / (2.0 * m)).to(
        fhat_half.device)
    return post_twiddle(fhat_half, torch.cos(th), torch.sin(th))


def rfft_twiddle(x, a, b, start: int = 0, pad_to: int | None = None,
                 max_radix: int = 4):
    """Fused rfft + r2r post-twiddle: ``a * Re(F)[start:start+k] + b *
    Im(F)[start:start+k]`` of the real (..., N) array ``x`` in one
    ``fft_stockham_twiddle`` kernel; the complex spectrum never reaches
    memory.  ``pad_to = 2N`` composes with the pruned zero tail.
    ``a``/``b``: (k,) tables of ``x``'s precision."""
    shp = x.shape
    rdt = ref._rdt(x)
    y = fft_stockham_twiddle(x.contiguous().reshape(_rows(shp), shp[-1]),
                             a.to(rdt).contiguous(), b.to(rdt).contiguous(),
                             start=start, pad_to=pad_to, max_radix=max_radix)
    return y.reshape(shp[:-1] + (a.shape[-1],))


def _fft_green(x, green, half: bool, pad_to, max_radix: int):
    """Shared body of the fused forward-FFT x Green epilogues."""
    shp = x.shape
    n = shp[-1]
    x2 = x.contiguous().reshape(_rows(shp), n)
    n_fft = pad_to if pad_to is not None else n
    k = n_fft // 2 + 1 if half else n_fft
    g2 = green.reshape(-1, k).to(ref._rdt(x)).contiguous()
    out = fft_stockham_scale(x2, g2, start=0, pad_to=pad_to,
                             max_radix=max_radix)
    return out.reshape(shp[:-1] + (k,))


def fft1d_green(x, green, pad_to: int | None = None, max_radix: int = 4):
    """Fused forward complex FFT x Green multiply: ``FFT(x) * green`` with
    ``green`` real of shape (..., n_fft) shared by any leading batch of
    ``x`` -- the Green multiply runs in the FFT kernel's epilogue."""
    return _fft_green(x, green, half=False, pad_to=pad_to,
                      max_radix=max_radix)


def rfft_green(x, green, pad_to: int | None = None, max_radix: int = 4):
    """Fused rfft x Green multiply on the half spectrum: ``rfft(x) *
    green`` with ``green`` real of shape (..., n_fft//2+1); ``pad_to = 2N``
    prunes the Hockney zero tail inside the same kernel."""
    return _fft_green(x, green, half=True, pad_to=pad_to,
                      max_radix=max_radix)


def fft1d(x, inverse: bool = False, pad_to: int | None = None,
          max_radix: int = 4):
    """Batched complex FFT via the Stockham kernel. x: (..., N).

    ``pad_to = 2N`` is the pruned Hockney-doubling entry point: the
    length-2N spectrum of the zero-tail-extended signal, computed without
    materializing the zeros."""
    shp = x.shape
    out = fft_stockham(x.contiguous().reshape(_rows(shp), shp[-1]),
                       inverse=inverse, pad_to=pad_to, max_radix=max_radix)
    return out.reshape(shp[:-1] + (out.shape[-1],))


def rfft_kernel(x, pad_to: int | None = None, max_radix: int = 4):
    """rfft of a real (..., N) array via the Stockham kernel: the kernel
    reads the real input directly and writes only the half spectrum.
    ``pad_to = 2N`` prunes the Hockney zero tail (length-2N spectrum, N+1
    bins kept)."""
    shp = x.shape
    half = (pad_to if pad_to is not None else shp[-1]) // 2 + 1
    out = fft_stockham(x.contiguous().reshape(_rows(shp), shp[-1]),
                       pad_to=pad_to, max_radix=max_radix, keep=half)
    return out.reshape(shp[:-1] + (half,))


def _hermitian_full(y2, n):
    """Full length-``n`` spectrum from the half spectrum rows ``y2``."""
    tail = torch.flip(y2[:, 1:n - n // 2], (-1,)).conj()
    return torch.cat([y2, tail], dim=-1)


def ifft_pruned(y, keep: int, max_radix: int = 4):
    """First ``keep`` samples of the length-2n inverse FFT of ``y`` via the
    parity split: x_j = (ifft_n(Y_even)_j + e^{i pi j / n} ifft_n(Y_odd)_j)
    / 2 for j < n -- two half-length Stockham inverses instead of one
    double-length inverse plus a crop (``keep <= n`` required)."""
    shp = y.shape
    n2 = shp[-1]
    n = n2 // 2
    if keep > n:
        raise ValueError(f"ifft_pruned keeps at most n={n}, got {keep}")
    y2 = y.reshape(_rows(shp), n2)
    h0, h1 = (fft_stockham(part.contiguous(), inverse=True,
                           max_radix=max_radix, keep=keep)
              for part in (y2[:, 0::2], y2[:, 1::2]))
    j = torch.arange(keep, dtype=torch.float64, device=y.device)
    mod = torch.polar(torch.ones_like(j), torch.pi * j / n).to(h0.dtype)
    # on the CPU the product in real arithmetic (``ref.cmul``): PyTorch's
    # CPU loops round a complex product differently in their vector body
    # and scalar tail, so a row's bits would depend on where it sits in a
    # batch.  On the card every element runs the same instructions, and
    # the complex product makes fewer passes over the block
    out = 0.5 * (h0 + (mod * h1 if h1.is_cuda else ref.cmul(h1, mod)))
    return out.reshape(shp[:-1] + (keep,))


def irfft_pruned(y, n: int, keep: int, max_radix: int = 4):
    """First ``keep`` samples of the length-``n`` irfft of a hermitian half
    spectrum (..., n//2+1): hermitian extension + parity-split pruned
    inverse, real part."""
    shp = y.shape
    full = _hermitian_full(y.reshape(_rows(shp), shp[-1]), n)
    out = ifft_pruned(full, keep, max_radix=max_radix)
    return out.real.reshape(shp[:-1] + (keep,))


def irfft_kernel(y, n: int, max_radix: int = 4):
    """irfft of a hermitian half spectrum (..., N//2+1) -> real (..., N)."""
    shp = y.shape
    full = _hermitian_full(y.reshape(_rows(shp), shp[-1]), n)
    out = fft_stockham(full, inverse=True, max_radix=max_radix)
    return out.real.reshape(shp[:-1] + (n,))
