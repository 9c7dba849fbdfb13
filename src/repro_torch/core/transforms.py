"""1-D transforms used by the solver, all on the LAST axis.

This slice ports the DFT part of ``repro.core.transforms``: the engine-aware
FFT backends and the pruned Hockney-doubling variants, plus the plan-time
numpy helpers (``twiddle_tables``, ``r2r_normfact``) that ``make_plan`` and
``build_schedule`` need.  The eight real-to-real transforms come with the
next slice, together with the kernels that carry them.

Engine selection: ``engine=None`` or the ``"torch"`` engine runs
``torch.fft`` (cuFFT on the card); the ``"cuda"`` engine routes every
power-of-two length through the hand-written Stockham kernel
(``repro_torch.kernels.ops``).  Other lengths take ``torch.fft`` on either
engine, as the reference does on its Pallas engine.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .bc import TransformKind

__all__ = ["r2r_normfact", "twiddle_tables"]


def _use_cuda(engine) -> bool:
    return engine is not None and getattr(engine, "use_cuda", False)


def _pow2(n: int) -> bool:
    return n >= 2 and (n & (n - 1)) == 0


def _cdt(dtype):
    """Complex dtype of the same precision as the real ``dtype``."""
    return torch.complex128 if dtype == torch.float64 else torch.complex64


# ---------------------------------------------------------------------------
# engine-aware FFT backends (torch.fft by default, Stockham kernel for cuda)
# ---------------------------------------------------------------------------

def _rfft(z, engine):
    if _use_cuda(engine) and _pow2(z.shape[-1]):
        from repro_torch.kernels import ops
        return ops.rfft_kernel(z, max_radix=engine.max_radix)
    return torch.fft.rfft(z, dim=-1)


def _irfft(c, n, engine):
    if _use_cuda(engine) and _pow2(n):
        from repro_torch.kernels import ops
        return ops.irfft_kernel(c, n, max_radix=engine.max_radix)
    return torch.fft.irfft(c, n=n, dim=-1)


def _cfft(z, engine, inverse=False):
    """Engine-aware complex FFT over the last axis (the solver's c2c dirs)."""
    if not z.is_complex():
        z = z.to(_cdt(z.dtype))
    if _use_cuda(engine) and _pow2(z.shape[-1]):
        from repro_torch.kernels import ops
        return ops.fft1d(z, inverse=inverse, max_radix=engine.max_radix)
    return (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=-1)


# ---------------------------------------------------------------------------
# pruned DFT variants (Hockney doubling: length-n_fft spectra of signals
# whose tail is identically zero / inverses of which only a head is kept)
# ---------------------------------------------------------------------------

def _zpad(x, n_fft):
    """``x`` zero-extended to ``n_fft`` points along the last axis."""
    out = x.new_zeros(x.shape[:-1] + (n_fft,))
    out[..., :x.shape[-1]] = x
    return out


def _rfft_padded(x, n_fft, engine):
    """Length-``n_fft`` half spectrum of ``[x, 0, ..., 0]`` from only the
    ``x.shape[-1]`` nonzero inputs.  The cuda engine skips the zero tail
    inside the Stockham kernel; the torch engine pads explicitly, which
    keeps the result bit-identical to a dense plan's."""
    n_in = x.shape[-1]
    if n_in == n_fft:
        return _rfft(x, engine)
    if _use_cuda(engine) and _pow2(n_fft) and n_fft == 2 * n_in:
        from repro_torch.kernels import ops
        return ops.rfft_kernel(x, pad_to=n_fft, max_radix=engine.max_radix)
    return _rfft(_zpad(x, n_fft), engine)


def _cfft_padded(z, n_fft, engine):
    """Length-``n_fft`` complex spectrum of the zero-tail-extended ``z``."""
    n_in = z.shape[-1]
    if n_in == n_fft:
        return _cfft(z, engine)
    if (_use_cuda(engine) and _pow2(n_fft) and n_fft == 2 * n_in
            and z.is_complex()):
        from repro_torch.kernels import ops
        return ops.fft1d(z, pad_to=n_fft, max_radix=engine.max_radix)
    return _cfft(_zpad(z, n_fft), engine)


def _irfft_crop(y, n_fft, keep, engine):
    """First ``keep`` samples of the length-``n_fft`` irfft.  The cuda
    engine reconstructs only the retained half via the parity split (two
    half-length inverse FFTs); torch.fft reconstructs fully and crops."""
    if keep >= n_fft:
        return _irfft(y, n_fft, engine)
    if (_use_cuda(engine) and _pow2(n_fft) and n_fft >= 4
            and keep <= n_fft // 2):
        from repro_torch.kernels import ops
        return ops.irfft_pruned(y, n_fft, keep, max_radix=engine.max_radix)
    return _irfft(y, n_fft, engine)[..., :keep]


def _icfft_crop(z, keep, engine):
    """First ``keep`` samples of the inverse complex FFT of ``z``."""
    n_fft = z.shape[-1]
    if keep >= n_fft:
        return _cfft(z, engine, inverse=True)
    if (_use_cuda(engine) and _pow2(n_fft) and n_fft >= 4
            and keep <= n_fft // 2):
        from repro_torch.kernels import ops
        return ops.ifft_pruned(z, keep, max_radix=engine.max_radix)
    return _cfft(z, engine, inverse=True)[..., :keep]


# ---------------------------------------------------------------------------
# twiddle tables (plan-time constants, float64; cast at use)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def twiddle_tables(kind: TransformKind, m: int):
    """Precomputed twiddle constants for a size-``m`` transform of ``kind``.

    Keys (all values ``np.float64``):
      post_a/post_b  forward post-twiddle  ``y = a*re + b*im``
      pre_re/pre_im  inverse-family pre-twiddle (2M factor folded in)
      split_c/split_s  type-IV cos/sin input split
    """
    if kind == TransformKind.DCT1:
        return {}
    if kind == TransformKind.DST1:
        # NR-style auxiliary sequence for the length-(m+1) rfft formulation
        j = np.arange(m + 1)
        return {"aux_sin": np.sin(np.pi * j / (m + 1.0))}
    if kind == TransformKind.DCT2:
        k = np.arange(m)
        th = np.pi * k / (2.0 * m)
        return {"post_a": np.cos(th), "post_b": np.sin(th)}
    if kind == TransformKind.DST2:
        k = np.arange(1, m + 1)
        th = np.pi * k / (2.0 * m)
        return {"post_a": np.sin(th), "post_b": -np.cos(th)}
    if kind == TransformKind.DCT3:
        k = np.arange(m)
        th = np.pi * k / (2.0 * m)
        return {"pre_re": 2.0 * m * np.cos(th),
                "pre_im": 2.0 * m * np.sin(th)}
    if kind == TransformKind.DST3:
        k = np.arange(1, m + 1)
        th = np.pi * k / (2.0 * m)
        return {"pre_re": 2.0 * m * np.sin(th),
                "pre_im": -2.0 * m * np.cos(th)}
    if kind in (TransformKind.DCT4, TransformKind.DST4):
        n = np.arange(m)
        b = np.pi * (2 * n + 1) / (4.0 * m)
        t = {"split_c": np.cos(b), "split_s": np.sin(b),
             "alt_sign": (-1.0) ** n}
        if m % 2 == 0:
            # half-length complex-FFT formulation (see dct4): pre-twiddle
            # e^{-i pi (4p+1)/(4M)} on z_p = x_{2p} + i x_{M-1-2p}, post
            # e^{-i pi q/M} on the length-M/2 spectrum
            p = np.arange(m // 2)
            pre = np.pi * (4 * p + 1) / (4.0 * m)
            post = np.pi * p / m
            t.update(q4_pre_re=np.cos(pre), q4_pre_im=-np.sin(pre),
                     q4_post_re=np.cos(post), q4_post_im=-np.sin(post))
        return t
    raise ValueError(kind)


def r2r_normfact(kind: TransformKind, m: int) -> float:
    """1 / (forward o backward) amplification for size-m transforms."""
    if kind in (TransformKind.DCT1,):
        return 1.0 / (2.0 * (m - 1))
    if kind in (TransformKind.DST1,):
        return 1.0 / (2.0 * (m + 1))
    return 1.0 / (2.0 * m)
