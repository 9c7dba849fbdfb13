"""1-D transforms used by the solver, all on the LAST axis.

Counterpart of ``repro.core.transforms``: the engine-aware FFT backends,
the pruned Hockney-doubling variants, and the eight real-to-real
transforms (DCT/DST types I-IV).  Every r2r transform runs a
half-spectrum real FFT on the real (anti)symmetric extension: forward
kinds post-twiddle the rfft half spectrum (``y = a * re + b * im``),
inverse-family kinds pre-twiddle the real input into the half spectrum
that ``irfft`` consumes.  Conventions match ``scipy.fft`` unnormalized
("backward").

Engine selection: ``engine=None`` or the ``"torch"`` engine runs
``torch.fft`` (cuFFT on the card) and plain elementwise torch; the
``"cuda"`` engine routes every power-of-two length through the
hand-written Stockham kernel (``repro_torch.kernels.ops``), and the
post-twiddle through the ``twiddle_pack`` kernel.  On power-of-two
extension lengths the forward post-twiddle kinds (dct1/dct2/dst2) run the
fused ``fft_stockham_twiddle`` kernel instead: the twiddle is the FFT's
epilogue and the complex spectrum never reaches memory.  Other lengths
take ``torch.fft`` on either engine, as the reference does on its Pallas
engine.

Twiddle tables are float64 numpy constants per ``(kind, m)``
(``twiddle_tables``); each transform takes them cast to its working dtype
and device from a cache (``device_tables``), so they are cast once.  The
O(M) prefix sums of dst1 and odd-M dct4 always run in float64, as the
reference's do under x64.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import trace as _trace
from .bc import TransformKind

__all__ = [
    "dct1", "dct2", "dct3", "dct4",
    "dst1", "dst2", "dst3", "dst4",
    "r2r_forward", "r2r_backward", "r2r_normfact", "twiddle_tables",
    "device_tables", "fft_length",
]


def _use_cuda(engine) -> bool:
    return engine is not None and getattr(engine, "use_cuda", False)


def _pow2(n: int) -> bool:
    return n >= 2 and (n & (n - 1)) == 0


def _cdt(dtype):
    """Complex dtype of the same precision as the real ``dtype``."""
    return torch.complex128 if dtype == torch.float64 else torch.complex64


# the O(M) prefix sums of dst1 / odd-M dct4 accumulate roundoff linearly
# along the axis: run them in float64 whatever the working precision
_SCAN_DTYPE = torch.float64


# ---------------------------------------------------------------------------
# engine-aware FFT backends (torch.fft by default, Stockham kernel for cuda)
# ---------------------------------------------------------------------------

def _traced(kind, x, n, y):
    """``y``, the ``torch.fft`` transform of ``x`` at length ``n``,
    recorded in the open traces (``core.trace``)."""
    if _trace.active():
        _trace.emit("fft", kind=kind, length=n, rows=x.numel() // x.shape[-1],
                    out=y.shape[-1], dtype=y.dtype)
    return y


def _rfft(z, engine):
    if _use_cuda(engine) and _pow2(z.shape[-1]):
        from repro_torch.kernels import ops
        return ops.rfft_kernel(z, max_radix=engine.max_radix)
    return _traced("rfft", z, z.shape[-1], torch.fft.rfft(z, dim=-1))


def _irfft(c, n, engine):
    if _use_cuda(engine) and _pow2(n):
        from repro_torch.kernels import ops
        return ops.irfft_kernel(c, n, max_radix=engine.max_radix)
    return _traced("irfft", c, n, torch.fft.irfft(c, n=n, dim=-1))


def _cfft(z, engine, inverse=False):
    """Engine-aware complex FFT over the last axis (the solver's c2c dirs)."""
    if not z.is_complex():
        z = z.to(_cdt(z.dtype))
    if _use_cuda(engine) and _pow2(z.shape[-1]):
        from repro_torch.kernels import ops
        return ops.fft1d(z, inverse=inverse, max_radix=engine.max_radix)
    return _traced("ifft" if inverse else "fft", z, z.shape[-1],
                   (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=-1))


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


def device_tables(kind: TransformKind, m: int, dtype, device):
    """``twiddle_tables(kind, m)`` as ``dtype`` tensors on ``device``, cast
    once and reused (plus ``ones``/``zeros`` of length m, the DCT-I
    post-twiddle, and the complex ``q4_pre``/``q4_post`` of even-M
    type-IV).  Under ``FakeTensorMode`` (the dry run) the tables are fake
    and made anew, so that no fake tensor enters the cache."""
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return _device_tables.__wrapped__(kind, m, dtype, device)
    return _device_tables(kind, m, dtype, device)


@lru_cache(maxsize=None)
def _device_tables(kind: TransformKind, m: int, dtype, device):
    t = {k: torch.from_numpy(v).to(device=device, dtype=dtype)
         for k, v in twiddle_tables(kind, m).items()}
    if kind == TransformKind.DCT1:
        t["ones"] = torch.ones(m, dtype=dtype, device=device)
        t["zeros"] = torch.zeros(m, dtype=dtype, device=device)
    if "q4_pre_re" in t:
        t["q4_pre"] = torch.complex(t["q4_pre_re"], t["q4_pre_im"])
        t["q4_post"] = torch.complex(t["q4_post_re"], t["q4_post_im"])
    return t


def fft_length(kind: TransformKind, m: int) -> int:
    """Length of the one FFT a size-``m`` transform of ``kind`` runs (the
    same for its inverse kind): the real extension of dct1/dst1/types
    II-III, the half-length complex FFT of even-M type IV, the DCT-II
    extension of odd-M type IV."""
    if kind == TransformKind.DCT1:
        return 2 * (m - 1)
    if kind == TransformKind.DST1:
        return m + 1
    if kind in (TransformKind.DCT4, TransformKind.DST4) and m % 2 == 0:
        return m // 2
    return 2 * m


# ---------------------------------------------------------------------------
# r2r post-twiddle (twiddle_pack kernel on the cuda engine)
# ---------------------------------------------------------------------------

def _post(f, a, b, engine):
    """``y = a * Re(f) + b * Im(f)`` along the last axis (the r2r
    post-twiddle) of the complex window ``f`` of an rfft half spectrum."""
    if _use_cuda(engine):
        from repro_torch.kernels import ops
        return ops.post_twiddle(f, a, b)
    return a * f.real + b * f.imag


def _rfft_twiddle_fused(z, a, b, start, engine):
    """Fused rfft + post-twiddle (``a*re + b*im`` over ``len(a)`` bins
    from ``start``) when the cuda engine can run it as one kernel; None
    when the caller must take the unfused rfft + ``_post`` path."""
    if not (_use_cuda(engine) and _pow2(z.shape[-1])):
        return None
    from repro_torch.kernels import ops
    return ops.rfft_twiddle(z, a, b, start=start, max_radix=engine.max_radix)


# ---------------------------------------------------------------------------
# DCT types
# ---------------------------------------------------------------------------

def dct1(x, engine=None):
    """DCT-I: y_k = x_0 + (-1)^k x_{M-1} + 2 sum_{n=1}^{M-2} x_n cos(pi k n/(M-1)).

    Even extension of length 2(M-1); the rfft of a real even signal is real,
    and its M half-spectrum bins are exactly the DCT-I coefficients.
    """
    m = x.shape[-1]
    t = device_tables(TransformKind.DCT1, m, x.dtype, x.device)
    z = torch.cat([x, torch.flip(x[..., 1:-1], (-1,))], dim=-1)
    fused = _rfft_twiddle_fused(z, t["ones"], t["zeros"], 0, engine)
    if fused is not None:
        return fused
    return _rfft(z, engine).real


def dct2(x, engine=None):
    """DCT-II: y_k = 2 sum_n x_n cos(pi k (2n+1) / (2M))."""
    m = x.shape[-1]
    t = device_tables(TransformKind.DCT2, m, x.dtype, x.device)
    z = torch.cat([x, torch.flip(x, (-1,))], dim=-1)     # even ext, len 2M
    fused = _rfft_twiddle_fused(z, t["post_a"], t["post_b"], 0, engine)
    if fused is not None:
        return fused
    f = _rfft(z, engine)[..., :m]
    return _post(f, t["post_a"], t["post_b"], engine)


def _pre_twiddled(x, t):
    """The complex ``x * pre_re + i x * pre_im`` of the type-III kinds."""
    return torch.complex(x * t["pre_re"], x * t["pre_im"])


def dct3(x, engine=None):
    """DCT-III: y_k = x_0 + 2 sum_{n=1}^{M-1} x_n cos(pi n (2k+1) / (2M)).

    Pre-twiddle the real input into the hermitian half spectrum whose
    length-2M irfft carries the DCT-III in its first M samples (the 2M
    normalization of irfft is folded into the twiddle table).
    """
    m = x.shape[-1]
    t = device_tables(TransformKind.DCT3, m, x.dtype, x.device)
    c = _pre_twiddled(x, t)
    c = torch.cat([c, c.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    return _irfft(c, 2 * m, engine)[..., :m]


def dct4(x, engine=None):
    """DCT-IV: y_k = 2 sum_n x_n cos(pi (2k+1)(2n+1) / (4M)).

    Even M: the half-length formulation.  Fold the input into the
    length-M/2 complex sequence z_p = (x_{2p} + i x_{M-1-2p})
    e^{-i pi (4p+1)/(4M)}; with t_q = FFT_{M/2}(z)_q e^{-i pi q/M} the
    outputs are y_{2q} = 2 Re t_q and y_{M-1-2q} = -2 Im t_q.

    Odd M: the product-to-sum identity.  With c_n = x_n cos(pi(2n+1)/(4M)),
    y_k + y_{k-1} = 2 DCT2(c)_k (and y_0 = DCT2(c)_0), i.e. one DCT-II
    plus an O(M) alternating prefix sum
    y_k = (-1)^k [Y_0 + 2 sum_{j=1..k} (-1)^j Y_j].
    """
    m = x.shape[-1]
    t = device_tables(TransformKind.DCT4, m, x.dtype, x.device)
    if m % 2 == 0:
        a = x[..., 0::2]                                  # x_{2p}
        b = torch.flip(x, (-1,))[..., 0::2]               # x_{M-1-2p}
        z = torch.complex(a, b) * t["q4_pre"]
        tq = _cfft(z, engine) * t["q4_post"]
        even = 2.0 * tq.real                              # y_{2q}
        odd = -2.0 * torch.flip(tq.imag, (-1,))           # y_{1+2r}
        return torch.stack([even, odd], dim=-1).reshape(x.shape)
    c = x * t["split_c"]
    y2 = dct2(c, engine).to(_SCAN_DTYPE)
    sgn = t["alt_sign"].to(_SCAN_DTYPE)
    cs = torch.cumsum(sgn * y2, dim=-1)
    return (sgn * (2.0 * cs - y2[..., :1])).to(x.dtype)


# ---------------------------------------------------------------------------
# DST types
# ---------------------------------------------------------------------------

def dst1(x, engine=None):
    """DST-I: y_k = 2 sum_n x_n sin(pi (k+1)(n+1) / (M+1)).

    Length-N formulation (N = M+1, the Numerical-Recipes auxiliary
    sequence): with u = [0, x] and its reversal ur = [0, rev(x)], the rfft
    Y of v_j = sin(pi j/N)(u_j + ur_j) + (u_j - ur_j)/2 carries the even
    coefficients directly (y_{2k} = -2 Im Y_k) and the odd ones as a prefix
    sum (y_{2k+1} = Re Y_0 + 2 sum_{j=1..k} Re Y_j).
    """
    m = x.shape[-1]
    t = device_tables(TransformKind.DST1, m, x.dtype, x.device)
    dtype = x.dtype
    zeros = x.new_zeros(x.shape[:-1] + (1,))
    u = torch.cat([zeros, x], dim=-1)                          # u_j
    ur = torch.cat([zeros, torch.flip(x, (-1,))], dim=-1)      # u_{N-j}
    v = t["aux_sin"] * (u + ur) + 0.5 * (u - ur)
    f = _rfft(v, engine)                                       # bins 0..N//2
    n_odd = (m + 1) // 2                                       # y_1, y_3, ...
    n_even = m // 2                                            # y_2, y_4, ...
    re = f.real[..., :n_odd].to(_SCAN_DTYPE)
    odd = (2.0 * torch.cumsum(re, dim=-1) - re[..., :1]).to(dtype)
    even = -2.0 * f.imag[..., 1:n_even + 1]
    if n_even < n_odd:                                         # odd M
        even = torch.cat([even, zeros], dim=-1)
    out = torch.stack([odd, even], dim=-1).reshape(
        x.shape[:-1] + (2 * n_odd,))
    return out[..., :m]


def dst2(x, engine=None):
    """DST-II: y_k = 2 sum_n x_n sin(pi (k+1)(2n+1) / (2M))."""
    m = x.shape[-1]
    t = device_tables(TransformKind.DST2, m, x.dtype, x.device)
    z = torch.cat([x, -torch.flip(x, (-1,))], dim=-1)    # odd ext, len 2M
    fused = _rfft_twiddle_fused(z, t["post_a"], t["post_b"], 1, engine)
    if fused is not None:
        return fused
    f = _rfft(z, engine)[..., 1:m + 1]
    return _post(f, t["post_a"], t["post_b"], engine)


def dst3(x, engine=None):
    """DST-III: y_k = (-1)^k x_{M-1} + 2 sum_{n=0}^{M-2} x_n sin(pi (n+1)(2k+1)/(2M)).

    Mirror of dct3: pre-twiddle into bins 1..M of the half spectrum (bin 0
    stays zero), irfft, keep the first M samples.
    """
    m = x.shape[-1]
    t = device_tables(TransformKind.DST3, m, x.dtype, x.device)
    c = _pre_twiddled(x, t)
    c = torch.cat([c.new_zeros(x.shape[:-1] + (1,)), c], dim=-1)
    return _irfft(c, 2 * m, engine)[..., :m]


def dst4(x, engine=None):
    """DST-IV: y_k = 2 sum_n x_n sin(pi (2k+1)(2n+1) / (4M)).

    Reversal identity: DST4(x)_k = (-1)^k DCT4(rev(x))_k.
    """
    m = x.shape[-1]
    t = device_tables(TransformKind.DST4, m, x.dtype, x.device)
    return t["alt_sign"] * dct4(torch.flip(x, (-1,)), engine=engine)


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


def r2r_forward(x, kind: TransformKind, engine=None):
    """Forward r2r transform of ``kind`` along the last axis of ``x``."""
    return _FWD[kind](x, engine=engine)


def r2r_backward(y, kind: TransformKind, engine=None):
    """Unnormalized inverse; the solver folds ``r2r_normfact`` into the
    Green's function (standalone callers multiply by it themselves)."""
    return _INV[kind](y, engine=engine)
