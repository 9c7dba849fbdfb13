"""Batched radix-4/2 Stockham complex FFT along the last axis, and the same
FFT fused with the spectral Green multiply or with the DCT/DST
post-twiddle: wrappers of the CUDA kernel in ``csrc/fft_stockham.cu``.

Counterparts of ``fft_stockham``, ``fft_stockham_scale`` and
``fft_stockham_twiddle`` in ``repro.kernels.fft_stockham``.  The TPU
kernels take separate (re, im) planes; here complex data is torch's own
interleaved complex tensor, and a real input stands for a zero imaginary
plane (the kernel reads it directly, no zeros plane is materialized).

On a CUDA tensor each wrapper launches its kernel on the current stream
and counts the launch; on a CPU tensor it runs the plain version in
``ref``; on a fake tensor (``FakeTensorMode``, the dry run) it returns an
output of the right shape and launches nothing.  Every call is recorded
in the open ``core.trace`` traces.  Anything else (other devices,
dtypes, shapes, strides) raises.
A row takes one of three tiers by its length (``path``), in either
precision: up to ``ONE_PASS_N`` points one pass; up to ``CLUSTER_N``
one pass on a thread-block cluster of N / ``ONE_PASS_N`` (at most 16)
blocks a row; longer rows two passes (a column pass into a scratch
buffer the wrapper allocates, then the row pass with the epilogue, on
clusters of blocks that exchange their bins before they store them).
Every call counts once in ``LAUNCHES``, and a cluster or two-pass call
once more in ``CLUSTER`` or ``TWO_PASS``.
"""
from __future__ import annotations

from functools import lru_cache

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core import trace as _trace

from . import ref
from ._build import CLUSTER, LAUNCHES, TWO_PASS, check, library

__all__ = ["fft_stockham", "fft_stockham_scale", "fft_stockham_twiddle",
           "path", "MAX_N", "ONE_PASS_N", "CLUSTER_N"]

# Longest row transformed by one block: 256 threads holding 16 points
# each.  Rows up to 16 times longer run on a cluster of up to 16 blocks
# (the largest an H100 takes; above 8 a non-portable size); longer rows
# take two passes of at most 4096 points each, so the kernel takes up to
# 4096^2.
ONE_PASS_N = ref.ONE_PASS_N
CLUSTER_N = 16 * ONE_PASS_N
MAX_N = ONE_PASS_N ** 2

_REAL = (torch.float32, torch.float64)
_COMPLEX = (torch.complex64, torch.complex128)


def _check_input(x, what):
    if x.dtype not in _REAL + _COMPLEX:
        raise TypeError(f"{what}: x must be float32/64 or complex64/128, "
                        f"got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{what}: x must be (batch, N), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _fft_len(n_in, pad_to, inverse, what):
    n = n_in if pad_to is None else pad_to
    if pad_to is not None:
        if pad_to != 2 * n_in:
            raise ValueError(f"{what}: pad_to must be 2N, got {pad_to} for "
                             f"N={n_in}")
        if inverse:
            raise ValueError(f"{what}: the zero-tail pruned input is a "
                             "forward-only shape")
    if n < 2 or n & (n - 1) or n > MAX_N:
        raise ValueError(f"{what}: transform length must be a power of two "
                         f"in [2, {MAX_N}], got {n}")
    return n


@lru_cache(maxsize=None)
def kernel_twiddles(n, cdtype, device):
    """The kernel's twiddle tables for rows of ``n`` points: ``ref``'s
    length-``n`` table and, above ``ONE_PASS_N`` points, two more after
    it, whose values are the long table's bit for bit: the
    ``ONE_PASS_N``-point table, which the 4096-point row FFTs read
    contiguously (the long table at stride ``n1 = n / ONE_PASS_N``), and
    the four-step split's inter-pass twiddles ``W[k1 * 4096 + n2] =
    W_n^(n2 k1)`` (``k1 < n1``, ``n2 < 4096``), which neighbouring columns
    read contiguously."""
    tw = ref.twiddles(n, cdtype, device)
    if n <= ONE_PASS_N:
        return tw
    k1 = torch.arange(n // ONE_PASS_N, device=device)[:, None]
    n2 = torch.arange(ONE_PASS_N, device=device)[None, :]
    return torch.cat((tw, ref.twiddles(ONE_PASS_N, cdtype, device),
                      tw[(k1 * n2).reshape(-1)]))


def _ptr(t):
    return None if t is None else t.data_ptr()


def path(n):
    """The kernel's tier for rows of ``n`` points (a power of two up to
    ``MAX_N``), in either precision: ``"one_pass"``, ``"cluster"`` or
    ``"two_pass"``."""
    if n <= ONE_PASS_N:
        return "one_pass"
    return "cluster" if n <= CLUSTER_N else "two_pass"


def _traced(kname, x, out, n, inverse=False):
    """``out``, recorded in the open traces as ``kname``'s call and the
    FFT it computes."""
    if _trace.active():
        _trace.kernel_call(kname, x, out)
        _trace.emit("fft", kind="ifft" if inverse else
                    "fft" if x.is_complex() else "rfft", length=n,
                    rows=x.shape[0], out=out.shape[-1], dtype=out.dtype)
    return out


def _launch(kname, x, out, n, inverse, max_radix, start, k, g=None,
            grows=1, a=None, b=None):
    rows, n_in = x.shape
    lib = library()
    fn = (lib.repro_fft_stockham_f64 if ref._rdt(x) == torch.float64
          else lib.repro_fft_stockham_f32)
    cdt = ref._cdt(ref._rdt(x))
    tw = kernel_twiddles(n, cdt, x.device)
    tier = path(n)
    # the column pass's output, (rows, N1, N2): read by the row pass on the
    # same stream, so the caching allocator may reuse it once this returns
    scratch = (torch.empty(rows * n, dtype=cdt, device=x.device)
               if tier == "two_pass" else None)
    err = fn(x.data_ptr(), int(x.is_complex()), out.data_ptr(), _ptr(g),
             _ptr(a), _ptr(b), tw.data_ptr(), _ptr(scratch), rows, n_in, n,
             int(inverse), max_radix, start, k, grows,
             torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "fft_stockham kernel launch")
    LAUNCHES[kname] += 1
    if tier == "cluster":
        CLUSTER[kname] += 1
    elif tier == "two_pass":
        TWO_PASS[kname] += 1


def _check_radix(max_radix):
    if max_radix not in (2, 4):
        raise ValueError(f"max_radix must be 2 or 4, got {max_radix}")


def _check_plane(t, x, what, name):
    """``t`` must be a contiguous real tensor of ``x``'s precision on
    ``x``'s device."""
    if t.dtype != ref._rdt(x) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous "
                         f"{ref._rdt(x)} tensor, got {tuple(t.shape)} "
                         f"{t.dtype}")
    if t.device != x.device:
        raise ValueError(f"{what}: {name} and x on different devices")


def fft_stockham(x, inverse=False, pad_to=None, max_radix=4, keep=None):
    """Complex FFT of ``x`` (batch, N) along the last axis -> complex
    (batch, keep or n_fft).

    ``inverse`` flips the sign and scales by 1/N.  ``pad_to = 2N``
    (forward only) is the pruned Hockney zero-tail shape: the length-2N
    spectrum of ``x`` zero-extended, computed from the N live samples.
    ``keep`` writes only bins ``[0, keep)``.  ``max_radix`` 4 (radix-4
    stages, one radix-2 step) or 2 (radix-2 only).
    """
    _check_input(x, "fft_stockham")
    _check_radix(max_radix)
    rows, n_in = x.shape
    n = _fft_len(n_in, pad_to, inverse, "fft_stockham")
    k = n if keep is None else keep
    if not 1 <= k <= n:
        raise ValueError(f"keep must be in [1, {n}], got {keep}")
    if x.device.type == "cpu" and not is_fake(x):
        return _traced("fft_stockham", x, ref.fft_stockham(
            x, inverse=inverse, pad_to=pad_to, max_radix=max_radix,
            keep=keep), n, inverse)
    out = torch.empty((rows, k), dtype=ref._cdt(ref._rdt(x)),
                      device=x.device)
    if rows and not is_fake(x):
        _launch("fft_stockham", x, out, n, inverse, max_radix, 0, k)
    return _traced("fft_stockham", x, out, n, inverse)


def fft_stockham_scale(x, g, start=0, pad_to=None, max_radix=4):
    """Forward FFT of ``x`` (rows, N) fused with the Green multiply:
    returns complex (rows, k), bins ``[start, start+k)`` of the spectrum
    times ``g`` (grows, k), row ``r`` taking Green row ``r % grows``.
    Composes with ``pad_to = 2N``."""
    _check_input(x, "fft_stockham_scale")
    _check_radix(max_radix)
    rows, n_in = x.shape
    n = _fft_len(n_in, pad_to, False, "fft_stockham_scale")
    _check_plane(g, x, "fft_stockham_scale", "g")
    if g.ndim != 2:
        raise ValueError(f"fft_stockham_scale: g must be 2-D, got "
                         f"{tuple(g.shape)}")
    grows, k = g.shape
    if grows < 1 or rows % grows or start < 0 or start + k > n or k < 1:
        raise ValueError(f"fft_stockham_scale: rows={rows}, g={grows}x{k}, "
                         f"start={start}, n_fft={n} do not fit")
    if x.device.type == "cpu" and not is_fake(x):
        return _traced("fft_stockham_scale", x, ref.fft_stockham_scale(
            x, g, start=start, pad_to=pad_to, max_radix=max_radix), n)
    out = torch.empty((rows, k), dtype=ref._cdt(ref._rdt(x)),
                      device=x.device)
    if rows and not is_fake(x):
        _launch("fft_stockham_scale", x, out, n, False, max_radix, start, k,
                g=g, grows=grows)
    return _traced("fft_stockham_scale", x, out, n)


def fft_stockham_twiddle(x, a, b, start=0, pad_to=None, max_radix=4):
    """Forward FFT of ``x`` (rows, N) fused with the DCT/DST post-twiddle:
    returns the real (rows, k) ``a * Re(F) + b * Im(F)`` over bins
    ``[start, start+k)``, with ``a``/``b`` real (k,) tables of ``x``'s
    precision.  The complex spectrum never reaches memory.  Composes with
    ``pad_to = 2N``."""
    _check_input(x, "fft_stockham_twiddle")
    _check_radix(max_radix)
    rows, n_in = x.shape
    n = _fft_len(n_in, pad_to, False, "fft_stockham_twiddle")
    for name, t in (("a", a), ("b", b)):
        _check_plane(t, x, "fft_stockham_twiddle", name)
    if a.ndim != 1 or a.shape != b.shape:
        raise ValueError(f"fft_stockham_twiddle: a and b must be (k,), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    k = a.shape[0]
    if k < 1 or start < 0 or start + k > n:
        raise ValueError(f"fft_stockham_twiddle: bins [{start}, "
                         f"{start + k}) do not fit n_fft={n}")
    if x.device.type == "cpu" and not is_fake(x):
        return _traced("fft_stockham_twiddle", x, ref.fft_stockham_twiddle(
            x, a, b, start=start, pad_to=pad_to, max_radix=max_radix), n)
    out = torch.empty((rows, k), dtype=ref._rdt(x), device=x.device)
    if rows and not is_fake(x):
        _launch("fft_stockham_twiddle", x, out, n, False, max_radix, start,
                k, a=a, b=b)
    return _traced("fft_stockham_twiddle", x, out, n)
