"""The port's ``kernels/ops`` wrappers and the DFT part of
``core/transforms`` against their reference counterparts (Pallas in
interpret mode for ``repro.kernels.ops``, XLA for
``repro.core.transforms``), float64, on the same numpy inputs, with
leading batch axes.  Bound: 1e-10 * sqrt(n), the float64 FFT tolerance."""
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import transforms as rtr
from repro.core.engine import as_engine as r_engine
from repro.kernels import ops as rops
from repro_torch.core import transforms as ttr
from repro_torch.core.engine import as_engine as t_engine
from repro_torch.kernels import ops as tops

LEAD = (2, 3)


def _tol(n):
    return dict(rtol=1e-10, atol=1e-10 * math.sqrt(n))


def _real(rng, n):
    return rng.standard_normal(LEAD + (n,))


def _cplx(rng, n):
    return (rng.standard_normal(LEAD + (n,))
            + 1j * rng.standard_normal(LEAD + (n,)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mode", ["forward", "inverse", "pad_to"])
@pytest.mark.parametrize("n", [8, 64])
def test_fft1d(n, mode):
    rng = np.random.default_rng(n)
    x = _cplx(rng, n // 2 if mode == "pad_to" else n)
    kw = dict(inverse=mode == "inverse",
              pad_to=n if mode == "pad_to" else None)
    want = rops.fft1d(jnp.asarray(x), **kw)
    got = tops.fft1d(_t(x), **kw)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(n))


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("n", [16, 128])
def test_rfft_kernel(n, pad):
    rng = np.random.default_rng(n)
    x = _real(rng, n // 2 if pad else n)
    pad_to = n if pad else None
    want = rops.rfft_pallas(jnp.asarray(x), pad_to=pad_to)
    got = tops.rfft_kernel(_t(x), pad_to=pad_to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(n))


@pytest.mark.parametrize("n", [16, 128])
def test_irfft_kernel(n):
    rng = np.random.default_rng(n)
    y = _cplx(rng, n // 2 + 1)
    want = rops.irfft_pallas(jnp.asarray(y), n)
    got = tops.irfft_kernel(_t(y), n)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(n))


@pytest.mark.parametrize("keep", [3, 8])
def test_ifft_and_irfft_pruned(keep):
    n2 = 16
    rng = np.random.default_rng(keep)
    y = _cplx(rng, n2)
    want = rops.ifft_pruned(jnp.asarray(y), keep)
    got = tops.ifft_pruned(_t(y), keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(n2))
    h = _cplx(rng, n2 // 2 + 1)
    want = rops.irfft_pruned(jnp.asarray(h), n2, keep)
    got = tops.irfft_pruned(_t(h), n2, keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(n2))


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("half", [False, True])
def test_fft_green(half, pad):
    n = 32
    rng = np.random.default_rng(int(half) + 2 * int(pad))
    n_in = n // 2 if pad else n
    x = _real(rng, n_in) if half else _cplx(rng, n_in)
    g = rng.standard_normal((3, n // 2 + 1 if half else n))
    pad_to = n if pad else None
    r_fn, t_fn = ((rops.rfft_green, tops.rfft_green) if half
                  else (rops.fft1d_green, tops.fft1d_green))
    want = r_fn(jnp.asarray(x), jnp.asarray(g), pad_to=pad_to)
    got = t_fn(_t(x), _t(g), pad_to=pad_to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(n))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("complex_field", [False, True])
def test_green_multiply(complex_field, batched):
    rng = np.random.default_rng(5)
    shp = (4, 6, 130)
    full = ((3,) if batched else ()) + shp
    f = rng.standard_normal(full)
    if complex_field:
        f = f + 1j * rng.standard_normal(full)
    g = rng.standard_normal(shp)
    want = rops.green_multiply(jnp.asarray(f), jnp.asarray(g), 0.5)
    got = tops.green_multiply(_t(f), _t(g), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=1e-14)


def test_green_multiply_takes_strided_fields():
    """The baseline pipeline hands the Green multiply a moved-axis view;
    the wrapper makes it contiguous for the kernel."""
    rng = np.random.default_rng(6)
    f = _t(_cplx(rng, 8)).movedim(-1, 0)          # (8, 2, 3), strided
    g = _t(rng.standard_normal((8, 2, 3)))
    got = tops.green_multiply(f, g)
    np.testing.assert_allclose(got.numpy(), f.numpy() * g.numpy(),
                               rtol=1e-15, atol=0)


# -- the r2r post-twiddle wrappers (twiddle_pack, fft_stockham_twiddle) ----

@pytest.mark.parametrize("start", [0, 1])
def test_post_twiddle_on_a_half_spectrum_window(start):
    """The unfused DCT-II / DST-II step: the window ``f[..., start:start+m]``
    of an rfft half spectrum with leading batch axes, read in place."""
    m = 12
    rng = np.random.default_rng(start)
    f = _t(_cplx(rng, m + 1))
    a, b = (rng.standard_normal(m) for _ in range(2))
    win = f[..., start:start + m]
    want = rops.post_twiddle(jnp.asarray(win.real.numpy()),
                             jnp.asarray(win.imag.numpy()), a, b)
    got = tops.post_twiddle(win, _t(a), _t(b))
    assert got.dtype == torch.float64 and tuple(got.shape) == LEAD + (m,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(m))


def test_dct2_post_twiddle():
    rng = np.random.default_rng(3)
    f = _cplx(rng, 10)
    want = rops.dct2_post_twiddle(jnp.asarray(f))
    got = tops.dct2_post_twiddle(_t(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(10))


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("start,k", [(0, 8), (0, 9), (1, 8)])
def test_rfft_twiddle(start, k, pad):
    n = 16
    rng = np.random.default_rng(k + start)
    x = _real(rng, n // 2 if pad else n)
    a, b = (rng.standard_normal(k) for _ in range(2))
    pad_to = n if pad else None
    want = rops.rfft_twiddle(jnp.asarray(x), a, b, start=start,
                             pad_to=pad_to)
    got = tops.rfft_twiddle(_t(x), _t(a), _t(b), start=start, pad_to=pad_to)
    assert tuple(got.shape) == LEAD + (k,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(n))


# -- core/transforms DFT part, both port engines against reference XLA ----

@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("n", [12, 16])
def test_transforms_dft_part(engine, n):
    """The engine-aware backends and the pruned variants; n=12 takes
    torch.fft on both engines, n=16 the kernels on "cuda"."""
    rng = np.random.default_rng(n)
    te, re_ = t_engine(engine), r_engine("xla")
    x, z = _real(rng, n), _cplx(rng, n)
    xh, zh = _real(rng, n // 2), _cplx(rng, n // 2)
    spec, half = _cplx(rng, n), _cplx(rng, n // 2 + 1)
    pairs = [
        (ttr._rfft(_t(x), te), rtr._rfft(jnp.asarray(x), re_)),
        (ttr._irfft(_t(half), n, te),
         rtr._irfft(jnp.asarray(half), n, re_)),
        (ttr._cfft(_t(z), te), rtr._cfft(jnp.asarray(z), re_)),
        (ttr._cfft(_t(x), te, inverse=True),
         rtr._cfft(jnp.asarray(x), re_, inverse=True)),
        (ttr._rfft_padded(_t(xh), n, te),
         rtr._rfft_padded(jnp.asarray(xh), n, re_)),
        (ttr._cfft_padded(_t(zh), n, te),
         rtr._cfft_padded(jnp.asarray(zh), n, re_)),
        (ttr._irfft_crop(_t(half), n, n // 2, te),
         rtr._irfft_crop(jnp.asarray(half), n, n // 2, re_)),
        (ttr._irfft_crop(_t(half), n, n // 2 + 1, te),
         rtr._irfft_crop(jnp.asarray(half), n, n // 2 + 1, re_)),
        (ttr._icfft_crop(_t(spec), n // 2, te),
         rtr._icfft_crop(jnp.asarray(spec), n // 2, re_)),
        (ttr._zpad(_t(xh), n), rtr._zpad(jnp.asarray(xh), n)),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **_tol(n))


def test_twiddle_tables_and_normfact_match_reference():
    from repro.core.bc import TransformKind as RK
    from repro_torch.core.bc import TransformKind as TK
    for kind in TK:
        if kind in (TK.DFT_R2C, TK.DFT_C2C):
            continue
        rk = RK(kind.value)
        for m in (7, 8):
            want = rtr.twiddle_tables(rk, m)
            got = ttr.twiddle_tables(kind, m)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
            assert ttr.r2r_normfact(kind, m) == rtr.r2r_normfact(rk, m)
