"""The port's kernels, through their wrappers on CPU tensors (which run the
plain PyTorch versions, the kernels' arithmetic stage for stage), against the
reference's Pallas kernels in interpret mode on the same numpy inputs.

Tolerances: float64 rtol 1e-10 (atol 1e-10 * sqrt(n) for FFTs); float32 as
``tests/test_kernels.py`` holds the Pallas kernels: rtol 1e-4 and atol
1e-3 * sqrt(n) for the FFT, rtol 2e-6 for the scale and the twiddle
pack.  The port's twiddles
are float64 values cast once, the reference's float32 angle arithmetic;
both sit far inside these bounds.
"""
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import fft_stockham as rk
from repro.kernels.spectral_scale import spectral_scale as r_spectral_scale
from repro.kernels.twiddle_pack import twiddle_pack as r_twiddle_pack
from repro_torch.kernels import LAUNCHES, TWO_PASS, reset_launches
from repro_torch.kernels._build import CLUSTER
from repro_torch.kernels import fft_stockham as tk
from repro_torch.kernels import ref as tref
from repro_torch.kernels.spectral_scale import spectral_scale
from repro_torch.kernels.twiddle_pack import twiddle_pack


def _tol(dtype, n=None):
    if dtype == np.float64:
        return dict(rtol=1e-10, atol=1e-10 * math.sqrt(n or 1))
    if n is None:
        return dict(rtol=2e-6, atol=1e-6)
    return dict(rtol=1e-4, atol=1e-3 * math.sqrt(n))


def _planes(rng, shape, dtype):
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def _cplx(re, im):
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im))


def _assert_pair(got, want_re, want_im, **tol):
    np.testing.assert_allclose(got.real.numpy(), np.asarray(want_re), **tol)
    np.testing.assert_allclose(got.imag.numpy(), np.asarray(want_im), **tol)


@pytest.mark.parametrize("mode", ["forward", "inverse", "pad_to"])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("n,batch", [(8, 1), (16, 13), (64, 8), (128, 13),
                                     (256, 1), (1024, 8)])
def test_fft_stockham_matches_pallas(n, batch, radix, mode):
    rng = np.random.default_rng(n + batch)
    n_in = n // 2 if mode == "pad_to" else n
    re, im = _planes(rng, (batch, n_in), np.float32)
    kw = dict(inverse=mode == "inverse",
              pad_to=n if mode == "pad_to" else None, max_radix=radix)
    want_re, want_im = rk.fft_stockham(jnp.asarray(re), jnp.asarray(im),
                                       **kw)
    got = tk.fft_stockham(_cplx(re, im), **kw)
    assert got.dtype == torch.complex64 and got.shape == (batch, n)
    _assert_pair(got, want_re, want_im, **_tol(np.float32, n))


@pytest.mark.parametrize("mode", ["forward", "inverse", "pad_to"])
@pytest.mark.parametrize("n", [8, 32, 512])
def test_fft_stockham_float64_matches_numpy(n, mode):
    """The plain version is exact to float64 roundoff on every mode (the
    Pallas float32 comparisons above cannot see below 1e-4)."""
    rng = np.random.default_rng(n)
    n_in = n // 2 if mode == "pad_to" else n
    re, im = _planes(rng, (5, n_in), np.float64)
    x = re + 1j * im
    if mode == "inverse":
        want = np.fft.ifft(x, axis=-1)
    else:
        want = np.fft.fft(x, n=n, axis=-1)
    for radix in (2, 4):
        got = tk.fft_stockham(_cplx(re, im), inverse=mode == "inverse",
                              pad_to=n if mode == "pad_to" else None,
                              max_radix=radix)
        assert got.dtype == torch.complex128
        np.testing.assert_allclose(got.numpy(), want, **_tol(np.float64, n))


# every one-pass length: the CUDA core's pass plan (radix-16 passes, then
# a radix-8, -4 or -2 pass; every pass radix 2 at max_radix 2) differs
# from one length to the next, and the plain version runs its stages
ONE_PASS_LENGTHS = [2 ** e for e in range(1, 13)]


@pytest.mark.parametrize("n", ONE_PASS_LENGTHS)
def test_fft_stockham_every_length_float64_matches_numpy(n):
    """Forward, inverse, pruned ``pad_to`` and a kept-bin window, radix 4
    and 2, exact to float64 roundoff at every power-of-two length the
    kernel takes in one pass."""
    rng = np.random.default_rng(7 * n)
    re, im = _planes(rng, (3, n), np.float64)
    x = re + 1j * im
    tol = _tol(np.float64, n)
    h = np.ascontiguousarray(x[:, :n // 2])
    for radix in (2, 4):
        got = tk.fft_stockham(_cplx(re, im), max_radix=radix)
        np.testing.assert_allclose(got.numpy(), np.fft.fft(x), **tol)
        got = tk.fft_stockham(_cplx(re, im), inverse=True, max_radix=radix,
                              keep=n // 2 + 1)
        np.testing.assert_allclose(got.numpy(),
                                   np.fft.ifft(x)[:, :n // 2 + 1], **tol)
        got = tk.fft_stockham(torch.from_numpy(h), pad_to=n,
                              max_radix=radix)
        np.testing.assert_allclose(got.numpy(), np.fft.fft(h, n=n), **tol)
        got = tk.fft_stockham(torch.from_numpy(re), max_radix=radix,
                              keep=n // 2 + 1)
        np.testing.assert_allclose(got.numpy(), np.fft.rfft(re), **tol)


@pytest.mark.parametrize("n", [n for n in ONE_PASS_LENGTHS if n <= 1024])
def test_fft_stockham_every_length_matches_pallas(n):
    """The plain version against the Pallas kernel in interpret mode at
    every length up to 1024 (float32 tolerances): forward, inverse and
    pruned ``pad_to``, radix 4 and 2."""
    rng = np.random.default_rng(11 * n)
    for mode in ("forward", "inverse", "pad_to"):
        n_in = n // 2 if mode == "pad_to" else n
        re, im = _planes(rng, (5, n_in), np.float32)
        for radix in (2, 4):
            kw = dict(inverse=mode == "inverse",
                      pad_to=n if mode == "pad_to" else None,
                      max_radix=radix)
            want_re, want_im = rk.fft_stockham(jnp.asarray(re),
                                               jnp.asarray(im), **kw)
            got = tk.fft_stockham(_cplx(re, im), **kw)
            assert got.shape == (5, n)
            _assert_pair(got, want_re, want_im, **_tol(np.float32, n))


def test_fft_stockham_real_input_and_keep():
    """A real input stands for a zero imaginary plane; ``keep`` returns
    the head of the spectrum."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 32))
    got = tk.fft_stockham(torch.from_numpy(x), pad_to=64, keep=33)
    np.testing.assert_allclose(got.numpy(), np.fft.rfft(x, n=64, axis=-1),
                               **_tol(np.float64, 64))
    got = tk.fft_stockham(torch.from_numpy(x), inverse=True, keep=5)
    np.testing.assert_allclose(got.numpy(), np.fft.ifft(x, axis=-1)[:, :5],
                               **_tol(np.float64, 32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("rows,grows,n,start,k", [
    (16, 16, 32, 0, 32),       # full spectrum, one Green row per row
    (24, 8, 64, 0, 33),        # grows < rows: 3 batch rows share a plane
    (12, 4, 16, 3, 10),        # an interior bin window
])
def test_fft_stockham_scale_matches_pallas(rows, grows, n, start, k, pad,
                                           dtype):
    rng = np.random.default_rng(rows + n)
    n_in = n // 2 if pad else n
    re, im = _planes(rng, (rows, n_in), dtype)
    g = rng.standard_normal((grows, k)).astype(dtype)
    pad_to = n if pad else None
    want_re, want_im = rk.fft_stockham_scale(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(g), start=start,
        pad_to=pad_to)
    got = tk.fft_stockham_scale(_cplx(re, im), torch.from_numpy(g),
                                start=start, pad_to=pad_to)
    assert got.shape == (rows, k)
    _assert_pair(got, want_re, want_im, **_tol(dtype, n))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(8, 128), (32, 256), (129, 384),
                                   (7, 130), (3, 16, 256)])
def test_spectral_scale_matches_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    re, im = _planes(rng, shape, dtype)
    g = rng.standard_normal(shape[-2:]).astype(dtype)
    want_re, want_im = r_spectral_scale(jnp.asarray(re), jnp.asarray(im),
                                        jnp.asarray(g), 0.37)
    got = spectral_scale(_cplx(re, im), torch.from_numpy(g), 0.37)
    assert got.shape == shape
    _assert_pair(got, want_re, want_im, **_tol(dtype))
    got_real = spectral_scale(torch.from_numpy(re), torch.from_numpy(g),
                              0.37)
    np.testing.assert_allclose(got_real.numpy(), np.asarray(want_re),
                               **_tol(dtype))


# -- rows longer than ONE_PASS_N: the cluster and two-pass tiers ------------

def test_two_pass_limits():
    assert tk.ONE_PASS_N == tref.ONE_PASS_N == 4096
    assert tk.CLUSTER_N == 16 * 4096
    assert tk.MAX_N == 2 ** 24


@pytest.mark.parametrize("n,tier", [
    (2, "one_pass"), (4096, "one_pass"), (8192, "cluster"),
    (16384, "cluster"), (32768, "cluster"), (65536, "cluster"),
    (131072, "two_pass"), (2 ** 24, "two_pass")])
def test_fft_stockham_path(n, tier):
    """The kernel's tier by row length, the same in both precisions: one
    block up to 4096 points, a cluster of N / 4096 <= 16 blocks up to
    65536, two passes above."""
    assert tk.path(n) == tier


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", [2 ** e for e in range(13, 21)])
def test_row_table_is_the_long_table_at_stride(n, cdtype):
    """The 4096-point rows of a long row read ``ONE_PASS_N``'s own table,
    stored after the length-N one; the plain version reads the length-N
    table at stride N / 4096.  The two agree bit for bit (both are the
    same float64 quotient scaled by a power of two, then cast once).  The
    inter-pass twiddles follow, ``W_N^(n2 k1)`` at ``k1 * 4096 + n2``."""
    cpu = torch.device("cpu")
    long = tref.twiddles(n, cdtype, cpu)
    row = tref.twiddles(4096, cdtype, cpu)
    assert torch.equal(row, long[::n // 4096])
    table = tk.kernel_twiddles(n, cdtype, cpu)
    assert table.shape == (2 * n + 4096,)
    assert torch.equal(table[:n], long)
    assert torch.equal(table[n:n + 4096], row)
    n1 = n // 4096
    inter = table[n + 4096:].reshape(n1, 4096)
    for k1 in {0, 1, n1 // 2, n1 - 1}:
        assert torch.equal(inter[k1], long[torch.arange(4096) * k1])
    assert torch.equal(tk.kernel_twiddles(4096, cdtype, cpu),
                       tref.twiddles(4096, cdtype, cpu))


@pytest.mark.parametrize("dtype,n,mode", [
    *((np.float64, n, mode) for n in (8192, 16384)
      for mode in ("forward", "inverse", "pad_to", "real_keep")),
    (np.float32, 8192, "forward"), (np.float32, 8192, "pad_to")])
def test_fft_stockham_two_pass_matches_pallas(dtype, n, mode):
    """Lengths above 4096 take the four-step split (N1 = N / 4096 point
    column FFTs, the inter-pass twiddle, 4096-point row FFTs), on a
    cluster up to 32768 points and in two passes above; the Pallas kernel
    runs them in one.  ``real_keep`` is the pruned rfft of the (U,U,U)
    forward: a real input, ``pad_to = 2N``, bins ``[0, N/2+1)``."""
    rng = np.random.default_rng(n + len(mode))
    n_in = n // 2 if mode in ("pad_to", "real_keep") else n
    re, im = _planes(rng, (3, n_in), dtype)
    kw = dict(inverse=mode == "inverse",
              pad_to=n if mode in ("pad_to", "real_keep") else None)
    if mode == "real_keep":
        im = np.zeros_like(re)
    want_re, want_im = rk.fft_stockham(jnp.asarray(re), jnp.asarray(im),
                                       **kw)
    if mode == "real_keep":
        got = tk.fft_stockham(torch.from_numpy(re), keep=n // 2 + 1, **kw)
        want_re, want_im = (np.asarray(w)[:, :n // 2 + 1]
                            for w in (want_re, want_im))
    else:
        got = tk.fft_stockham(_cplx(re, im), **kw)
    _assert_pair(got, want_re, want_im, **_tol(dtype, n))


@pytest.mark.parametrize("n", [8192, 16384])
@pytest.mark.parametrize("start", [0, 1])
def test_fft_stockham_scale_two_pass_matches_pallas(n, start):
    """The Green epilogue on the row pass: bin ``f = k1 + N1 k2`` of kernel
    row ``(r, k1)`` takes ``g[r % grows, f - start]``.  ``start`` 0 is the
    pruned half spectrum of a fused rfft x Green; ``start`` 1 an interior
    window of a full spectrum."""
    rng = np.random.default_rng(n + start)
    pad = start == 0
    n_in = n // 2 if pad else n
    k = n // 2 + 1 if pad else n - 1
    re, im = _planes(rng, (4, n_in), np.float64)
    g = rng.standard_normal((2, k))
    pad_to = n if pad else None
    want_re, want_im = rk.fft_stockham_scale(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(g), start=start,
        pad_to=pad_to)
    got = tk.fft_stockham_scale(_cplx(re, im), torch.from_numpy(g),
                                start=start, pad_to=pad_to)
    assert got.shape == (4, k)
    _assert_pair(got, want_re, want_im, **_tol(np.float64, n))


@pytest.mark.parametrize("n", [8192, 16384])
@pytest.mark.parametrize("window", ["dct2", "dct1", "dst2"])
def test_fft_stockham_twiddle_two_pass_matches_pallas(n, window):
    """The r2r windows on the row pass: DCT-I and DST-II read the Nyquist
    bin f = N/2, which lies in kernel row k1 = 0 (N1 even)."""
    start, k = {"dct2": (0, n // 2), "dct1": (0, n // 2 + 1),
                "dst2": (1, n // 2)}[window]
    rng = np.random.default_rng(n + k + start)
    pad = window == "dct2"
    x = rng.standard_normal((3, n // 2 if pad else n))
    a, b = (rng.standard_normal(k) for _ in range(2))
    kw = dict(start=start, pad_to=n if pad else None)
    want = rk.fft_stockham_twiddle(jnp.asarray(x), jnp.zeros_like(x),
                                   jnp.asarray(a), jnp.asarray(b), **kw)
    got = tk.fft_stockham_twiddle(*(torch.from_numpy(v) for v in (x, a, b)),
                                  **kw)
    assert got.shape == (3, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(np.float64, n))


@pytest.mark.parametrize("n", [2 ** 13, 2 ** 14, 2 ** 15, 2 ** 17, 2 ** 18])
@pytest.mark.parametrize("radix", [2, 4])
def test_fft_stockham_two_pass_float64_matches_numpy(n, radix):
    """Forward, inverse and pruned FFTs above 4096 points exact to float64
    roundoff: cluster lengths (N1 = 2, 4, 8 point column FFTs) and two
    passes at N1 = 32 and 64."""
    rng = np.random.default_rng(n + radix)
    re, im = _planes(rng, (2, n), np.float64)
    x = re + 1j * im
    tol = _tol(np.float64, n)
    got = tk.fft_stockham(_cplx(re, im), max_radix=radix)
    np.testing.assert_allclose(got.numpy(), np.fft.fft(x), **tol)
    got = tk.fft_stockham(_cplx(re, im), inverse=True, max_radix=radix)
    np.testing.assert_allclose(got.numpy(), np.fft.ifft(x), **tol)
    h = _cplx(re[:, :n // 2].copy(), im[:, :n // 2].copy())
    got = tk.fft_stockham(h, pad_to=n, max_radix=radix)
    np.testing.assert_allclose(got.numpy(), np.fft.fft(x[:, :n // 2], n=n),
                               **tol)


# -- spectral_scale: the batched contract the kernel's batch loop keeps -------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("plane", [(8, 128), (7, 130), (129, 384)])
def test_spectral_scale_batched_matches_pallas(plane, batch, dtype):
    """(B, rows, lanes) fields over one shared (rows, lanes) plane, complex
    and real, on aligned and ragged planes (a ragged real float32 plane
    leaves each batch entry at another 16-byte phase)."""
    rng = np.random.default_rng(batch * 1000 + plane[1])
    re, im = _planes(rng, (batch,) + plane, dtype)
    g = rng.standard_normal(plane).astype(dtype)
    want_re, want_im = r_spectral_scale(jnp.asarray(re), jnp.asarray(im),
                                        jnp.asarray(g), 1.7)
    got = spectral_scale(_cplx(re, im), torch.from_numpy(g), 1.7)
    assert got.shape == (batch,) + plane
    _assert_pair(got, want_re, want_im, **_tol(dtype))
    got_real = spectral_scale(torch.from_numpy(re), torch.from_numpy(g), 1.7)
    np.testing.assert_allclose(got_real.numpy(), np.asarray(want_re),
                               **_tol(dtype))


def test_cpu_calls_count_no_launch():
    reset_launches()
    x = torch.zeros((2, 8), dtype=torch.complex64)
    tk.fft_stockham(x)
    tk.fft_stockham_scale(x, torch.ones((2, 8)))
    spectral_scale(x, torch.ones((2, 8)))
    tk.fft_stockham_twiddle(x, torch.ones(4), torch.ones(4))
    twiddle_pack(x, torch.ones(8), torch.ones(8))
    tk.fft_stockham(torch.zeros((1, 8192), dtype=torch.complex64))
    tk.fft_stockham(torch.zeros((1, 65536), dtype=torch.complex64))
    assert LAUNCHES == {"fft_stockham": 0, "fft_stockham_scale": 0,
                        "spectral_scale": 0, "twiddle_pack": 0,
                        "fft_stockham_twiddle": 0}
    assert not any(CLUSTER.values())
    assert not any(TWO_PASS.values())


@pytest.mark.parametrize("n", [65536, 131072])
def test_cpu_long_rows_count_no_launch(n):
    """A 65536-point row (a 16-block cluster on the card) and a
    131072-point one (two passes) run the plain version on CPU tensors and
    count nothing, through every wrapper."""
    reset_launches()
    x = torch.zeros((1, n // 2), dtype=torch.complex64)
    tk.fft_stockham(x, pad_to=n)
    tk.fft_stockham_scale(x, torch.ones((1, n // 2 + 1)), pad_to=n)
    tk.fft_stockham_twiddle(torch.zeros((1, n // 2)), torch.ones(n // 2),
                            torch.ones(n // 2), pad_to=n)
    assert not any(LAUNCHES.values())
    assert not any(CLUSTER.values())
    assert not any(TWO_PASS.values())


@pytest.mark.parametrize("bad", ["strided", "dtype", "too_long", "not_pow2",
                                 "pad_inverse", "pad_len", "rank"])
def test_fft_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((4, 16), dtype=torch.complex64)
    kw = {}
    if bad == "strided":
        x = torch.zeros((4, 32), dtype=torch.complex64)[:, ::2]
    elif bad == "dtype":
        x = torch.zeros((4, 16), dtype=torch.float16)
    elif bad == "too_long":
        # 2^25 points: refused before a byte is read, so left uninitialized
        x = torch.empty((1, 2 * tk.MAX_N), dtype=torch.complex64)
    elif bad == "not_pow2":
        x = torch.zeros((4, 12), dtype=torch.complex64)
    elif bad == "pad_inverse":
        kw = dict(pad_to=32, inverse=True)
    elif bad == "pad_len":
        kw = dict(pad_to=64)
    elif bad == "rank":
        x = torch.zeros((2, 4, 16), dtype=torch.complex64)
    with pytest.raises((ValueError, TypeError)):
        tk.fft_stockham(x, **kw)


def test_scale_wrappers_reject_mismatched_green():
    x = torch.zeros((6, 16), dtype=torch.complex64)
    with pytest.raises(ValueError):      # rows % grows != 0
        tk.fft_stockham_scale(x, torch.ones((4, 16)))
    with pytest.raises(ValueError):      # float64 plane for complex64 data
        tk.fft_stockham_scale(x, torch.ones((6, 16), dtype=torch.float64))
    with pytest.raises(ValueError):      # plane shape differs
        spectral_scale(x, torch.ones((6, 8)))
    with pytest.raises(ValueError):      # strided field
        spectral_scale(torch.zeros((6, 32), dtype=torch.complex64)[:, ::2],
                       torch.ones((6, 16)))


def test_twiddle_table_is_the_forward_root_of_unity():
    w = tref.twiddles(16, torch.complex128, torch.device("cpu"))
    np.testing.assert_allclose(w.numpy(),
                               np.exp(-2j * np.pi * np.arange(16) / 16),
                               rtol=0, atol=1e-15)


# -- fft_stockham_twiddle and twiddle_pack ----------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("window", ["dct2", "dct1", "dst2"])
@pytest.mark.parametrize("n,batch", [(8, 1), (64, 13), (512, 13)])
def test_fft_stockham_twiddle_matches_pallas(n, batch, window, radix, pad,
                                             dtype):
    """Bin windows of the three fused r2r kinds: DCT-II keeps [0, N/2),
    DCT-I [0, N/2+1) (up to the Nyquist bin), DST-II [1, N/2+1)."""
    start, k = {"dct2": (0, n // 2), "dct1": (0, n // 2 + 1),
                "dst2": (1, n // 2)}[window]
    rng = np.random.default_rng(n + k + start)
    x = rng.standard_normal((batch, n // 2 if pad else n)).astype(dtype)
    a, b = (rng.standard_normal(k).astype(dtype) for _ in range(2))
    kw = dict(start=start, pad_to=n if pad else None, max_radix=radix)
    want = rk.fft_stockham_twiddle(jnp.asarray(x), jnp.zeros_like(x),
                                   jnp.asarray(a), jnp.asarray(b), **kw)
    t = [torch.from_numpy(v) for v in (x, a, b)]
    got = tk.fft_stockham_twiddle(*t, **kw)
    assert got.dtype == t[0].dtype and got.shape == (batch, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(dtype, n))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(8, 128), (64, 257), (5, 96)])
def test_twiddle_pack_matches_pallas(shape, dtype):
    rng = np.random.default_rng(shape[1])
    re, im = _planes(rng, shape, dtype)
    a, b = (rng.standard_normal(shape[1]).astype(dtype) for _ in range(2))
    want = r_twiddle_pack(jnp.asarray(re), jnp.asarray(im), jnp.asarray(a),
                          jnp.asarray(b))
    got = twiddle_pack(_cplx(re, im), torch.from_numpy(a),
                       torch.from_numpy(b))
    assert got.shape == shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dtype))


@pytest.mark.parametrize("start", [0, 1])
def test_twiddle_pack_reads_a_strided_window(start):
    """The unfused r2r path packs ``f[:, start:start+k]`` of a contiguous
    half spectrum: the wrapper takes the window as it lies (row pitch
    k+1), with no copy, and matches the Pallas kernel on the copied
    window."""
    rng = np.random.default_rng(start)
    re, im = _planes(rng, (6, 13), np.float64)
    f = _cplx(re, im)
    win = f[:, start:start + 12]
    assert not win.is_contiguous() and win.stride() == (13, 1)
    a, b = (rng.standard_normal(12) for _ in range(2))
    want = r_twiddle_pack(jnp.asarray(re[:, start:start + 12]),
                          jnp.asarray(im[:, start:start + 12]),
                          jnp.asarray(a), jnp.asarray(b))
    got = twiddle_pack(win, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(np.float64))


@pytest.mark.parametrize("bad", ["real", "conj", "rank", "last_stride",
                                 "table_len", "table_dtype"])
def test_twiddle_pack_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((4, 8), dtype=torch.complex64)
    a = b = torch.ones(8)
    if bad == "real":
        x = torch.zeros((4, 8))
    elif bad == "conj":
        x = x.conj()
    elif bad == "rank":
        x = torch.zeros((2, 4, 8), dtype=torch.complex64)
    elif bad == "last_stride":
        x = torch.zeros((4, 16), dtype=torch.complex64)[:, ::2]
    elif bad == "table_len":
        a = torch.ones(7)
    elif bad == "table_dtype":
        a = torch.ones(8, dtype=torch.float64)
    with pytest.raises((ValueError, TypeError)):
        twiddle_pack(x, a, b)


@pytest.mark.parametrize("bad", ["window", "table_shape", "table_dtype"])
def test_fft_twiddle_wrapper_rejects_bad_tables(bad):
    x = torch.zeros((4, 16))
    a = b = torch.ones(9)
    start = 0
    if bad == "window":
        start = 8
    elif bad == "table_shape":
        b = torch.ones(8)
    elif bad == "table_dtype":
        a = b = torch.ones(9, dtype=torch.float64)
    with pytest.raises(ValueError):
        tk.fft_stockham_twiddle(x, a, b, start=start)
