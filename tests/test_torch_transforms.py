"""The port's eight real-to-real transforms (``core/transforms``) against
``repro.core.transforms`` and ``scipy.fft`` on the same numpy inputs, with
leading batch axes, on both port engines ("cuda" runs the kernels' plain
versions on the CPU: the fused ``fft_stockham_twiddle`` on power-of-two
extensions, ``twiddle_pack`` after ``torch.fft`` elsewhere).

Bounds: float64 |got - want| <= 1e-12 max|want|; float32 the FFT bound of
``tests/test_kernels.py``, rtol 1e-4 and atol 1e-3 sqrt(n) with n the
length of the FFT the transform runs.
"""
import math

import numpy as np
import pytest
import scipy.fft as sfft
import jax.numpy as jnp
import torch

from repro.core import transforms as rtr
from repro.core.bc import TransformKind as RK
from repro.core.engine import TransformEngine as REngine
from repro_torch.core import transforms as ttr
from repro_torch.core.bc import INVERSE_KIND, TransformKind as TK
from repro_torch.core.engine import TransformEngine

KINDS = [k for k in TK if k not in (TK.DFT_R2C, TK.DFT_C2C)]
LEAD = (2, 3)
# odd, even and power-of-two lengths: powers of two (and 7, 9, 15, 31 for
# dst1/dct1, whose FFTs are m+1 and 2(m-1) long) take the fused kernel on
# the cuda engine, the others torch.fft + twiddle_pack
LENGTHS = [3, 4, 5, 7, 8, 9, 12, 15, 16, 31, 32, 33, 64, 96, 128, 129]
PORT_ENGINES = [TransformEngine("torch"), TransformEngine("cuda")]


def _scipy(kind, x):
    name, t = kind.name[:3].lower(), int(kind.name[3])
    return (sfft.dct if name == "dct" else sfft.dst)(x, type=t, axis=-1,
                                                     norm=None)


def _assert_close(got, want, dtype, kind, m):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    assert tuple(got.shape) == want.shape
    if dtype == np.float64:
        bound = 1e-12 * np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= bound
    else:
        n = ttr.fft_length(kind, m)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-3 * math.sqrt(n))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", LENGTHS)
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.name)
def test_r2r_matches_reference_and_scipy(kind, m, dtype):
    rng = np.random.default_rng(m)
    x = rng.standard_normal(LEAD + (m,)).astype(dtype)
    fwd_ref = rtr.r2r_forward(jnp.asarray(x), RK(kind.value))
    bwd_ref = rtr.r2r_backward(jnp.asarray(x), RK(kind.value))
    fwd_sp = _scipy(kind, x.astype(np.float64)).astype(dtype)
    bwd_sp = _scipy(INVERSE_KIND[kind], x.astype(np.float64)).astype(dtype)
    for engine in PORT_ENGINES:
        fwd = ttr.r2r_forward(torch.from_numpy(x), kind, engine=engine)
        bwd = ttr.r2r_backward(torch.from_numpy(x), kind, engine=engine)
        _assert_close(fwd, fwd_ref, dtype, kind, m)
        _assert_close(bwd, bwd_ref, dtype, kind, m)
        _assert_close(fwd, fwd_sp, dtype, kind, m)
        _assert_close(bwd, bwd_sp, dtype, kind, m)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [7, 9, 12, 16])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.name)
def test_cuda_engine_matches_reference_pallas(kind, m, dtype):
    """The port's kernel path against the reference's Pallas path
    (interpret mode): m=16 runs the fused kernels (DCT-II/DST-II extension
    32, DCT-IV's half-length FFT 8), 9 the fused DCT-I (extension 16), 7
    the Stockham rfft of DST-I (length 8), 12 twiddle_pack after the
    library rfft."""
    rng = np.random.default_rng(m + 1)
    x = rng.standard_normal(LEAD + (m,)).astype(dtype)
    pallas = REngine("pallas")
    engine = TransformEngine("cuda")
    for fn_r, fn_t in ((rtr.r2r_forward, ttr.r2r_forward),
                       (rtr.r2r_backward, ttr.r2r_backward)):
        want = fn_r(jnp.asarray(x), RK(kind.value), engine=pallas)
        got = fn_t(torch.from_numpy(x), kind, engine=engine)
        _assert_close(got, want, dtype, kind, m)


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.name)
def test_round_trip_is_the_normfact(kind):
    """bwd(fwd(x)) = x / normfact on the cuda engine's kernel path."""
    m = 16
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(LEAD + (m,)))
    engine = TransformEngine("cuda")
    y = ttr.r2r_backward(ttr.r2r_forward(x, kind, engine=engine), kind,
                         engine=engine)
    torch.testing.assert_close(y * ttr.r2r_normfact(kind, m), x, rtol=0,
                               atol=1e-13)


def test_tables_are_cast_once_and_reused():
    t1 = ttr.device_tables(TK.DCT2, 16, torch.float32, torch.device("cpu"))
    t2 = ttr.device_tables(TK.DCT2, 16, torch.float32, torch.device("cpu"))
    assert t1 is t2 and t1["post_a"].dtype == torch.float32
    np.testing.assert_array_equal(
        t1["post_b"].numpy(),
        ttr.twiddle_tables(TK.DCT2, 16)["post_b"].astype(np.float32))


def test_prefix_sums_run_in_float64():
    """dst1 and odd-M dct4 accumulate an O(M) prefix sum: in float64 even
    for float32 data (the reference's scan dtype under x64), so the
    float32 result stays within a few ulps of float64's at M = 129."""
    x = np.random.default_rng(4).standard_normal((4, 129))
    for kind in (TK.DST1, TK.DCT4):
        y64 = ttr.r2r_forward(torch.from_numpy(x), kind).numpy()
        y32 = ttr.r2r_forward(torch.from_numpy(x.astype(np.float32)),
                              kind).numpy()
        assert np.abs(y32 - y64).max() < 1e-5 * np.abs(y64).max()


@pytest.mark.parametrize("kind,m,want", [
    (TK.DCT1, 9, 16), (TK.DST1, 7, 8), (TK.DCT2, 8, 16), (TK.DST3, 5, 10),
    (TK.DCT4, 16, 8), (TK.DST4, 7, 14),
])
def test_fft_length(kind, m, want):
    assert ttr.fft_length(kind, m) == want
