"""The Stockham kernel's CUDA source, run on the CPU by
``tools/emulate_stockham.py`` (every CUDA thread a host thread, compiled
with ``g++``), bit for bit against ``kernels/ref.py`` on the short tier's
rows: 2 to 128 points, float32 and float64.

Each length runs every mode of the harness: the forward, the inverse,
the pruned forward (``pad_to = 2n``) and the pruned inverse's kept head,
real inputs with ``keep`` (pruned and not), radix 2 and 4, the Green
epilogue (a plane of ``grows < rows`` rows, ``start`` 0 and 1), the
twiddle epilogue (DCT-II, DCT-I and DST-II windows), and inputs one
element off 16-byte alignment; on 257 rows or 3000 (at most 48000
points), which are no multiple of a row-block's rows and span several
of the emulated card's persistent blocks.  The host
compiler contracts no multiply-add, so the kernel's arithmetic must
equal the plain version's exactly.  Skips only where ``g++`` is absent.
"""
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _harness():
    spec = importlib.util.spec_from_file_location(
        "emulate_stockham", ROOT / "tools" / "emulate_stockham.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


em = _harness()


@pytest.fixture(scope="module")
def fns(tmp_path_factory):
    """The emulated kernel's entry points, built once for the module."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the CUDA source cannot be emulated")
    return em.bind(em.build(tmp_path_factory.mktemp("emulated")))


@pytest.mark.parametrize("rdt", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("n", em.SHORT_LENGTHS)
def test_short_rows_bit_equal_to_plain(fns, n, rdt):
    rng = np.random.default_rng(n)
    todo = em.cases(n, rdt, rng)
    labels = {label for label, _ in todo}
    assert {"inverse", "pruned forward", "real pruned keep",
            "Green, start 1", "twiddle DST-II",
            "misaligned real pruned keep"} <= labels
    bad = []
    for label, kw in todo:
        same, err, d = em.run_case(fns, n, kw)
        if not same:
            bad.append(f"{label} (rows {kw['x'].shape[0]}): error {err}, "
                       f"max |d| {d:.3e}")
    assert not bad, f"N={n} {rdt}: " + "; ".join(bad)
