"""A short run of each one-card cell on the card, read as the contract
reads its last line (``python -m pytest -m chip flupsbench/tests`` on a
machine with a card)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from flupsbench import catalog
from flupsbench.tests.conftest import ROOT


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["poisson_node.step",
                                      "periodic_cell.step"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, workload, trace):
    cell = catalog.cell(workload)
    out = subprocess.run(
        [sys.executable, "flupsbench/run.py", "--workload", workload,
         "--seed", "2147483700", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
    assert list(res)[-1] == "checks"
