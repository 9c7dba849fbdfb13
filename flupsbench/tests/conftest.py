"""Fixtures of the benchmark's own tests (``python -m pytest flupsbench/tests``
from the root of the repository): a small copy of the benchmark, and the
look for a card, made inside a fixture."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the grid of the copies: n = 16 cells a direction
SMALL_N = 16


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is there."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)


def small_copy(dest: Path, n: int = SMALL_N) -> Path:
    """A copy of ``BENCHMARK.json`` and ``flupsbench/``'s data files with
    every configuration at ``n`` cells a direction, and a four-rank cell,
    ``poisson_node.dist4`` (``flups_poisson`` under ``traffic/dist4.json``),
    beside the benchmark's own."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "poisson_node.dist4", "chips": 4,
                              "config": "flups_poisson", "traffic": "dist4",
                              "why": "four ranks, mesh (2, 2)"})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copytree(ROOT / "flupsbench", dest / "flupsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dest / "flupsbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["n"] = n
        f.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def small(tmp_path) -> Path:
    return small_copy(tmp_path)
