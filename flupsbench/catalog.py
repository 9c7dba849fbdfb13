"""Find the benchmark's parts by the names ``BENCHMARK.json`` gives.

* a cell (``workloads`` entry) names its configuration and its traffic;
* a configuration is the JSON file its ``configs`` entry names;
* a traffic mix is ``traffic/<name>.json``;
* a metric (end-to-end or per-layer) is read by ``metrics/<name>.py``,
  whose ``read(run)`` returns a number or None (nothing to read);
* a plain reference is ``references/<name>.py``, named by the
  configuration's ``"reference"`` key.

So a later cell, configuration, mix or metric is a new file and a new
entry, and no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple      # BENCHMARK.json metric entries this cell reports
    per_layer: tuple


def load_spec(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as fh:
        return json.load(fh)


def _reports(entry: dict, cell: str, moved: set | None) -> bool:
    """Whether the metric ``entry`` is reported in ``cell``: listed there,
    or (without a ``workloads`` key) reported in every cell, a per-layer
    one wherever the end-to-end metric it moves is."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return moved is None or entry["moves"] in moved


def cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    spec = load_spec(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"there are {sorted(work)}")
    w = work[name]
    cfgs = {c["name"]: c for c in spec["configs"]}
    with open(root / cfgs[w["config"]]["file"]) as fh:
        config = json.load(fh)
    with open(root / "flupsbench" / "traffic" / f"{w['traffic']}.json") as fh:
        traffic = json.load(fh)
    e2e = tuple(m for m in spec["end_to_end"] if _reports(m, name, None))
    moved = {m["name"] for m in e2e}
    per = tuple(m for m in spec["per_layer"] if _reports(m, name, moved))
    return Cell(name, config, traffic, int(w["chips"]), e2e, per)


def _load(path: Path, tag: str):
    mod_name = "flupsbench_" + tag + "_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return _load(Path(root) / "flupsbench" / "metrics" / f"{metric}.py",
                 "metric").read


def reference(config: dict, root: Path = ROOT):
    """The plain reference module the configuration names."""
    return _load(Path(root) / "flupsbench" / "references"
                 / f"{config['reference']}.py", "reference")
