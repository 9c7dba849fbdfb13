"""A configuration, a traffic mix and a metric added as new files and new
entries only are found by name, and a run reports the metric."""
from __future__ import annotations

import json

import pytest

from flupsbench import catalog


def test_every_name_in_benchmark_json_has_its_file():
    spec = catalog.load_spec()
    for w in spec["workloads"]:
        cell = catalog.cell(w["name"])
        assert cell.chips == int(w["chips"])
        assert catalog.reference(cell.config).solve
        for m in cell.end_to_end + cell.per_layer:
            assert callable(catalog.reader(m["name"]))
    for c in spec["configs"]:
        assert (catalog.ROOT / c["file"]).is_file()


def test_each_cell_reports_every_end_to_end_metric():
    spec = catalog.load_spec()
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names
    for w in spec["workloads"]:
        cell = catalog.cell(w["name"])
        assert {m["name"] for m in cell.end_to_end} == names
        assert cell.per_layer


def test_a_new_config_traffic_and_metric_from_new_files(small):
    bench = small / "flupsbench"
    before = {p: p.read_bytes() for p in small.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "flups_poisson.json").read_text())
    cfg.update(name="throwaway", n=8, batch=1)
    (bench / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "step.json").read_text())
    tr.update(ring=2, warmup_steps=1)
    (bench / "traffic" / "short_ring.json").write_text(json.dumps(tr))
    (bench / "metrics" / "steps_done.py").write_text(
        "def read(run):\n    return float(len(run.steps))\n")
    spec = json.loads((small / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway", "source": "a test",
                            "file": "flupsbench/configs/throwaway.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "throwaway.short", "chips": 1,
                              "config": "throwaway", "traffic": "short_ring",
                              "why": "a test"})
    spec["end_to_end"].append({"name": "steps_done", "unit": "1",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["throwaway.short"]})
    (small / "BENCHMARK.json").write_text(json.dumps(spec))
    changed = [p for p, b in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []

    from flupsbench import run
    cell = catalog.cell("throwaway.short", small)
    assert cell.config["n"] == 8 and cell.traffic["ring"] == 2
    runs = run.run_ranks(cell, [3], 0.2, False, "cpu", root=small, t0=0.0)
    out = run.result(cell, runs[0], False, 1, root=small)
    assert out["correct"], out
    assert out["metrics"]["steps_done"]["value"] == runs[0].attempted > 0
    # the new metric stays out of the cells it does not list
    assert "steps_done" not in {
        m["name"] for m in catalog.cell("poisson_node.step",
                                        small).end_to_end}


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        catalog.cell("no_such.cell")
