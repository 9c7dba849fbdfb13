"""Nothing the harness or the references load is JAX, Flax or the JAX
package ``repro``, compared by whole top-level names; and where something
does, no result is printed."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

from flupsbench import stepper
from flupsbench.tests.conftest import ROOT


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in stepper.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in stepper.forbidden_modules()


def test_a_run_loads_none_of_them(tmp_path):
    # a fresh interpreter: this test process may hold JAX from elsewhere
    from flupsbench.tests.conftest import small_copy
    small_copy(tmp_path)
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
        from flupsbench import catalog, run, stepper
        for w in ("poisson_node.step", "periodic_cell.step"):
            cell = catalog.cell(w, {str(tmp_path)!r})
            for patch in (None, stepper.control(cell)):
                r = run.run_ranks(cell, [5], 0.1, True, "cpu", patch=patch,
                                  root={str(tmp_path)!r}, t0=0.0)
                run.result(cell, r[0], True, 1, root={str(tmp_path)!r})
        bad = sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"jax", "jaxlib", "flax", "repro"}})
        assert not bad, bad
        assert "repro_torch" in sys.modules
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-3000:]


def test_a_reader_that_loads_the_jax_package_stops_the_result(tmp_path):
    # a later metric reader that imports ``repro`` (here a stub of that
    # name) after the window: the run prints no result and exits 1
    from flupsbench.tests.conftest import small_copy
    (tmp_path / "bench").mkdir()
    bench = small_copy(tmp_path / "bench")
    stub = tmp_path / "stub" / "repro"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    (bench / "flupsbench" / "metrics" / "loads_repro.py").write_text(
        f"import sys\nsys.path.insert(0, {str(stub.parent)!r})\n"
        "import repro  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    spec = json.loads((bench / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "loads_repro", "unit": "1",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["periodic_cell.step"]})
    (bench / "BENCHMARK.json").write_text(json.dumps(spec))
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
        from flupsbench import catalog, run
        root = {str(bench)!r}
        for w in ("poisson_node.step", "periodic_cell.step"):
            cell = catalog.cell(w, root)
            r = run.run_ranks(cell, [5], 0.1, False, "cpu", root=root,
                              t0=0.0)
            sys.stderr.write(f"{{w}} exit {{run.report(cell, r[0], False, 1, root)}}\\n")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    # the first cell, which does not report the metric, prints its line
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["correct"], out.stdout
    assert "poisson_node.step exit 0" in out.stderr
    assert "periodic_cell.step exit 1" in out.stderr
    assert "repro loaded in the process that reports: no result" \
        in out.stderr
