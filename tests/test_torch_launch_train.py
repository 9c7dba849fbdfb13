"""The port's train launcher (``repro_torch.launch.train``) ==
``repro.launch.train``, on the CPU.

The same flags print the same ``[train]`` lines (the same steps logged,
learning rates and straggler policy; the losses differ, since each
package initialises from its own generator and draws its own synthetic
tokens); ``--fail-at`` raises ``SystemExit`` and a relaunch resumes from
the latest checkpoint, bit-equal to an uninterrupted run; a checkpoint
written by either package's launcher resumes in the other; without a
card and without ``--device`` the launcher raises.
"""
import re

import numpy as np
import pytest
import torch

import jax

from repro.launch import train as rtrain

from repro_torch.launch import train

ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "4", "--batch", "2",
        "--seq", "16", "--log-every", "1"]
LINE = re.compile(r"^\[train\] step (\d+)  loss (\d+\.\d{4})  gnorm "
                  r"(\d+\.\d{3})  lr (\d\.\d\de[-+]\d\d)  \d+\.\d\ds$")


def _lines(out):
    return [l for l in out.splitlines() if l.startswith("[train]")]


def test_smoke_prints_the_reference_lines(capsys):
    rtrain.main(ARGS)
    want = _lines(capsys.readouterr().out)
    state = train.main(ARGS + ["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert len(got) == len(want) == 5
    assert got[-1] == want[-1] == "[train] done"
    for g, w in zip(got[:-1], want[:-1]):
        mg, mw = LINE.match(g), LINE.match(w)
        assert mg and mw, (g, w)
        assert mg.group(1) == mw.group(1)            # the step
        assert mg.group(4) == mw.group(4)            # the lr
        assert abs(float(mg.group(2)) - np.log(512)) < 0.5
    rec = state.record
    assert rec["device"] == "cpu" and rec["steps"] == [0, 1, 2, 3]
    assert rec["start"] == 0 and rec["restore_seconds"] is None
    assert rec["save_seconds"] == [] and len(rec["seconds"]) == 4
    assert all(np.isfinite(rec["loss"]))
    assert int(state.opt_state["step"]) == 4


def test_fail_at_then_resume_matches_uninterrupted(tmp_path, capsys):
    base = ARGS + ["--device", "cpu", "--ckpt-every", "2"]
    straight = train.main(base)
    with pytest.raises(SystemExit, match="simulated failure at step 2") as e:
        train.main(base + ["--ckpt-dir", str(tmp_path), "--fail-at", "2"])
    resumed = train.main(base + ["--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out
    records = [straight.record, e.value.record, resumed.record]
    assert [r["steps"] for r in records] == [[0, 1, 2, 3], [0, 1], [2, 3]]
    assert records[2]["loss"] == records[0]["loss"][2:]
    assert len(records[1]["save_seconds"]) == 1
    assert records[1]["restore_seconds"] is None
    assert records[2]["start"] == 2 and records[2]["restore_seconds"] > 0
    for a, b in zip(straight.params.parameters(), resumed.params.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, capsys, first):
    d = str(tmp_path)
    args = ARGS + ["--ckpt-dir", d, "--ckpt-every", "2", "--compress"]
    mains = {"reference": rtrain.main,
             "port": lambda a: train.main(a + ["--device", "cpu"])}
    second = "port" if first == "reference" else "reference"
    with pytest.raises(SystemExit):
        mains[first](args + ["--fail-at", "2"])
    capsys.readouterr()
    state = mains[second](args)
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out
    steps = [int(m.group(1)) for m in map(LINE.match, _lines(out)) if m]
    assert steps == [2, 3]
    step = state.opt_state["step"]
    assert int(step) == 4
    err = state.err_fb
    assert err is not None
    leaves = jax.tree.leaves(err) if second == "reference" else \
        list(err.values())
    assert any(np.abs(np.asarray(l)).max() > 0 for l in leaves)


def test_without_a_card_and_device_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(ARGS)
