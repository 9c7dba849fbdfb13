"""The port's checkpoints (``repro_torch.ckpt.checkpoint``) == the
reference's (``repro.ckpt.checkpoint``).

The checkpoint-integrity tests of ``tests/test_faults.py`` on trees of
numpy arrays and of torch tensors; a flipped leaf raising
``CheckpointError`` naming it; ``keep_last``; and checkpoints written by
either package restored bit-equal by the other, with the same manifest
leaf entries (shape, dtype, CRC32) and the same ``arr_<i>`` order.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as rck
from repro_torch.ckpt import checkpoint as ck
from repro_torch.runtime import faults

KINDS = ["numpy", "torch"]


def _leaf(a, kind):
    return torch.from_numpy(np.array(a)) if kind == "torch" else np.array(a)


def _tree(step, kind="numpy"):
    return {"w": _leaf(np.full((4, 3), float(step)), kind),
            "b": _leaf(np.arange(5.0), kind)}


def _equal(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_restore_validates_manifest(tmp_path, kind):
    d = str(tmp_path)
    ck.save(d, 0, _tree(0, kind))
    like = _tree(0, kind)
    out = ck.restore(d, 0, like)
    assert type(out["w"]) is type(like["w"])
    assert _equal(out["w"], _tree(0, kind)["w"])
    with pytest.raises(ck.CheckpointError, match="leaves"):
        ck.restore(d, 0, {"w": like["w"]})
    with pytest.raises(ck.CheckpointError, match="shape"):
        ck.restore(d, 0, {"w": _leaf(np.zeros((2, 2)), kind),
                          "b": like["b"]})


@pytest.mark.parametrize("kind", KINDS)
def test_truncated_array_skips_step(tmp_path, kind):
    d = str(tmp_path)
    for s in (0, 1, 2):
        ck.save(d, s, _tree(s, kind))
    assert ck.all_steps(d) == [0, 1, 2]
    # torn write past the rename / disk rot: truncate one leaf of step 2
    bad = os.path.join(d, "step_2", "arr_0.npy")
    with open(bad, "r+b") as fh:
        fh.truncate(os.path.getsize(bad) // 2)
    assert ck.all_steps(d) == [0, 1]
    assert ck.latest_step(d) == 1           # restart falls back
    with pytest.raises(ck.CheckpointError, match="damaged"):
        ck.restore(d, 2, _tree(2, kind))
    os.remove(os.path.join(d, "step_1", "arr_1.npy"))
    assert ck.latest_step(d) == 0           # missing leaf also skipped
    out = ck.restore(d, 0, _tree(0, kind))
    assert _equal(out["w"], _tree(0, kind)["w"])


@pytest.mark.parametrize("kind", KINDS)
def test_torn_write_mid_leaf_preserves_previous_step(tmp_path, kind):
    d = str(tmp_path)
    ck.save(d, 0, _tree(0, kind))
    with faults.FaultPlan([dict(kind="torn_write", stage="ckpt.leaf.1")]):
        with pytest.raises(faults.InjectedFault):
            ck.save(d, 1, _tree(1, kind))
    # the torn step never committed; the previous one is intact
    assert ck.all_steps(d) == [0]
    out = ck.restore(d, 0, _tree(0, kind))
    assert _equal(out["w"], _tree(0, kind)["w"])
    # a retry of the same save succeeds over the leftover tmp dir
    ck.save(d, 1, _tree(1, kind))
    assert ck.latest_step(d) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_flipped_leaf_raises_naming_it(tmp_path, kind):
    d = str(tmp_path)
    ck.save(d, 0, _tree(3, kind))
    with faults.FaultPlan([dict(kind="flip", stage="ckpt.leaf.1")]) as plan:
        with pytest.raises(ck.CheckpointError, match="digest") as e:
            ck.restore(d, 0, _tree(0, kind))
    assert e.value.leaf == 1 and not e.value.transient
    assert [r["stage"] for r in plan.log] == ["ckpt.leaf.1"]
    # the bytes on disk are intact: a clean restore still works
    assert _equal(ck.restore(d, 0, _tree(0, kind))["w"], _tree(3, kind)["w"])


def test_restore_validates_every_leaf_before_loading_any(tmp_path):
    d = str(tmp_path)
    ck.save(d, 0, _tree(0))
    like = {"w": np.zeros((2, 2)), "b": np.zeros(5)}
    with faults.FaultPlan([dict(kind="flip", stage="ckpt.leaf.*")]) as plan:
        with pytest.raises(ck.CheckpointError, match="shape") as e:
            ck.restore(d, 0, like)
    assert e.value.leaf == 1 and not plan.log


def test_keep_last(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        ck.save(d, s, _tree(s), keep_last=2)
    assert ck.all_steps(d) == [4, 5]
    assert sorted(os.listdir(d)) == ["step_4", "step_5"]
    ck.save(d, 6, _tree(6))
    assert ck.all_steps(d) == [4, 5, 6]


def test_restore_places_leaves_on_the_like_leaf_device_and_dtype(tmp_path):
    d = str(tmp_path)
    ck.save(d, 0, {"a": np.arange(4.0), "t": torch.arange(3.0)})
    out = ck.restore(d, 0, {"a": np.zeros(4, np.float32),
                            "t": torch.zeros(3, dtype=torch.float64)})
    assert isinstance(out["a"], np.ndarray) and out["a"].dtype == np.float32
    assert torch.is_tensor(out["t"]) and out["t"].dtype == torch.float64
    # the like-leaf's kind decides, not what was saved
    out = ck.restore(d, 0, {"a": torch.zeros(4, dtype=torch.float64),
                            "t": np.zeros(3)})
    assert torch.is_tensor(out["a"]) and out["a"].device.type == "cpu"
    assert torch.equal(out["a"], torch.arange(4.0, dtype=torch.float64))
    assert isinstance(out["t"], np.ndarray)
    np.testing.assert_array_equal(out["t"], np.arange(3.0))


def _mixed_tree(kind):
    rng = np.random.default_rng(7)
    return {
        "w": _leaf(rng.standard_normal((3, 4)), kind),
        "b": [_leaf(rng.standard_normal(5).astype(np.float32), kind),
              None,
              (_leaf(np.arange(6, dtype=np.int32).reshape(2, 3), kind),
               _leaf(rng.standard_normal(4) + 1j * rng.standard_normal(4),
                     kind))],
        "a": _leaf(np.array(2.5), kind),
        "skip": None,
    }


def _flat_like(tree):
    """The leaves of a ``_mixed_tree`` in the reference's order."""
    return [tree["a"], tree["b"][0], tree["b"][2][0], tree["b"][2][1],
            tree["w"]]


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoints_cross_between_the_packages(tmp_path, kind):
    tree = _mixed_tree(kind)
    ref_tree = _mixed_tree("numpy")
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    rck.save(d_ref, 4, ref_tree)
    ck.save(d_port, 4, tree)
    m_ref, m_port = _manifest(d_ref, 4), _manifest(d_port, 4)
    assert m_port["n_leaves"] == m_ref["n_leaves"] == 5
    assert m_port["leaves"] == m_ref["leaves"]
    for i, want in enumerate(_flat_like(ref_tree)):
        for d in (d_ref, d_port):
            assert _equal(np.load(os.path.join(d, "step_4",
                                               f"arr_{i}.npy")), want)
    # the reference's checkpoint restored by the port, bit-equal
    got = ck.restore(d_ref, 4, _mixed_tree(kind))
    assert got["skip"] is None and got["b"][1] is None
    for g, want in zip(_flat_like(got), _flat_like(ref_tree)):
        assert type(g) is type(_flat_like(tree)[0])
        assert _equal(g, want)
    # the port's checkpoint restored by the reference, bit-equal
    got = rck.restore(d_port, 4, _mixed_tree("numpy"))
    for g, want in zip(_flat_like(got), _flat_like(ref_tree)):
        assert _equal(np.asarray(g), want)


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_parameters_restore_from_a_training_state(tmp_path, saver):
    """A like-tree of a model's parameters alone (what a server restores)
    takes the parameters of a training state's checkpoint, the port's
    ``(params, {"m", "step", "v"}, err_fb)`` or the reference's
    ``TrainState``, bit-equal; a like-tree that does not head the saved
    tree still raises."""
    import dataclasses
    import jax
    from repro.configs import get_smoke as rget_smoke
    from repro.training import train_step as rts
    from repro_torch.configs import get_smoke
    from repro_torch.models import convert
    arch = "qwen3-0.6b"
    rcfg = dataclasses.replace(rget_smoke(arch), compute_dtype="float32")
    state = rts.make_train_state(jax.random.PRNGKey(0), rcfg)
    state = jax.tree.map(np.asarray, state)
    d = str(tmp_path)
    if saver == "port":
        ck.save(d, 2, (state.params, state.opt_state, state.err_fb))
    else:
        rck.save(d, 2, state)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    like = convert.reference_like(cfg)[0]
    got = ck.restore(d, 2, like)
    want = ck._flatten(state.params)[0]
    assert len(want) > 2
    for g, w in zip(ck._flatten(got)[0], want, strict=True):
        assert _equal(g, w)
    with pytest.raises(ck.CheckpointError, match="leaves"):
        ck.restore(d, 2, {"w": np.zeros((4, 3))})
