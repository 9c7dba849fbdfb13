"""The port's partition specs (``transformer.param_specs``,
``cache_specs``, ``training.train_step.state_specs``) == the reference's,
leaf by leaf, for every full and smoke LM config on four meshes; and
``common.spec_placements`` / ``convert.local_spec``, which lay them onto
the port's per-layer tensors.

The port's ``P`` is a tuple that normalises its entries as
``jax.sharding.PartitionSpec`` does, so a port spec equals
``tuple(reference spec)``.  The port's caches for the full configs are
built on the ``meta`` device (shapes, no storage); the reference's with
``jax.eval_shape``.
"""
import types

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import jax
from jax.sharding import PartitionSpec

from repro.configs import get_config as rget_config
from repro.configs import get_smoke as rget_smoke
from repro.models import transformer as rtf
from repro.training import train_step as rts

from repro_torch.configs import LM_ARCHS, get_config, get_smoke
from repro_torch.models import convert
from repro_torch.models import transformer as tf
from repro_torch.models.common import P, spec_placements
from repro_torch.training import train_step as ts

MESHES = {"d2m4": {"data": 2, "model": 4}, "d4m2": {"data": 4, "model": 2},
          "p2d2m2": {"pod": 2, "data": 2, "model": 2},
          "m16": {"model": 16}}
CONFIGS = [(a, size) for a in LM_ARCHS for size in ("full", "smoke")]


def _cfgs(arch, size):
    if size == "full":
        return get_config(arch), rget_config(arch)
    return get_smoke(arch), rget_smoke(arch)


def _ref_leaves(tree):
    """{path: tuple(spec)} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, PartitionSpec))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): tuple(s) for path, s in flat}


def _leaves(tree, prefix=()):
    """{path: spec} of a port spec tree (``P`` leaves)."""
    if isinstance(tree, P):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,size", CONFIGS)
def test_param_specs_match_reference(arch, size, mesh):
    cfg, rcfg = _cfgs(arch, size)
    got = _leaves(tf.param_specs(cfg, MESHES[mesh]))
    assert got == _ref_leaves(rtf.param_specs(rcfg, MESHES[mesh]))
    assert all(isinstance(s, P) for s in got.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,size", CONFIGS)
def test_cache_specs_match_reference(arch, size, mesh):
    cfg, rcfg = _cfgs(arch, size)
    want = rtf.cache_specs(rcfg, MESHES[mesh], jax.eval_shape(
        lambda: rtf.init_caches(rcfg, 2, 64)))
    caches = tf.init_caches(cfg, 2, 64, device="meta")
    assert _leaves(tf.cache_specs(cfg, MESHES[mesh], caches)) == \
        _ref_leaves(want)


@pytest.mark.parametrize("arch,size", CONFIGS)
def test_state_specs_match_reference(arch, size):
    cfg, rcfg = _cfgs(arch, size)
    for shape in MESHES.values():
        got = ts.state_specs(cfg, shape)
        want = rts.state_specs(rcfg, shape)
        assert got.err_fb is None and want.err_fb is None
        assert _leaves(got.params) == _ref_leaves(want.params)
        assert _leaves(got.opt_state) == _ref_leaves(want.opt_state)


def test_p_normalises_as_partition_spec():
    for args in ((None, (), "model"), (("data",), None),
                 (("pod", "data"), "model", None), ()):
        assert P(*args) == tuple(PartitionSpec(*args))
    assert P(None, "a") != P(None, "a", None)


def test_spec_placements():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert spec_placements(P(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert spec_placements(P(None, "data"), mesh) == [
        Replicate(), Shard(1), Replicate()]
    # a name the mesh lacks is an axis of size one
    two = types.SimpleNamespace(mesh_dim_names=("model",))
    assert spec_placements(P("data", "model"), two) == [Shard(1)]
    with pytest.raises(ValueError, match="mesh order"):
        spec_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="two"):
        spec_placements(P("model", "model"), mesh)


def test_local_spec_of_port_tensors():
    """Every parameter and cache leaf of the port finds its spec; a
    per-layer tensor's spec has the tensor's rank (the stacked axis
    dropped), an unstacked one's is the tree's leaf."""
    cfg = get_config("recurrentgemma-9b")
    shape = MESHES["d2m4"]
    specs = tf.param_specs(cfg, shape)
    with torch.device("meta"):
        model = tf.Transformer(cfg)
    for name, p in model.named_parameters():
        spec = convert.local_spec(specs, name)
        assert len(spec) == p.ndim, (name, spec, p.shape)
    assert convert.local_spec(specs, "groups.rec0.3.rec.w_x") == \
        P("data", "model")
    assert convert.local_spec(specs, "rem.rec0.rec.w_x") == \
        P("data", "model")
    caches = tf.init_caches(cfg, 2, 64, device="meta")
    cspecs = tf.cache_specs(cfg, shape, caches)
    for name, t in convert._dotted(caches).items():
        assert len(convert.local_spec(cspecs, name)) == t.ndim, name
    assert convert.local_spec(cspecs, "groups.attn2.0.sa.k") == \
        P("data", None, None, None)
    state = ts.state_specs(cfg, shape)
    assert convert.local_spec(state.opt_state["m"], "embed") == \
        P("model", "data")
