"""The port's training substrate (``repro_torch.training``,
``repro_torch.data``) == the reference's, on the CPU.

Optimizer units on the same inputs; two train steps per architecture
(half of them here, the other half in ``test_torch_train_steps.py``), with
and without int8 error feedback, from the reference's initial state
loaded through ``models.convert`` on one numpy batch; resume
determinism; checkpoints across the two packages; the data pipeline.

Tolerances, float32 compute.  The gradients agree to float32 rounding
(about 1e-6 of each leaf's largest; the reference runs parts of
attention in float64 under the test suite's x64, tests/conftest.py):
- loss, ``grad_norm`` and ``lr``: ``|port - ref| <= 1e-5 |ref|``
  (``grad_norm`` 1e-3 under int8, see below); ``moe_drop`` to 1e-6;
- each leaf of the new state: ``||port - ref|| <= 1e-4 ||ref||``
  (norm-wise), and ``max |port - ref| <= 1e-2 max |ref|``.  Element by
  element the first Adam step divides a gradient by ``|g| + eps``, so
  where ``|g|`` is below ``eps = 1e-8`` it divides rounding noise by
  ``eps``: such elements move by up to 1e-3 of the leaf's largest
  (observed 1.1e-4 to 4.8e-4), the norm-wise error stays under 1e-5;
- under ``grad_compress="int8"`` the parameters as above; ``m`` and
  ``v`` norm-wise within 1e-3 (observed up to 6.9e-4), and the error
  feedback off by at most one quantum on at most 1% of its elements: a
  gradient element within rounding of an int8 rounding boundary
  quantizes to the neighbouring level (one quantum, the leaf's
  ``max |g| / 127``) in one package and not the other.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI images without hypothesis: deterministic local shim
    from _hypothesis_shim import given, settings, strategies as st

from repro.ckpt import checkpoint as rck
from repro.configs import get_smoke as rget_smoke
from repro.data import pipeline as rpipe
from repro.training import optimizer as ropt
from repro.training import train_step as rts

from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import LM_ARCHS, get_smoke
from repro_torch.data import pipeline as pipe
from repro_torch.models import convert
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

B, S = 2, 16
STATE_TOL = 1e-4
METRIC_TOL = 1e-5
STATE_MAX_TOL = 1e-2
QUANT_TOL = 1e-3
# the archs whose train steps this file holds (the rest:
# test_torch_train_steps.py)
ARCHS = LM_ARCHS[:5]


def _rel(got, want):
    got = got.detach().double().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l) for p, l in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_state_close(got, want, tol=STATE_TOL, max_tol=None):
    """Every leaf of two reference-layout trees within ``tol``, as the
    norm-wise ``||port - ref|| / ||ref||``; with ``max_tol``, also as
    ``max |port - ref| / max |ref|``."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert g[k].shape == w[k].shape, k
        d = g[k].astype(np.float64) - w[k]
        err = np.linalg.norm(d) / max(np.linalg.norm(w[k]), 1e-30)
        assert err <= tol, f"{k}: norm-wise relative error {err:.3e}"
        if max_tol is not None:
            err = _rel(g[k], w[k])
            assert err <= max_tol, f"{k}: relative max error {err:.3e}"


def assert_flips_only(got, want):
    """Error-feedback leaves: equal but where an element quantized to the
    neighbouring int8 level in one package, at most 1% of the elements,
    each off by at most one quantum (``|err| <= q / 2``, so ``q`` is
    about ``2 max |err|``)."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        d = np.abs(g[k].astype(np.float64) - w[k])
        q = 2.0 * np.abs(w[k]).max()
        assert d.max() <= 1.01 * q, k
        assert (d > 1e-3 * q).mean() <= 0.01, k


def _batch(cfg, step, seed=0):
    rng = np.random.default_rng(1000 * seed + step)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"inputs": toks[:, :-1], "labels": toks[:, 1:],
           "mask": np.ones((B, S), np.float32)}
    if cfg.n_frontend_tokens:
        out["frontend"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _ref_state_tuple(state):
    return (state.params, dict(state.opt_state), state.err_fb)


_REF_STATE = jax.jit(rts.make_train_state, static_argnums=(1, 2, 3))


@functools.lru_cache(maxsize=None)
def _ref_step(rcfg, adam):
    return jax.jit(rts.train_step_fn(rcfg, adam=adam))


def run_two_steps(arch, compress):
    """Two steps of both packages from the reference's initial state;
    asserts the metrics and the new states agree."""
    rcfg = dataclasses.replace(rget_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    kw = dict(lr=1e-3, warmup=0, total_steps=100,
              grad_compress="int8" if compress else "none")
    radam, adam = ropt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    rstate = _REF_STATE(jax.random.PRNGKey(0), rcfg, 3e-4, radam)
    state = convert.from_reference(
        jax.tree.map(np.asarray, _ref_state_tuple(rstate)), cfg)
    rstep, step = _ref_step(rcfg, radam), ts.train_step_fn(cfg, adam=adam)
    for i in range(2):
        nb = _batch(cfg, i)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in nb.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in nb.items()})
        for k in ("loss", "grad_norm", "lr"):
            # under int8 the norm is of the quantized gradient (flips)
            tol = QUANT_TOL if compress and k == "grad_norm" else METRIC_TOL
            assert _rel(m[k], rm[k]) <= tol, (i, k)
        assert float(m["moe_drop"]) == pytest.approx(float(rm["moe_drop"]),
                                                     abs=1e-6)
    assert int(state.opt_state["step"]) == 2
    got = convert.to_reference(state)
    want = jax.tree.map(np.asarray, _ref_state_tuple(rstate))
    assert_state_close(got[0], want[0], STATE_TOL, STATE_MAX_TOL)
    if compress:
        assert_state_close(got[1], want[1], QUANT_TOL)
        assert_flips_only(got[2], want[2])
    else:
        assert_state_close(got[1:], want[1:], STATE_TOL, STATE_MAX_TOL)


@pytest.mark.parametrize("compress", [False, True], ids=["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_reference(arch, compress):
    run_two_steps(arch, compress)


# ---------------------------------------------------------------------------
# optimizer units
# ---------------------------------------------------------------------------

def test_lr_schedule():
    for cfg in (opt.AdamWConfig(), opt.AdamWConfig(warmup=0, total_steps=7),
                opt.AdamWConfig(warmup=3, total_steps=10, min_lr_frac=0.0)):
        rcfg = ropt.AdamWConfig(**dataclasses.asdict(cfg))
        steps = np.arange(0, cfg.total_steps + 5, dtype=np.int32)
        got = torch.stack([opt.lr_schedule(cfg, torch.tensor(s))
                           for s in steps])
        want = jax.jit(jax.vmap(functools.partial(ropt.lr_schedule, rcfg)))(
            jnp.asarray(steps))
        assert _rel(got, want) <= 1e-6


def _stacked_tree(seed=0):
    """A reference-layout tree: stacked 3-D and 2-D leaves (two layers),
    a stacked 1-D-per-layer norm scale, unstacked 2-D and 1-D leaves."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": r(11, 4), "ln_f": {"scale": r(4)},
            "layers": {"ln1": {"scale": r(2, 4)}, "mlp": {"w_in": r(2, 4, 6)}},
            "rem": {"rec0": {"ln1": {"scale": r(4)},
                             "rec": {"lam": r(4)}}}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _unstack(tree):
    """The reference-layout tree -> flat dotted names, one tensor a layer."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                out[".".join(keys[:1] + [str(i)] + keys[1:])] = \
                    torch.from_numpy(np.array(leaf[i]))
        else:
            out[".".join(keys)] = torch.from_numpy(np.array(leaf))
    return out


def _restack(flat):
    """Flat dotted names -> the reference-layout tree of numpy arrays."""
    groups = {}
    for name, t in flat.items():
        path, i = convert.ref_path(name)
        groups.setdefault(path, {})[i] = t.numpy()
    tree = {}
    for path, d in groups.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = d[None] if None in d else \
            np.stack([d[i] for i in sorted(d)])
    return tree


def test_adamw_update_decay_follows_the_stacked_layout():
    """Stacked per-layer 1-D leaves (rank 2 in the reference) are decayed,
    unstacked 1-D ones (``ln_f``, the remainder block's) are not; the flat
    per-layer layout decays exactly as the stacked tree does."""
    cfg = opt.AdamWConfig(lr=0.1, warmup=0, weight_decay=0.5)
    rcfg = ropt.AdamWConfig(**dataclasses.asdict(cfg))
    params, grads = _stacked_tree(0), _stacked_tree(1)
    rstate = ropt.init_opt_state(jax.tree.map(jnp.asarray, params))
    tstate = opt.init_opt_state(_to_torch(params))
    fstate = opt.init_opt_state(_unstack(params))
    rp, tp, fp = jax.tree.map(jnp.asarray, params), _to_torch(params), \
        _unstack(params)
    for _ in range(3):
        rp, rstate, rm = ropt.adamw_update(
            rcfg, rp, jax.tree.map(jnp.asarray, grads), rstate)
        tp, tstate, tm = opt.adamw_update(cfg, tp, _to_torch(grads), tstate)
        fp, fstate, fm = opt.adamw_update(cfg, fp, _unstack(grads), fstate)
    want = jax.tree.map(np.asarray, rp)
    assert_state_close(jax.tree.map(lambda t: t.numpy(), tp), want, 1e-6)
    assert_state_close(_restack(fp), want, 1e-6)
    assert_state_close(_restack(fstate["m"]),
                       jax.tree.map(np.asarray, rstate["m"]), 1e-6)
    for m in (tm, fm):
        assert _rel(m["grad_norm"], rm["grad_norm"]) <= 1e-6
        assert _rel(m["lr"], rm["lr"]) <= 1e-6
    # the trap itself: the same 1-D values, decayed when stacked only
    no_decay = dataclasses.replace(cfg, weight_decay=0.0)
    nd, _, _ = opt.adamw_update(no_decay, _unstack(params), _unstack(grads),
                                opt.init_opt_state(_unstack(params)))
    dec, _, _ = opt.adamw_update(cfg, _unstack(params), _unstack(grads),
                                 opt.init_opt_state(_unstack(params)))
    assert not torch.equal(nd["layers.0.ln1.scale"], dec["layers.0.ln1.scale"])
    assert torch.equal(nd["ln_f.scale"], dec["ln_f.scale"])
    assert torch.equal(nd["rem.rec0.rec.lam"], dec["rem.rec0.rec.lam"])


def test_in_place_update_is_bit_equal(monkeypatch):
    """``adamw_update_`` (the train step's, slice by slice) writes the bits
    of ``adamw_update``, whatever the slice size."""
    cfg = opt.AdamWConfig(lr=0.1, warmup=0, weight_decay=0.5)
    params, grads = _unstack(_stacked_tree(0)), _unstack(_stacked_tree(1))
    want, wstate, wm = opt.adamw_update(cfg, params, grads,
                                        opt.init_opt_state(params))
    for chunk in (5, 1 << 24):
        monkeypatch.setattr(opt, "_CHUNK", chunk)
        mine = {n: t.clone() for n, t in params.items()}
        state = opt.init_opt_state(mine)
        state, m = opt.adamw_update_(cfg, mine, grads, state)
        for n in want:
            assert torch.equal(mine[n], want[n]), (chunk, n)
            assert torch.equal(state["m"][n], wstate["m"][n])
            assert torch.equal(state["v"][n], wstate["v"][n])
        assert int(state["step"]) == 1
        assert torch.equal(m["grad_norm"], wm["grad_norm"])


def test_global_norm_and_clip_metric():
    tree = _stacked_tree(2)
    assert _rel(opt.global_norm(_to_torch(tree)),
                ropt.global_norm(jax.tree.map(jnp.asarray, tree))) <= 1e-6
    cfg = opt.AdamWConfig(grad_clip=1e-3)
    params = {"w": torch.ones(4)}
    _, _, m = opt.adamw_update(cfg, params, {"w": torch.full((4,), 100.0)},
                               opt.init_opt_state(params))
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_compress_int8_rounds_half_to_even():
    # scale = 127 / 127 = 1: every other value sits on a half
    g = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.49, -126.5],
                 np.float32)
    deq, err = opt.compress_int8(torch.from_numpy(g), torch.zeros(8))
    rdeq, rerr = ropt.compress_int8(jnp.asarray(g), jnp.zeros(8, jnp.float32))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(rdeq))
    np.testing.assert_array_equal(err.numpy(), np.asarray(rerr))
    assert deq.tolist() == [127, 0, 2, 2, -2, -0.0, 3, -126]


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_compress_int8_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(64) * 10 ** rng.uniform(-4, 2)).astype(
        np.float32)
    e = (rng.standard_normal(64) * 1e-3).astype(np.float32)
    deq, err = opt.compress_int8(torch.from_numpy(g), torch.from_numpy(e))
    rdeq, rerr = ropt.compress_int8(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_allclose(deq.numpy(), np.asarray(rdeq), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(err.numpy(), np.asarray(rerr), rtol=1e-5,
                               atol=1e-6 * np.abs(g).max())


def test_apply_compression_shares_one_scale_per_reference_leaf():
    """Per-layer tensors of one stacked leaf share its scale (the max over
    all layers), as the reference quantizes the whole stacked leaf."""
    cfg = opt.AdamWConfig(grad_compress="int8")
    rcfg = ropt.AdamWConfig(grad_compress="int8")
    grads = _stacked_tree(3)
    grads["layers"]["mlp"]["w_in"][1] *= 100.0     # layer 1 dominates
    err = jax.tree.map(lambda a: np.zeros_like(a), grads)
    rdeq, rerr = ropt.apply_compression(
        rcfg, jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, err))
    deq, nerr = opt.apply_compression(cfg, _unstack(grads), _unstack(err))
    assert_state_close(_restack(deq), jax.tree.map(np.asarray, rdeq), 1e-6)
    assert_state_close(_restack(nerr), jax.tree.map(np.asarray, rerr), 1e-5)
    same, _ = opt.apply_compression(opt.AdamWConfig(), _unstack(grads), None)
    assert same["layers.0.mlp.w_in"] is not None


# ---------------------------------------------------------------------------
# resume, checkpoints across packages, data
# ---------------------------------------------------------------------------

def test_resume_determinism(tmp_path):
    """Train 4 steps straight == train 2, checkpoint, restore, train 2."""
    cfg = get_smoke("qwen3-0.6b")
    step = ts.train_step_fn(cfg)

    def run(state, a, b):
        for i in range(a, b):
            state, _ = step(state, pipe.synthetic_batch(cfg, i, 2, 16))
        return state

    new = lambda: ts.make_train_state(torch.Generator().manual_seed(0), cfg)
    s_ref = convert.to_reference(run(new(), 0, 4))
    s = run(new(), 0, 2)
    d = str(tmp_path / "ck")
    ck.save(d, 2, convert.to_reference(s))
    tree = ck.restore(d, 2, convert.reference_like(cfg))
    s2 = convert.to_reference(run(convert.from_reference(tree, cfg), 2, 4))
    assert_state_close(s2, s_ref, 0.0)


@pytest.mark.parametrize("compress", [False, True], ids=["none", "int8"])
def test_checkpoint_across_packages(tmp_path, compress):
    """A TrainState checkpoint written by either package restores in the
    other, leaf for leaf bit-equal."""
    arch = "recurrentgemma-9b"
    rcfg, cfg = rget_smoke(arch), get_smoke(arch)
    adam = ropt.AdamWConfig(grad_compress="int8" if compress else "none")
    rstate = _REF_STATE(jax.random.PRNGKey(0), rcfg, 3e-4, adam)
    rstate = dataclasses.replace(rstate, opt_state=dict(
        rstate.opt_state, step=jnp.int32(7)))
    d1, d2 = str(tmp_path / "ref"), str(tmp_path / "port")
    rck.save(d1, 3, rstate)
    mine = ck.restore(d1, 3, convert.reference_like(cfg, compress))
    state = convert.from_reference(mine, cfg)
    assert int(state.opt_state["step"]) == 7
    want = jax.tree.map(np.asarray, _ref_state_tuple(rstate))
    got = convert.to_reference(state)
    assert_state_close(got, want, 0.0)
    ck.save(d2, 3, got)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        rstate)
    back = rck.restore(d2, 3, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_memmap_tokens_bit_equal(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.default_rng(0).integers(0, 50000, 10_007).astype(
        np.int32).tofile(path)
    cfg, rcfg = get_smoke("qwen3-0.6b"), rget_smoke("qwen3-0.6b")
    mine, ref = pipe.MemmapTokens(path, 64), rpipe.MemmapTokens(path, 64)
    assert mine.n_seqs == ref.n_seqs
    for step in (0, 3, 77):
        got = mine.batch_for_step(cfg, step, 4)
        want = ref.batch_for_step(rcfg, step, 4)
        for k in ("inputs", "labels", "mask"):
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
            assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes()


def test_synthetic_batch_is_pure():
    cfg = get_smoke("paligemma-3b")
    a = pipe.synthetic_batch(cfg, 5, 2, 16, seed=3)
    b = pipe.synthetic_batch(cfg, 5, 2, 16, seed=3)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["inputs"].dtype == torch.int32
    assert a["frontend"].shape == (2, cfg.n_frontend_tokens, cfg.d_model)
    assert torch.equal(a["inputs"][:, 1:], a["labels"][:, :-1])
    assert int(a["inputs"].max()) < cfg.vocab and int(a["inputs"].min()) >= 0
    for other in (pipe.synthetic_batch(cfg, 6, 2, 16, seed=3),
                  pipe.synthetic_batch(cfg, 5, 2, 16, seed=4)):
        assert not torch.equal(a["inputs"], other["inputs"])
        assert not torch.equal(a["frontend"], other["frontend"])


def _one_rank_mesh_steps(tmp_path, cfg, adam, batch, n):
    """``n`` mesh train steps on a one-rank gloo mesh (1, 1) of this
    process, from seed 0: the losses and the final parameters."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        state = ts.make_train_state(torch.Generator().manual_seed(0), cfg,
                                    adam=adam)
        step = ts.train_step_fn(cfg, adam=adam, mesh=mesh)
        losses = []
        for _ in range(n):
            state, m = step(state, ts.data_shard(batch, mesh))
            losses.append(float(m["loss"]))
        return losses, [p.detach().clone() for p in state.params.parameters()]
    finally:
        dist.destroy_process_group()


def test_compressed_training_memorizes_a_batch(tmp_path):
    cfg = get_smoke("qwen3-0.6b")
    adam = opt.AdamWConfig(lr=1e-3, grad_compress="int8", warmup=0)
    state = ts.make_train_state(torch.Generator().manual_seed(0), cfg,
                                adam=adam)
    assert state.err_fb is not None
    step = ts.train_step_fn(cfg, adam=adam)
    batch = pipe.synthetic_batch(cfg, 0, 2, 16)
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    # the same on a one-rank mesh (the step that raised before training
    # on a mesh was ported): the same losses and parameters
    mesh_losses, mesh_params = _one_rank_mesh_steps(tmp_path, cfg, adam,
                                                    batch, 8)
    assert mesh_losses == losses
    for got, want in zip(mesh_params, state.params.parameters()):
        assert torch.equal(got, want.detach())
