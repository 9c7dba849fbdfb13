"""The port's serving path (``prefill``, ``init_caches``, ``decode_step``
and the decode paths of attention, ssm and rglru) == the reference's, at
the ten smoke configs on the CPU.

Parameters are the reference's ``init_params(PRNGKey(0))`` loaded into
the port through ``models.convert``; tokens and frontends are numpy
draws from a seed; caches are compared leaf by leaf through
``convert.caches_to_reference`` (the port keeps one dict a layer, the
reference stacks them).  Tolerances, as ``max |port - ref| <= tol * max
|ref|``: float32 compute 1e-4 (the reference runs parts of it in
float64 under the suite's x64, tests/conftest.py); decode against the
port's own forward in the configs' bfloat16 at the reference test's
2e-2 (``tests/test_archs_smoke.py``, elementwise rtol and atol).

Two faults of the reference's whisper path are not ported (ROADMAP
queue 3): its ``prefill`` returns the decoder's caches without the
``"layers"`` key its ``decode_step`` reads, and its decode applies RoPE
to the decoder's self-attention, which its forward does not.  Where the
port's whisper decode is held to the reference's, the reference runs
with that RoPE off (its ``attention._qkv`` patched for the test); the
faults themselves are shown by ``test_reference_whisper_faults``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as rget_smoke
from repro.models import attention as rattn
from repro.models import common as rcommon
from repro.models import transformer as rtf

from repro_torch.configs import LM_ARCHS, get_smoke
from repro_torch.models import common, convert
from repro_torch.models import transformer as tf

B, S = 2, 32
F32_TOL = 1e-4
DEV = "cpu"

_REF_INIT = jax.jit(rtf.init_params, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _ref_params(cfg):
    return jax.tree.map(np.asarray, _REF_INIT(jax.random.PRNGKey(0), cfg))


def _f32(arch, no_drop=False):
    """The smoke config in float32 (both packages' copies); with
    ``no_drop`` a MoE capacity factor of E / k, so that no token is
    dropped whatever the batch's token count."""
    out = []
    for cfg in (get_smoke(arch), rget_smoke(arch)):
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        if no_drop and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        out.append(cfg)
    return out


def _model(cfg, rcfg):
    return convert.from_reference(_ref_params(rcfg), cfg, DEV)


def _inputs(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    frontend = (rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model))
                .astype(np.float32) if cfg.n_frontend_tokens else None)
    return tokens, frontend


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _close(got, want, tol=F32_TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"relative max error {err:.3e} > {tol:.0e}"
    return err


def _leaves(tree):
    """{path: leaf} of a nested dict of arrays (JAX or numpy)."""
    return {tuple(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _caches_close(port_caches, ref_caches, tol=F32_TOL):
    got = _leaves(convert.caches_to_reference(port_caches))
    want = _leaves(ref_caches)
    assert set(got) == set(want)
    for path, w in want.items():
        # numpy has no bfloat16: such leaves come back as float32
        assert got[path].dtype == w.dtype or str(w.dtype) == "bfloat16", \
            (path, got[path].dtype, w.dtype)
        _close(got[path], np.asarray(w, np.float64), tol)


@pytest.fixture
def ref_decode_without_rope_on_encdec(monkeypatch):
    """The reference's decode with whisper's decoder RoPE off (the port's
    decode matches the reference's forward there)."""
    qkv = rattn._qkv
    monkeypatch.setattr(
        rattn, "_qkv", lambda p, cfg, x, positions, rope=True: qkv(
            p, cfg, x, positions, rope and cfg.family != "encdec"))


def _ref_decode(rcfg):
    return jax.jit(lambda p, t, c, pos: rtf.decode_step(p, rcfg, t, c, pos))


def _ref_layers(caches):
    """The reference's prefill caches with whisper's missing ``"layers"``
    key put back."""
    return caches if {"layers", "groups"} & set(caches) else \
        {"layers": caches}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_caches_match_reference(arch):
    """Shapes and dtypes, leaf by leaf, at the configs' own compute
    dtype; the ``meta`` device gives the same shapes without storage."""
    cfg, rcfg = get_smoke(arch), rget_smoke(arch)
    want = _leaves(jax.eval_shape(lambda: rtf.init_caches(rcfg, B, S + 4)))
    for dev in (DEV, "meta"):
        caches = tf.init_caches(cfg, B, S + 4, device=dev)
        got = convert.cache_leaves(caches)
        n = {path: sum(1 for name in convert._dotted(caches)
                       if convert.ref_path(name)[0] == path) for path in got}
        assert set(got) == set(want)
        for path, w in want.items():
            lead = () if path[0] == "rem" else (n[path],)
            assert lead + tuple(got[path].shape) == tuple(w.shape), path
            assert str(got[path].dtype) == f"torch.{w.dtype}", path
            assert got[path].device.type == dev
    zeros = convert.caches_to_reference(tf.init_caches(cfg, B, S + 4,
                                                       device=DEV))
    assert all(not np.any(a) for a in _leaves(zeros).values())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_two_steps_match_reference(
        arch, ref_decode_without_rope_on_encdec):
    """Two ``decode_step``s from zero caches: logits and every cache leaf
    against the reference's after each step."""
    cfg, rcfg = _f32(arch)
    model = _model(cfg, rcfg)
    rng = np.random.default_rng(4)
    caches = tf.init_caches(cfg, B, S, device=DEV)
    rcaches = rtf.init_caches(rcfg, B, S)
    fn = _ref_decode(rcfg)
    for pos in range(2):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        logits, caches = tf.decode_step(model, _t(tok), caches, pos)
        rlogits, rcaches = fn(_ref_params(rcfg), jnp.asarray(tok), rcaches,
                              pos)
        assert logits.shape == (B, 1, cfg.vocab)
        _close(logits, rlogits)
        _caches_close(caches, rcaches)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "starcoder2-7b"])
def test_decode_matches_forward(arch):
    """Autoregressive decode logits == the full forward's (same tokens),
    in the config's bfloat16, as ``tests/test_archs_smoke.py:72``; the
    windowed configs' 16 slots roll over twice."""
    cfg = get_smoke(arch)
    model = _model(cfg, rget_smoke(arch))
    tokens = _t(_inputs(cfg, 2)[0])
    full, _ = tf.forward(model, tokens)
    caches = tf.init_caches(cfg, B, S, device=DEV)
    outs = []
    for i in range(S):
        lg, caches = tf.decode_step(model, tokens[:, i:i + 1], caches, i)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(),
                               full.detach().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """``prefill`` of S - 8 tokens (max_len S + 4), then 8 decode steps
    == the forward's positions on all S tokens, in float32 (the MoE
    configs without token drops: a decode step's few tokens and a
    forward's many get different capacities)."""
    cfg, rcfg = _f32(arch, no_drop=True)
    model = _model(cfg, rcfg)
    tokens, frontend = _inputs(cfg, 3)
    fr = _t(frontend)
    p = S - 8
    prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    logits, caches = tf.prefill(model, _t(tokens[:, :p]), fr,
                                max_len=S + 4 + prefix)
    full = tf.forward(model, _t(tokens), fr)[0].detach()
    n = logits.shape[1]
    assert n == p + prefix
    _close(logits, full[:, :n])
    for j in range(S - p):
        lg, caches = tf.decode_step(model, _t(tokens[:, p + j:p + j + 1]),
                                    caches, n + j)
        _close(lg[:, 0], full[:, n + j])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_caches_match_reference(arch):
    """``prefill``'s logits and caches, leaf by leaf, against the
    reference's; starcoder2 and recurrentgemma (window 16) at a prompt
    of 32, so the rolling buffer takes the last 16 positions; the
    reference's caches back through ``caches_from_reference`` give the
    port's."""
    cfg, rcfg = _f32(arch)
    model = _model(cfg, rcfg)
    tokens, frontend = _inputs(cfg, 5)
    max_len = S + 4 + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    logits, caches = tf.prefill(model, _t(tokens), _t(frontend),
                                max_len=max_len)
    rlogits, rcaches = jax.jit(lambda p, t, f: rtf.prefill(
        p, rcfg, t, f, max_len=max_len))(
            _ref_params(rcfg), jnp.asarray(tokens),
            None if frontend is None else jnp.asarray(frontend))
    _close(logits, rlogits)
    rcaches = _ref_layers(rcaches)
    _caches_close(caches, rcaches)
    back = convert.caches_from_reference(jax.tree.map(np.asarray, rcaches),
                                         cfg, DEV)
    got, want = convert._dotted(back), convert._dotted(caches)
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        _close(got[name], t.detach().numpy())
    if cfg.window:
        assert all(t.shape[1] == cfg.window for name, t in want.items()
                   if name.endswith((".k", ".v")))


@pytest.mark.parametrize("arch", ["starcoder2-7b", "recurrentgemma-9b"])
def test_short_prompt_prefill_keeps_the_window(arch):
    """A window config (window 16) prefilled with 8 tokens into caches
    for 40 positions: its attention caches have the window's 16 slots,
    as ``init_caches`` gives them, the prompt in slots 0-7 and zeros
    after; then 24 decode steps (positions 8-31, past the window) ==
    the forward's positions, in float32."""
    cfg, rcfg = _f32(arch)
    model = _model(cfg, rcfg)
    tokens, _ = _inputs(cfg, 8)
    p, max_len = 8, 40
    logits, caches = tf.prefill(model, _t(tokens[:, :p]), max_len=max_len)
    kv = {name: t for name, t in convert._dotted(caches).items()
          if name.endswith((".k", ".v"))}
    assert kv and all(t.shape[1] == cfg.window for t in kv.values())
    assert all(not t[:, p:].any() and t[:, :p].abs().amax(dim=(0, 2, 3))
               .gt(0).all() for t in kv.values())
    full = tf.forward(model, _t(tokens))[0].detach()
    _close(logits, full[:, :p])
    for j in range(S - p):
        lg, caches = tf.decode_step(model, _t(tokens[:, p + j:p + j + 1]),
                                    caches, p + j)
        _close(lg[:, 0], full[:, p + j])


def test_reference_short_prompt_window_fault():
    """The reference's prefill of a prompt no longer than the window pads
    its caches to ``max_len`` slots, and its decode then attends past the
    window: on starcoder2's smoke config (window 16), 8 prompt tokens and
    ``max_len`` 40, its decode matches its forward up to position 15 and
    strays from it from position 16 on (ROADMAP queue 3); the port's
    (``test_short_prompt_prefill_keeps_the_window``) does not."""
    cfg, rcfg = _f32("starcoder2-7b")
    tokens, _ = _inputs(cfg, 8)
    params = _ref_params(rcfg)
    p, max_len = 8, 40
    _, rcaches = rtf.prefill(params, rcfg, jnp.asarray(tokens[:, :p]),
                             max_len=max_len)
    assert all(a.shape[2] == max_len for a in _leaves(rcaches).values())
    full = np.asarray(rtf.forward(params, rcfg, jnp.asarray(tokens))[0])
    fn = _ref_decode(rcfg)
    errs = []
    for j in range(S - p):
        lg, rcaches = fn(params, jnp.asarray(tokens[:, p + j:p + j + 1]),
                         rcaches, p + j)
        errs.append(np.abs(np.asarray(lg[:, 0]) - full[:, p + j]).max()
                    / np.abs(full[:, p + j]).max())
    window = cfg.window - p
    assert max(errs[:window]) <= F32_TOL, errs[:window]
    assert min(errs[window:]) > 1e-2, errs[window:]


def test_bfloat16_caches_round_trip():
    """The configs' own bfloat16 caches through the reference layout and
    back, bit for bit (numpy has no bfloat16: they travel as float32)."""
    cfg = get_smoke("recurrentgemma-9b")
    model = tf.init_params(torch.Generator().manual_seed(0), cfg)
    _, caches = tf.prefill(model, _t(_inputs(cfg, 6)[0]), max_len=S + 4)
    back = convert.caches_from_reference(
        convert.caches_to_reference(caches), cfg, DEV)
    got, want = convert._dotted(back), convert._dotted(caches)
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t)


def test_reference_whisper_faults():
    """The reference's whisper prefill lacks the ``"layers"`` key its
    decode reads, and its decode (RoPE on the decoder's self-attention)
    strays from its forward; the port's decode matches the forward."""
    cfg, rcfg = _f32("whisper-medium")
    tokens, frontend = _inputs(cfg, 7, 9)
    params = _ref_params(rcfg)
    _, rcaches = rtf.prefill(params, rcfg, jnp.asarray(tokens[:, :8]),
                             jnp.asarray(frontend), max_len=12)
    assert "layers" not in rcaches
    full, _ = rtf.forward(params, rcfg, jnp.asarray(tokens),
                          jnp.asarray(frontend))
    ref_dec, _ = rtf.decode_step(params, rcfg, jnp.asarray(tokens[:, 8:]),
                                 {"layers": rcaches}, 8)
    err = np.abs(np.asarray(ref_dec[:, 0]) - np.asarray(full[:, -1])).max()
    assert err > 1e-2 * np.abs(np.asarray(full)).max()
    model = _model(cfg, rcfg)
    _, caches = tf.prefill(model, _t(tokens[:, :8]), _t(frontend),
                           max_len=12)
    dec, _ = tf.decode_step(model, _t(tokens[:, 8:]), caches, 8)
    _close(dec[:, 0], full[:, -1])


@pytest.mark.parametrize("pos", [0, 1, 77, 2 ** 15 - 1])
def test_sinusoid_row_is_the_reference_table_row(pos):
    """Whisper's decode reads one row of the 2^15-row table: bit-equal to
    the reference's table's row."""
    want = np.asarray(rcommon.sinusoidal_positions(2 ** 15, 64))[pos]
    got = common.sinusoidal_positions(1, 64, start=pos)[0].numpy()
    assert np.array_equal(got, want)


def test_decode_position_checks():
    cfg = get_smoke("qwen3-0.6b")
    model = tf.init_params(torch.Generator().manual_seed(0), cfg)
    caches = tf.init_caches(cfg, 1, 4, device=DEV)
    with pytest.raises(IndexError, match="past the cache"):
        tf.decode_step(model, torch.zeros((1, 1), dtype=torch.long), caches,
                       4)
    with pytest.raises(ValueError, match="max_len"):
        tf.prefill(model, torch.zeros((1, 8), dtype=torch.long), max_len=4)
