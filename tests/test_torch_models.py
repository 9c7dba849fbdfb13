"""The port's LM models (``repro_torch.models``) == the reference's
(``repro.models``) at the smoke configs, on the CPU.

Parameters are the reference's ``init_params(PRNGKey(0))`` loaded into
the port through ``models.convert`` (torch's generator cannot reproduce
threefry's bits); tokens and frontends are numpy draws from a seed.

Tolerances, as ``max |port - ref| <= tol * max |ref|``:
- float32 compute: 1e-4 on logits and every unit.  The test suite
  runs JAX with x64 on (tests/conftest.py), so parts of the reference
  (rope angles, the attention logits' scale and softmax) run in float64
  while the port runs them in float32; the differences are float32
  rounding.
- bfloat16 compute (the configs' default): 3e-2 on every position's
  logits (observed 0.7e-2 to 2.2e-2).  Both sides round every product to
  bfloat16, but XLA and PyTorch round the elementwise chains
  differently: a few ulps of bfloat16 (2^-8 each) through two layers.
  In the MoE models such a difference can flip a router's near-tie,
  which changes that token's expert: there at most 10% of the positions
  may exceed 3e-2 (observed 0% and 4.7%), the median stays under 1e-2,
  and ``moe_drop`` is within 4 / (T k) of the reference's.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as rget_config
from repro.configs import get_smoke as rget_smoke
from repro.models import attention as rattn
from repro.models import common as rcommon
from repro.models import moe as rmoe
from repro.models import rglru as rrglru
from repro.models import ssm as rssm
from repro.models import transformer as rtf

from repro_torch.configs import LM_ARCHS, get_config, get_smoke
from repro_torch.models import attention as attn
from repro_torch.models import common, convert, moe, rglru, ssm
from repro_torch.models import transformer as tf

B, S = 2, 32
F32_TOL = 1e-4
BF16_TOL = 3e-2


def _close(got, want, tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"relative max error {err:.3e} > {tol:.0e}"
    return err


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


_REF_INIT = jax.jit(rtf.init_params, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _ref_params(cfg):
    """The reference's initial parameters (numpy; read-only by use)."""
    return _np_tree(_REF_INIT(jax.random.PRNGKey(0), cfg))


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frontend = (rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model))
                .astype(np.float32) if cfg.n_frontend_tokens else None)
    return tokens, frontend


def _forward_pair(arch, compute_dtype):
    rcfg = dataclasses.replace(rget_smoke(arch), compute_dtype=compute_dtype)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=compute_dtype)
    tree = _ref_params(rget_smoke(arch))     # compute_dtype plays no part
    tokens, frontend = _inputs(cfg)
    want, waux = jax.jit(lambda p, t, f: rtf.forward(p, rcfg, t, f))(
        tree, jnp.asarray(tokens),
        None if frontend is None else jnp.asarray(frontend))
    model = convert.from_reference(tree, cfg)
    with torch.no_grad():
        got, aux = tf.forward(
            model, torch.from_numpy(tokens),
            None if frontend is None else torch.from_numpy(frontend))
    return got, aux, np.asarray(want), float(waux["moe_drop"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference_f32(arch):
    got, aux, want, wdrop = _forward_pair(arch, "float32")
    s_total = S + (get_smoke(arch).n_frontend_tokens
                   if get_smoke(arch).family == "vlm" else 0)
    assert tuple(got.shape) == (B, s_total, get_smoke(arch).vocab)
    assert got.dtype == torch.float32
    _close(got, want, F32_TOL)
    assert float(aux["moe_drop"]) == pytest.approx(wdrop, abs=1e-6)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference_bf16(arch):
    got, aux, want, wdrop = _forward_pair(arch, "bfloat16")
    got = got.numpy()
    assert np.isfinite(got).all()
    per_pos = np.abs(got - want).max(-1) / np.abs(want).max()
    cfg = get_smoke(arch)
    if cfg.family != "moe":
        assert per_pos.max() <= BF16_TOL, per_pos.max()
        return
    assert (per_pos > BF16_TOL).mean() <= 0.1
    assert np.median(per_pos) <= 1e-2
    assert float(aux["moe_drop"]) == pytest.approx(
        wdrop, abs=4 / (B * S * cfg.moe.top_k))


# ---------------------------------------------------------------------------
# full configs: parameter counts and leaf shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_config_params_and_shapes(arch):
    rcfg, cfg = rget_config(arch), get_config(arch)
    want = jax.eval_shape(lambda: rtf.init_params(jax.random.PRNGKey(0),
                                                  rcfg))
    got = convert.reference_like(cfg)[0]
    wflat = {tuple(k.key for k in path): (tuple(l.shape), str(l.dtype))
             for path, l in jax.tree_util.tree_flatten_with_path(want)[0]}
    gflat = {tuple(k.key for k in path): (tuple(l.shape), str(l.dtype))
             for path, l in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert gflat == wflat
    assert cfg.n_params() == sum(int(np.prod(s)) for s, _ in wflat.values())


def test_configs_match_reference():
    for arch in LM_ARCHS:
        for mine, ref in ((get_config(arch), rget_config(arch)),
                          (get_smoke(arch), rget_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_flups_poisson_config_and_serving():
    from repro.configs import get_config as rgc
    from repro_torch.configs import ALL_ARCHS, arch_shapes, get_config as gc
    assert "flups-poisson" in ALL_ARCHS
    mine, ref = gc("flups-poisson"), rgc("flups-poisson")
    want = dataclasses.asdict(ref)
    want["engine"] = {"xla": "torch", "pallas": "cuda"}[want["engine"]]
    got = dataclasses.asdict(mine)
    for d in (got, want):          # the enums by name: two packages' enums
        d["layout"] = d["layout"].name
        d["bcs"] = tuple(tuple(b.name for b in pair) for pair in d["bcs"])
    assert got == want
    assert arch_shapes("flups-poisson") == ()
    assert [s.name for s in arch_shapes("mamba2-2.7b")] == [
        "train_4k", "prefill_32k", "decode_32k", "long_500k"]
    # the serving half (ROADMAP item 3b) now runs
    cfg = get_smoke("qwen3-0.6b")
    model = tf.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    logits, caches = tf.prefill(model, tokens, max_len=6)
    assert logits.shape == (1, 4, cfg.vocab)
    fresh = tf.init_caches(cfg, 1, 6, device="cpu")
    assert convert.cache_leaves(fresh)[("layers", "sa", "k")].shape == \
        convert.cache_leaves(caches)[("layers", "sa", "k")].shape
    logits, _ = tf.decode_step(model, tokens[:, :1], caches, 4)
    assert logits.shape == (1, 1, cfg.vocab)
    assert torch.isfinite(logits).all()
    shape = {"data": 2, "model": 4}
    assert convert.local_spec(tf.param_specs(cfg, shape),
                              "layers.0.attn.wq") == ("data", "model", None)
    assert tf.cache_specs(cfg, shape, fresh)["layers"]["sa"]["k"] == (
        None, "data", None, None, None)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-medium",
                                  "moonshot-v1-16b-a3b"])
def test_converter_round_trip(arch):
    cfg = dataclasses.replace(get_smoke(arch), n_layers=4) \
        if arch == "recurrentgemma-9b" else get_smoke(arch)
    rcfg = dataclasses.replace(rget_smoke(arch), n_layers=cfg.n_layers)
    tree = _ref_params(rcfg)                 # 4 layers: a remainder block
    back = convert.to_reference(convert.from_reference(tree, cfg))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(tree)]
    for (_, a), (_, b) in zip(flat(back), flat(tree)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # a port-initialised model has the reference's layout too
    model = tf.init_params(torch.Generator().manual_seed(0), cfg)
    mine = convert.to_reference(model)
    assert [(p, a.shape) for p, a in flat(mine)] == \
        [(p, a.shape) for p, a in flat(tree)]


def test_port_init_statistics():
    """Initialisers: truncated normal at +-2 std scaled by fan-in; zero
    rms scales; the SSM and RG-LRU constants equal the reference's."""
    cfg = get_smoke("mamba2-2.7b")
    model = tf.init_params(torch.Generator().manual_seed(0), cfg)
    tree = _ref_params(rget_smoke("mamba2-2.7b"))
    w = model.layers[0].ssm.w_in.detach().numpy()
    assert np.abs(w).max() <= 2.0 / np.sqrt(w.shape[0]) + 1e-7
    assert abs(w.std() * np.sqrt(w.shape[0]) - 0.88) < 0.03
    assert np.abs(model.embed.detach().numpy()).max() <= 0.04 + 1e-7
    for name in ("a_log", "dt_bias", "d_skip", "conv_b"):
        np.testing.assert_allclose(
            getattr(model.layers[1].ssm, name).detach().numpy(),
            tree["layers"]["ssm"][name][1], rtol=1e-6)
    assert not model.layers[0].ln1.scale.detach().any()
    htree = _ref_params(rget_smoke("recurrentgemma-9b"))
    rec = rglru.init_rglru(torch.Generator().manual_seed(1),
                           get_smoke("recurrentgemma-9b"))
    np.testing.assert_allclose(rec.lam.detach().numpy(),
                               htree["groups"]["rec0"]["rec"]["lam"][0],
                               rtol=1e-6)
    assert not rec.conv_b.detach().any()
    # the per-module initialisers give the reference's shapes
    gen = torch.Generator().manual_seed(2)
    for mod, key in ((attn.init_attn(gen, get_smoke("qwen3-0.6b")), "attn"),
                     (moe.init_moe(gen, get_smoke("moonshot-v1-16b-a3b")),
                      "moe"),
                     (ssm.init_ssm(gen, cfg), "ssm")):
        arch = {"attn": "qwen3-0.6b", "moe": "moonshot-v1-16b-a3b",
                "ssm": "mamba2-2.7b"}[key]
        want = _ref_params(rget_smoke(arch))["layers"][key]
        got = {n.replace(".", "/"): tuple(p.shape)
               for n, p in mod.named_parameters()}
        assert got == {"/".join(k.key for k in path): l.shape[1:]
                       for path, l in
                       jax.tree_util.tree_flatten_with_path(want)[0]}


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def _rng_array(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def test_norms():
    x = _rng_array((3, 5, 16), 0, 3.0)
    w, b = _rng_array((16,), 1, 0.1), _rng_array((16,), 2, 0.1)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           rcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), F32_TOL)
    _close(common.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), 1e-5),
           rcommon.layer_norm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), 1e-5), F32_TOL)
    # population variance (jnp.var), not torch's default correction
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert common.layer_norm(xb, torch.ones(16), torch.zeros(16),
                             1e-5).dtype == torch.bfloat16


def test_rope_partial():
    cfg = get_smoke("glm4-9b")              # rope_fraction 0.5
    rcfg = rget_smoke("glm4-9b")
    x = _rng_array((2, 12, 4, cfg.d_head))
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    cos, sin = common.rope_freqs(cfg, torch.from_numpy(pos))
    rcos, rsin = rcommon.rope_freqs(rcfg, jnp.asarray(pos))
    assert cos.shape[-1] == cfg.d_head // 4
    _close(cos, rcos, F32_TOL)
    got = common.apply_rope(torch.from_numpy(x), cos, sin, 0.5)
    want = rcommon.apply_rope(jnp.asarray(x), rcos, rsin, 0.5)
    _close(got, want, F32_TOL)
    # the unrotated half passes through
    assert torch.equal(got[..., cfg.d_head // 2:],
                       torch.from_numpy(x)[..., cfg.d_head // 2:])
    _close(common.sinusoidal_positions(10, 16),
           rcommon.sinusoidal_positions(10, 16), 0.0)


def _attn_pair(arch, **over):
    rcfg = dataclasses.replace(rget_smoke(arch), compute_dtype="float32",
                               **over)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32",
                              **over)
    tree = _ref_params(rget_smoke(arch))
    model = convert.from_reference(tree, cfg)
    rp = jax.tree.map(lambda a: a[0], tree["layers"])["attn"]
    return cfg, rcfg, model.layers[0].attn, rp


def test_gqa_sdpa():
    """Query head h reads kv head h // g (repeat_interleave)."""
    cfg, rcfg, _, _ = _attn_pair("qwen3-0.6b")
    q = _rng_array((2, 9, 4, 16), 0)
    k, v = _rng_array((2, 9, 2, 16), 1), _rng_array((2, 9, 2, 16), 2)
    pos = np.tile(np.arange(9), (2, 1))
    mask = attn._mask(cfg, torch.from_numpy(pos), torch.from_numpy(pos),
                      True)
    got = attn._sdpa(cfg, torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), mask)
    want = rattn._sdpa(rcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       rattn._mask(rcfg, jnp.asarray(pos), jnp.asarray(pos),
                                   True))
    _close(got, want, F32_TOL)
    kr = torch.from_numpy(k).repeat_interleave(2, dim=2)
    vr = torch.from_numpy(v).repeat_interleave(2, dim=2)
    full = torch.nn.functional.scaled_dot_product_attention(
        torch.from_numpy(q).transpose(1, 2), kr.transpose(1, 2),
        vr.transpose(1, 2), is_causal=True).transpose(1, 2)
    _close(got, full, F32_TOL)


@pytest.mark.parametrize("arch,s,prefix_len", [
    ("qwen3-0.6b", 64, 0),          # causal
    ("starcoder2-7b", 64, 0),       # sliding window 16
    ("paligemma-3b", 64, 12),       # prefix-LM
    ("qwen3-0.6b", 50, 0),          # 50 % 16 != 0
])
def test_chunked_attention(arch, s, prefix_len):
    """The cases of tests/test_attention_chunked.py: chunked == naive in
    the port, and both == the reference's."""
    cfg, rcfg, p, rp = _attn_pair(arch)
    x = _rng_array((2, s, cfg.d_model))
    pos = np.tile(np.arange(s), (2, 1))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    with torch.no_grad():
        naive = attn.attention(p, dataclasses.replace(cfg, attn_block=0), tx,
                               tpos, prefix_len=prefix_len)
        chunked = attn.attention(p, dataclasses.replace(cfg, attn_block=16),
                                 tx, tpos, prefix_len=prefix_len)
    want = jax.jit(functools.partial(
        rattn.attention, cfg=dataclasses.replace(rcfg, attn_block=16),
        prefix_len=prefix_len))(rp, x=jnp.asarray(x),
                                positions=jnp.asarray(pos))
    _close(chunked, naive.numpy(), F32_TOL)
    _close(chunked, want, F32_TOL)


def test_moe_overflow_dispatch_combine():
    """Routing, dispatch and combine on a batch that overflows capacity:
    the same experts, gates, dropped entries, buffer and output."""
    cfg = dataclasses.replace(get_smoke("moonshot-v1-16b-a3b"),
                              compute_dtype="float32")
    rcfg = dataclasses.replace(rget_smoke("moonshot-v1-16b-a3b"),
                               compute_dtype="float32")
    tree = _ref_params(rget_smoke("moonshot-v1-16b-a3b"))
    rp = jax.tree.map(lambda a: a[0], tree["layers"])["moe"]
    p = convert.from_reference(tree, cfg).layers[0].moe
    # skew the tokens toward a few experts: capacity overflows
    x = _rng_array((3, 16, cfg.d_model)) + 2.0 * _rng_array(
        (1, 1, cfg.d_model), 7)
    xf = x.reshape(-1, cfg.d_model)
    gate, idx = moe._route(p, cfg.moe, torch.from_numpy(xf))
    rgate, ridx = rmoe._route(rp, rcfg.moe, jnp.asarray(xf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _close(gate, rgate, F32_TOL)
    m = cfg.moe
    cap = int(xf.shape[0] * m.top_k / m.n_experts * m.capacity_factor) + 1
    buf, (dest, keep) = moe._dispatch_local(torch.from_numpy(xf), idx,
                                            m.n_experts, cap)
    rbuf, (rdest, rkeep) = rmoe._dispatch_local(jnp.asarray(xf), ridx,
                                                m.n_experts, cap)
    assert not keep.all()                          # entries were dropped
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rdest))
    _close(buf, rbuf, 0.0)
    y = _rng_array(tuple(buf.shape), 3)
    got = moe._combine_local(torch.from_numpy(y), (dest, keep), gate,
                             xf.shape[0], m.top_k)
    want = rmoe._combine_local(jnp.asarray(y), (rdest, rkeep), rgate,
                               xf.shape[0], m.top_k)
    _close(got, want, F32_TOL)
    out, drop = moe.moe_block(p, cfg, torch.from_numpy(x))
    rout, rdrop = rmoe._moe_local(rp, rcfg, jnp.asarray(x))
    _close(out, rout, F32_TOL)
    assert float(rdrop) > 0
    assert float(drop) == pytest.approx(float(rdrop), abs=1e-7)


def test_moe_router_ties_lower_index_first():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3]])

    class P:
        router = torch.eye(4)
    gate, idx = moe._route(P, get_smoke("moonshot-v1-16b-a3b").moe,
                           torch.log(probs))
    rgate, ridx = rmoe._route({"router": jnp.eye(4)},
                              rget_smoke("moonshot-v1-16b-a3b").moe,
                              jnp.log(jnp.asarray(probs.numpy())))
    assert idx.tolist() == np.asarray(ridx).tolist() == [[1, 2]]


def test_ssd_chunked_several_chunks():
    rng = np.random.default_rng(0)
    b, s, h, p, n, chunk = 2, 32, 3, 4, 5, 8
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(np.linspace(0.0, 1.0, h)).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    y, st = ssm.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, Bm, Cm)),
                            chunk)
    ry, rst = rssm.ssd_chunked(*map(jnp.asarray, (xh, dt, a, Bm, Cm)), chunk)
    _close(y, ry, F32_TOL)
    _close(st, rst, F32_TOL)
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, Bm, Cm)), 12)


def test_ssd_gradient_finite_where_decays_overflow():
    """Above the diagonal the in-chunk decay difference passes 88 at full
    width; masking it before the exp keeps the gradient finite.  The
    forward is the reference's."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 64, 4, 2, 3
    xh = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(
        np.float32))
    dt = torch.full((b, s, h), 0.1, requires_grad=True)
    a = -torch.tensor([1.0, 20.0, 40.0, 80.0])
    Bm = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    Cm = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    y, _ = ssm.ssd_chunked(xh, dt, a, Bm, Cm, s)
    ry, _ = rssm.ssd_chunked(*map(lambda t: jnp.asarray(t.detach().numpy()),
                                  (xh, dt, a, Bm, Cm)), s)
    _close(y, ry, F32_TOL)
    y.square().sum().backward()
    assert torch.isfinite(dt.grad).all()


def test_rglru_scan():
    """The Hillis-Steele scan against the reference's associative scan
    and against the plain recurrence."""
    cfg = dataclasses.replace(get_smoke("recurrentgemma-9b"),
                              compute_dtype="float32")
    rcfg = dataclasses.replace(rget_smoke("recurrentgemma-9b"),
                               compute_dtype="float32")
    tree = _ref_params(rget_smoke("recurrentgemma-9b"))
    rp = jax.tree.map(lambda a: a[0], tree["groups"]["rec0"])["rec"]
    p = convert.from_reference(tree, cfg).groups["rec0"][0].rec
    x = _rng_array((2, 37, cfg.d_model))
    with torch.no_grad():
        out, state, _ = rglru.rglru_block(p, cfg, torch.from_numpy(x))
    rout, rstate, _ = jax.jit(functools.partial(rrglru.rglru_block,
                                                cfg=rcfg))(rp, x=jnp.asarray(x))
    _close(out, rout, F32_TOL)
    _close(state, rstate, F32_TOL)
    a = torch.rand(2, 37, 5) * 0.9 + 0.05
    bb = torch.randn(2, 37, 5)
    _, hh = rglru._scan(a, bb)
    h = torch.zeros(2, 5)
    for t in range(37):
        h = a[:, t] * h + bb[:, t]
        _close(hh[:, t], h.numpy(), 1e-5)
