"""The port's ring attention and expert-parallel MoE on a mesh == the
reference's single-process attention and ``_moe_local``.

One spawn of 8 gloo CPU ranks, mesh (2, 4) ("data", "model"), for the
module (``tests/test_torch_ranks.py`` scenario ``lm_mesh``; the ranks
never import JAX).  The reference runs here, in float32, on the same
numpy inputs, and the ranks load its parameters through
``models.convert``.  The reference's own ring test
(``tests/test_ring_attention.py``) runs 8 host devices in a subprocess;
its cases are held here against the reference's plain ``attention``,
the comparison that test makes.

- ring attention, each rank's (batch, sequence) block (b 1, s 8 of
  2 x 32) against the same block of the reference's attention: qwen3
  (causal, qk-norm), starcoder2 (window 16 over blocks of 8: 3 of the 4
  ring steps run), paligemma (``prefix_len=12``), each at its own heads
  and at ``n_heads=6, n_kv=2`` (6 heads on a ring of 4); 1e-4.
- the expert-parallel ``moe_block`` (moonshot smoke: 8 experts, 2 on
  each model rank) under a2a, pipelined:2 and fused against the
  reference's ``_moe_local`` on each rank's block: the same local
  capacity, only the FFN's row grouping changes; 1e-4, and the drop
  fraction's mean over the 8 blocks within 1e-6; the same from a module
  that holds only the rank's 2 experts (the layout ``param_specs``
  gives), and a ``ValueError`` from one holding neither 8 nor 2.
- both under autograd (the paths that raised before their gradients
  were ported): on each rank the input gradient and the weight
  gradients summed over "model" of the last ring case (paligemma at 6
  heads) against the whole attention's on the rank's data shard, and of
  the expert-parallel MoE against ``_moe_local``'s on the rank's block;
  1e-4 (``test_torch_train_mesh.py`` holds both against ``jax.vjp``).
- the model on the mesh: qwen3 smoke with ``attn_ring`` (every layer's
  attention on the ring), its forward on each rank's data shard against
  the reference's forward; moonshot smoke with a capacity factor of
  E / k (no token dropped, so the shards' capacities match the whole
  batch's), its prefill's logits and caches against the reference's
  prefill; 1e-4.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import test_torch_ranks as ranks
from repro.configs import get_smoke as rget_smoke
from repro.models import attention as rattn
from repro.models import moe as rmoe
from repro.models import transformer as rtf

TOL = 1e-4
B, S = 2, 32
MOE_COMMS = ("a2a:1", "pipelined:2", "fused:1")
MAX_LEN = S + 4

# (config tag, arch, overrides); float32 compute throughout
MODELS = {
    "qwen3": ("qwen3-0.6b", {}),
    "qwen3_h6": ("qwen3-0.6b", {"n_heads": 6, "n_kv": 2}),
    "starcoder2": ("starcoder2-7b", {}),
    "starcoder2_h6": ("starcoder2-7b", {"n_heads": 6, "n_kv": 2}),
    "paligemma": ("paligemma-3b", {}),
    "paligemma_h6": ("paligemma-3b", {"n_heads": 6, "n_kv": 2}),
    "moe": ("moonshot-v1-16b-a3b", {}),
    "ring_model": ("qwen3-0.6b", {"attn_ring": True}),
    "moe_model": ("moonshot-v1-16b-a3b", {}),
}
NO_DROP = {"moe_model"}
RING = {f"{m}": {"model": m, "prefix_len": 12 if "paligemma" in m else 0}
        for m in MODELS if m.split("_")[0] in ("qwen3", "starcoder2",
                                               "paligemma")}


def _cfg(tag):
    arch, over = MODELS[tag]
    cfg = dataclasses.replace(rget_smoke(arch), compute_dtype="float32",
                              **over)
    if tag in NO_DROP:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_mesh")
    rng = np.random.default_rng(0)
    models = {}
    params = {}
    for tag in MODELS:
        cfg = _cfg(tag)
        params[tag] = rtf.init_params(jax.random.PRNGKey(0), cfg)
        np.savez(d / f"model_{tag}.npz", **_flat(params[tag]))
        arch, over = MODELS[tag]
        models[tag] = {"arch": arch,
                       "over": dict(over, compute_dtype="float32")}
        if tag in NO_DROP:
            models[tag]["capacity_factor"] = cfg.moe.capacity_factor

    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    for tag, case in RING.items():
        cfg = _cfg(tag)
        p = jax.tree.map(lambda a: a[0], params[tag]["layers"])["attn"]
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        np.save(d / f"ring_{tag}_x.npy", x)
        np.save(d / f"ring_{tag}_want.npy", np.asarray(rattn.attention(
            p, cfg, jnp.asarray(x), pos, causal=True,
            prefix_len=case["prefix_len"])))

    # the reference's _moe_local on each rank's (batch, sequence) block
    cfg = _cfg("moe")
    p = jax.tree.map(lambda a: a[0], params["moe"]["layers"])["moe"]
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want = np.zeros_like(x)
    drops = []
    for i in range(2):
        for j in range(4):
            blk = (slice(i, i + 1), slice(j * S // 4, (j + 1) * S // 4))
            out, drop = rmoe._moe_local(p, cfg, jnp.asarray(x[blk]))
            want[blk] = np.asarray(out)
            drops.append(float(drop))
    np.save(d / "moe_x.npy", x)
    np.save(d / "moe_want.npy", want)

    cfg = _cfg("ring_model")
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    np.save(d / "fwd_tokens.npy", tokens)
    np.save(d / "fwd_want.npy", np.asarray(
        rtf.forward(params["ring_model"], cfg, jnp.asarray(tokens))[0]))
    cfg = _cfg("moe_model")
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    logits, caches = rtf.prefill(params["moe_model"], cfg,
                                 jnp.asarray(tokens), max_len=MAX_LEN)
    np.save(d / "pre_tokens.npy", tokens)
    np.save(d / "pre_want.npy", np.asarray(logits))
    np.savez(d / "pre_caches.npz", **_flat(caches))

    runs = ranks.launch("lm_mesh", d, 8, {
        "models": models, "ring": RING, "moe_comms": MOE_COMMS,
        "max_len": MAX_LEN})
    return runs, float(np.mean(drops))


@pytest.mark.parametrize("case", sorted(RING))
def test_ring_attention_matches_reference(mesh_run, case):
    runs, _ = mesh_run
    for r, res in enumerate(runs):
        assert res["ring"][case] < TOL, (r, res["ring"][case])


@pytest.mark.parametrize("comm", MOE_COMMS)
def test_expert_parallel_moe_matches_local(mesh_run, comm):
    runs, drop = mesh_run
    for r, res in enumerate(runs):
        err, got_drop = res["moe"][comm]
        assert err < TOL, (r, err)
        assert abs(got_drop - drop) < 1e-6, (r, got_drop, drop)


def test_expert_parallel_moe_from_the_ranks_own_experts(mesh_run):
    runs, drop = mesh_run
    for r, res in enumerate(runs):
        err, got_drop = res["moe_own_experts"]
        assert err < TOL, (r, err)
        assert abs(got_drop - drop) < 1e-6, (r, got_drop, drop)
        assert "takes all 8 or this rank's 2" in res["moe_bad_rows"], \
            res["moe_bad_rows"]


def test_ring_and_expert_parallel_raise_under_autograd(mesh_run):
    """They no longer raise: their gradients are the local paths'."""
    runs, _ = mesh_run
    for r, res in enumerate(runs):
        for key in ("ring_grad", "moe_grad"):
            assert res[key] < TOL, (r, key, res[key])


def test_model_on_the_mesh_matches_reference(mesh_run):
    runs, _ = mesh_run
    for r, res in enumerate(runs):
        assert res["forward_ring"] < TOL, (r, res["forward_ring"])
        assert res["prefill_moe"] < TOL, (r, res["prefill_moe"])
        assert set(res["prefill_caches"]) == {"layers/sa/k",
                                              "layers/sa/v"}
        for k, err in res["prefill_caches"].items():
            assert err < TOL, (r, k, err)
