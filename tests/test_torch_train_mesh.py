"""Training on a mesh in the port == the reference's single-process
training, on the CPU.

One spawn of 8 gloo CPU ranks for the module (``tests/test_torch_ranks.py``
scenario ``train_mesh``; the ranks never import JAX).  The reference runs
here, in float32, on the same numpy inputs, and the ranks load its
parameters through ``models.convert``.  The reference's own elastic test
(``tests/test_elastic.py``) needs 8 host devices in a subprocess; its
scenario is held here against straight single-process reference steps,
the comparison that test makes.

- the gradients of ring attention, mesh (2, 4): for each of
  ``test_torch_lm_mesh.py``'s six ring cases (qwen3; starcoder2, window
  16 over blocks of 8; paligemma, ``prefix_len=12``; each also at 6
  heads on the ring of 4), each rank's input-gradient block and the
  weight gradients summed over "model", against ``jax.vjp`` of the
  reference's plain ``attention`` on the rank's data shard with the same
  cotangent; 1e-4 relative to the leaf's largest value;
- the gradients of the expert-parallel MoE (moonshot smoke, 8 experts, 2
  a model rank) under a2a:1, pipelined:2 and fused:1, from all 8 experts
  and from the rank's own 2: the input, router (summed over "model") and
  expert gradients (the rank's rows) against ``jax.vjp`` of the
  reference's ``_moe_local`` on each rank's block (the expert-parallel
  MoE is ``_moe_local`` block by block: the same local capacity); 1e-4;
- the train step on mesh (2, 4), three steps on the global batches of
  the reference's ``jax.jit(train_step_fn(cfg, adam))``: qwen3 with
  ``attn_ring``, also under ``grad_compress="int8"``; moonshot at a
  capacity factor of E / k (no token dropped, so the shards' capacities
  match the whole batch's); mamba2, recurrentgemma, whisper and
  paligemma, replicated over "model".  The second data shard's mask
  drops its last 6 positions, which holds the loss to the global mask
  sum.  Parameters and moments within the reference elastic test's
  rtol 2e-5, atol 2e-6; losses within 1e-6 relative; every rank's parameters bit-equal to rank
  0's after every step;
- the elastic rescale (``tests/test_elastic.py``'s scenario):
  minitron-8b smoke, two steps on (2, 4), ``ck.save``, ``ck.restore``
  onto (4, 2), two more steps, against four straight reference steps at
  rtol 2e-5, atol 2e-6, on a global batch of 4 (the reference test's 2
  does not split over 4 data shards);
- a moonshot state holding each rank's own 2 experts, one step on (2, 4)
  (held as the all-expert step is), saved whole and restored onto (4, 2):
  each rank gets its new 4 experts' rows of the parameters and both
  moments, bit for bit.
"""
import concurrent.futures
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
from repro.training import optimizer as ropt
from repro.training import train_step as rts

GRAD_TOL = 1e-4
LOSS_TOL = 1e-6
RTOL, ATOL = 2e-5, 2e-6
B, S, RING_S = 2, 16, 32
N_STEPS = 3
MOE_COMMS = ("a2a:1", "pipelined:2", "fused:1")

# (arch, overrides); float32 compute throughout
MODELS = {
    "qwen3": ("qwen3-0.6b", {}),
    "qwen3_h6": ("qwen3-0.6b", {"n_heads": 6, "n_kv": 2}),
    "starcoder2": ("starcoder2-7b", {}),
    "starcoder2_h6": ("starcoder2-7b", {"n_heads": 6, "n_kv": 2}),
    "paligemma": ("paligemma-3b", {}),
    "paligemma_h6": ("paligemma-3b", {"n_heads": 6, "n_kv": 2}),
    "moe": ("moonshot-v1-16b-a3b", {}),
    "qwen3_ring": ("qwen3-0.6b", {"attn_ring": True}),
    "moonshot": ("moonshot-v1-16b-a3b", {}),
    "mamba2": ("mamba2-2.7b", {}),
    "recurrentgemma": ("recurrentgemma-9b", {}),
    "whisper": ("whisper-medium", {}),
    "minitron": ("minitron-8b", {}),
}
NO_DROP = {"moonshot"}
RING = {m: {"model": m, "prefix_len": 12 if "paligemma" in m else 0}
        for m in ("qwen3", "qwen3_h6", "starcoder2", "starcoder2_h6",
                  "paligemma", "paligemma_h6")}
# train-step case: (model tag, int8 compression)
STEPS = {
    "qwen3_ring": ("qwen3_ring", False),
    "qwen3_ring_int8": ("qwen3_ring", True),
    "moonshot": ("moonshot", False),
    "mamba2": ("mamba2", False),
    "recurrentgemma": ("recurrentgemma", False),
    "whisper": ("whisper", False),
    "paligemma": ("paligemma", False),
}
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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(cfg, step, batch=B):
    """A global batch; the second half's mask drops the last 6
    positions."""
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, cfg.vocab, (batch, S + 1)).astype(np.int32)
    mask = np.ones((batch, S), np.float32)
    mask[batch // 2:, S - 6:] = 0.0
    out = {"inputs": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    if cfg.n_frontend_tokens:
        out["frontend"] = rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _reference_steps(tag, adam, batches):
    """The reference's jitted train steps from its initial state: the
    losses and the state (params, m, v) after each step, flattened."""
    cfg = _cfg(tag)
    state = rts.make_train_state(jax.random.PRNGKey(0), cfg, adam=adam)
    step = jax.jit(rts.train_step_fn(cfg, adam))
    losses, states = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        states.append(_flat({"params": state.params,
                             "m": state.opt_state["m"],
                             "v": state.opt_state["v"]}))
    return losses, states


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    rng = np.random.default_rng(0)
    models, params = {}, {}
    for tag in MODELS:
        cfg = _cfg(tag)
        params[tag] = rtf.init_params(jax.random.PRNGKey(0), cfg)
        np.savez(d / f"model_{tag}.npz", **_flat(params[tag]))
        arch, over = MODELS[tag]
        models[tag] = {"arch": arch,
                       "over": dict(over, compute_dtype="float32")}
        if tag in NO_DROP:
            models[tag]["capacity_factor"] = cfg.moe.capacity_factor

    # the inputs, all drawn before the ranks start
    inputs = {}
    for tag in list(RING) + ["moe"]:
        x = rng.standard_normal((B, RING_S, _cfg(tag).d_model)).astype(
            np.float32)
        inputs[tag] = x, rng.standard_normal(x.shape).astype(np.float32)
        name = f"ring_{tag}" if tag in RING else tag
        np.save(d / f"{name}_x.npy", inputs[tag][0])
        np.save(d / f"{name}_ct.npy", inputs[tag][1])
    steps, batches = {}, {}
    for case, (tag, compress) in STEPS.items():
        batches[case] = [_batch(_cfg(tag), i) for i in range(N_STEPS)]
        for i, b in enumerate(batches[case]):
            np.savez(d / f"batch_{case}_{i}.npz", **b)
        steps[case] = {"model": tag, "compress": compress,
                       "batches": [f"batch_{case}_{i}"
                                   for i in range(N_STEPS)]}
    batches["elastic"] = [_batch(_cfg("minitron"), i, batch=4)
                          for i in range(4)]
    for i, b in enumerate(batches["elastic"]):
        np.savez(d / f"batch_elastic_{i}.npz", **b)

    # the ranks run while the reference is computed here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(ranks.launch, "train_mesh", d, 8, {
            "models": models, "ring": RING, "moe_comms": MOE_COMMS,
            "steps": steps,
            "elastic": {"model": "minitron",
                        "batches": [f"batch_elastic_{i}" for i in range(4)]},
            "own_ckpt": {"model": "moonshot",
                         "batches": ["batch_moonshot_0"]}}, 240)

        # ring attention: jax.vjp of the plain attention on each data
        # shard
        want = {}
        pos = jnp.broadcast_to(jnp.arange(RING_S), (1, RING_S))
        for tag, case in RING.items():
            cfg = _cfg(tag)
            p = jax.tree.map(lambda a: a[0], params[tag]["layers"])["attn"]
            x, ct = inputs[tag]
            for i in range(B):
                _, vjp = jax.vjp(lambda p_, x_: rattn.attention(
                    p_, cfg, x_, pos, causal=True,
                    prefix_len=case["prefix_len"]), p,
                    jnp.asarray(x[i:i + 1]))
                dp, dx = vjp(jnp.asarray(ct[i:i + 1]))
                want[f"ring_{tag}", i] = dict(_flat(dp), x=np.asarray(dx))

        # the MoE: jax.vjp of _moe_local on each rank's (batch, sequence)
        # block; a data shard's weight gradients sum its four blocks'
        cfg = _cfg("moe")
        p = jax.tree.map(lambda a: a[0], params["moe"]["layers"])["moe"]
        x, ct = inputs["moe"]
        q = RING_S // 4
        for i in range(B):
            acc = None
            for j in range(4):
                blk = (slice(i, i + 1), slice(j * q, (j + 1) * q))
                _, vjp = jax.vjp(
                    lambda p_, x_: rmoe._moe_local(p_, cfg, x_)[0], p,
                    jnp.asarray(x[blk]))
                dp, dx = vjp(jnp.asarray(ct[blk]))
                want["moe_x", i, j] = np.asarray(dx)
                dp = _flat(dp)
                acc = dp if acc is None else {k: acc[k] + dp[k] for k in dp}
            want["moe", i] = acc

        ref = {}
        for case, (tag, compress) in STEPS.items():
            adam = ropt.AdamWConfig(grad_compress="int8" if compress
                                    else "none")
            ref[case] = _reference_steps(tag, adam, batches[case])
        ref["elastic"] = _reference_steps("minitron", ropt.AdamWConfig(),
                                          batches["elastic"])
        runs = ranks_done.result()
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(8)]
    states = {case: dict(np.load(d / f"rank0_{case}.npz"))
              for case in list(STEPS) + ["elastic", "own_ckpt"]}
    return {"runs": runs, "arrays": arrays, "states": states, "want": want,
            "ref": ref}


def _coords(r):
    return r // 4, r % 4


@pytest.mark.parametrize("case", sorted(RING))
def test_ring_attention_gradients_match_reference(mesh_run, case):
    want = mesh_run["want"]
    q = RING_S // 4
    for r, arr in enumerate(mesh_run["arrays"]):
        dr, mr = _coords(r)
        w = want[f"ring_{case}", dr]
        err = _rel(arr[f"ring_{case}/x"], w["x"][:, mr * q:(mr + 1) * q])
        assert err < GRAD_TOL, (r, "x", err)
        for name in ("wq", "wk", "wv", "wo", "q_norm/scale", "k_norm/scale"):
            if name in w:
                err = _rel(arr[f"ring_{case}/{name.replace('/', '.')}"],
                           w[name])
                assert err < GRAD_TOL, (r, name, err)


@pytest.mark.parametrize("layout", ["all", "own"])
@pytest.mark.parametrize("comm", MOE_COMMS)
def test_expert_parallel_moe_gradients_match_local(mesh_run, comm, layout):
    want = mesh_run["want"]
    e_loc = 8 // 4
    for r, arr in enumerate(mesh_run["arrays"]):
        dr, mr = _coords(r)
        key = f"moe_{comm}_{layout}"
        err = _rel(arr[f"{key}/x"], want["moe_x", dr, mr])
        assert err < GRAD_TOL, (r, "x", err)
        w = want["moe", dr]
        assert _rel(arr[f"{key}/router"], w["router"]) < GRAD_TOL, r
        for name in ("w_in", "w_gate", "w_out"):
            if name in w:
                err = _rel(arr[f"{key}/{name}"],
                           w[name][mr * e_loc:(mr + 1) * e_loc])
                assert err < GRAD_TOL, (r, name, err)


def _assert_state(got, want):
    """Every leaf of the reference's state (``want``: params, m, v) in
    ``got`` within rtol 2e-5, atol 2e-6."""
    assert set(want) == set(got), set(want) ^ set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _assert_losses_and_bits(res, want_losses):
    for r, rec in enumerate(res):
        got = rec["loss"]
        assert len(got) == len(want_losses)
        for i, (g, w) in enumerate(zip(got, want_losses)):
            assert abs(g - w) <= LOSS_TOL * abs(w), (r, i, g, w)
        assert rec["crc"] == res[0]["crc"], (r, "parameters differ from "
                                             "rank 0's")


@pytest.mark.parametrize("case", list(STEPS))
def test_mesh_train_step_matches_reference(mesh_run, case):
    losses, states = mesh_run["ref"][case]
    _assert_losses_and_bits([run["steps"][case] for run in mesh_run["runs"]],
                            losses)
    _assert_state(mesh_run["states"][case], states[-1])


def test_elastic_rescale_matches_straight_steps(mesh_run):
    losses, states = mesh_run["ref"]["elastic"]
    _assert_losses_and_bits([run["elastic"] for run in mesh_run["runs"]],
                            losses)
    _assert_state(mesh_run["states"]["elastic"], states[-1])


def test_own_experts_step_and_checkpoint_resplit(mesh_run):
    losses, states = mesh_run["ref"]["moonshot"]
    _assert_losses_and_bits([run["own_ckpt"] for run in mesh_run["runs"]],
                            losses[:1])
    whole = mesh_run["states"]["own_ckpt"]
    _assert_state(whole, states[0])
    e_loc = 8 // 2
    for r, (run, arr) in enumerate(zip(mesh_run["runs"],
                                       mesh_run["arrays"])):
        _, mr = run["mesh_b"]
        assert run["own_ckpt"]["rows"], r
        for name, shape in run["own_ckpt"]["rows"].items():
            assert shape[0] == e_loc, (r, name, shape)
        got = {k[len("own_ckpt/"):]: v for k, v in arr.items()
               if k.startswith("own_ckpt/")}
        assert got, r
        for k, a in got.items():
            full = whole[k]
            np.testing.assert_array_equal(
                a, full[:, mr * e_loc:(mr + 1) * e_loc], err_msg=(r, k))

