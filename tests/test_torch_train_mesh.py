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
- the train step on mesh (2, 4), three steps on the global batches of 4
  of the reference's ``jax.jit(train_step_fn(cfg, adam))``: qwen3 with
  ``attn_ring``, also under ``grad_compress="int8"``; moonshot at a
  capacity factor of E / k (no token dropped, so the shards' capacities
  match the whole batch's); mamba2, recurrentgemma, whisper and
  paligemma, replicated over "model".  The second half of the batch's
  mask drops its last 6 positions, which holds the loss to the global
  mask sum.  Parameters and moments within the reference elastic test's
  rtol 2e-5, atol 2e-6; losses within 1e-6 relative; every rank's
  parameters bit-equal to rank 0's after every step.  qwen3 under int8
  also on (4, 2), on global batches of 4: there the first moment may
  differ by one int8 quantum a step at a rounding tie
  (``_assert_state_int8``);
- the same cases from a state cut by ``shard_state_`` (FSDP: the rank's
  block of every parameter, moment and error-feedback leaf over "data",
  its own experts over "model") on (2, 4) and (4, 2) (global batches of
  4), and qwen3 on a (2, 2, 2) ("pod", "data", "model") mesh, against
  the same reference steps: each rank's held shapes equal to the
  reference's ``state_specs`` local shapes over "data" (and the experts'
  "model"), the spec's other "model" entries whole; the first step's
  gradient blocks within 1e-4 of the reference gradient leaf's largest
  value; ranks on one "data" coordinate bit-equal, the gathered state
  bit-equal on every rank; the losses and the gathered state as above
  (the int8 case on (4, 2) also against the port's whole-state steps
  there); the int8 case's state on (2, 4), saved and restored onto
  (4, 2), each rank's blocks of it, error feedback included, bit-equal
  to the saved leaves' slices;
- the elastic rescale (``tests/test_elastic.py``'s scenario):
  minitron-8b smoke, two steps on (2, 4), ``ck.save``, ``ck.restore``
  onto (4, 2), two more steps, against four straight reference steps at
  rtol 2e-5, atol 2e-6, on a global batch of 4 (the reference test's 2
  does not split over 4 data shards); from a whole state, and from a
  sharded one: its save byte-identical to a save of the same state held
  whole, each rank's restored blocks bit-equal to the saved leaves'
  slices;
- a moonshot state holding each rank's own 2 experts, one step on (2, 4)
  (held as the all-expert step is), saved whole and restored onto (4, 2):
  each rank gets its new 4 experts' rows of the parameters and both
  moments, bit for bit.
"""
import concurrent.futures
import dataclasses
import itertools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

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
# FSDP cases: a train-step case on a mesh, from a sharded state
MESH_NAMES = {(2, 4): ("data", "model"), (4, 2): ("data", "model"),
              (2, 2, 2): ("pod", "data", "model")}
FSDP = {f"fsdp-{case}-{'x'.join(map(str, shape))}": (case, shape)
        for case in STEPS for shape in ((2, 4), (4, 2))}
FSDP["fsdp-qwen3_ring-2x2x2"] = ("qwen3_ring", (2, 2, 2))
# whole-state train-step cases on (4, 2), at the global batch of 4
WHOLE_4X2 = {"qwen3_ring_int8-4x2": "qwen3_ring_int8"}
# the sharded int8 state saved after its steps and restored onto (4, 2)
INT8_CKPT = "fsdp-qwen3_ring_int8-2x4"


def _ref_key(case):
    """The reference run an FSDP case is held against: its train-step
    case's on a mesh of 2 data shards, else the same steps on a global
    batch of 4 (``<case>@4``), which splits over 4 data shards."""
    step_case, shape = FSDP[case]
    return step_case if shape == (2, 4) else step_case + "@4"


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


def _reference_steps(tag, adam, batches, grads=False):
    """The reference's jitted train steps from its initial state: the
    losses, the state (params, m, v) after each step, flattened, and,
    where ``grads``, the first step's gradients (``jax.grad`` of its
    loss, jitted apart from the step), else None."""
    cfg = _cfg(tag)
    state = rts.make_train_state(jax.random.PRNGKey(0), cfg, adam=adam)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    first = None
    if grads:
        first = _flat(jax.jit(jax.grad(lambda p, b: rts.loss_fn(
            p, cfg, b, None, None)[0]))(state.params, batches[0]))
    step = jax.jit(rts.train_step_fn(cfg, adam))
    losses, states = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        states.append(_flat({"params": state.params,
                             "m": state.opt_state["m"],
                             "v": state.opt_state["v"]}))
    return losses, states, first


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
        for key, size in ((case, B), (case + "@4", 4)):
            batches[key] = [_batch(_cfg(tag), i, batch=size)
                            for i in range(N_STEPS)]
            for i, b in enumerate(batches[key]):
                np.savez(d / f"batch_{key}_{i}.npz", **b)
            steps[key] = {"model": tag, "compress": compress,
                          "batches": [f"batch_{key}_{i}"
                                      for i in range(N_STEPS)]}
    fsdp = {case: dict(steps[_ref_key(case)], mesh=list(FSDP[case][1]))
            for case in FSDP}
    steps = dict({case: steps[case] for case in STEPS},
                 **{case: dict(steps[step_case + "@4"], mesh=[4, 2])
                    for case, step_case in WHOLE_4X2.items()})
    batches["elastic"] = [_batch(_cfg("minitron"), i, batch=4)
                          for i in range(4)]
    for i, b in enumerate(batches["elastic"]):
        np.savez(d / f"batch_elastic_{i}.npz", **b)

    # the ranks run while the reference is computed here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(ranks.launch, "train_mesh", d, 8, {
            "models": models, "ring": RING, "moe_comms": MOE_COMMS,
            "steps": steps, "fsdp": fsdp, "int8_ckpt": INT8_CKPT,
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

        # the reference runs, four at a time (XLA compiles and runs them
        # outside the interpreter lock)
        with_grads = {_ref_key(case) for case in FSDP}
        jobs = {"elastic": ("minitron", ropt.AdamWConfig())}
        for case, (tag, compress) in STEPS.items():
            adam = ropt.AdamWConfig(grad_compress="int8" if compress
                                    else "none")
            jobs.update({key: (tag, adam) for key in (case, case + "@4")})
        with concurrent.futures.ThreadPoolExecutor(4) as refs:
            ref = {key: refs.submit(_reference_steps, tag, adam,
                                    batches[key], key in with_grads)
                   for key, (tag, adam) in jobs.items()}
            ref = {key: job.result() for key, job in ref.items()}
        runs = ranks_done.result()
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(8)]
    states = {case: dict(np.load(d / f"rank0_{case}.npz"))
              for case in list(STEPS) + list(WHOLE_4X2) + list(FSDP) + [
                  "elastic", "elastic_fsdp", "elastic_fsdp_saved",
                  "own_ckpt", "int8_ckpt"]}
    specs = {(tag, shape): _spec_flat(rts.state_specs(
        _cfg(tag), dict(zip(MESH_NAMES[shape], shape))).params)
        for tag in {t for t, _ in STEPS.values()} | {"minitron"}
        for shape in MESH_NAMES}
    return {"runs": runs, "arrays": arrays, "states": states, "want": want,
            "ref": ref, "specs": specs}


def _coords(r):
    return r // 4, r % 4


def _spec_flat(tree):
    """{"a/b/c": PartitionSpec} of the reference's spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): spec
            for path, spec in leaves}


def _held(key, spec, shape, sizes):
    """Per dimension of the reference leaf ``key`` (stacked ``shape``
    under ``spec``), the rank's block as the port holds it by the layout
    rule: ``(extent, axis or None)``, split over "data" where the spec
    names it and over "model" only on an MoE expert weight (its expert
    axis); a dimension the axis does not divide stays whole."""
    expert = "/moe/w_" in "/" + key
    out = []
    for k, d in enumerate(shape):
        e = spec[k] if k < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        axes = [a for a in axes if a == "data" or (a == "model" and expert)]
        count = math.prod(sizes.get(a, 1) for a in axes)
        if axes and d % count == 0 and count > 1:
            assert len(axes) == 1, (key, spec)
            out.append((d // count, axes[0]))
        else:
            out.append((d, None))
    return out


def _port_leaf(name):
    """The reference leaf of the port's dotted parameter ``name`` and its
    layer index (None unstacked)."""
    parts = name.split(".")
    idx = [int(p) for p in parts if p.isdigit()]
    return "/".join(p for p in parts if not p.isdigit()), \
        (idx[0] if idx else None)


def _slice(held, coords):
    """The index of the block ``held`` (``_held``'s) at ``coords``."""
    return tuple(slice(None) if a is None else
                 slice(coords[a] * n, (coords[a] + 1) * n) for n, a in held)


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


def _int8_on_four(key) -> bool:
    """Whether reference run ``key`` is an int8 case's on a batch of 4
    (the port's runs of it split over 4 data shards)."""
    return key.endswith("@4") and STEPS[key[:-2]][1]


def _assert_state_int8(got, states):
    """``got`` against an int8 reference run's last state (``states``, one
    a step), as ``_assert_state``, but for one allowance.  Summed over 4
    data shards, a gradient element that lies at a rounding tie of its
    int8 code can round one quantum off the reference's (the reference
    sums the batch of 4 in one computation); the error feedback carries
    the difference into the next step's code.  So an element of the first
    moment may differ from the reference's by the moment's share of one
    quantum, up or down, at each step: by ``(1 - b1) sum_i b1^(N-i) k_i
    q_i`` with each ``k_i`` in {-1, 0, 1}, ``q_i`` step ``i``'s quantum
    of the leaf (the leaf's largest clipped, dequantised gradient, 127
    quanta, recovered from the reference's moments), within the usual
    limits of that.  At most one element in a thousand of a leaf may
    take it; the parameters and the second moment are held as usual (a
    quantum moves them by less than the limits)."""
    b1 = ropt.AdamWConfig().b1
    n = len(states)
    want = states[-1]
    assert set(want) == set(got), set(want) ^ set(got)
    for k in want:
        if not k.startswith("m/"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
            continue
        ms = [np.zeros_like(want[k])] + [st[k] for st in states]
        quanta = [np.abs((ms[i] - b1 * ms[i - 1]) / (1 - b1)).max() / 127
                  for i in range(1, n + 1)]
        shifts = np.array([(1 - b1) * sum(b1 ** (n - i) * c * q for i, (c, q)
                                          in enumerate(zip(ks, quanta), 1))
                           for ks in itertools.product((-1, 0, 1), repeat=n)])
        diff = (np.asarray(got[k], np.float64) - want[k]).reshape(-1)
        lim = ATOL + RTOL * np.abs(want[k]).reshape(-1)
        off = np.abs(diff[:, None] - shifts[None]).min(axis=1)
        assert (off <= lim).all(), (k, float((off - lim).max()))
        moved = int((np.abs(diff) > lim).sum())
        assert moved <= diff.size // 1000, (k, moved, diff.size)


def _hold_state(mesh_run, got, key):
    """``got`` against reference run ``key``'s last state:
    ``_assert_state``, or ``_assert_state_int8`` for an int8 case on 4
    data shards."""
    states = mesh_run["ref"][key][1]
    if _int8_on_four(key):
        _assert_state_int8(got, states)
    else:
        _assert_state(got, states[-1])


def _assert_losses_and_bits(res, want_losses):
    for r, rec in enumerate(res):
        got = rec["loss"]
        assert len(got) == len(want_losses)
        for i, (g, w) in enumerate(zip(got, want_losses)):
            assert abs(g - w) <= LOSS_TOL * abs(w), (r, i, g, w)
        assert rec["crc"] == res[0]["crc"], (r, "parameters differ from "
                                             "rank 0's")


def _assert_fsdp(mesh_run, case):
    """An FSDP case's held shapes, first-step gradient blocks, losses and
    bits (ranks on one "data" coordinate bit-equal, the gathered state
    bit-equal on every rank)."""
    step_case, shape = FSDP[case]
    tag = STEPS[step_case][0]
    sizes = dict(zip(MESH_NAMES[shape], shape))
    specs = mesh_run["specs"][tag, shape]
    losses, states, grads = mesh_run["ref"][_ref_key(case)]
    res = [run["fsdp"][case] for run in mesh_run["runs"]]
    for r, (rec, arr) in enumerate(zip(res, mesh_run["arrays"])):
        for g in rec["loss"]:
            assert math.isfinite(g), (r, rec["loss"])
        for i, (g, w) in enumerate(zip(rec["loss"], losses)):
            assert abs(g - w) <= LOSS_TOL * abs(w), (r, i, g, w)
        assert len(rec["loss"]) == len(losses)
        coords = {"data": rec["data"], "model": rec["model"]}
        held_trees = rec["held"]
        assert set(held_trees["params"]) == set(held_trees["m"]) \
            == set(held_trees["v"]), r
        if STEPS[step_case][1]:
            assert set(held_trees["err_fb"]) == set(held_trees["params"])
        blocks = 0
        for name, got in held_trees["params"].items():
            key, i = _port_leaf(name)
            held = _held(key, specs[key], states[-1]["params/" + key].shape,
                         sizes)
            if i is not None:
                held = held[1:]
            want = [n for n, _ in held]
            blocks += want != list(grads[key].shape[i is not None:])
            for tree in ("params", "m", "v", "err_fb"):
                if held_trees[tree]:
                    assert held_trees[tree][name] == want, (r, tree, name)
            g_want = grads[key] if i is None else grads[key][i]
            err = np.abs(arr[f"{case}/{name}"] - g_want[_slice(
                held, coords)]).max() / max(np.abs(g_want).max(), 1e-30)
            assert err < GRAD_TOL, (r, name, err)
        assert blocks, "no leaf held as a block"
    for r, rec in enumerate(res):
        peer = next(p for p in res if p["data"] == rec["data"])
        assert rec["crc"] == peer["crc"], (r, "blocks differ from those of "
                                           "its data coordinate's ranks")
        assert rec["whole_crc"] == res[0]["whole_crc"], r


@pytest.mark.parametrize("case", list(STEPS) + list(WHOLE_4X2) + list(FSDP))
def test_mesh_train_step_matches_reference(mesh_run, case):
    """A whole-state case (``STEPS``, ``WHOLE_4X2``) or an FSDP one against
    the reference's steps.  An int8 FSDP case on 4 data shards is also
    held, at the usual limits on every leaf, against the port's
    whole-state steps on the same mesh and batches: not bit for bit, as
    its reduce-scatter sums the shards in another order than the whole
    state's all-reduce."""
    state = mesh_run["states"][case]
    if case in FSDP:
        _assert_fsdp(mesh_run, case)
        _hold_state(mesh_run, state, _ref_key(case))
        whole = f"{FSDP[case][0]}-{'x'.join(map(str, FSDP[case][1]))}"
        if whole in WHOLE_4X2:
            _assert_state(state, mesh_run["states"][whole])
        return
    key = WHOLE_4X2[case] + "@4" if case in WHOLE_4X2 else case
    _assert_losses_and_bits([run["steps"][case] for run in mesh_run["runs"]],
                            mesh_run["ref"][key][0])
    _hold_state(mesh_run, state, key)


def test_elastic_rescale_matches_straight_steps(mesh_run):
    losses, states, _ = mesh_run["ref"]["elastic"]
    _assert_losses_and_bits([run["elastic"] for run in mesh_run["runs"]],
                            losses)
    _assert_state(mesh_run["states"]["elastic"], states[-1])


def test_sharded_elastic_rescale_matches_straight_steps(mesh_run):
    """From a sharded state on (2, 4): the save byte-identical to that of
    the same state held whole; restored onto (4, 2), each rank's blocks
    bit-equal to the saved leaves' slices and shaped by the layout rule;
    the four steps against the reference's."""
    losses, states, _ = mesh_run["ref"]["elastic"]
    runs = mesh_run["runs"]
    assert runs[0]["elastic_fsdp"]["save_identical"], runs[0]["elastic_fsdp"]
    assert runs[0]["elastic_fsdp"]["files"] > 2
    for r, run in enumerate(runs):
        got = run["elastic_fsdp"]["loss"]
        assert len(got) == len(losses)
        for i, (g, w) in enumerate(zip(got, losses)):
            assert abs(g - w) <= LOSS_TOL * abs(w), (r, i, g, w)
    _assert_state(mesh_run["states"]["elastic_fsdp"], states[-1])
    saved = mesh_run["states"]["elastic_fsdp_saved"]
    specs = mesh_run["specs"]["minitron", (4, 2)]
    sizes = {"data": 4, "model": 2}
    cut = 0
    for r, (run, arr) in enumerate(zip(runs, mesh_run["arrays"])):
        coords = dict(zip(("data", "model"), run["mesh_b"]))
        for k, whole in saved.items():
            key = k.split("/", 1)[1]
            held = _held(key, specs[key], whole.shape, sizes)
            block = arr[f"elastic_fsdp/{k}"]
            np.testing.assert_array_equal(block, whole[_slice(held, coords)],
                                          err_msg=(r, k))
            cut += block.shape != whole.shape
        for name, shape in run["elastic_fsdp"]["held"].items():
            key, i = _port_leaf(name)
            held = _held(key, specs[key], saved["params/" + key].shape,
                         sizes)
            assert shape == [n for n, _ in held[i is not None:]], (r, name)
    assert cut, "no leaf restored as a block"


def test_own_experts_step_and_checkpoint_resplit(mesh_run):
    losses, states, _ = mesh_run["ref"]["moonshot"]
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




def test_sharded_int8_state_restores_as_blocks(mesh_run):
    """The sharded int8 state of ``INT8_CKPT`` (the error feedback cut as
    the parameters), saved after its steps on (2, 4) and restored onto
    (4, 2) through ``held_like(compress=True)`` and ``held_specs``: each
    rank's blocks of the parameters, both moments and the error feedback
    bit-equal to the saved leaves' slices, the parameters and the error
    feedback shaped by the layout rule."""
    saved = dict(mesh_run["states"][INT8_CKPT])
    saved.update(mesh_run["states"]["int8_ckpt"])
    tag = STEPS[FSDP[INT8_CKPT][0]][0]
    specs = mesh_run["specs"][tag, (4, 2)]
    sizes = {"data": 4, "model": 2}
    cut = set()
    for r, (run, arr) in enumerate(zip(mesh_run["runs"],
                                       mesh_run["arrays"])):
        coords = dict(zip(("data", "model"), run["mesh_b"]))
        for k, whole in saved.items():
            held = _held(k.split("/", 1)[1], specs[k.split("/", 1)[1]],
                         whole.shape, sizes)
            block = arr[f"int8_ckpt/{k}"]
            np.testing.assert_array_equal(block, whole[_slice(held, coords)],
                                          err_msg=(r, k))
            if block.shape != whole.shape:
                cut.add(k.split("/", 1)[0])
        for tree in ("params", "err_fb"):
            for name, shape in run["int8_ckpt"][tree].items():
                key, i = _port_leaf(name)
                held = _held(key, specs[key], saved["params/" + key].shape,
                             sizes)
                assert shape == [n for n, _ in held[i is not None:]], \
                    (r, tree, name)
    assert cut == {"params", "m", "v", "err_fb"}, cut
