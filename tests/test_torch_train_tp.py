"""Tensor parallelism in the port's mesh train step == the reference's
single-process training, on the CPU.

One spawn of 8 gloo CPU ranks for the module (``tests/test_torch_ranks.py``
scenario ``train_tp``; the ranks never import JAX), while the
reference's jitted steps run here, in float32, on the same numpy
batches (global batches of 4, the second half's mask dropping its last 6
positions).  Each case's state is cut by ``shard_state_``: a rank holds
its block of every parameter and both moments over "data" where
``state_specs`` names it, and over "model" its block of the attention
heads (``wq``, ``wo``, and ``wk``/``wv`` where the kv heads divide), of
the MLP's d_ff, of the vocabulary, of the SSM's d_model (``w_in``'s
rows, ``w_out``'s columns) and of the RG-LRU's d_rnn, and its own
experts.

- three train steps of qwen3 smoke on (2, 4) (4 heads, 2 kv heads over 4
  model ranks: each rank's query head reads a kv head of ``wk``/``wv``
  held whole) and on (4, 2) (both split), qwen3 with ``attn_ring`` on
  (2, 4) (the attention's blocks gathered whole for the ring),
  moonshot smoke on (2, 4) (attention tensor-parallel beside its own
  experts, capacity factor E / k), whisper smoke on (4, 2) (the
  encoder's and the cross-attention's heads), mamba2 smoke on (2, 4)
  and (4, 2) (the SSM's projections row- and column-parallel, its core
  replicated) and recurrentgemma smoke on (2, 4) and (4, 2) (the RG-LRU
  on the rank's channels of d_rnn beside the tensor-parallel MLP and
  local attention), against the reference's
  ``jax.jit(train_step_fn(cfg, adam))`` (the ring changes none of its
  single-process numbers): losses within 1e-6 relative, the gathered
  parameters and moments within rtol 2e-5, atol 2e-6, the first step's
  gradient blocks within 1e-4 of the reference gradient leaf's largest
  value; each rank's held shapes equal to the reference's
  ``state_specs`` local shapes; the gathered state bit-equal on every
  rank and the leaves held whole bit-equal along "model";
- the int8-compressed steps of qwen3 with ``attn_ring`` on (2, 4) and
  on (4, 2), held as above but for the state, which is held with
  ``test_torch_train_mesh._assert_state_int8``'s allowance of one int8
  quantum a step at a rounding tie: a tensor-parallel region's partial
  sums, all-reduced over "model", and the vocab-parallel loss's sums
  reach a gradient element in another order than the reference's one
  computation, so one at a tie of its int8 code can round a quantum off
  the reference's;
- qwen3's and mamba2's states on (2, 4) saved and restored onto
  (4, 2): each rank's blocks bit-equal to the saved leaves' slices
  (serving from such a state: ``tests/test_torch_serve_tp.py``);
- with no spawn: ``held_shapes`` against the reference's ``state_specs``
  for the ten smoke configs on (2, 4), (4, 2) and (2, 2, 2), every leaf
  the reference's local shape.
"""
import concurrent.futures
import math

import numpy as np
import pytest

import jax

import test_torch_ranks as ranks
from test_torch_train_mesh import (GRAD_TOL, LOSS_TOL, MODELS, NO_DROP,
                                   _assert_state, _assert_state_int8,
                                   _batch, _cfg, _flat, _port_leaf,
                                   _reference_steps, _slice, _spec_flat)
from repro.configs import get_smoke as rget_smoke
from repro.training import optimizer as ropt
from repro.models import transformer as rtf
from repro.training import train_step as rts

N_STEPS = 3
# case: (model tag of test_torch_train_mesh.MODELS, mesh)
CASES = {"qwen3-2x4": ("qwen3", (2, 4)), "qwen3-4x2": ("qwen3", (4, 2)),
         "qwen3_ring-2x4": ("qwen3_ring", (2, 4)),
         "moonshot-2x4": ("moonshot", (2, 4)),
         "whisper-4x2": ("whisper", (4, 2)),
         "mamba2-2x4": ("mamba2", (2, 4)), "mamba2-4x2": ("mamba2", (4, 2)),
         "recurrentgemma-2x4": ("recurrentgemma", (2, 4)),
         "recurrentgemma-4x2": ("recurrentgemma", (4, 2))}
# the int8-compressed cases, the same way
INT8 = {"qwen3_ring_int8-2x4": ("qwen3_ring", (2, 4)),
        "qwen3_ring_int8-4x2": ("qwen3_ring", (4, 2))}
# the reference run of a model tag: one process runs no ring
REF = {"qwen3": "qwen3", "qwen3_ring": "qwen3", "moonshot": "moonshot",
       "whisper": "whisper", "mamba2": "mamba2",
       "recurrentgemma": "recurrentgemma"}
# the cases whose states are saved and restored onto (4, 2)
CKPT = "qwen3-2x4"
SSM_CKPT = "mamba2-2x4"
SMOKE_ARCHS = ("qwen3-0.6b", "moonshot-v1-16b-a3b", "mamba2-2.7b",
               "recurrentgemma-9b", "whisper-medium", "paligemma-3b",
               "minitron-8b", "starcoder2-7b", "glm4-9b",
               "qwen3-moe-235b-a22b")
MESHES = {(2, 4): ("data", "model"), (4, 2): ("data", "model"),
          (2, 2, 2): ("pod", "data", "model")}


def _sizes(shape):
    return dict(zip(MESHES[shape], shape))


def _held(key, spec, shape, sizes):
    """Per dimension of the reference leaf ``key`` (stacked ``shape``
    under ``spec``), the rank's block as the port holds it by the
    training layout rule: ``(extent, axis or None)``, split over each
    axis the spec names; a dimension the axis does not divide stays
    whole."""
    out = []
    for k, d in enumerate(shape):
        e = spec[k] if k < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        axes = [a for a in axes if a in ("data", "model")]
        count = math.prod(sizes.get(a, 1) for a in axes)
        if axes and d % count == 0 and count > 1:
            assert len(axes) == 1, (key, spec)
            out.append((d // count, axes[0]))
        else:
            out.append((d, None))
    return out


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_tp")
    models = {}
    for tag in REF:
        cfg = _cfg(tag)
        np.savez(d / f"model_{tag}.npz",
                 **_flat(rtf.init_params(jax.random.PRNGKey(0), cfg)))
        arch, over = MODELS[tag]
        models[tag] = {"arch": arch,
                       "over": dict(over, compute_dtype="float32")}
        if tag in NO_DROP:
            models[tag]["capacity_factor"] = cfg.moe.capacity_factor
    batches = {}
    for tag in set(REF.values()):
        batches[tag] = [_batch(_cfg(tag), i, batch=4)
                        for i in range(N_STEPS)]
        for i, b in enumerate(batches[tag]):
            np.savez(d / f"batch_{tag}_{i}.npz", **b)
    cases = {case: {"model": tag, "mesh": list(shape),
                    "compress": case in INT8,
                    "batches": [f"batch_{REF[tag]}_{i}"
                                for i in range(N_STEPS)]}
             for case, (tag, shape) in {**CASES, **INT8}.items()}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(ranks.launch, "train_tp", d, 8, {
            "models": models, "cases": cases, "ckpt": [CKPT, SSM_CKPT]},
            180)
        with concurrent.futures.ThreadPoolExecutor(4) as refs:
            ref = {tag: refs.submit(_reference_steps, tag,
                                    ropt.AdamWConfig(), batches[tag], True)
                   for tag in batches}
            ref["qwen3_int8"] = refs.submit(
                _reference_steps, "qwen3",
                ropt.AdamWConfig(grad_compress="int8"), batches["qwen3"])
            ref = {tag: job.result() for tag, job in ref.items()}
        runs = ranks_done.result()
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(8)]
    states = {case: dict(np.load(d / f"rank0_{case}.npz"))
              for case in {**CASES, **INT8}}
    specs = {(tag, shape): _spec_flat(rts.state_specs(
        _cfg(tag), _sizes(shape)).params)
        for tag, shape in set(CASES.values()) | set(INT8.values())
        | {("qwen3", (4, 2))}}
    return {"runs": runs, "arrays": arrays, "states": states, "ref": ref,
            "specs": specs}


def _hold_steps(tp_run, case, tag, shape, losses):
    """Every rank's losses of ``case`` against the reference's
    (``losses``), its held shapes against ``state_specs``' local shapes,
    its first step's gradient blocks against the reference's gradients;
    the leaves held whole bit-equal along "model" and the gathered state
    bit-equal on every rank."""
    sizes = _sizes(shape)
    specs = tp_run["specs"][tag, shape]
    _, states, grads = tp_run["ref"][REF[tag]]
    res = [run[case] for run in tp_run["runs"]]
    for r, (rec, arr) in enumerate(zip(res, tp_run["arrays"])):
        assert len(rec["loss"]) == len(losses)
        for i, (g, w) in enumerate(zip(rec["loss"], losses)):
            assert math.isfinite(g) and abs(g - w) <= LOSS_TOL * abs(w), \
                (r, i, g, w)
        coords = {"data": rec["data"], "model": rec["model"]}
        blocks = 0
        for name, got in rec["held"]["params"].items():
            key, i = _port_leaf(name)
            held = _held(key, specs[key], states[-1]["params/" + key].shape,
                         sizes)[i is not None:]
            for tree in ("params", "m", "v"):
                assert rec["held"][tree][name] == [n for n, _ in held], \
                    (r, tree, name)
            blocks += any(a == "model" for _, a in held)
            g_want = grads[key] if i is None else grads[key][i]
            err = np.abs(arr[f"{case}/{name}"] - g_want[_slice(
                held, coords)]).max() / max(np.abs(g_want).max(), 1e-30)
            assert err < GRAD_TOL, (r, name, err)
        assert blocks, "no leaf held as a block over \"model\""
    for r, rec in enumerate(res):
        peer = next(p for p in res if p["data"] == rec["data"])
        assert rec["crc"] == peer["crc"], (r, "the leaves held whole differ "
                                           "along \"model\"")
        assert rec["whole_crc"] == res[0]["whole_crc"], r


@pytest.mark.parametrize("case", list(CASES))
def test_tp_train_step_matches_reference(tp_run, case):
    tag, shape = CASES[case]
    losses, states, _ = tp_run["ref"][REF[tag]]
    _hold_steps(tp_run, case, tag, shape, losses)
    _assert_state(tp_run["states"][case], states[-1])


@pytest.mark.parametrize("case", list(INT8))
def test_tp_int8_train_step_within_one_quantum(tp_run, case):
    """An int8 case as ``test_tp_train_step_matches_reference`` holds its
    case, but its last state with ``_assert_state_int8``'s allowance
    against the reference's int8 steps (module docstring)."""
    tag, shape = INT8[case]
    losses, states, _ = tp_run["ref"]["qwen3_int8"]
    _hold_steps(tp_run, case, tag, shape, losses)
    _assert_state_int8(tp_run["states"][case], states)


def _hold_restore(tp_run, case, leaves):
    """The state of ``case`` after its steps, saved from its mesh and
    restored onto (4, 2) by ``held_like`` and ``held_specs``: each rank's
    blocks of the parameters and both moments bit-equal to the saved
    leaves' slices by the training layout rule, some of ``leaves`` (a
    predicate of the leaf's key) over "model"."""
    saved = tp_run["states"][case]
    tag = CASES[case][0]
    specs = tp_run["specs"][tag, (4, 2)]
    over_model = 0
    for r, (run, arr) in enumerate(zip(tp_run["runs"], tp_run["arrays"])):
        coords = dict(zip(("data", "model"), run["ckpt"][case]["mesh_b"]))
        for k, whole in saved.items():
            key = k.split("/", 1)[1]
            held = _held(key, specs[key], whole.shape, _sizes((4, 2)))
            np.testing.assert_array_equal(arr[f"ckpt/{case}/{k}"],
                                          whole[_slice(held, coords)],
                                          err_msg=(r, k))
            over_model += leaves(key) and any(a == "model" for _, a in held)
    assert over_model


def test_tp_checkpoint_restores_as_blocks(tp_run):
    """``CKPT``'s state (qwen3) restored onto (4, 2) as the rank's blocks
    (``_hold_restore``)."""
    _hold_restore(tp_run, CKPT, lambda key: True)


def test_tp_ssm_checkpoint_restores_as_blocks(tp_run):
    """``SSM_CKPT``'s state (mamba2 on (2, 4)) restored onto (4, 2) as the
    rank's blocks, the SSM's ``w_in`` and ``w_out`` among those over
    "model" (``_hold_restore``)."""
    _hold_restore(tp_run, SSM_CKPT, lambda key: "/ssm/" in f"/{key}/")


def _local(spec, shape, sizes, axes=("data", "model")):
    """``shape`` cut by ``spec``'s entries among ``axes`` on a mesh of
    ``sizes`` (a dimension they do not divide whole)."""
    out = []
    for k, d in enumerate(shape):
        e = spec[k] if k < len(spec) else None
        names = () if e is None else (e,) if isinstance(e, str) else e
        c = math.prod(sizes.get(a, 1) for a in names if a in axes)
        out.append(d // c if d % c == 0 else d)
    return tuple(out)


@pytest.mark.parametrize("shape", list(MESHES),
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_held_shapes_match_state_specs(arch, shape):
    """The training layout rule (``train_step.held_shapes``) against the
    reference's ``state_specs``: every leaf the reference's local shape
    on the mesh."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.convert import logical_shapes
    from repro_torch.training import train_step as ts
    sizes = _sizes(shape)
    specs = _spec_flat(rts.state_specs(rget_smoke(arch), sizes).params)
    held = ts.held_shapes(get_smoke(arch), sizes)
    whole = logical_shapes(get_smoke(arch))
    assert set(held) == set(whole)
    over_model = 0
    for name, got in held.items():
        key, i = _port_leaf(name)
        spec = specs[key][i is not None:]
        want = _local(spec, whole[name], sizes)
        assert got == want, (name, got, want, spec)
        over_model += got != _local(spec, whole[name], sizes, ("data",))
    assert over_model, "no leaf split over \"model\""
