"""Serving from a tensor-parallel state in the port == the reference's
single-process serving, on the CPU.

One spawn of 8 gloo CPU ranks for the module (``tests/test_torch_ranks.py``
scenario ``serve_tp``; the ranks never import JAX).  Each rank loads the
reference's parameters through ``models.convert``, cuts them to its
blocks by the training layout rule (``train_step.shard_params_`` by
``"train"``: each leaf over "data" where ``param_specs`` names it, over
"model" the attention heads, the MLP's d_ff, the vocabulary, the MoE's
own experts, the SSM's d_model and the RG-LRU's d_rnn)
and serves its data shard of a global batch of 4 on meshes (2, 4) and
(4, 2), as ``tests/test_torch_serve_sharded.py`` serves the ``"fsdp"``
layout: ``prefill`` of 24 prompt tokens into caches for 4 more
positions, then two ``decode_step``s, against the reference's
single-process ``prefill`` and ``decode_step`` on the whole parameters
(that file's configs, inputs and reference runner).

- the six families on both meshes: each rank's rows of every call's
  logits, and its block of the caches by the reference's
  ``cache_specs`` (its data shard's rows, its kv heads over "model"
  where they divide; the SSM's and the RG-LRU's caches whole) after
  prefill and after the last step, within 1e-4 of the reference's
  largest value there.  qwen3 on (2, 4) is the GQA case: 4 query heads
  and 2 kv heads over 4 model ranks, ``wk``/``wv`` and the caches whole,
  each rank's query head reading its group's kv head; whisper's cross
  caches hold the rank's kv heads of the encoder output.  Ranks on one
  "data" coordinate hold bit-equal logits and bit-equal cache leaves
  where the leaf is whole over "model"; every rank holds some
  tensor-parallel block (mamba2 and recurrentgemma some of an SSM or
  RG-LRU layer), and its parameters are the training rule's shapes;
- the serving restore: qwen3's tensor-parallel train state after one
  step on (2, 4) (``shard_state_``), saved, and its parameters saved
  alone, each restored onto (4, 2) through ``held_params_like`` by
  ``"train"``: the blocks' shapes the training rule's, and every logit
  and cache leaf bit-equal to serving the same trained parameters cut
  there by ``shard_params_``;
- with no spawn: ``init_caches(mesh=)`` for the ten smoke configs on
  (2, 4), (4, 2) and (2, 2, 2) against the reference's ``cache_specs``
  local shapes.
"""
import concurrent.futures
import math
import types

import numpy as np
import pytest

import jax

import test_torch_ranks as ranks
from test_torch_serve_sharded import (B, EXTRA, MESHES, MODELS, RESTORE, S,
                                      STEPS, TOL, _cfg, _decoder_rope_off,
                                      _err, _inputs, _reference)
from test_torch_train_mesh import _flat, _port_leaf, _spec_flat
from test_torch_train_tp import SMOKE_ARCHS, _held
from repro.configs import get_smoke as rget_smoke
from repro.models import transformer as rtf
from repro.training import train_step as rts
from repro_torch.models.convert import nest

CASES = [f"{tag}-{'x'.join(map(str, m))}" for tag in MODELS for m in MESHES]
CACHE_MESHES = {(2, 4): ("data", "model"), (4, 2): ("data", "model"),
                (2, 2, 2): ("pod", "data", "model")}


def _cache_held(key, spec, shape, sizes):
    """Per dimension of the reference cache leaf ``key`` (``shape`` under
    the reference's ``cache_specs`` entry ``spec``), the rank's block as
    the port holds it: ``(extent, axes)``, split over the axes the spec
    names where they divide the dimension."""
    out = []
    for k, d in enumerate(shape):
        e = spec[k] if k < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        count = math.prod(sizes.get(a, 1) for a in axes)
        out.append((d // count, axes) if count > 1 and d % count == 0
                   else (d, ()))
    return out


def _cache_block(want, held, coords, sizes):
    """The rank's block ``held`` (``_cache_held``'s) of ``want`` at
    ``coords``; several axes on one dimension in mesh order, the major
    first."""
    idx = []
    for n, axes in held:
        i = 0
        for a in axes:
            i = i * sizes[a] + coords[a]
        idx.append(slice(i * n, (i + 1) * n) if axes else slice(None))
    return want[tuple(idx)]


@pytest.fixture(scope="module")
def tp_serve(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_tp")
    models, cases, params, inputs = {}, {}, {}, {}
    for i, tag in enumerate(MODELS):
        cfg = _cfg(tag)
        params[tag] = rtf.init_params(jax.random.PRNGKey(0), cfg)
        np.savez(d / f"model_{tag}.npz", **_flat(params[tag]))
        arch, over = MODELS[tag]
        models[tag] = {"arch": arch,
                       "over": dict(over, compute_dtype="float32")}
        if cfg.moe is not None:
            models[tag]["capacity_factor"] = cfg.moe.capacity_factor
        prompt, steps = inputs[tag] = _inputs(cfg, 20 + i)
        np.savez(d / f"prompt_{tag}.npz", **prompt)
        for j, tok in enumerate(steps):
            np.savez(d / f"tok_{tag}_{j}.npz", token=tok)
        prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
        cases[tag] = {"prompt": f"prompt_{tag}",
                      "steps": [f"tok_{tag}_{j}" for j in range(STEPS)],
                      "max_len": prefix + S + EXTRA}
    rng = np.random.default_rng(4)
    toks = rng.integers(0, _cfg(RESTORE).vocab, (B, S + 1)).astype(np.int32)
    np.savez(d / "train_batch.npz", inputs=toks[:, :-1], labels=toks[:, 1:],
             mask=np.ones((B, S), np.float32))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(ranks.launch, "serve_tp", d, 8, {
            "models": models, "cases": cases, "meshes": list(MESHES),
            "restore": {"model": RESTORE, "batch": "train_batch"}}, 240)
        with _decoder_rope_off():
            ref = {tag: _reference(_cfg(tag), params[tag], *inputs[tag],
                                   cases[tag]["max_len"]) for tag in MODELS}
        runs = ranks_done.result()
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(8)]
    specs, cache_specs = {}, {}
    for tag in MODELS:
        for shape in MESHES:
            sizes = dict(zip(("data", "model"), shape))
            specs[tag, shape] = _spec_flat(rts.state_specs(
                _cfg(tag), sizes).params)
            cache_specs[tag, shape] = _spec_flat(rtf.cache_specs(
                _cfg(tag), sizes, nest({tuple(k.split("/")): a for k, a in
                                        ref[tag]["caches"].items()})))
    return {"runs": runs, "arrays": arrays, "ref": ref, "specs": specs,
            "cache_specs": cache_specs,
            "params": {tag: _flat(p) for tag, p in params.items()}}


def _assert_held(run, specs, params, sizes, recurrent=False):
    """Every parameter of the rank shaped by the training layout rule
    (``test_torch_train_tp._held``); some tensor-parallel block held,
    where ``recurrent`` some of an SSM or RG-LRU layer."""
    for name, shape in run["held"].items():
        key, i = _port_leaf(name)
        held = _held(key, specs[key], params[key].shape, sizes)
        assert shape == [n for n, _ in held[i is not None:]], (name, shape)
    assert run["tp_blocks"] > 0
    assert run["recurrent_blocks"] > 0 or not recurrent


@pytest.mark.parametrize("case", CASES)
def test_tp_serving_matches_reference(tp_serve, case):
    """Each rank's rows of every call's logits and its ``cache_specs``
    block of the caches after prefill and after the last decode step,
    against the reference's single-process serving of the whole batch;
    the rank's parameters shaped by the training layout rule (mamba2's
    and recurrentgemma's with SSM or RG-LRU leaves over "model"); ranks
    on one "data" coordinate bit-equal in the logits and in the cache
    leaves held whole over "model"."""
    tag, mesh = case.split("-")
    shape = tuple(int(x) for x in mesh.split("x"))
    sizes = dict(zip(("data", "model"), shape))
    want = tp_serve["ref"][tag]
    cspecs = tp_serve["cache_specs"][tag, shape]
    b = B // shape[0]
    res = [run[case] for run in tp_serve["runs"]]
    whole = {}                      # (data, part, leaf) -> the first array
    for r, (rec, arr) in enumerate(zip(res, tp_serve["arrays"])):
        idx = rec["data"]
        coords = {"data": idx, "model": rec["model"]}
        _assert_held(rec, tp_serve["specs"][tag, shape],
                     tp_serve["params"][tag], sizes,
                     _cfg(tag).family in ("ssm", "hybrid"))
        for j, w in enumerate(want["logits"]):
            err = _err(arr[f"{case}/logits{j}"], w[idx * b:(idx + 1) * b])
            assert err <= TOL, (r, f"logits of call {j}", err)
        for part in ("caches_prefill", "caches"):
            got = {k[len(f"{case}/{part}/"):]: a for k, a in arr.items()
                   if k.startswith(f"{case}/{part}/")}
            assert set(got) == set(want[part]), (r, part)
            for k, w in want[part].items():
                held = _cache_held(k, cspecs[k], w.shape, sizes)
                err = _err(got[k], _cache_block(w, held, coords, sizes))
                assert err <= TOL, (r, part, k, err)
                if not any("model" in axes for _, axes in held):
                    first = whole.setdefault((idx, part, k), got[k])
                    np.testing.assert_array_equal(got[k], first,
                                                  err_msg=(r, part, k))
    for r, rec in enumerate(res):
        peer = next(p for p in res if p["data"] == rec["data"])
        assert rec["crc"] == peer["crc"], (r, "logits differ from those of "
                                           "its data coordinate's ranks")


@pytest.mark.parametrize("ckpt", ["state_ck", "params_ck"])
def test_tp_serving_restore_from_a_training_checkpoint(tp_serve, ckpt):
    """qwen3's tensor-parallel train state after a step on (2, 4), saved
    (the state, or its parameters alone), restored onto (4, 2) by
    ``held_params_like`` under ``"train"``: shaped by the training rule,
    and every logit and cache leaf bit-equal to serving the same
    parameters cut by ``shard_params_``."""
    key = f"restore-{ckpt}"
    sizes = {"data": 4, "model": 2}
    for r, (run, arr) in enumerate(zip(tp_serve["runs"],
                                       tp_serve["arrays"])):
        assert run[key]["held"] == run["restore-cut"]["held"], r
        _assert_held(run[key], tp_serve["specs"][RESTORE, (4, 2)],
                     tp_serve["params"][RESTORE], sizes)
        got = {k[len(key) + 1:]: a for k, a in arr.items()
               if k.startswith(key + "/")}
        want = {k[len("restore-cut/"):]: a for k, a in arr.items()
                if k.startswith("restore-cut/")}
        assert got and set(got) == set(want), r
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=(r, k))


@pytest.mark.parametrize("shape", list(CACHE_MESHES),
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_rank_caches_match_cache_specs(arch, shape):
    """``init_caches(mesh=)``: every leaf the reference's ``cache_specs``
    local shape of a global batch of 8 (its data shard's rows, the kv
    heads over "model" where they divide; the SSM state's heads whole:
    ``cache_specs`` splits them as the kv heads, and mamba2 has one)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import convert
    from repro_torch.models import transformer as tf
    sizes = dict(zip(CACHE_MESHES[shape], shape))
    mesh = types.SimpleNamespace(mesh_dim_names=CACHE_MESHES[shape],
                                 shape=shape)
    rcfg = rget_smoke(arch)
    want = jax.eval_shape(lambda: rtf.init_caches(rcfg, 8, 64))
    specs = _spec_flat(rtf.cache_specs(rcfg, sizes, want))
    want = {"/".join(str(k.key) for k in path): a.shape for path, a in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = convert._dotted(tf.init_caches(get_smoke(arch), 8, 64,
                                         device="meta", mesh=mesh))
    split = 0
    for name, t in got.items():
        key, i = _port_leaf(name)
        held = _cache_held(key, specs[key], want[key], sizes)
        assert tuple(t.shape) == tuple(n for n, _ in held[i is not None:]), \
            (name, tuple(t.shape), held)
        split += any("model" in axes for _, axes in held)
    assert {_port_leaf(n)[0] for n in got} == set(want)
    assert bool(split) == (rcfg.n_kv % sizes["model"] == 0), (arch, split)
