"""Serving from a sharded state in the port == the reference's
single-process serving, on the CPU.

One spawn of 8 gloo CPU ranks for the module (``tests/test_torch_ranks.py``
scenario ``serve_sharded``; the ranks never import JAX).  Each rank loads
the reference's parameters through ``models.convert``, cuts them to its
blocks by the layout rule (``train_step.shard_params_``: each leaf over
"data" where ``param_specs`` names it, an MoE's own experts over
"model", the dense weights' "model" entries whole) and serves its data
shard of a global batch of 4 on meshes (2, 4) and (4, 2): ``prefill`` of
24 prompt tokens (paligemma's 8 image tokens before them, whisper's 8
encoder frames beside them) into caches for 4 more positions, then two
``decode_step``s.  The reference runs here, in float32, the same prompt
and tokens through its single-process ``prefill`` and ``decode_step`` on
the whole parameters.

- six families' smoke configs: qwen3 (dense), moonshot (MoE, at a
  capacity factor of E / k: a rank routes its own tokens, the reference
  the whole batch), mamba2 (SSM), recurrentgemma at 4 layers (one
  (rec, rec, attn) group and a remainder rec block; its window of 16
  rolls over the 24-token prompt), whisper (cross-attention, the
  reference's decode with its decoder RoPE off and its prefill's caches
  under "layers", as ``tests/test_torch_decode.py`` holds it) and
  paligemma (the image prefix): each rank's rows of every call's logits
  and of the caches after prefill and after the last step within 1e-4
  of the reference's largest value there; ranks on one "data"
  coordinate bit-equal; some leaf held as a block on every rank;
- the serving restore: qwen3's FSDP train state after one step on
  (2, 4), saved, and its parameters saved alone, each restored onto
  (4, 2) as the rank's serving blocks: the blocks' shapes the layout
  rule's, and every logit and cache bit-equal to serving the same
  trained parameters cut there by ``shard_params_``.
"""
import concurrent.futures
import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import test_torch_ranks as ranks
from test_torch_train_mesh import _flat, _held, _port_leaf, _spec_flat
from repro.configs import get_smoke as rget_smoke
from repro.models import attention as rattn
from repro.models import transformer as rtf
from repro.training import train_step as rts

TOL = 1e-4
B, S, STEPS, EXTRA = 4, 24, 2, 4
MESHES = ((2, 4), (4, 2))
# (arch, overrides); float32 compute throughout
MODELS = {
    "qwen3": ("qwen3-0.6b", {}),
    "moonshot": ("moonshot-v1-16b-a3b", {}),
    "mamba2": ("mamba2-2.7b", {}),
    "recurrentgemma": ("recurrentgemma-9b", {"n_layers": 4}),
    "whisper": ("whisper-medium", {}),
    "paligemma": ("paligemma-3b", {}),
}
RESTORE = "qwen3"
CASES = [f"{tag}-{'x'.join(map(str, m))}" for tag in MODELS for m in MESHES]


def _cfg(tag):
    arch, over = MODELS[tag]
    cfg = dataclasses.replace(rget_smoke(arch), compute_dtype="float32",
                              **over)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    prompt = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_frontend_tokens:
        prompt["frontend"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    steps = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
             for _ in range(STEPS)]
    return prompt, steps


@contextlib.contextmanager
def _decoder_rope_off():
    """The reference's whisper decode with its decoder RoPE off (its
    forward has none; ROADMAP queue 3)."""
    qkv = rattn._qkv
    rattn._qkv = lambda p, cfg, x, positions, rope=True: qkv(
        p, cfg, x, positions, rope and cfg.family != "encdec")
    try:
        yield
    finally:
        rattn._qkv = qkv


def _reference(cfg, params, prompt, steps, max_len):
    """The reference's prefill and decode steps on the whole batch: each
    call's logits and the caches after prefill and after the last step,
    flattened (whisper's prefill caches put under "layers")."""
    front = prompt.get("frontend")
    logits, caches = jax.jit(lambda p, t, f: rtf.prefill(
        p, cfg, t, f, max_len=max_len))(
            params, jnp.asarray(prompt["tokens"]),
            None if front is None else jnp.asarray(front))
    if not {"layers", "groups"} & set(caches):
        caches = {"layers": caches}
    out = {"logits": [np.asarray(logits)], "caches_prefill": _flat(caches)}
    n = logits.shape[1]
    step = jax.jit(lambda p, t, c, pos: rtf.decode_step(p, cfg, t, c, pos))
    for j, tok in enumerate(steps):
        lg, caches = step(params, jnp.asarray(tok), caches, n + j)
        out["logits"].append(np.asarray(lg))
    out["caches"] = _flat(caches)
    return out


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_sharded")
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
        prompt, steps = inputs[tag] = _inputs(cfg, 10 + i)
        np.savez(d / f"prompt_{tag}.npz", **prompt)
        for j, tok in enumerate(steps):
            np.savez(d / f"tok_{tag}_{j}.npz", token=tok)
        prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
        cases[tag] = {"prompt": f"prompt_{tag}",
                      "steps": [f"tok_{tag}_{j}" for j in range(STEPS)],
                      "max_len": prefix + S + EXTRA}
    rng = np.random.default_rng(3)
    toks = rng.integers(0, _cfg(RESTORE).vocab, (B, S + 1)).astype(np.int32)
    np.savez(d / "train_batch.npz", inputs=toks[:, :-1], labels=toks[:, 1:],
             mask=np.ones((B, S), np.float32))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(ranks.launch, "serve_sharded", d, 8, {
            "models": models, "cases": cases, "meshes": list(MESHES),
            "restore": {"model": RESTORE, "batch": "train_batch"}}, 240)
        with _decoder_rope_off():
            ref = {tag: _reference(_cfg(tag), params[tag], *inputs[tag],
                                   cases[tag]["max_len"]) for tag in MODELS}
        runs = ranks_done.result()
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(8)]
    specs = {(tag, shape): _spec_flat(rts.state_specs(
        _cfg(tag), dict(zip(("data", "model"), shape))).params)
        for tag in MODELS for shape in MESHES}
    return {"runs": runs, "arrays": arrays, "ref": ref, "specs": specs,
            "params": {tag: _flat(p) for tag, p in params.items()}}


def _rows(key, want, idx, b):
    """The rows of the rank's data shard (``idx``-th of ``b`` rows) of
    reference leaf ``key``: a layer-stacked cache leaf has the batch
    second."""
    axis = 0 if key.startswith("rem/") else 1
    return np.take(want, range(idx * b, (idx + 1) * b), axis=axis)


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_held(run, specs, params, sizes):
    """Every parameter of the rank shaped by the layout rule
    (``test_torch_train_mesh._held``)."""
    for name, shape in run["held"].items():
        key, i = _port_leaf(name)
        held = _held(key, specs[key], params[key].shape, sizes)
        assert shape == [n for n, _ in held[i is not None:]], (name, shape)


@pytest.mark.parametrize("case", CASES)
def test_sharded_serving_matches_reference(serve_run, case):
    """Each rank's rows of every call's logits and of the caches after
    prefill and after the last decode step, against the reference's
    single-process serving of the whole batch; the rank's parameters
    shaped by the layout rule, some of them blocks; ranks on one "data"
    coordinate bit-equal."""
    tag, mesh = case.split("-")
    shape = tuple(int(x) for x in mesh.split("x"))
    want = serve_run["ref"][tag]
    b = B // shape[0]
    res = [run[case] for run in serve_run["runs"]]
    for r, (rec, arr) in enumerate(zip(res, serve_run["arrays"])):
        idx = rec["data"]
        assert rec["blocks"] > 0, r
        _assert_held(rec, serve_run["specs"][tag, shape],
                     serve_run["params"][tag],
                     dict(zip(("data", "model"), shape)))
        for j, w in enumerate(want["logits"]):
            err = _err(arr[f"{case}/logits{j}"], w[idx * b:(idx + 1) * b])
            assert err <= TOL, (r, f"logits of call {j}", err)
        for part in ("caches_prefill", "caches"):
            got = {k[len(f"{case}/{part}/"):]: a for k, a in arr.items()
                   if k.startswith(f"{case}/{part}/")}
            assert set(got) == set(want[part]), (r, part)
            for k, w in want[part].items():
                err = _err(got[k], _rows(k, w, idx, b))
                assert err <= TOL, (r, part, k, err)
    for r, rec in enumerate(res):
        peer = next(p for p in res if p["data"] == rec["data"])
        assert rec["crc"] == peer["crc"], (r, "logits differ from those of "
                                           "its data coordinate's ranks")


@pytest.mark.parametrize("ckpt", ["state_ck", "params_ck"])
def test_serving_restore_from_a_training_checkpoint(serve_run, ckpt):
    """qwen3's FSDP train state after a step on (2, 4), saved whole (the
    state, or its parameters alone), restored onto (4, 2) as serving
    blocks: shaped by the layout rule, and every logit and cache leaf
    bit-equal to serving the same parameters cut by ``shard_params_``."""
    key = f"restore-{ckpt}"
    sizes = {"data": 4, "model": 2}
    for r, (run, arr) in enumerate(zip(serve_run["runs"],
                                       serve_run["arrays"])):
        assert run[key]["blocks"] > 0, r
        assert run[key]["held"] == run["restore-cut"]["held"], r
        _assert_held(run[key], serve_run["specs"][RESTORE, (4, 2)],
                     serve_run["params"][RESTORE], sizes)
        got = {k[len(key) + 1:]: a for k, a in arr.items()
               if k.startswith(key + "/")}
        want = {k[len("restore-cut/"):]: a for k, a in arr.items()
                if k.startswith("restore-cut/")}
        assert got and set(got) == set(want), r
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=(r, k))
