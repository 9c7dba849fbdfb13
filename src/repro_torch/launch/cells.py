"""(architecture x shape x mesh) cell construction for the dry run.

Counterpart of ``repro.launch.cells``.  ``build_cell`` returns a ``Cell``:
``fn(*args)`` runs one step of this rank -- a train step, a prefill
forward, a decode step, or the distributed Poisson solve -- on ``args``,
fake tensors (``FakeTensorMode``, ``Cell.mode``) of the rank's shapes on
``device``.  No parameter, activation or Green's function is ever
materialised; ``launch.flops_probe.measure`` runs the step under the
counters.  The mesh's process group is the ``"fake"`` one of
``launch.mesh`` (or any other: every rank would run the same step).

The rank holds what the port's step holds: its data shard of the batch,
and its block of the state by the training layout rule: on a train cell
``training.train_step.shard_state_`` (parameters, both moments and the
error feedback over ``"data"`` where ``state_specs`` names it; over
``"model"`` the MoE's own ``E / n`` experts and the tensor-parallel
blocks of the attention heads, the MLP's ``d_ff``, the vocabulary, the
SSM's ``d_model`` and the RG-LRU's ``d_rnn``), on a prefill or decode
cell ``shard_params_``, the parameters alone by the same rule, and a
decode cell's caches by ``init_caches(mesh=)`` (``cache_specs``' local
shapes).
``Cell.spec_bytes`` gives the bytes of the reference's layout (the spec
trees' local shapes, what its
``memory_analysis().argument_size_in_bytes`` measures), beside the
port's ``launch.flops_probe.held_bytes(*cell.args)``; a decode cell's
arguments hold the position as the reference's do, a 0-d int32.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.comm import CommConfig
from repro_torch.models import convert
from repro_torch.models import transformer as tf
from repro_torch.models.common import DATA_AXES, ModelConfig
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import (TrainState, shard_params_,
                                             shard_state_, state_specs,
                                             train_step_fn)

__all__ = ["Cell", "build_cell", "model_flops", "spec_bytes"]


@dataclass
class Cell:
    arch: str
    shape: str
    fn: Any                  # the rank's step: fn(*args)
    args: tuple              # fake tensors (and modules, dicts of them)
    meta: dict
    mode: Any                # the FakeTensorMode the args live in
    spec_bytes: int          # the reference layout's argument bytes


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dp_spec(ms: dict, batch=None):
    dp = tuple(a for a in DATA_AXES if a in ms)
    if batch is not None and batch % math.prod(ms[a] for a in dp) != 0:
        return ()          # replicate tiny batches (e.g. long_500k B=1)
    return dp


def model_flops(cfg: ModelConfig, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); decode uses the
    2 N per-token forward cost."""
    n = _active_params(cfg)
    per_tok = 6.0 * n if kind == "train" else 2.0 * n
    return per_tok * tokens


def _active_params(cfg: ModelConfig) -> float:
    """Active (per-token) parameter count."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        s = cfg.ssm
        din = s.d_inner(d)
        nh = s.n_heads(d)
        per = d * (2 * din + 2 * s.d_state + nh) + din * d
        return emb + L * per
    att = d * cfg.n_heads * cfg.d_head * 2 + \
        d * cfg.n_kv * cfg.d_head * 2
    gate = 1 if cfg.act in ("swiglu", "geglu") else 0
    mlp = d * cfg.d_ff * (2 + gate)
    if cfg.family == "moe":
        mlp = mlp * cfg.moe.top_k + d * cfg.moe.n_experts  # router
    per = att + mlp
    if cfg.family == "hybrid":
        dr = cfg.hybrid.d_rnn or d
        rec = d * dr * 2 + dr * dr * 2 + dr * d + d * cfg.d_ff * (2 + gate)
        n_att = cfg.n_layers // 3
        return emb + n_att * per + (L - n_att) * rec
    if cfg.family == "encdec":
        return emb + L * (per + att) + cfg.n_enc_layers * per
    return emb + L * per


def _local_numel(shape, spec, ms: dict) -> int:
    """Elements of one shard of ``shape`` laid out by ``spec`` on a mesh
    of axis sizes ``ms`` (an uneven split rounds up, as JAX pads it)."""
    n = 1
    for i, d in enumerate(shape):
        e = spec[i] if spec is not None and i < len(spec) else None
        names = () if e is None else (e,) if isinstance(e, str) else e
        n *= -(-d // math.prod(ms.get(a, 1) for a in names))
    return n


def spec_bytes(leaves, ms: dict) -> int:
    """Bytes of one rank's shards of ``leaves``: ``(shape, dtype, spec)``
    triples, ``spec`` a partition spec (None: replicated)."""
    return sum(_local_numel(shape, spec, ms) * torch.empty(
        (), dtype=dt).element_size() for shape, dt, spec in leaves)


def _named_leaves(named: dict, specs, ms, dtype=None):
    return [(tuple(t.shape), dtype or t.dtype, convert.local_spec(specs, n))
            for n, t in named.items()]


def build_cell(arch: str, shape_name: str, mesh,
               comm: CommConfig = CommConfig(),
               adam: opt.AdamWConfig | None = None,
               remat: str | None = None,
               extra_cfg: dict | None = None,
               device: str = "cuda") -> Cell:
    """The rank's step of one cell on fake tensors on ``device`` (module
    docstring).  ``shape_name``: a name of ``configs.SHAPES`` or a
    ``ShapeSpec``; ``mesh``: a ``DeviceMesh``, or None for one process.
    ``extra_cfg``: config fields to replace (for ``flups-poisson``,
    ``PoissonArchConfig`` fields)."""
    if arch == "flups-poisson":
        return _build_poisson_cell(shape_name, mesh, comm, extra_cfg,
                                   device)
    cfg = get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = sh.name
    ms = _mesh_shape(mesh) if mesh is not None else {}
    B, S = sh.global_batch, sh.seq_len
    dp = _dp_spec(ms, B)
    b = B // math.prod(ms[a] for a in dp)      # this rank's data shard
    dspec = (dp, None, None)
    meta = {"arch": arch, "shape": shape_name, "kind": sh.kind,
            "global_batch": B, "seq_len": S, "mesh": tuple(ms.items()),
            "model_flops": model_flops(
                cfg, B * S if sh.kind != "decode" else B, sh.kind)}
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode, torch.device(device):
        # the weights' values never enter a dry run: no initialisation
        model = tf.Transformer(cfg)
        named = dict(model.named_parameters())
        pspecs = tf.param_specs(cfg, ms)
        leaves = _named_leaves(named, pspecs, ms)
        tok = lambda s: torch.zeros((b, s), dtype=torch.int32)  # noqa: E731
        frontend = (torch.zeros((b, cfg.n_frontend_tokens, cfg.d_model))
                    if cfg.n_frontend_tokens else None)
        inputs = [((B, S), torch.int32, dspec)]
        if frontend is not None:
            inputs.append(((B, cfg.n_frontend_tokens, cfg.d_model),
                           torch.float32, dspec))

        if sh.kind == "train":
            adam = adam or opt.AdamWConfig()
            err = (opt.init_error_feedback(named)
                   if adam.grad_compress != "none" else None)
            state = TrainState(model, opt.init_opt_state(named), err)
            sspecs = state_specs(cfg, ms).opt_state
            leaves += (_named_leaves(named, sspecs["m"], ms, torch.float32)
                       + _named_leaves(named, sspecs["v"], ms,
                                       torch.float32))
            leaves.append(((), torch.int32, None))           # the step
            if mesh is not None:
                shard_state_(state, mesh)
            batch = {"inputs": tok(S), "labels": tok(S),
                     "mask": torch.zeros((b, S))}
            leaves += [inputs[0], inputs[0], ((B, S), torch.float32, dspec)]
            if frontend is not None:
                batch["frontend"] = frontend
                leaves.append(inputs[1])
            fn = train_step_fn(cfg, adam=adam, comm=comm, mesh=mesh)
            args = (state, batch)
        elif sh.kind == "prefill":
            if mesh is not None:
                shard_params_(model, mesh)
            leaves += inputs
            args = (model, tok(S)) + ((frontend,) if frontend is not None
                                      else ())

            @torch.no_grad()
            def fn(m, t, f=None):
                return tf.forward(m, t, f, comm, mesh)
        else:
            # decode: one new token with caches of length S
            if mesh is not None:
                shard_params_(model, mesh)
            caches = tf.init_caches(cfg, B, S, device=device, mesh=mesh)
            whole = tf.init_caches(cfg, B, S, device="meta")   # global
            cspecs = tf.cache_specs(cfg, ms, whole, dp=dp)
            leaves += _named_leaves(convert._dotted(whole), cspecs, ms)
            leaves += [((B, 1), torch.int32, dspec), ((), torch.int32, None)]
            # the position: held as the reference's argument, read as an int
            args = (model, tok(1), caches, torch.zeros((), dtype=torch.int32))

            def fn(m, t, c, pos):
                return tf.decode_step(m, t, c, S - 1, comm, mesh)
    return Cell(arch, shape_name, fn, args, meta, mode,
                spec_bytes(leaves, ms))


def _build_poisson_cell(shape_name, mesh, comm, extra_cfg, device):
    from repro_torch.configs.flups_poisson import CONFIG
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    cfg = dataclasses.replace(CONFIG, **extra_cfg) if extra_cfg else CONFIG
    multi = "pod" in mesh.mesh_dim_names
    # precedence: a launcher comm that differs from the stock default wins;
    # otherwise the arch config's knobs apply
    if comm == CommConfig():
        comm = ("auto" if cfg.comm == "auto"
                else CommConfig(cfg.comm, cfg.comm_chunks))
    if comm == "auto":
        # the tuner times its candidates: nothing runs on fake tensors
        raise ValueError("a dry run cannot resolve comm='auto'")
    # single-pod meshes run cfg.batch fields as ONE batched multi-RHS solve
    # (in-block batch axis); multi-pod splits the batch over "pod"
    local_batch = not multi and cfg.batch > 1
    batch = cfg.batch if (multi or local_batch) else None
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        solver = DistributedPoissonSolver(
            (cfg.n,) * 3, 1.0, cfg.bcs, layout=cfg.layout,
            green_kind=cfg.green, mesh=mesh, axes=("data", "model"),
            comm=comm, batch_axis="pod" if multi else None,
            lazy_green=True, engine=cfg.engine, doubling=cfg.doubling,
            relayout=cfg.relayout, verify=cfg.verify or None,
            verify_rtol=cfg.verify_rtol, device=device)
        xshape, gshape = solver.lowered_shapes(batch, local_batch=local_batch)
        x = torch.empty(xshape, dtype=solver.dtype, device=device)
        g = torch.empty(gshape, dtype=solver.dtype, device=device)
    n = cfg.n
    meta = {"arch": "flups-poisson", "shape": shape_name, "kind": "solve",
            "grid": n, "mesh": tuple(_mesh_shape(mesh).items()),
            "batch": batch or 1, "engine": cfg.engine,
            # forward + backward 3-D FFT on the doubled (2n)^3 domain
            "model_flops": (batch or 1) * 2 * 5 * (2 * n) ** 3
            * float(np.log2((2 * n) ** 3))}

    def fn(x, g):
        return solver.solve_local(x, green=g)

    elem = torch.empty((), dtype=solver.dtype).element_size()
    return Cell("flups-poisson", shape_name, fn, (x, g), meta, mode,
                (x.numel() + g.numel()) * elem)
