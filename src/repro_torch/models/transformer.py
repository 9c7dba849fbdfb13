"""Model assembly for all assigned architectures.

Counterpart of ``repro.models.transformer``: one ``nn.Module`` per block
kind (dense attention, MoE, SSM, recurrent, whisper's cross-attention
decoder block), a ``ModuleList`` per stack and a top-level
``Transformer(cfg)``, with three entry points:

  * ``forward``      -- training / scoring (full sequence, causal or prefix)
  * ``prefill``      -- forward + build decode caches (serving, prompt pass)
  * ``decode_step``  -- one token with caches (serving, autoregressive)

The reference stacks each uniform stack's layers on a leading axis and
scans over them; here the layers are modules run in a Python loop, so
``cfg.scan_layers`` and ``cfg.unroll_inner`` change nothing.
``cfg.remat`` of ``"block"`` or ``"full"`` wraps each block in
``torch.utils.checkpoint`` (memory changes, numbers do not), which
re-runs the block's whole forward, its collectives included, where the
backward first needs one of its saved tensors (``_run_block``).  Module
attribute names are the reference tree's keys, so a parameter's dotted
name is its reference path with the layer index inserted
(``models.convert``).

The decode caches are a nested dict of per-layer dicts: ``{"layers":
[layer 0's, ...]}``, the hybrid's ``{"groups": {"rec0": [...], ...},
"rem": {...}}``, where the reference stacks them on a leading axis
(``convert.caches_to_reference`` / ``caches_from_reference`` map one
onto the other).  ``prefill`` and ``decode_step`` run without autograd;
``decode_step`` updates the caches it is given in place.  Two faults of
the reference's whisper path are not copied (ROADMAP queue 3): its
``prefill`` returns the decoder's caches without the ``"layers"`` key
``decode_step`` reads, and its decode applies RoPE to the decoder's
self-attention, which its forward does not.

On a mesh (a ``DeviceMesh`` with a ``"model"`` axis; ``forward`` and
``prefill``) every rank passes the tokens of its data shard, whole
sequences.  The blocks that run over the model axis -- ring attention
where ``cfg.attn_ring`` and no caches are collected, the
expert-parallel MoE -- take the rank's sequence block of their input and
all-gather their output over the axis, so every block's input and
output are the data shard, replicated over ``"model"``.  These paths
have gradients: the block split's backward all-gathers the blocks'
gradients and the gather's backward takes the rank's own block, since
every rank of the axis computes the same loss; the ring's and the
switches' backward passes are in ``attention`` and ``moe``.
``training.train_step`` sums the weight gradients over the axis where
the sharded region used them.

A model may hold blocks of its weights (``training.train_step.
shard_state_``, or for serving ``shard_params_``), recognised by their
shapes against the logical leaves and the axes their ``param_specs``
entries name (``block_axes``, ``held_axes``).  Over ``"data"`` (FSDP)
``forward`` and ``prefill`` gather each block's weights whole inside its
checkpointed region, one all-gather a block, and call the block on them
through ``torch.func.functional_call`` (every parameter keeps its dotted
name); the embedding and ``lm_head`` are gathered where they are used
(a tied embedding at each of its two uses).  The gather's backward
reduce-scatters the gradients over ``"data"`` (``_GatherData``).
``decode_step`` gathers the same way, a block at a time, and runs the
block's ``decode`` on its gathered weights; an MoE holding only its own
experts decodes them and sums over ``"model"`` (``moe.moe_decode``).
Every rank issues the gathers in the same order, forward, decode and
recomputation alike.  ``fsdp_timing`` times the gathers and
reduce-scatters where asked.  A rank's caches are those of its data
shard of the batch.

Over ``"model"`` (tensor parallelism, the training layout) a rank holds
its block of the attention heads (``wq``, ``wo``, and ``wk``/``wv`` where
the kv heads divide over the axis), of the MLP's ``d_ff`` and of the
vocabulary (``embed``, ``lm_head``), and ``forward`` runs the Megatron
pattern on them: each tensor-parallel region (an attention, an MLP)
takes its replicated input through ``_CopyToModel`` (identity; its
backward sums the input's gradient over the axis), computes the rank's
heads or ``d_ff`` columns and sums its output over the axis in
``_SumOverModel`` (its backward the identity), so each region costs one
all-reduce forward and one backward.  A rank's query heads read the kv
heads of their group whole where the kv heads do not divide
(``attention._sdpa``'s ``q0``).  The embedding looks up the rank's rows
(zero for the other ranks' ids) and sums over the axis; the head is
column-parallel, each rank computing its block of the logits, which the
training loss reads in place (``forward_local``; ``training.train_step``'s
vocab-parallel NLL) and ``forward`` gathers whole.  On the ring the
attention's blocks are gathered whole over ``"model"`` first (the
reference's ring takes the weights whole) and their gradients
reduce-scattered back.  ``prefill`` and ``decode_step`` run the same
regions: a rank's caches hold the kv heads its ``wk``/``wv`` compute
(its block of them where they divide over the axis, as ``cache_specs``
splits them; all of them where they do not), its query heads decode
against them, and the step's logits are gathered whole over the axis.
The SSM holds its rows of ``w_in`` and columns of ``w_out`` of
``d_model``: its in-projection is row-parallel (summed over the axis),
its core runs replicated on the whole projection and its out-projection
is column-parallel (gathered whole); the RG-LRU holds its block of
``d_rnn`` and runs on the rank's channels, the gates' inputs
reduce-scattered to them (``_ReduceScatter``), its output summed over
the axis (``models.ssm``, ``models.rglru``).  Their caches stay whole
over ``"model"``, as ``cache_specs`` lays them out.  ``tp_timing`` times
these collectives over ``"model"``, ``fsdp_timing`` those over
``"data"``.

``param_specs`` and ``cache_specs`` give the reference's partition-spec
trees (``common.P``; stacked stacks with a leading ``None``);
``convert.local_spec`` looks up a port tensor's spec in them and
``common.spec_placements`` lays it onto a ``DeviceMesh``.
"""
from __future__ import annotations

import contextlib
import functools
import math
import time
import types

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import convert
from .attention import Attention
from .common import (DATA_AXES, ModelConfig, Norm, P, act_fn, dense_init_,
                     embed_init_, initialise, is_gated, mesh_sizes, param,
                     sinusoidal_positions, spec_entry)
from .moe import MoE, moe_block, moe_decode
from .rglru import RGLRU, init_rglru_cache, rglru_block, rglru_decode
from .ssm import SSM, init_ssm_cache, ssm_block, ssm_decode


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, d=None, dff=None):
        super().__init__()
        d = d or cfg.d_model
        dff = dff or cfg.d_ff
        self.w_in = param((d, dff), cfg.pdtype())
        self.w_out = param((dff, d), cfg.pdtype())
        if is_gated(cfg.act):
            self.w_gate = param((d, dff), cfg.pdtype())

    def init_weights(self, gen):
        d, dff = self.w_in.shape
        dense_init_(self.w_in, gen, fan_in=d)
        dense_init_(self.w_out, gen, fan_in=dff)
        if hasattr(self, "w_gate"):
            dense_init_(self.w_gate, gen, fan_in=d)


def _mlp(p, cfg, x):
    cd = cfg.cdtype()
    h = torch.einsum("bsd,df->bsf", x, p.w_in.to(cd))
    if is_gated(cfg.act):
        g = torch.einsum("bsd,df->bsf", x, p.w_gate.to(cd))
        h = act_fn(cfg.act, h, g)
    else:
        h = act_fn(cfg.act, h)
    return torch.einsum("bsf,fd->bsd", h, p.w_out.to(cd))


def _ffn(p, cfg, x, mesh):
    """The MLP ``p`` of ``x``; where ``p`` holds a block of ``d_ff``, its
    columns of ``w_in``/``w_gate`` and rows of ``w_out`` (column- then
    row-parallel), summed over ``"model"``."""
    group = _tp_group(p, "w_in", mesh)
    if group is None:
        return _mlp(p, cfg, x)
    return _SumOverModel.apply(
        _mlp(p, cfg, _CopyToModel.apply(x, group)), group)


# ---------------------------------------------------------------------------
# blocks: forward(x, positions, causal, prefix_len, x_enc, rope, comm, mesh,
# collect) -> (x, aux, cache or None); decode(x, cache, pos, mesh) -> x
# ---------------------------------------------------------------------------

def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _model_group(mesh):
    """The ``"model"`` axis's process group of ``mesh``, or None."""
    if "model" not in (getattr(mesh, "mesh_dim_names", None) or ()):
        return None
    return mesh.get_group("model")


def _model_dims(module) -> dict:
    """``{leaf: dimension}`` of ``module``'s own parameters of which this
    rank holds a block over ``"model"`` (set by ``held_axes``, which every
    forward reads first)."""
    return module.__dict__.get("_model_dims", {})


def _tp_group(module, leaf, mesh):
    """The ``"model"`` group of ``mesh`` where ``module``'s parameter
    ``leaf`` is this rank's block over the axis, else None."""
    return _model_group(mesh) if leaf in _model_dims(module) else None


class _CopyToModel(torch.autograd.Function):
    """The entry of a tensor-parallel region: ``x`` as it is; backward:
    its gradient summed over the ``"model"`` axis (each rank's is its
    heads' or columns' share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _timed("model", "all_reduce", g, dist.all_reduce, g,
               group=ctx.group)
        return g, None


class _SumOverModel(torch.autograd.Function):
    """The exit of a tensor-parallel region: the ranks' partial outputs
    summed over the ``"model"`` axis; backward: the identity (every rank
    of the axis computes the same loss)."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone(memory_format=torch.contiguous_format)
        _timed("model", "all_reduce", y, dist.all_reduce, y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SeqBlock(torch.autograd.Function):
    """This rank's block of ``x``'s sequence; backward: the model axis's
    block gradients all-gathered, so the replicated input's gradient is
    whole on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        s = x.shape[1] // n
        ctx.group = group
        return x[:, r * s:(r + 1) * s].clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, 1), None


class _Gather(torch.autograd.Function):
    """The model axis's blocks of ``y`` on dimension ``dim`` in rank order
    (the sequence's, or the vocabulary's of the logits); backward: this
    rank's block of the gradient (every rank of the axis holds the whole
    gradient of the same loss, so nothing is summed)."""

    @staticmethod
    def forward(ctx, y, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(y, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        s = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, r * s, s), None, None


class _ReduceScatter(torch.autograd.Function):
    """The ranks' partial ``y`` summed over the ``"model"`` axis, and of
    the sum this rank's block on dimension ``dim`` (the blocks in rank
    order): one reduce-scatter; backward: the blocks' gradients
    all-gathered, so that each rank's partial takes the whole gradient of
    the sum."""

    @staticmethod
    def forward(ctx, y, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim = group, dim
        k = dim % y.ndim
        shape = list(y.shape)
        shape[k] //= n
        parts = y.reshape(*shape[:k], n, *shape[k:]).movedim(k, 0) \
            .contiguous()
        out = y.new_empty(shape)
        _timed("model", "reduce_scatter", parts,
               dist.reduce_scatter_tensor, out.view(-1), parts.view(-1),
               group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def _all_gather(y, group, dim):
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    _timed("model", "gather", y, dist.all_gather, parts, y.contiguous(),
           group=group)
    return torch.cat(parts, dim=dim)


def _seq_block(x, group):
    """This rank's block of ``x``'s sequence over the model axis."""
    n = dist.get_world_size(group)
    if x.shape[1] % n:
        raise ValueError(f"a sequence of {x.shape[1]} does not split over "
                         f"the {n} ranks of the model axis")
    return _SeqBlock.apply(x, group)


def on_ring(cfg: ModelConfig, mesh, seq: int) -> bool:
    """Whether self-attention over ``seq`` positions runs as ring
    attention on ``mesh`` (when no caches are collected): ``attn_ring``,
    a ``"model"`` axis and a sequence that splits over it."""
    group = _model_group(mesh)
    return bool(cfg.attn_ring and group is not None
                and seq % dist.get_world_size(group) == 0)


def _whole_heads(p, group):
    """The attention ``p`` with its blocks over ``"model"`` gathered whole
    over ``group`` (``_GatherData``: its backward reduce-scatters their
    gradients back to the blocks), for the ring, which takes the weights
    whole; ``p`` itself where it holds none."""
    dims = _model_dims(p)
    if not dims:
        return p
    whole = _GatherData.apply(group, "model", tuple(dims.values()),
                              *(getattr(p, n) for n in dims))
    return types.SimpleNamespace(
        **dict(p.named_children()),
        **(dict(p.named_parameters(recurse=False)) | dict(zip(dims, whole))))


def _q0(p, group) -> int:
    """The global index of the first query head of the attention ``p``'s
    block of the heads on this rank of ``group``."""
    return dist.get_rank(group) * p.wq.shape[1]


def _attend(blk, x, positions, causal, prefix_len, rope, mesh, collect):
    """x + self-attention; with ``collect`` also the layer's
    ``{"sa": {"k", "v"}}`` cache, under tensor parallelism the kv heads
    the rank computes (ring attention only without it, and where the
    block may run on the ring, ``blk.ring``)."""
    cfg = blk.cfg
    h = blk.ln1(x)
    if blk.ring and not collect and on_ring(cfg, mesh, x.shape[1]):
        group = _model_group(mesh)
        a = attn.attention_ring(_whole_heads(blk.attn, group), cfg,
                                _seq_block(h, group), mesh, causal=causal,
                                rope=rope, prefix_len=prefix_len)
        return x + _Gather.apply(a, group, 1), None
    group = _tp_group(blk.attn, "wq", mesh)
    if group is not None:
        a = attn.attention(blk.attn, cfg, _CopyToModel.apply(h, group),
                           positions, causal=causal, rope=rope,
                           prefix_len=prefix_len, return_kv=collect,
                           q0=_q0(blk.attn, group))
        cache = None
        if collect:
            a, (k, v) = a
            cache = {"sa": {"k": k, "v": v}}
        return x + _SumOverModel.apply(a, group), cache
    if collect:
        a, (k, v) = attn.attention(blk.attn, cfg, h, positions,
                                   causal=causal, rope=rope,
                                   prefix_len=prefix_len, return_kv=True)
        return x + a, {"sa": {"k": k, "v": v}}
    return x + attn.attention(blk.attn, cfg, h, positions, causal=causal,
                              rope=rope, prefix_len=prefix_len), None


def _attend_decode(blk, x, cache, pos, mesh, rope=True):
    """x + self-attention of one token against the layer's cache; under
    tensor parallelism the rank's query heads against the kv heads it
    caches, summed over ``"model"``."""
    h = blk.ln1(x)
    group = _tp_group(blk.attn, "wq", mesh)
    if group is None:
        a, _ = attn.attention_decode(blk.attn, blk.cfg, h, cache["sa"], pos,
                                     rope=rope)
        return x + a
    a, _ = attn.attention_decode(blk.attn, blk.cfg, h, cache["sa"], pos,
                                 rope=rope, q0=_q0(blk.attn, group))
    return x + _SumOverModel.apply(a, group)


class DenseBlock(nn.Module):
    """Self-attention + MLP (dense, vlm, the hybrid's ``attn``, whisper's
    encoder, whose blocks never run on the ring, as the reference's:
    ``ring`` False)."""

    ring = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model)
        self.attn = Attention(cfg)
        self.ln2 = Norm(cfg, cfg.d_model)
        self.mlp = MLP(cfg)

    def forward(self, x, positions, causal=True, prefix_len=0, x_enc=None,
                rope=True, comm=None, mesh=None, collect=False):
        x, cache = _attend(self, x, positions, causal, prefix_len, rope,
                           mesh, collect)
        return x + _ffn(self.mlp, self.cfg, self.ln2(x), mesh), _zero(x), \
            cache

    def decode(self, x, cache, pos, mesh=None):
        x = _attend_decode(self, x, cache, pos, mesh)
        return x + _ffn(self.mlp, self.cfg, self.ln2(x), mesh)


class MoEBlock(nn.Module):
    ring = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model)
        self.attn = Attention(cfg)
        self.ln2 = Norm(cfg, cfg.d_model)
        self.moe = MoE(cfg)

    def forward(self, x, positions, causal=True, prefix_len=0, x_enc=None,
                rope=True, comm=None, mesh=None, collect=False):
        x, cache = _attend(self, x, positions, causal, prefix_len, rope,
                           mesh, collect)
        h = self.ln2(x)
        group = _model_group(mesh)
        if group is None:
            out, aux = moe_block(self.moe, self.cfg, h)
        else:
            out, aux = moe_block(self.moe, self.cfg, _seq_block(h, group),
                                 comm, mesh)
            out = _Gather.apply(out, group, 1)
        return x + out, aux.float(), cache

    def decode(self, x, cache, pos, mesh=None):
        x = _attend_decode(self, x, cache, pos, mesh)
        return x + moe_decode(self.moe, self.cfg, self.ln2(x), mesh)


class CrossBlock(nn.Module):
    """Whisper's decoder block: self-attention, cross-attention against
    the encoder output, MLP."""

    ring = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model)
        self.attn = Attention(cfg)
        self.lnx = Norm(cfg, cfg.d_model)
        self.xattn = Attention(cfg)
        self.ln2 = Norm(cfg, cfg.d_model)
        self.mlp = MLP(cfg)

    def forward(self, x, positions, causal=True, prefix_len=0, x_enc=None,
                rope=True, comm=None, mesh=None, collect=False):
        x, cache = _attend(self, x, positions, causal, prefix_len, rope,
                           mesh, collect)
        cfg, h = self.cfg, self.lnx(x)
        group = _tp_group(self.xattn, "wq", mesh)
        if group is None:
            kv_x = attn.encode_kv(self.xattn, cfg, x_enc)
            x = x + attn.attention_cross(self.xattn, cfg, h, kv_x)
        else:
            # the rank's heads against its kv heads of the encoder output
            kv_x = attn.encode_kv(self.xattn, cfg,
                                  _CopyToModel.apply(x_enc, group))
            a = attn.attention_cross(
                self.xattn, cfg, _CopyToModel.apply(h, group), kv_x,
                q0=_q0(self.xattn, group))
            x = x + _SumOverModel.apply(a, group)
        if collect:
            cache["xk"], cache["xv"] = kv_x
        return x + _ffn(self.mlp, cfg, self.ln2(x), mesh), _zero(x), cache

    def decode(self, x, cache, pos, mesh=None):
        # no RoPE: the decoder's forward has none (whisper's positions are
        # the sinusoidal table added to the embedding)
        x = _attend_decode(self, x, cache, pos, mesh, rope=False)
        kv_x, h = (cache["xk"], cache["xv"]), self.lnx(x)
        group = _tp_group(self.xattn, "wq", mesh)
        if group is None:
            x = x + attn.attention_cross(self.xattn, self.cfg, h, kv_x)
        else:
            x = x + _SumOverModel.apply(attn.attention_cross(
                self.xattn, self.cfg, h, kv_x, q0=_q0(self.xattn, group)),
                group)
        return x + _ffn(self.mlp, self.cfg, self.ln2(x), mesh)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model)
        self.ssm = SSM(cfg)

    def forward(self, x, positions, causal=True, prefix_len=0, x_enc=None,
                rope=True, comm=None, mesh=None, collect=False):
        h, state, tail = ssm_block(self.ssm, self.cfg, self.ln1(x),
                                   return_tail=collect,
                                   group=_tp_group(self.ssm, "w_in", mesh))
        cache = {"state": state, "conv": tail} if collect else None
        return x + h, _zero(x), cache

    def decode(self, x, cache, pos, mesh=None):
        h, new = ssm_decode(self.ssm, self.cfg, self.ln1(x), cache,
                            group=_tp_group(self.ssm, "w_in", mesh))
        cache.update(new)
        return x + h


class RecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model)
        self.rec = RGLRU(cfg)
        self.ln2 = Norm(cfg, cfg.d_model)
        self.mlp = MLP(cfg)

    def forward(self, x, positions, causal=True, prefix_len=0, x_enc=None,
                rope=True, comm=None, mesh=None, collect=False):
        h, state, tail = rglru_block(self.rec, self.cfg, self.ln1(x),
                                     return_tail=collect,
                                     group=_tp_group(self.rec, "w_x", mesh))
        cache = {"state": state, "conv": tail} if collect else None
        x = x + h
        return x + _ffn(self.mlp, self.cfg, self.ln2(x), mesh), _zero(x), \
            cache

    def decode(self, x, cache, pos, mesh=None):
        h, new = rglru_decode(self.rec, self.cfg, self.ln1(x), cache,
                              group=_tp_group(self.rec, "w_x", mesh))
        cache.update(new)
        x = x + h
        return x + _ffn(self.mlp, self.cfg, self.ln2(x), mesh)


_BLOCKS = {"dense": DenseBlock, "attn": DenseBlock, "moe": MoEBlock,
           "cross": CrossBlock, "ssm": SSMBlock, "rec": RecBlock}


def _hybrid_layout(cfg: ModelConfig):
    """(n_groups, remainder_kinds) for the hybrid pattern."""
    pat = cfg.hybrid.pattern
    n_groups = cfg.n_layers // len(pat)
    rem = cfg.n_layers - n_groups * len(pat)
    return n_groups, tuple(pat[:rem])


def _run_block(cfg, block, x, fsdp, **kw):
    """One block, recomputed in the backward pass unless ``cfg.remat`` is
    ``"none"``.  The recomputation runs the block's forward to its end
    (early stop off), where autograd first unpacks one of the block's
    saved tensors.  On a mesh that is what keeps the ranks' collectives
    in step: every rank records the same graph, autograd walks it in the
    same order on each, so each rank re-issues the same ring shifts,
    switches, gathers and tensor-parallel all-reduces
    (``_SumOverModel``), in the forward's order, at the same point of its
    backward.  Where the rank holds ``"data"`` blocks of the block's
    weights (``fsdp``, a ``_DataBlocks``), the block runs on them
    gathered whole, inside the recomputed region, so the recomputation
    gathers them again."""
    fn = block if not fsdp.dims else \
        lambda x, **kw: fsdp.call(block, x, **kw)
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(x, **kw)
    return checkpoint(fn, x, use_reentrant=False, early_stop=False, **kw)


def _run_stack(cfg, blocks, x, fsdp, **kw):
    """The blocks in order; the mean of their aux and, when collecting,
    their caches (else None)."""
    auxs, caches = [], []
    for block in blocks:
        x, aux, cache = _run_block(cfg, block, x, fsdp, **kw)
        auxs.append(aux)
        caches.append(cache)
    return x, torch.stack(auxs).mean(), \
        caches if kw.get("collect") else None


# ---------------------------------------------------------------------------
# FSDP: the rank's "data" blocks of the weights, gathered where used
# ---------------------------------------------------------------------------

# the timing contexts now open, ``(mesh axis, {key: seconds})``
# (``fsdp_timing``, ``tp_timing``): a collective is timed only where one
# asks for its axis and key
_TIMERS = []


@contextlib.contextmanager
def _timing(axis, keys):
    secs = dict.fromkeys(keys, 0.0)
    _TIMERS.append((axis, secs))
    try:
        yield secs
    finally:
        _TIMERS.remove((axis, secs))


def fsdp_timing():
    """Within: the seconds of the FSDP all-gathers over ``"data"``
    (forward and recomputation) and reduce-scatters (backward) made in
    this process, the card synchronised around each; yields ``{"gather":
    s, "reduce_scatter": s}``, their sums.  Off by default: the
    synchronisations cost."""
    return _timing("data", ("gather", "reduce_scatter"))


def tp_timing():
    """Within: the seconds of the tensor-parallel collectives over
    ``"model"`` made in this process, timed as ``fsdp_timing`` times its
    own; yields ``{"all_reduce": s, "gather": s, "reduce_scatter": s}``:
    the regions' all-reduces (``_SumOverModel`` forward and
    recomputation, ``_CopyToModel`` backward, the vocab-parallel loss's),
    the all-gathers (the ring's of the attention's blocks, forward and
    recomputation; the blocks' outputs', ``_Gather``: the ring's and the
    MoE's sequence blocks, the logits' vocabulary blocks, the SSM's
    output columns, the RG-LRU's caches; the sequence blocks' and the
    RG-LRU's gates' gradients') and the reduce-scatters (the ring's
    blocks' gradients, the RG-LRU's gates' inputs, ``_ReduceScatter``)."""
    return _timing("model", ("all_reduce", "gather", "reduce_scatter"))


def _timed(axis, key, t, fn, *args, **kw):
    """``fn(*args, **kw)``, a collective over ``axis``; within a timing
    context asking for ``axis`` and ``key`` its seconds are added there,
    the card synchronised before and after where ``t`` is on it."""
    timers = [secs for over, secs in _TIMERS
              if over == axis and key in secs]
    if not timers:
        fn(*args, **kw)
        return
    sync = torch.cuda.synchronize if t.is_cuda else lambda: None
    sync()
    t0 = time.perf_counter()
    fn(*args, **kw)
    sync()
    for secs in timers:
        secs[key] += time.perf_counter() - t0


def _join(part, shape, k, n):
    """``(n, numel)`` blocks of ``shape``, one a rank in rank order -> the
    whole tensor, the blocks joined on dimension ``k``."""
    whole = list(shape)
    whole[k] *= n
    return part.reshape(n, *shape).movedim(0, k).reshape(whole)


def _cut(g, shape, k, n):
    """The inverse of ``_join``: the whole ``g`` -> its ``(n, numel)``
    blocks of ``shape`` on dimension ``k``, one a rank."""
    return g.reshape(*shape[:k], n, *shape[k:]).movedim(k, 0).reshape(n, -1)


class _GatherData(torch.autograd.Function):
    """The whole weights of this rank's blocks ``blocks`` over ``axis``
    (``"data"``: FSDP; ``"model"``: the ring's attention), each a block
    on its dimension ``dims[i]``: one all-gather over the axis's
    ``group`` of the blocks' flat concatenation; backward: the whole
    weights' gradients summed over the axis and cut back to this rank's
    blocks, one reduce-scatter."""

    @staticmethod
    def forward(ctx, group, axis, dims, *blocks):
        if len({b.dtype for b in blocks}) != 1:
            raise ValueError("FSDP: the blocks gathered at once must share "
                             "a dtype")
        n = dist.get_world_size(group)
        ctx.group, ctx.axis, ctx.dims = group, axis, dims
        ctx.shapes = [tuple(b.shape) for b in blocks]
        flat = torch.cat([b.reshape(-1) for b in blocks])
        out = flat.new_empty(n * flat.numel())
        _timed(axis, "gather", flat, dist.all_gather_into_tensor, out, flat,
               group=group)
        parts = out.view(n, -1).split([b.numel() for b in blocks], dim=1)
        return tuple(_join(p, s, k, n)
                     for p, s, k in zip(parts, ctx.shapes, dims))

    @staticmethod
    def backward(ctx, *grads):
        n = dist.get_world_size(ctx.group)
        flat = torch.cat([_cut(g, s, k, n) for g, s, k in
                          zip(grads, ctx.shapes, ctx.dims)], dim=1)
        out = flat.new_empty(flat.shape[1])
        _timed(ctx.axis, "reduce_scatter", flat, dist.reduce_scatter_tensor,
               out, flat.reshape(-1), group=ctx.group)
        sizes = [math.prod(s) for s in ctx.shapes]
        return (None, None, None) + tuple(
            g.view(s) for g, s in zip(out.split(sizes), ctx.shapes))


@functools.lru_cache(maxsize=64)
def _specs(cfg, sizes):
    return param_specs(cfg, dict(sizes))


def block_axes(name, shape, cfg: ModelConfig, mesh_shape: dict) -> dict:
    """``{mesh axis: dimension}`` on which a parameter ``name`` of
    ``shape`` is a block of its logical leaf (``convert.logical_shapes``)
    on a mesh of axis sizes ``mesh_shape``: each dimension shorter than
    the leaf's is its block over the one axis of the mesh that the leaf's
    ``param_specs`` entry names there (``"data"``: FSDP; ``"model"``: an
    MoE expert weight's own experts, or a tensor-parallel block).  Empty
    for a whole leaf; raises where a shorter dimension is no such
    block."""
    full = convert.logical_shapes(cfg)[name]
    spec = convert.local_spec(
        _specs(cfg, tuple(sorted(mesh_shape.items()))), name)
    axes = {}
    for k, (a, b) in enumerate(zip(shape, full)):
        if a == b:
            continue
        over = [x for x in spec_entry(spec, k) if mesh_shape.get(x, 1) > 1]
        if len(over) != 1 or a * mesh_shape[over[0]] != b:
            raise ValueError(f"{name}: a block of {tuple(shape)} of the leaf "
                             f"{full} is no block over the axes {over} its "
                             f"spec {spec} names on dimension {k} of a mesh "
                             f"{mesh_shape}")
        axes[over[0]] = k
    return axes


def held_axes(model, mesh) -> dict:
    """``{dotted name: block_axes}`` of the parameters of ``model`` (a
    ``Transformer``) of which this rank holds a block on ``mesh`` (None:
    no mesh), read from their shapes and kept on the model for the mesh's
    sizes, each module given its own blocks over ``"model"``
    (``_model_dims``, which the tensor-parallel forward reads);
    ``common.replace_param_``, which changes a parameter's shape, drops
    what was kept."""
    sizes = mesh_sizes(mesh)
    kept = model.__dict__.get("_held_axes")
    if kept is None or kept[0] != sizes:
        held = {}
        for name, p in model.named_parameters():
            axes = block_axes(name, p.shape, model.cfg, sizes)
            if axes:
                held[name] = axes
        for module in model.modules():
            module.__dict__["_model_dims"] = {}
        for name, axes in held.items():
            if "model" in axes:
                prefix, _, leaf = name.rpartition(".")
                _model_dims(model.get_submodule(prefix))[leaf] = axes["model"]
        kept = model.__dict__["_held_axes"] = (sizes, held)
    return kept[1]


class _DataBlocks:
    """One forward's FSDP plan: ``dims`` maps each parameter of which this
    rank holds a ``"data"`` block to the dimension of the block.  Empty
    where the rank holds none: every module then runs on its own
    parameters, as without FSDP."""

    def __init__(self, model, mesh):
        self.dims = {model.get_parameter(n): a["data"]
                     for n, a in held_axes(model, mesh).items()
                     if "data" in a}
        if self.dims:
            self.group = mesh.get_group("data")

    def _gather(self, named) -> dict:
        """``{name: whole tensor}`` of the held blocks among ``named``
        (``(name, parameter)`` pairs), gathered in one all-gather."""
        held = [(n, p) for n, p in named if p in self.dims]
        if not held:
            return {}
        return dict(zip((n for n, _ in held), _GatherData.apply(
            self.group, "data", tuple(self.dims[p] for _, p in held),
            *(p for _, p in held))))

    def weight(self, model, name):
        """Top-level leaf ``name`` of ``model``, gathered where held."""
        p = getattr(model, name)
        return self._gather([(name, p)]).get(name, p)

    def call(self, block, x, **kw):
        """``block(x, **kw)`` on its held weights gathered whole (its
        parameters keep their names: ``torch.func.functional_call``)."""
        whole = self._gather(block.named_parameters())
        if not whole:
            return block(x, **kw)
        return torch.func.functional_call(block, whole, (x,), kw)

    def decode(self, block, x, cache, pos, **kw):
        """``block.decode(x, cache, pos, **kw)`` on its held weights
        gathered whole, as ``call``: through ``_Decode``, whose forward
        is the block's ``decode``, so that every parameter keeps its
        dotted name and nothing is written back into the held block."""
        whole = self._gather(block.named_parameters())
        if not whole:
            return block.decode(x, cache, pos, **kw)
        return torch.func.functional_call(
            _Decode(block), {"block." + n: t for n, t in whole.items()},
            (x, cache, pos), kw)


class _Decode(nn.Module):
    """``block`` with its ``decode`` as the forward
    (``torch.func.functional_call`` calls a module's forward)."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x, cache, pos, **kw):
        return self.block.decode(x, cache, pos, **kw)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed = param((cfg.vocab, d), cfg.pdtype())
        self.ln_f = Norm(cfg, d)
        if not cfg.tie_embeddings:
            self.lm_head = param((d, cfg.vocab), cfg.pdtype())
        stack = lambda kind, n: nn.ModuleList(_BLOCKS[kind](cfg)
                                              for _ in range(n))
        if cfg.family == "hybrid":
            n_groups, rem = _hybrid_layout(cfg)
            self.groups = nn.ModuleDict(
                {kind + str(i): stack(kind, n_groups)
                 for i, kind in enumerate(cfg.hybrid.pattern)})
            self.rem = nn.ModuleDict({kind + str(i): _BLOCKS[kind](cfg)
                                      for i, kind in enumerate(rem)})
        elif cfg.family == "encdec":
            self.enc = stack("dense", cfg.n_enc_layers)
            for blk in self.enc:
                blk.ring = False
            self.ln_enc = Norm(cfg, d)
            self.layers = stack("cross", cfg.n_layers)
        else:
            kind = {"ssm": "ssm", "moe": "moe"}.get(cfg.family, "dense")
            self.layers = stack(kind, cfg.n_layers)

    def init_weights(self, gen):
        embed_init_(self.embed, gen)
        if hasattr(self, "lm_head"):
            dense_init_(self.lm_head, gen, fan_in=self.cfg.d_model)

    def forward(self, tokens, frontend=None, comm=None, mesh=None):
        """tokens: (B, S) int.  Returns (logits (B, S_total, V) float32
        (float64 under a float64 compute),
        {"moe_drop": the MoE layers' mean drop fraction (0 elsewhere)})."""
        logits, aux, _, vocab = _forward_impl(self, tokens, frontend, comm,
                                              mesh, collect=False)
        if vocab is not None:
            logits = _Gather.apply(logits, vocab, logits.ndim - 1)
        return logits, aux


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """The model built on ``gen``'s device and initialised from ``gen``."""
    with torch.device(gen.device):
        return initialise(Transformer(cfg), gen)


def _embed(embed, cfg, tokens, group=None):
    """The embedding of ``tokens``; with ``group`` (where ``embed`` is the
    rank's block of the vocabulary), its rows' (zero for the other ranks'
    ids) summed over ``"model"`` (one rank's nonzero: exact)."""
    cd = cfg.cdtype()
    if group is None:
        x = embed[tokens].to(cd)
    else:
        v_loc = embed.shape[0]
        local = tokens - dist.get_rank(group) * v_loc
        own = (local >= 0) & (local < v_loc)
        x = torch.where(own[..., None], embed[torch.where(own, local, 0)],
                        0.0).to(cd)
        x = _SumOverModel.apply(x, group)
    if cfg.scale_embed:
        # the factor is cast to the compute dtype before the product
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=cd,
                             device=x.device)
    return x


def _embed_in(embed, cfg, tokens, frontend, group=None):
    x = _embed(embed, cfg, tokens, group)
    prefix_len = 0
    if frontend is not None and cfg.family != "encdec":
        x = torch.cat([frontend.to(cfg.cdtype()), x], dim=1)
        prefix_len = frontend.shape[1]
    return x, prefix_len


def _head(cfg) -> str:
    """The name of the output projection's leaf."""
    return "embed" if cfg.tie_embeddings else "lm_head"


def _logits(p, cfg, x, head, group=None):
    """Logits of the final norm of ``x`` against ``head`` (the leaf
    ``_head`` names, gathered where the rank holds a ``"data"`` block of
    it); with ``group`` (where the rank holds a block of the vocabulary),
    the rank's block of the logits (column-parallel).  Float32, as the
    reference's, but float64 under a float64 compute, whose loss then
    sums in float64 too."""
    x = p.ln_f(x)
    if group is not None:
        x = _CopyToModel.apply(x, group)
    if cfg.tie_embeddings:
        out = torch.einsum("bsd,vd->bsv", x, head.to(cfg.cdtype()))
    else:
        out = torch.einsum("bsd,dv->bsv", x, head.to(cfg.cdtype()))
    return out.to(torch.promote_types(out.dtype, torch.float32))


def _encode(p, cfg, frontend, fsdp, mesh):
    """Whisper encoder over stubbed frame embeddings (non-causal; its
    blocks never on the ring, ``DenseBlock.ring``, but tensor-parallel on
    ``mesh``)."""
    cd = cfg.cdtype()
    x = frontend.to(cd)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(cd)[None]
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    x, _, _ = _run_stack(cfg, p.enc, x, fsdp, positions=positions,
                         causal=False, rope=False, mesh=mesh)
    return p.ln_enc(x)


def _forward_impl(model, tokens, frontend, comm, mesh, collect):
    """(logits, {"moe_drop"}, caches in the per-layer layout or None, the
    ``"model"`` group where the logits are the rank's block of the
    vocabulary, else None)."""
    cfg = model.cfg
    fsdp = _DataBlocks(model, mesh)
    x, prefix_len = _embed_in(fsdp.weight(model, "embed"), cfg, tokens,
                              frontend, _tp_group(model, "embed", mesh))
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    kw = dict(positions=positions, comm=comm, mesh=mesh, collect=collect)
    caches = None
    if cfg.family == "hybrid":
        n_groups, rem = _hybrid_layout(cfg)
        pat = cfg.hybrid.pattern
        auxs = []
        gcaches = {kind + str(i): [] for i, kind in enumerate(pat)}
        for g in range(n_groups):
            a = _zero(x)
            for i, kind in enumerate(pat):
                x, ai, c = _run_block(cfg, model.groups[kind + str(i)][g], x,
                                      fsdp, **kw)
                a = a + ai
                gcaches[kind + str(i)].append(c)
            auxs.append(a)
        aux = torch.stack(auxs).mean()
        rem_caches = {}
        for i, kind in enumerate(rem):       # no share in the aux
            x, _, rem_caches[kind + str(i)] = _run_block(
                cfg, model.rem[kind + str(i)], x, fsdp, **kw)
        if collect:
            caches = {"groups": gcaches, "rem": rem_caches}
    elif cfg.family == "encdec":
        x_enc = _encode(model, cfg, frontend, fsdp, mesh)
        pos_dec = sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                       x.device).to(cfg.cdtype())
        x = x + pos_dec[None]
        x, aux, layers = _run_stack(cfg, model.layers, x, fsdp, x_enc=x_enc,
                                    rope=False, **kw)
        caches = {"layers": layers} if collect else None
    else:
        x, aux, layers = _run_stack(cfg, model.layers, x, fsdp,
                                    prefix_len=prefix_len, **kw)
        caches = {"layers": layers} if collect else None
    head = fsdp.weight(model, _head(cfg))
    vocab = _tp_group(model, _head(cfg), mesh)
    return _logits(model, cfg, x, head, vocab), {"moe_drop": aux}, caches, \
        vocab


def forward(model: Transformer, tokens, frontend=None, comm=None,
            mesh=None):
    """Training/scoring forward.  tokens: (B, S) int.
    Returns (logits (B, S_total, V) f32, aux dict)."""
    return model(tokens, frontend, comm, mesh)


def forward_local(model: Transformer, tokens, frontend=None, comm=None,
                  mesh=None):
    """``forward`` without the logits' gather: ``(logits, aux, group)``,
    the logits the rank's block of the vocabulary ``(B, S_total, V / n)``
    and ``group`` the ``"model"`` group where it holds the vocabulary's
    blocks (tensor parallelism), else the whole logits and None."""
    logits, aux, _, vocab = _forward_impl(model, tokens, frontend, comm,
                                          mesh, collect=False)
    return logits, aux, vocab


@torch.no_grad()
def prefill(model: Transformer, tokens, frontend=None, comm=None, mesh=None,
            max_len=None):
    """Prompt pass: logits + decode caches for ``max_len`` positions (the
    prompt's length by default), laid out as ``init_caches`` lays them
    out, on the model's device.  On a mesh, ``tokens`` (and
    ``frontend``) are the rank's data shard and the caches are that
    shard's rows, under tensor parallelism the kv heads the rank holds,
    as ``decode_step`` on the mesh takes them (``init_caches(mesh=)``
    lays them out); the logits are whole, as ``forward``'s."""
    logits, _, caches, vocab = _forward_impl(model, tokens, frontend, comm,
                                             mesh, collect=True)
    if vocab is not None:
        logits = _Gather.apply(logits, vocab, logits.ndim - 1)
    s = logits.shape[1]
    return logits, _finalize_caches(model.cfg, caches, s, max_len or s)


def _finalize_caches(cfg, caches, s, max_len):
    """Pad / roll collected prefill caches into decode layout, the slots
    ``init_caches`` gives: for a window config with ``window <= max_len``
    a rolling buffer of ``window`` slots holding the prompt's last
    positions (position p in slot p % window), whatever the prompt's
    length; else each layer's keys and values padded to ``max_len``
    slots.  (The reference pads a prompt no longer than the window to
    ``max_len`` slots, which its decode then reads without the window:
    ROADMAP queue 3.)"""
    rolling = bool(cfg.window) and cfg.window <= max_len

    def fix_kv(kv):
        # kv: (B, S, hkv, dh) each
        k = kv["k"]
        if rolling:
            win = cfg.window
            keep = min(s, win)
            idx = torch.arange(s - keep, s, device=k.device) % win
            out = {}
            for key in ("k", "v"):
                buf = k.new_zeros((k.shape[0], win) + tuple(k.shape[2:]))
                buf[:, idx] = kv[key][:, s - keep:]
                out[key] = buf
            return out
        if max_len < s:
            raise ValueError(f"prefill: max_len {max_len} is shorter than "
                             f"the prompt's {s} positions")
        return {key: F.pad(kv[key], (0, 0, 0, 0, 0, max_len - s))
                for key in ("k", "v")}

    def walk(t):
        if isinstance(t, dict) and set(t) == {"k", "v"}:
            return fix_kv(t)
        if isinstance(t, dict):
            return {kk: walk(vv) for kk, vv in t.items()}
        if isinstance(t, list):
            return [walk(vv) for vv in t]
        return t

    return walk(caches)


# ---------------------------------------------------------------------------
# serving: decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch, max_len, device=None, mesh=None):
    """Zero decode caches, one dict per layer (the reference stacks
    them), on the card unless ``device`` says otherwise (``"meta"`` gives
    the shapes only).  On ``mesh``, the caches this rank holds of a
    global ``batch``, as a model cut by ``train_step.shard_params_``'s
    ``"train"`` layout decodes them: ``cache_specs``' local shapes, the
    rows of its data shard (all rows where the data axes do not divide
    the batch) and the keys' and values' kv heads over ``"model"`` where
    they divide; the SSM's and the RG-LRU's caches whole over ``"model"``
    (``cache_specs`` splits the SSM state's heads as the kv heads, which
    no SSM config's single kv head lets divide)."""
    device = torch.device("cuda" if device is None else device)
    cd = cfg.cdtype()
    win = min(cfg.window, max_len) if cfg.window else max_len
    n_kv = cfg.n_kv
    if mesh is not None:
        sizes = mesh_sizes(mesh)
        rows = math.prod(sizes.get(a, 1) for a in DATA_AXES)
        batch = batch // rows if batch % rows == 0 else batch
        tp = sizes.get("model", 1)
        n_kv = n_kv // tp if n_kv % tp == 0 else n_kv

    def attn_cache():
        return {"sa": attn.init_cache(cfg, batch, win, cd, device, n_kv)}

    def layer_cache(kind):
        if kind == "ssm":
            return init_ssm_cache(cfg, batch, cd, device)
        if kind == "rec":
            return init_rglru_cache(cfg, batch, cd, device)
        c = attn_cache()
        if kind == "cross":
            shape = (batch, cfg.n_frontend_tokens, n_kv, cfg.d_head)
            c["xk"] = torch.zeros(shape, dtype=cd, device=device)
            c["xv"] = torch.zeros(shape, dtype=cd, device=device)
        return c

    if cfg.family == "hybrid":
        n_groups, rem = _hybrid_layout(cfg)
        return {"groups": {kind + str(i): [layer_cache(kind)
                                           for _ in range(n_groups)]
                           for i, kind in enumerate(cfg.hybrid.pattern)},
                "rem": {kind + str(i): layer_cache(kind)
                        for i, kind in enumerate(rem)}}
    kind = {"ssm": "ssm", "encdec": "cross"}.get(cfg.family, "attn")
    return {"layers": [layer_cache(kind) for _ in range(cfg.n_layers)]}


# whisper's decoder reads its position from a table of this many rows
_SINUSOID_ROWS = 2 ** 15


@torch.no_grad()
def decode_step(model: Transformer, token, caches, pos: int, comm=None,
                mesh=None):
    """One serving step.  token: (B, 1) int; pos: the 0-based index of
    this token.  Updates ``caches`` in place and returns (logits (B, 1, V)
    float32, caches).  ``comm`` is taken as the reference takes it and
    unused: decode runs the local paths.

    On a mesh every rank passes its data shard of the tokens and its
    caches for those rows (``prefill(mesh=)`` or ``init_caches(mesh=)``
    gives them), and every block's ``decode`` takes the mesh.  Where the
    model holds ``"data"`` blocks of its weights (FSDP), each block runs
    on its weights gathered whole, one all-gather a block a step, every
    rank in the same order, and the embedding and ``lm_head`` are
    gathered where they are used, as in ``forward``.  Where it holds
    blocks over ``"model"``, the step runs ``forward``'s tensor-parallel
    regions: the rank's query heads against the kv heads it caches, its
    columns of the MLP's ``d_ff``, each region summed over the axis, the
    embedding's rows of its vocabulary summed over the axis and its block
    of the logits, gathered whole; an MoE holding its own ``E / n``
    experts runs them on every token of the rank and sums the experts'
    outputs over the axis (``moe.moe_decode``)."""
    cfg = model.cfg
    fsdp = _DataBlocks(model, mesh)
    x = _embed(fsdp.weight(model, "embed"), cfg, token,
               _tp_group(model, "embed", mesh))
    if cfg.family == "encdec":
        if not 0 <= pos < _SINUSOID_ROWS:
            raise IndexError(f"decode_step: position {pos} is past the "
                             f"{_SINUSOID_ROWS}-row sinusoidal table")
        x = x + sinusoidal_positions(1, cfg.d_model, x.device,
                                     start=pos).to(cfg.cdtype())[None]
    if cfg.family == "hybrid":
        n_groups, rem = _hybrid_layout(cfg)
        for g in range(n_groups):
            for i, kind in enumerate(cfg.hybrid.pattern):
                key = kind + str(i)
                x = fsdp.decode(model.groups[key][g], x,
                                caches["groups"][key][g], pos, mesh=mesh)
        for i, kind in enumerate(rem):
            key = kind + str(i)
            x = fsdp.decode(model.rem[key], x, caches["rem"][key], pos,
                            mesh=mesh)
    else:
        for block, cache in zip(model.layers, caches["layers"], strict=True):
            x = fsdp.decode(block, x, cache, pos, mesh=mesh)
    head = fsdp.weight(model, _head(cfg))
    vocab = _tp_group(model, _head(cfg), mesh)
    logits = _logits(model, cfg, x, head, vocab)
    if vocab is not None:
        logits = _Gather.apply(logits, vocab, logits.ndim - 1)
    return logits, caches


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_specs(cfg: ModelConfig, mesh_shape: dict):
    """The reference's partition-spec tree of the parameters (stacked
    stacks with a leading ``None``); ``convert.local_spec`` gives a port
    parameter's.

    TP/EP over "model"; ZeRO/FSDP over "data": every weight's d_model axis
    is additionally sharded over the data axis (when divisible) so params +
    optimizer state scale down with the FULL mesh, not just the model axis.
    (Which entries a rank of the port holds as blocks is its layout rule:
    ``training.train_step.held_shapes``.)
    """
    tp = mesh_shape.get("model", 1)
    fs = mesh_shape.get("data", 1)

    def heads_ok(n):
        return n % tp == 0

    def dd(dim):  # fsdp-shard a dim when divisible
        return "data" if dim % fs == 0 else None

    dm = dd(cfg.d_model)
    qspec = P(dm, "model", None) if heads_ok(cfg.n_heads) else \
        P(dm, None, None)
    kvspec = P(dm, "model", None) if heads_ok(cfg.n_kv) else \
        P(dm, None, None)
    ospec = P("model", None, dm) if heads_ok(cfg.n_heads) else \
        P(None, None, dm)
    a = {"wq": qspec, "wk": kvspec, "wv": kvspec, "wo": ospec}
    if cfg.qk_norm:
        a["q_norm"] = {"scale": P(None)}
        a["k_norm"] = {"scale": P(None)}
    nrm = ({"scale": P(None)} if cfg.norm == "rms"
           else {"scale": P(None), "bias": P(None)})
    if cfg.mlp_weight_gathered:
        # weight-gathered mode: MLP replicated over model (FSDP over data
        # only)
        fsh = None if dm else dd(cfg.d_ff)
        mlp = {"w_in": P(dm, fsh), "w_out": P(fsh, dm)}
        if is_gated(cfg.act):
            mlp["w_gate"] = P(dm, fsh)
    else:
        mlp = {"w_in": P(dm, "model"), "w_out": P("model", dm)}
        if is_gated(cfg.act):
            mlp["w_gate"] = P(dm, "model")

    def block_spec(kind):
        if kind == "ssm":
            return {"ln1": nrm, "ssm": {
                "w_in": P("model", dd(2 * 2 * cfg.d_model)),
                "conv_w": P(None, None),
                "conv_b": P(None), "a_log": P(None), "dt_bias": P(None),
                "d_skip": P(None), "out_norm": nrm,
                "w_out": P(None, "model")}}
        if kind == "rec":
            dr = cfg.hybrid.d_rnn or cfg.d_model
            return {"ln1": nrm, "rec": {
                "w_x": P(dm, "model"), "w_y": P(dm, "model"),
                "conv_w": P(None, "model"), "conv_b": P("model"),
                "w_r": P("model", dd(dr)), "w_i": P("model", dd(dr)),
                "lam": P(None), "w_out": P("model", dm)},
                "ln2": nrm, "mlp": mlp}
        if kind == "moe":
            mspec = {"router": P(None, None),
                     "w_in": P("model", dm, None),
                     "w_out": P("model", None, dm)}
            if is_gated(cfg.act):
                mspec["w_gate"] = P("model", dm, None)
            return {"ln1": nrm, "attn": a, "ln2": nrm, "moe": mspec}
        if kind == "cross":
            return {"ln1": nrm, "attn": a, "lnx": nrm, "xattn": a,
                    "ln2": nrm, "mlp": mlp}
        return {"ln1": nrm, "attn": a, "ln2": nrm, "mlp": mlp}

    def stacked(spec):
        return _tree_map(lambda s: P(None, *s), spec)

    vshard = "model" if cfg.vocab % tp == 0 else None
    vdata = "data" if cfg.vocab % fs == 0 else None
    out = {"embed": P(vshard, dm if vshard else (dm or vdata)), "ln_f": nrm}
    if not cfg.tie_embeddings:
        out["lm_head"] = P(dm, vshard)
    if cfg.family == "hybrid":
        n_groups, rem = _hybrid_layout(cfg)
        out["groups"] = {k + str(i): stacked(block_spec(k))
                         for i, k in enumerate(cfg.hybrid.pattern)}
        out["rem"] = {k + str(i): block_spec(k) for i, k in enumerate(rem)}
    elif cfg.family == "encdec":
        out["enc"] = stacked(block_spec("dense"))
        out["ln_enc"] = nrm
        out["layers"] = stacked(block_spec("cross"))
    else:
        kind = {"ssm": "ssm", "moe": "moe"}.get(cfg.family, "dense")
        out["layers"] = stacked(block_spec(kind))
    return out


def cache_specs(cfg: ModelConfig, mesh_shape: dict, caches, dp=None):
    """The reference's partition-spec tree of the decode caches (stacked,
    with a leading ``None``), given the port's per-layer ``caches``
    (``init_caches(..., device="meta")`` will do): batch over the data
    axes, kv heads over "model" when divisible."""
    tp = mesh_shape.get("model", 1)
    if dp is None:
        dp = tuple(a for a in DATA_AXES if a in mesh_shape)
    kvm = "model" if cfg.n_kv % tp == 0 else None

    def leaf_spec(path, a):
        lead = () if path[0] == "rem" else (None,)   # layer-stacked?
        name = path[-1]
        if name in ("k", "v", "xk", "xv"):
            return P(*lead, dp, None, kvm, None)
        if name == "state" and a.ndim == 4:          # ssm state
            return P(*lead, dp, kvm, None, None)
        if name == "state":                           # rglru state
            return P(*lead, dp, None)
        if name == "conv":
            return P(*lead, dp, None, None)
        return P()

    return convert.nest({path: leaf_spec(path, a) for path, a in
                         convert.cache_leaves(caches).items()})
