"""MoE FFN with capacity-based (GShard-style) dispatch, on one device or
expert-parallel over a mesh's ``"model"`` axis.

Counterpart of ``repro.models.moe``.  The router runs in
float32; the top-k keeps ``lax.top_k``'s order (descending, the lower
expert first on ties) through a stable sort, since ``torch.topk``'s order
on ties is unspecified on CUDA.  Capacity slots come from a cumulative
sum in the flattened (T*k) order, so the dropped entries and the
``moe_drop`` metric are the reference's.

On a mesh with a ``"model"`` axis, tokens are split over the data axes
and the ``"model"`` axis and experts over ``"model"`` (a rank's module
holds either all ``E`` experts' weights or only its own ``E / n``, as
``param_specs`` lays them out); dispatch and combine are each one
flups topology switch over that axis
(``repro_torch.core.comm.topology_switch``, any strategy), and the
capacity comes from the shard's own token count.  Each switch is an
autograd Function whose backward is the reverse switch under the same
``CommConfig`` (the transpose JAX derives for the reference's
``all_to_all``), so the path has gradients: the input's, the router's
(this rank's tokens' share) and the experts' (every token routed to the
rank's experts).

A decode step's MoE (``moe_decode``) keeps its tokens on the rank: a
module of the rank's own experts runs their slots and the outputs are
summed over ``"model"``.  Its capacity comes from the rank's tokens, its
data shard of the batch, where the reference's decode on a mesh routes
the global batch: the two drop the same tokens only where no slot binds
(a capacity factor of ``E / k``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.core.comm import as_comm, topology_switch
from .common import (ModelConfig, act_fn, dense_init_, initialise,
                     is_gated, param)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        m = cfg.moe
        d, dff, e = cfg.d_model, cfg.d_ff, m.n_experts
        self.router = param((d, e), torch.float32)
        self.w_in = param((e, d, dff), cfg.pdtype())
        self.w_out = param((e, dff, d), cfg.pdtype())
        if is_gated(cfg.act):
            self.w_gate = param((e, d, dff), cfg.pdtype())

    def init_weights(self, gen):
        d, dff = self.w_in.shape[1:]
        dense_init_(self.router, gen, fan_in=d)
        dense_init_(self.w_in, gen, fan_in=d)
        dense_init_(self.w_out, gen, fan_in=dff)
        if hasattr(self, "w_gate"):
            dense_init_(self.w_gate, gen, fan_in=d)


def init_moe(gen, cfg: ModelConfig) -> MoE:
    with torch.device(gen.device):
        return initialise(MoE(cfg), gen)


def _route(p, m, xf):
    logits = (xf.float() @ p.router).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[:, :m.top_k], idx[:, :m.top_k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate, idx


def _dispatch_local(x, idx, n_experts, capacity):
    """Bucket local tokens into a (E, C, d) buffer.

    x: (T, d); idx: (T, k) top-k expert assignments.
    Returns buf (E, C, d) and the (dest, keep) bookkeeping for combine.
    """
    t, k = idx.shape
    flat_e = idx.reshape(-1)                      # (T*k,)
    # position of each entry within its expert's bucket
    onehot = F.one_hot(flat_e, n_experts)         # (T*k, E)
    pos = onehot.cumsum(dim=0) - 1
    slot = pos.gather(1, flat_e[:, None])[:, 0]
    keep = slot < capacity
    slot_c = torch.where(keep, slot, 0)
    dest = flat_e * capacity + slot_c             # flat (E*C) index
    src = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = x.new_zeros((n_experts * capacity, x.shape[-1]))
    buf = buf.index_add(0, dest, torch.where(keep[:, None], x[src], 0.0))
    return buf.reshape(n_experts, capacity, -1), (dest, keep)


def _combine_local(ybuf, book, gate, t, k):
    dest, keep = book
    y = ybuf.reshape(-1, ybuf.shape[-1])[dest]    # (T*k, d)
    y = torch.where(keep[:, None], y, 0.0)
    y = y * gate.reshape(-1)[:, None].to(y.dtype)
    return y.reshape(t, k, -1).sum(dim=1)


def _expert_ffn(cfg, buf, w_in, w_gate, w_out):
    cd = cfg.cdtype()
    h = torch.bmm(buf, w_in.to(cd))
    if w_gate is not None:
        h = act_fn(cfg.act, h, torch.bmm(buf, w_gate.to(cd)))
    else:
        h = act_fn(cfg.act, h)
    return torch.bmm(h, w_out.to(cd))


def _local_experts(p, m, n, r):
    """This rank's expert rows of ``p``: its ``E / n`` when ``p`` holds
    only those (the layout ``param_specs`` gives, experts over
    ``"model"``), or the ``r``-th ``E / n`` when it holds all ``E``."""
    if m.n_experts % n:
        raise ValueError(f"moe_block: {m.n_experts} experts do not divide "
                         f"over the {n} ranks of the model axis")
    e_loc = m.n_experts // n
    rows = p.w_in.shape[0]
    if rows == m.n_experts:
        experts = slice(r * e_loc, (r + 1) * e_loc)
    elif rows == e_loc:
        experts = slice(None)
    else:
        raise ValueError(f"moe_block: the module holds {rows} experts' "
                         f"weights; on {n} model ranks it takes all "
                         f"{m.n_experts} or this rank's {e_loc}")
    w_gate = getattr(p, "w_gate", None)
    return (p.w_in[experts], None if w_gate is None else w_gate[experts],
            p.w_out[experts])


class _Switch(torch.autograd.Function):
    """``topology_switch`` over ``"model"`` (split ``split``, gather
    ``concat``); its backward is the switch back (split ``concat``,
    gather ``split``) under the same strategy, a permutation's
    transpose."""

    @staticmethod
    def forward(ctx, x, split, concat, comm, groups):
        ctx.args = (split, concat, comm, groups)
        return topology_switch(x, "model", split, concat, comm,
                               groups=groups)

    @staticmethod
    def backward(ctx, g):
        split, concat, comm, groups = ctx.args
        return (topology_switch(g.contiguous(), "model", concat, split, comm,
                                groups=groups), None, None, None, None)


def _moe_shard(p, cfg: ModelConfig, x, comm, mesh):
    """One rank's share of the expert-parallel MoE: ``x`` is its token
    block, its experts the ``"model"`` coordinate's ``E / n``
    (``_local_experts``; the router and each expert's d_model axis
    whole: a rank holding a ``"data"`` block of them runs on them
    gathered, ``transformer._DataBlocks``).  Returns (out, the drop
    fraction's mean over every rank of the mesh, outside the autograd
    graph)."""
    m = cfg.moe
    group = mesh.get_group("model")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    w_in, w_gate, w_out = _local_experts(p, m, n, r)
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gate, idx = _route(p, m, xf)
    capacity = int(t * m.top_k / m.n_experts * m.capacity_factor) + 1
    buf, book = _dispatch_local(xf, idx, m.n_experts, capacity)
    comm = as_comm(comm)
    groups = {"model": group}
    # flups topology switch #1: (E, C, d) -> (E_loc, C * n, d)
    buf = _Switch.apply(buf, 0, 1, comm, groups)
    y = _expert_ffn(cfg, buf, w_in, w_gate, w_out)
    # flups topology switch #2 (reverse): back to the token layout
    y = _Switch.apply(y, 1, 0, comm, groups)
    out = _combine_local(y, book, gate, t, m.top_k)
    # pmean over every mesh axis: a metric, no gradient
    drop = 1.0 - book[1].float().mean()
    for name in mesh.mesh_dim_names:
        dist.all_reduce(drop, group=mesh.get_group(name))
    return out.reshape(b, s, d).to(x.dtype), drop / mesh.size()


def _moe_local(p, cfg: ModelConfig, x):
    """Single-device MoE (and decode's, ``moe_decode``): returns (out
    (B, S, D), drop fraction)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gate, idx = _route(p, m, xf)
    capacity = int(t * m.top_k / m.n_experts * m.capacity_factor) + 1
    buf, book = _dispatch_local(xf, idx, m.n_experts, capacity)
    y = _expert_ffn(cfg, buf, p.w_in, getattr(p, "w_gate", None), p.w_out)
    out = _combine_local(y, book, gate, t, m.top_k)
    drop = 1.0 - book[1].float().mean()
    return out.reshape(b, s, d).to(x.dtype), drop


def moe_decode(p, cfg: ModelConfig, x, mesh=None):
    """The decode step's MoE: ``_moe_local``'s output on the rank's tokens
    ``x`` (B, S, D), every rank of the ``"model"`` axis passing the same.
    A module of all ``E`` experts runs ``_moe_local``.  One holding only
    the rank's own ``E / n`` (``_local_experts``; the layout rule on a
    mesh) routes and dispatches every token to all ``E`` experts' slots
    as ``_moe_local`` does, runs its own experts' slots alone, combines
    them (the other experts' slots zero) and sums the ``n`` ranks'
    combined outputs over the axis: ``_moe_local``'s numbers at the same
    capacity, summed in another order.  The capacity comes from the
    rank's token count, as in ``_moe_local``."""
    m = cfg.moe
    if p.w_in.shape[0] == m.n_experts:
        return _moe_local(p, cfg, x)[0]
    if "model" not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError(f"moe_decode: the module holds "
                         f"{p.w_in.shape[0]} of {m.n_experts} experts; "
                         "decoding them needs the mesh's \"model\" axis")
    group = mesh.get_group("model")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    w_in, w_gate, w_out = _local_experts(p, m, n, r)
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gate, idx = _route(p, m, xf)
    capacity = int(t * m.top_k / m.n_experts * m.capacity_factor) + 1
    buf, book = _dispatch_local(xf, idx, m.n_experts, capacity)
    own = slice(r * w_in.shape[0], (r + 1) * w_in.shape[0])
    y = torch.zeros_like(buf)
    y[own] = _expert_ffn(cfg, buf[own], w_in, w_gate, w_out)
    out = _combine_local(y, book, gate, t, m.top_k)
    dist.all_reduce(out, group=group)
    return out.reshape(b, s, d).to(x.dtype)


def moe_block(p, cfg: ModelConfig, x, comm=None, mesh=None):
    """MoE FFN -> (out, drop fraction).  Without a mesh with a ``"model"``
    axis, x: (B, S, D) and the local path.  On such a mesh, x is this
    rank's block (B_loc, S_loc, D) of the tokens, split over the data
    axes and the ``"model"`` axis (``P(DATA_AXES, "model", None)``), and
    the out block is this rank's; every rank of the mesh must call it."""
    if "model" not in (getattr(mesh, "mesh_dim_names", None) or ()):
        return _moe_local(p, cfg, x)
    return _moe_shard(p, cfg, x, comm, mesh)
