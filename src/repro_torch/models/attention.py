"""GQA/MQA attention with RoPE, qk-norm, sliding windows, prefix-LM
masking, KV caches and ring attention.

Counterpart of ``repro.models.attention``.  The functions take the
``Attention`` module as ``p`` (its attributes are the reference dict's
keys).  ``attention_decode`` writes the new token's keys and values into
the layer's cache in place, where the reference returns an updated copy:
the cache is not copied each step.  ``attention_ring`` runs over the
``"model"`` axis of a ``DeviceMesh`` with point-to-point sends, each ring
shift a pair of autograd Functions whose backward sends the gradient
round the ring the other way (the transpose JAX derives for the
reference's ``ppermute``).  Under tensor parallelism ``attention`` and
``attention_cross`` run on a module holding the rank's block of the
heads and return its share of the output (``models.transformer`` sums
it over ``"model"``), and so does ``attention_decode`` against a cache
of the kv heads the rank computes; the ring takes the weights whole.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from .common import (ModelConfig, Norm, apply_rope, dense_init_, initialise,
                     param, rms_norm, rope_freqs)

NEG_INF = -2.0e38
_LSE_MIN = -1.0e30


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, d_model=None):
        super().__init__()
        d = d_model or cfg.d_model
        dh, h, hkv = cfg.d_head, cfg.n_heads, cfg.n_kv
        pd = cfg.pdtype()
        self.d = d
        self.wq = param((d, h, dh), pd)
        self.wk = param((d, hkv, dh), pd)
        self.wv = param((d, hkv, dh), pd)
        self.wo = param((h, dh, d), pd)
        if cfg.qk_norm:
            self.q_norm = Norm(cfg, dh)
            self.k_norm = Norm(cfg, dh)

    def init_weights(self, gen):
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, gen, fan_in=self.d)
        dense_init_(self.wo, gen, fan_in=self.wo.shape[0] * self.wo.shape[1])


def init_attn(gen, cfg: ModelConfig, d_model=None) -> Attention:
    with torch.device(gen.device):
        return initialise(Attention(cfg, d_model), gen)


def _mask(cfg: ModelConfig, q_pos, k_pos, causal):
    """(..., Sq, Sk) additive mask."""
    m = torch.zeros(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                    dtype=torch.float32, device=q_pos.device)
    if causal:
        m = torch.where(k_pos[..., None, :] > q_pos[..., :, None], NEG_INF, m)
    if cfg.window:
        m = torch.where(k_pos[..., None, :] <= q_pos[..., :, None]
                        - cfg.window, NEG_INF, m)
    return m


def _qkv(p, cfg: ModelConfig, x, positions, rope=True):
    cd = cfg.cdtype()
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(cd))
    if cfg.qk_norm:
        # rms whatever cfg.norm says, as the reference
        q = rms_norm(q, p.q_norm.scale, cfg.norm_eps)
        k = rms_norm(k, p.k_norm.scale, cfg.norm_eps)
    if rope:
        cos, sin = rope_freqs(cfg, positions)
        q = apply_rope(q, cos, sin, cfg.rope_fraction)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
    return q, k, v


def _sdpa(cfg: ModelConfig, q, k, v, mask, q0=0):
    """q: (b,sq,h,dh), k/v: (b,sk,hkv,dh) -> (b,sq,h,dh).  Query head h
    reads kv head h // g; the softmax runs in float32 and its weights are
    cast back to q's dtype.  Where ``q`` holds a block of the query heads
    (tensor parallelism) whose groups the kv heads ``k``/``v`` do not
    match, the kv heads whole, query head ``q0 + i`` reads kv head
    ``(q0 + i) // g``, one kv head taken for each."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = cfg.n_heads // cfg.n_kv
    if hkv * g != h:
        idx = torch.arange(q0, q0 + h, device=q.device) // g
        k, v = k.index_select(2, idx), v.index_select(2, idx)
        hkv, g = h, 1
    qg = q.reshape(b, sq, hkv, g, dh)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg, k).float()
    logits = logits / math.sqrt(dh) + mask[:, None, None]
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqs,bshk->bqhgk", w, v)
    return o.reshape(b, sq, h, dh)


def _prefix(mask, k_pos, prefix_len):
    """Every query sees the prefix keys (prefix-LM)."""
    return torch.where(k_pos[..., None, :] < prefix_len, 0.0, mask)


def _sdpa_chunked(cfg: ModelConfig, q, k, v, q_pos, k_pos, causal,
                  prefix_len=0, q0=0):
    """Exact chunked attention: a loop over static q blocks, each attending
    a static KV slice (causal upper bound / sliding window)."""
    b, s, h, dh = q.shape
    qb = min(cfg.attn_block, s)
    n_blocks = -(-s // qb)
    outs = []
    for i in range(n_blocks):
        lo, hi = i * qb, min((i + 1) * qb, s)
        # static KV extent: causal -> [0, hi); window -> last (win + qb)
        k_lo = 0
        if cfg.window:
            k_lo = max(0, hi - cfg.window - qb)
        k_hi = hi if causal else s
        mask = _mask(cfg, q_pos[:, lo:hi], k_pos[:, k_lo:k_hi], causal)
        if prefix_len:
            mask = _prefix(mask, k_pos[:, k_lo:k_hi], prefix_len)
        outs.append(_sdpa(cfg, q[:, lo:hi], k[:, k_lo:k_hi],
                          v[:, k_lo:k_hi], mask, q0))
    return torch.cat(outs, dim=1)


def attention(p, cfg: ModelConfig, x, positions, causal=True, rope=True,
              prefix_len=0, return_kv=False, q0=0):
    """Full (training / prefill) attention. x: (B, S, D).  With
    ``return_kv`` also the post-RoPE ``(k, v)`` in the compute dtype.
    Where ``p`` holds a block of the heads (tensor parallelism; ``q0``
    the global index of its first query head), the rank's heads' share of
    the output, which the caller sums over ``"model"``."""
    q, k, v = _qkv(p, cfg, x, positions, rope)
    if cfg.attn_block and x.shape[1] > cfg.attn_block:
        o = _sdpa_chunked(cfg, q, k, v, positions, positions, causal,
                          prefix_len, q0)
    else:
        mask = _mask(cfg, positions, positions, causal)
        if prefix_len:
            mask = _prefix(mask, positions, prefix_len)
        o = _sdpa(cfg, q, k, v, mask, q0)
    out = torch.einsum("bshk,hkd->bsd", o, p.wo.to(cfg.cdtype()))
    return (out, (k, v)) if return_kv else out


def _p2p(t, group, to: int, frm: int):
    """Posts the send of ``t`` to ``group``'s rank ``to`` and the receive
    of a block like it from rank ``frm``; returns a function that waits
    for both and gives the received block.  gloo's point-to-point calls
    take host memory only, so on gloo a device block is staged through
    the host."""
    stage = t.device.type != "cpu" and dist.get_backend(group) == "gloo"
    send = t.cpu() if stage else t.contiguous()
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dist.get_global_rank(group, to), group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm),
                   group)])

    def wait():
        for w in works:
            w.wait()
        return recv.to(t.device) if stage else recv
    return wait


class _Shift:
    """One ring shift of the ``"model"`` group (rank ``r`` of ``n``): the
    forward sends to ``r + 1`` and receives from ``r - 1``, the backward
    sends the received block's gradient to ``r - 1`` and receives the
    sent block's from ``r + 1``.  ``_RingPost`` and ``_RingWait`` carry
    it through autograd."""

    def __init__(self, group, r: int, n: int):
        self.group, self.nxt, self.prv = group, (r + 1) % n, (r - 1) % n
        self.wait = self.wait_grad = None


class _RingPost(torch.autograd.Function):
    """Posts the shift of ``t`` and returns an empty token that
    ``_RingWait`` takes; its backward waits for the gradient that
    ``_RingWait``'s backward posted and gives it as ``t``'s."""

    @staticmethod
    def forward(ctx, t, shift):
        ctx.shift = shift
        shift.wait = _p2p(t, shift.group, shift.nxt, shift.prv)
        return t.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        return ctx.shift.wait_grad(), None


class _RingWait(torch.autograd.Function):
    """Waits for the shift ``_RingPost`` posted and returns the received
    block; its backward posts that block's gradient round the ring the
    other way."""

    @staticmethod
    def forward(ctx, token, shift):
        ctx.shift = shift
        return shift.wait()

    @staticmethod
    def backward(ctx, g):
        shift = ctx.shift
        shift.wait_grad = _p2p(g, shift.group, shift.prv, shift.nxt)
        return g.new_zeros(0), None


def attention_ring(p, cfg: ModelConfig, x, mesh, causal=True, rope=True,
                   prefix_len=0):
    """Ring attention over the ``"model"`` axis of ``mesh`` (sequence-
    sharded KV), with gradients.

    ``x`` (B_loc, S_loc, D) is this rank's block of the input, the
    sequence sharded over the ``"model"`` ranks in order (the block
    ``P(DATA_AXES, "model", None)`` gives the rank): its queries sit at
    positions ``r * S_loc + arange(S_loc)``, ``r`` the rank's coordinate
    on the axis.  Each rank takes its queries against its local KV block,
    then the blocks rotate around the ring, rank r sending to r + 1 (the
    reference's ``ppermute`` order, one point-to-point step at a time),
    with an online-softmax accumulation in float32.  The next block's
    send and receive are posted before the current block's work, so on
    NCCL the transfer overlaps it.  Any head count works.  For
    sliding-window configs only ``ceil(window / S_loc) + 1`` ring steps
    carry unmasked work; the rest are skipped.  Returns this rank's output
    block (B_loc, S_loc, D).

    Each shift is two autograd Functions, ``_RingPost`` (post) and
    ``_RingWait`` (wait), so that the post stays ahead of the block's
    work.  In the backward, ``_RingWait``'s posts the gradient of the
    received block to rank r - 1 (receiving from r + 1) and
    ``_RingPost``'s waits for it, after autograd has taken the block's
    own work back (it was recorded later, so it runs first): each
    forward shift has exactly one mirror, the window configs' too.  The
    weight gradients are this rank's queries' share: the caller sums
    them over the axis (``training.train_step``)."""
    group = mesh.get_group("model")
    n_ring = dist.get_world_size(group)
    r = dist.get_rank(group)
    b, s_loc, _ = x.shape
    n_steps = (min(n_ring, -(-cfg.window // s_loc) + 1) if cfg.window
               else n_ring)
    ar = torch.arange(s_loc, device=x.device)
    pos_q = r * s_loc + ar
    q, k, v = _qkv(p, cfg, x, pos_q.expand(b, s_loc), rope)
    h, dh = q.shape[2:]
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s_loc, hkv, g, dh)
    f32 = torch.float32
    acc = torch.zeros((b, hkv, g, s_loc, dh), dtype=f32, device=x.device)
    mx = torch.full((b, hkv, g, s_loc), -torch.inf, dtype=f32,
                    device=x.device)
    li = torch.zeros((b, hkv, g, s_loc), dtype=f32, device=x.device)
    kv = torch.stack([k, v])
    for t in range(n_steps):
        # the next block is on the wire while this one is worked on
        shift = _Shift(group, r, n_ring) if t < n_steps - 1 else None
        token = _RingPost.apply(kv, shift) if shift else None
        pos_k = (r - t) % n_ring * s_loc + ar
        logits = torch.einsum("bqhgk,bshk->bhgqs", qg,
                              kv[0]).float() / math.sqrt(dh)
        mask = torch.zeros((s_loc, s_loc), dtype=f32, device=x.device)
        if causal:
            mask = torch.where(pos_k[None, :] > pos_q[:, None], NEG_INF,
                               mask)
        if cfg.window:
            mask = torch.where(pos_k[None, :] <= pos_q[:, None]
                               - cfg.window, NEG_INF, mask)
        if prefix_len:
            mask = torch.where(pos_k[None, :] < prefix_len, 0.0, mask)
        logits = logits + mask
        bmx = torch.maximum(mx, logits.amax(dim=-1))
        bmx_safe = bmx.clamp_min(_LSE_MIN)
        scale = torch.exp(mx.clamp_min(_LSE_MIN) - bmx_safe)
        w = torch.exp(logits - bmx_safe[..., None])
        li = li * scale + w.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum(
            "bhgqs,bshk->bhgqk", w, kv[1].float())
        mx = bmx
        if shift:
            kv = _RingWait.apply(token, shift)
    out = acc / li[..., None].clamp_min(1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s_loc, h, dh)
    return torch.einsum("bshk,hkd->bsd", out.to(x.dtype),
                        p.wo.to(cfg.cdtype()))


def attention_cross(p, cfg: ModelConfig, x, kv, q0=0):
    """Cross-attention against precomputed encoder K/V (whisper decoder);
    ``q0`` as in ``attention``."""
    cd = cfg.cdtype()
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(cd))
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm.scale, cfg.norm_eps)
    k, v = kv
    b, sq = q.shape[:2]
    mask = torch.zeros((b, sq, k.shape[1]), dtype=torch.float32,
                       device=q.device)
    o = _sdpa(cfg, q, k, v, mask, q0)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(cd))


def encode_kv(p, cfg: ModelConfig, x_enc):
    cd = cfg.cdtype()
    k = torch.einsum("bsd,dhk->bshk", x_enc, p.wk.to(cd))
    v = torch.einsum("bsd,dhk->bshk", x_enc, p.wv.to(cd))
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm.scale, cfg.norm_eps)
    return k, v


# -- decode path -------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch, max_len, dtype, device, n_kv=None):
    """KV cache for one attention layer: (B, S_max, Hkv, dh) pair, of
    ``n_kv`` kv heads (a rank's block of them; all by default)."""
    shape = (batch, max_len, n_kv or cfg.n_kv, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, cfg: ModelConfig, x, cache, pos: int, rope=True,
                     q0=0):
    """One-token decode.  x: (B, 1, D); pos: the token's 0-based index;
    ``q0`` as in ``attention`` (the cache then holds the kv heads ``p``
    computes).

    Writes the token's k and v into ``cache`` in place and returns
    ``(out, cache)``.  For sliding-window configs whose cache has
    ``cfg.window`` slots it is a rolling buffer: position ``pos`` lives
    in slot ``pos % window``.  A slot past the cache raises (the
    reference's ``dynamic_update_slice`` would clamp it to the last)."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x, torch.full((b, 1), pos, device=x.device),
                   rope=rope)
    s_max = cache["k"].shape[1]
    rolling = bool(cfg.window) and s_max == cfg.window
    slot = pos % cfg.window if rolling else pos
    if not 0 <= slot < s_max:
        raise IndexError(f"attention_decode: position {pos} is past the "
                         f"cache's {s_max} slots")
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    idx = torch.arange(s_max, device=x.device)
    if rolling:
        # slot i holds the position whose age (pos - position) is
        # (slot - i) mod window
        valid = pos - (slot - idx) % cfg.window >= 0
    else:
        valid = idx <= pos
    mask = torch.zeros(s_max, dtype=torch.float32, device=x.device)
    mask = mask.masked_fill(~valid, NEG_INF).expand(b, 1, s_max)
    o = _sdpa(cfg, q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask,
              q0)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(cfg.cdtype())), cache
