"""GQA/MQA attention with RoPE, qk-norm, sliding windows and prefix-LM
masking (training forward).

Counterpart of ``repro.models.attention``'s training path.  The functions
take the ``Attention`` module as ``p`` (its attributes are the reference
dict's keys).  The decode caches and ring attention are not ported yet
(ROADMAP queue 1 item 3b).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .common import (ModelConfig, Norm, apply_rope, dense_init_, initialise,
                     param, rms_norm, rope_freqs)

NEG_INF = -2.0e38


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


def _sdpa(cfg: ModelConfig, q, k, v, mask):
    """q: (b,sq,h,dh), k/v: (b,sk,hkv,dh) -> (b,sq,h,dh).  Query head h
    reads kv head h // g; the softmax runs in float32 and its weights are
    cast back to q's dtype."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
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
                  prefix_len=0):
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
                          v[:, k_lo:k_hi], mask))
    return torch.cat(outs, dim=1)


def attention(p, cfg: ModelConfig, x, positions, causal=True, rope=True,
              prefix_len=0):
    """Full (training) attention. x: (B, S, D)."""
    q, k, v = _qkv(p, cfg, x, positions, rope)
    if cfg.attn_block and x.shape[1] > cfg.attn_block:
        o = _sdpa_chunked(cfg, q, k, v, positions, positions, causal,
                          prefix_len)
    else:
        mask = _mask(cfg, positions, positions, causal)
        if prefix_len:
            mask = _prefix(mask, positions, prefix_len)
        o = _sdpa(cfg, q, k, v, mask)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(cfg.cdtype()))


def attention_cross(p, cfg: ModelConfig, x, kv):
    """Cross-attention against precomputed encoder K/V (whisper decoder)."""
    cd = cfg.cdtype()
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(cd))
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm.scale, cfg.norm_eps)
    k, v = kv
    b, sq = q.shape[:2]
    mask = torch.zeros((b, sq, k.shape[1]), dtype=torch.float32,
                       device=q.device)
    o = _sdpa(cfg, q, k, v, mask)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(cd))


def encode_kv(p, cfg: ModelConfig, x_enc):
    cd = cfg.cdtype()
    k = torch.einsum("bsd,dhk->bshk", x_enc, p.wk.to(cd))
    v = torch.einsum("bsd,dhk->bshk", x_enc, p.wv.to(cd))
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm.scale, cfg.norm_eps)
    return k, v
