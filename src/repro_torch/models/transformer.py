"""Model assembly for all assigned architectures (training forward).

Counterpart of ``repro.models.transformer``'s training path.  One
``nn.Module`` per block kind (dense attention, MoE, SSM, recurrent,
whisper's cross-attention decoder block), a ``ModuleList`` per stack and a
top-level ``Transformer(cfg)`` whose ``forward(tokens, frontend)`` returns
``(logits (B, S_total, V) float32, {"moe_drop": ...})``.

The reference stacks each uniform stack's layers on a leading axis and
scans over them; here the layers are modules run in a Python loop, so
``cfg.scan_layers`` and ``cfg.unroll_inner`` change nothing.
``cfg.remat`` of ``"block"`` or ``"full"`` wraps each block in
``torch.utils.checkpoint`` (memory changes, numbers do not).  Module
attribute names are the reference tree's keys, so a parameter's dotted
name is its reference path with the layer index inserted
(``models.convert``).

``prefill``, ``decode_step``, ``init_caches``, ``param_specs`` and
``cache_specs`` are not ported yet (ROADMAP queue 1 item 3b).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .attention import Attention
from .common import (ModelConfig, Norm, act_fn, dense_init_, embed_init_,
                     initialise, is_gated, not_ported, param,
                     sinusoidal_positions)
from .moe import MoE, moe_block
from .rglru import RGLRU, rglru_block
from .ssm import SSM, ssm_block


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


# ---------------------------------------------------------------------------
# blocks: forward(x, positions, causal, prefix_len, x_enc, rope) -> (x, aux)
# ---------------------------------------------------------------------------

def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _attend(blk, x, positions, causal, prefix_len, rope):
    return x + attn.attention(blk.attn, blk.cfg, blk.ln1(x), positions,
                              causal=causal, rope=rope,
                              prefix_len=prefix_len)


class DenseBlock(nn.Module):
    """Self-attention + MLP (dense, vlm, the hybrid's ``attn``, whisper's
    encoder)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model)
        self.attn = Attention(cfg)
        self.ln2 = Norm(cfg, cfg.d_model)
        self.mlp = MLP(cfg)

    def forward(self, x, positions, causal=True, prefix_len=0, x_enc=None,
                rope=True):
        x = _attend(self, x, positions, causal, prefix_len, rope)
        return x + _mlp(self.mlp, self.cfg, self.ln2(x)), _zero(x)


class MoEBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model)
        self.attn = Attention(cfg)
        self.ln2 = Norm(cfg, cfg.d_model)
        self.moe = MoE(cfg)

    def forward(self, x, positions, causal=True, prefix_len=0, x_enc=None,
                rope=True):
        x = _attend(self, x, positions, causal, prefix_len, rope)
        h, aux = moe_block(self.moe, self.cfg, self.ln2(x))
        return x + h, aux.float()


class CrossBlock(nn.Module):
    """Whisper's decoder block: self-attention, cross-attention against
    the encoder output, MLP."""

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
                rope=True):
        x = _attend(self, x, positions, causal, prefix_len, rope)
        kv_x = attn.encode_kv(self.xattn, self.cfg, x_enc)
        x = x + attn.attention_cross(self.xattn, self.cfg, self.lnx(x), kv_x)
        return x + _mlp(self.mlp, self.cfg, self.ln2(x)), _zero(x)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model)
        self.ssm = SSM(cfg)

    def forward(self, x, positions, causal=True, prefix_len=0, x_enc=None,
                rope=True):
        h, _ = ssm_block(self.ssm, self.cfg, self.ln1(x))
        return x + h, _zero(x)


class RecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model)
        self.rec = RGLRU(cfg)
        self.ln2 = Norm(cfg, cfg.d_model)
        self.mlp = MLP(cfg)

    def forward(self, x, positions, causal=True, prefix_len=0, x_enc=None,
                rope=True):
        h, _ = rglru_block(self.rec, self.cfg, self.ln1(x))
        x = x + h
        return x + _mlp(self.mlp, self.cfg, self.ln2(x)), _zero(x)


_BLOCKS = {"dense": DenseBlock, "attn": DenseBlock, "moe": MoEBlock,
           "cross": CrossBlock, "ssm": SSMBlock, "rec": RecBlock}


def _hybrid_layout(cfg: ModelConfig):
    """(n_groups, remainder_kinds) for the hybrid pattern."""
    pat = cfg.hybrid.pattern
    n_groups = cfg.n_layers // len(pat)
    rem = cfg.n_layers - n_groups * len(pat)
    return n_groups, tuple(pat[:rem])


def _run_block(cfg, block, x, **kw):
    """One block, recomputed in the backward pass unless ``cfg.remat`` is
    ``"none"``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return block(x, **kw)
    return checkpoint(block, x, use_reentrant=False, **kw)


def _run_stack(cfg, blocks, x, **kw):
    """The blocks in order; the mean of their aux."""
    auxs = []
    for block in blocks:
        x, aux = _run_block(cfg, block, x, **kw)
        auxs.append(aux)
    return x, torch.stack(auxs).mean()


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
            self.ln_enc = Norm(cfg, d)
            self.layers = stack("cross", cfg.n_layers)
        else:
            kind = {"ssm": "ssm", "moe": "moe"}.get(cfg.family, "dense")
            self.layers = stack(kind, cfg.n_layers)

    def init_weights(self, gen):
        embed_init_(self.embed, gen)
        if hasattr(self, "lm_head"):
            dense_init_(self.lm_head, gen, fan_in=self.cfg.d_model)

    def forward(self, tokens, frontend=None):
        """tokens: (B, S) int.  Returns (logits (B, S_total, V) float32,
        {"moe_drop": the MoE layers' mean drop fraction (0 elsewhere)})."""
        cfg = self.cfg
        x, prefix_len = _embed_in(self, cfg, tokens, frontend)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        if cfg.family == "hybrid":
            n_groups, rem = _hybrid_layout(cfg)
            pat = cfg.hybrid.pattern
            auxs = []
            for g in range(n_groups):
                a = _zero(x)
                for i, kind in enumerate(pat):
                    x, ai = _run_block(cfg, self.groups[kind + str(i)][g], x,
                                       positions=positions)
                    a = a + ai
                auxs.append(a)
            aux = torch.stack(auxs).mean()
            for i, kind in enumerate(rem):       # no share in the aux
                x, _ = _run_block(cfg, self.rem[kind + str(i)], x,
                                  positions=positions)
        elif cfg.family == "encdec":
            x_enc = _encode(self, cfg, frontend)
            pos_dec = sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                           x.device).to(cfg.cdtype())
            x = x + pos_dec[None]
            x, aux = _run_stack(cfg, self.layers, x, positions=positions,
                                x_enc=x_enc, rope=False)
        else:
            x, aux = _run_stack(cfg, self.layers, x, positions=positions,
                                prefix_len=prefix_len)
        return _logits(self, cfg, x), {"moe_drop": aux}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """The model built on ``gen``'s device and initialised from ``gen``."""
    with torch.device(gen.device):
        return initialise(Transformer(cfg), gen)


def _embed_in(p, cfg, tokens, frontend):
    cd = cfg.cdtype()
    x = p.embed[tokens].to(cd)
    if cfg.scale_embed:
        # the factor is cast to the compute dtype before the product
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=cd,
                             device=x.device)
    prefix_len = 0
    if frontend is not None and cfg.family != "encdec":
        x = torch.cat([frontend.to(cd), x], dim=1)
        prefix_len = frontend.shape[1]
    return x, prefix_len


def _logits(p, cfg, x):
    x = p.ln_f(x)
    if cfg.tie_embeddings:
        out = torch.einsum("bsd,vd->bsv", x, p.embed.to(cfg.cdtype()))
    else:
        out = torch.einsum("bsd,dv->bsv", x, p.lm_head.to(cfg.cdtype()))
    return out.float()


def _encode(p, cfg, frontend):
    """Whisper encoder over stubbed frame embeddings (non-causal)."""
    cd = cfg.cdtype()
    x = frontend.to(cd)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(cd)[None]
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    x, _ = _run_stack(cfg, p.enc, x, positions=positions, causal=False,
                      rope=False)
    return p.ln_enc(x)


def forward(model: Transformer, tokens, frontend=None):
    """Training/scoring forward.  tokens: (B, S) int.
    Returns (logits (B, S_total, V) f32, aux dict)."""
    return model(tokens, frontend)


def _serving(what):
    def fn(*args, **kwargs):
        raise not_ported(what, "3b", "the decode caches and the sharding "
                         "specs")
    fn.__name__ = what
    return fn


prefill = _serving("prefill")
decode_step = _serving("decode_step")
init_caches = _serving("init_caches")
param_specs = _serving("param_specs")
cache_specs = _serving("cache_specs")
