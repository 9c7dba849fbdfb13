"""Mamba-2 (SSD, state-space duality) block, chunked scan and O(1)
decode.

Counterpart of ``repro.models.ssm``.  Per head, a
scalar-decay SSM

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t,   y_t = C_t^T h_t + D x_t

computed chunk-parallel: a quadratic attention-like term inside chunks of
length ``chunk`` and a sequential state pass between chunks (a Python
loop over chunks, in float32).  Decode carries the conv history and the
float32 SSM state and costs O(1) per token.

Tensor-parallel (``group``, the ``"model"`` axis, where the rank holds
``param_specs``' blocks: ``w_in``'s rows and ``w_out``'s columns of
``d_model``): the in-projection is row-parallel, the rank's block of
``d_model`` of the input against its rows of ``w_in``, the partial
projections summed over the axis; the conv, the scan, the skip and the
gated norm then run replicated on the whole projection (every rank holds
the same sum), so the state and the conv history come out whole, as
``cache_specs`` lays them out; the out-projection is column-parallel,
the rank's columns of ``d_model`` gathered whole.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .common import (ModelConfig, Norm, const_init_, dense_init_, initialise,
                     param, rms_norm)


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        din, nh = s.d_inner(d), s.n_heads(d)
        pd = cfg.pdtype()
        conv_dim = din + 2 * s.d_state
        # fused input projection: [z (gate), x, B, C, dt]
        self.w_in = param((d, 2 * din + 2 * s.d_state + nh), pd)
        self.conv_w = param((s.d_conv, conv_dim), pd)
        self.conv_b = param((conv_dim,), pd)
        self.a_log = param((nh,), pd)
        self.dt_bias = param((nh,), pd)
        self.d_skip = param((nh,), pd)
        self.out_norm = Norm(cfg, din)
        self.w_out = param((din, d), pd)

    def init_weights(self, gen):
        nh = self.a_log.shape[0]
        dense_init_(self.w_in, gen, fan_in=self.w_in.shape[0])
        dense_init_(self.conv_w, gen, fan_in=self.conv_w.shape[0])
        dense_init_(self.w_out, gen, fan_in=self.w_out.shape[0])
        const_init_(self.conv_b, np.zeros(self.conv_b.shape))
        const_init_(self.a_log, np.log(np.linspace(1.0, float(nh), nh)))
        const_init_(self.dt_bias,
                    np.log(np.expm1(np.linspace(1e-3, 0.1, nh))))
        const_init_(self.d_skip, np.ones(nh))


def init_ssm(gen, cfg: ModelConfig) -> SSM:
    with torch.device(gen.device):
        return initialise(SSM(cfg), gen)


def _split_proj(cfg, proj):
    s = cfg.ssm
    din = s.d_inner(cfg.d_model)
    z, xbc, dt = torch.split(proj, [din, din + 2 * s.d_state,
                                    proj.shape[-1] - 2 * din
                                    - 2 * s.d_state], dim=-1)
    return z, xbc, dt


def _conv1d(xbc, w, b, d_conv):
    """Causal depthwise conv along the sequence. xbc: (B, S, C)."""
    pad = F.pad(xbc, (0, 0, d_conv - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(d_conv))
    return F.silu(out + b)


def ssd_chunked(xh, dt, a, B, C, chunk):
    """SSD scan.  xh: (b, s, h, p); dt: (b, s, h); B,C: (b, s, n).

    One step per chunk: the quadratic intra-chunk work, then the
    inter-chunk state.  Needs ``s % chunk == 0``.  Returns y (b, s, h, p)
    and the final state (b, h, p, n).

    The in-chunk decays ``exp(seg_q - seg_k)`` are taken of the masked
    differences (``-inf`` above the diagonal), not masked after the
    ``exp``: at full width a difference above the diagonal can pass 88
    and overflow to ``inf``, and the masked ``inf``'s gradient (0 * inf)
    would be NaN.  The forward values are the reference's.
    """
    b, s, h, pdim = xh.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {chunk}")
    la = dt * a                                      # log-decay per step < 0
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))
    state = xh.new_zeros((b, h, pdim, n))
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc, lac, Bc, Cc = xh[:, sl], dt[:, sl], la[:, sl], B[:, sl], \
            C[:, sl]
        seg = lac.cumsum(dim=1)                      # (b,c,h)
        decay = seg[:, :, None, :] - seg[:, None, :, :]      # (b,q,k,h)
        w = torch.where(causal[None, :, :, None], decay, -torch.inf).exp()
        scores = torch.einsum("bqn,bkn->bqk", Cc, Bc)
        y = torch.einsum("bqk,bqkh,bkhp->bqhp", scores, w * dtc[:, None], xc)
        # contribution of the incoming state
        y = y + torch.einsum("bqn,bqh,bhpn->bqhp", Cc, seg.exp(), state)
        # outgoing state
        tail = seg[:, -1:, :] - seg
        out_state = torch.einsum("bkh,bkn,bkhp->bhpn", tail.exp() * dtc,
                                 Bc, xc)
        state = state * seg[:, -1].exp()[..., None, None] + out_state
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _tf():
    """``models.transformer``, whose tensor-parallel autograd Functions
    the blocks use (imported where used: it imports this module)."""
    from . import transformer
    return transformer


def _in_proj(p, x, cd, group):
    """``x @ w_in``; with ``group``, row-parallel: the rank's block of
    ``d_model`` of ``x`` against its rows of ``w_in``, summed over the
    axis (the input's gradient summed back over it)."""
    if group is None:
        return torch.einsum("bsd,de->bse", x, p.w_in.to(cd))
    tf = _tf()
    rows = p.w_in.shape[0]
    r = dist.get_rank(group)
    xb = tf._CopyToModel.apply(x, group)[..., r * rows:(r + 1) * rows]
    return tf._SumOverModel.apply(
        torch.einsum("bsd,de->bse", xb, p.w_in.to(cd)), group)


def _out_proj(p, y, cd, group):
    """``y @ w_out``; with ``group``, column-parallel: the rank's columns
    of ``d_model`` gathered whole over the axis (``y``'s gradient, each
    rank's columns' share, summed over it)."""
    if group is None:
        return torch.einsum("bse,ed->bsd", y, p.w_out.to(cd))
    tf = _tf()
    out = torch.einsum("bse,ed->bsd", tf._CopyToModel.apply(y, group),
                       p.w_out.to(cd))
    return tf._Gather.apply(out, group, out.ndim - 1)


def ssm_block(p, cfg: ModelConfig, x, return_tail=False, group=None):
    """Training / prefill forward. x: (B, S, D).

    Returns (out, final_state, conv_tail); conv_tail is the raw xbc history
    needed to continue decoding (None unless ``return_tail``).  With
    ``group`` the projections run tensor-parallel over it (module
    docstring); the results are whole."""
    s = cfg.ssm
    cd = cfg.cdtype()
    din = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    proj = _in_proj(p, x, cd, group)
    z, xbc, dt = _split_proj(cfg, proj)
    # the tail in storage of its own, not a view holding the projection
    conv_tail = xbc[:, -(s.d_conv - 1):, :].clone() if return_tail else None
    xbc = _conv1d(xbc, p.conv_w.to(cd), p.conv_b.to(cd), s.d_conv)
    xs, B, C = torch.split(xbc, [din, s.d_state, s.d_state], dim=-1)
    bsz, slen = x.shape[:2]
    xh = xs.reshape(bsz, slen, nh, s.head_dim)
    dt = F.softplus(dt.float() + p.dt_bias.float())
    a = -torch.exp(p.a_log.float())
    y, state = ssd_chunked(xh.float(), dt, a, B.float(), C.float(),
                           min(s.chunk, slen))
    y = y + xh.float() * p.d_skip.float()[None, None, :, None]
    y = y.reshape(bsz, slen, din).to(cd)
    y = rms_norm(y * F.silu(z), p.out_norm.scale, cfg.norm_eps)
    return _out_proj(p, y, cd, group), state, conv_tail


# -- decode -------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch, dtype, device):
    s = cfg.ssm
    din = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = din + 2 * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }


def ssm_decode(p, cfg: ModelConfig, x, cache, group=None):
    """One token. x: (B, 1, D) -> (out, new cache).  The conv sums its
    taps in the reference's order in the compute dtype; the state stays
    float32.  With ``group`` as ``ssm_block``: the cache whole."""
    s = cfg.ssm
    cd = cfg.cdtype()
    din = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    proj = _in_proj(p, x, cd, group)
    z, xbc, dt = _split_proj(cfg, proj)
    hist = torch.cat([cache["conv"], xbc], dim=1)        # (B, d_conv, C)
    w = p.conv_w.to(cd)
    conv = sum(hist[:, i, :] * w[i] for i in range(s.d_conv))
    xbc1 = F.silu(conv + p.conv_b.to(cd))[:, None, :]
    xs, B, C = torch.split(xbc1, [din, s.d_state, s.d_state], dim=-1)
    xh = xs.reshape(-1, nh, s.head_dim).float()
    dtv = F.softplus(dt[:, 0].float() + p.dt_bias.float())      # (B, h)
    a = -torch.exp(p.a_log.float())
    dec = torch.exp(dtv * a)                                     # (B, h)
    Bv = B[:, 0].float()                                         # (B, n)
    Cv = C[:, 0].float()
    st = cache["state"] * dec[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dtv, Bv, xh)
    y = torch.einsum("bn,bhpn->bhp", Cv, st)
    y = y + xh * p.d_skip.float()[None, :, None]
    y = y.reshape(-1, 1, din).to(cd)
    y = rms_norm(y * F.silu(z), p.out_norm.scale, cfg.norm_eps)
    return _out_proj(p, y, cd, group), {"conv": hist[:, 1:, :].clone(),
                                         "state": st}
