"""RG-LRU recurrent block (RecurrentGemma / Griffin): forward and O(1)
decode.

Counterpart of ``repro.models.rglru``:

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

The recurrence is a Hillis-Steele scan of log2(S) steps with the
reference's ``combine``; ``lax.associative_scan`` combines in another
(tree) order, so the two agree to float32 rounding, not bit for bit.
Decode carries the conv history and the float32 state.

Tensor-parallel (``group``, the ``"model"`` axis, where the rank holds
``param_specs``' blocks of ``d_rnn``) the block runs on the rank's
channels: ``w_x``/``w_y``'s columns and the conv's give its block of
``u`` and of the gate; its rows of ``w_r``/``w_i`` give partial sums
over every channel of the gates' inputs, reduced over the axis and
scattered to the ranks' channels (one reduce-scatter carries both);
``lam``'s channels of the rank, the scan on them, and ``w_out``'s rows,
the output summed over the axis.  The caches stay whole, as
``cache_specs`` lays them out: the final state and conv history are
gathered from the channels' blocks, and decode reads its channels of
them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, const_init_, dense_init_, initialise, param

_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        dr = cfg.hybrid.d_rnn or d
        pd = cfg.pdtype()
        self.w_x = param((d, dr), pd)
        self.w_y = param((d, dr), pd)
        self.conv_w = param((cfg.hybrid.conv_width, dr), pd)
        self.conv_b = param((dr,), pd)
        self.w_r = param((dr, dr), pd)
        self.w_i = param((dr, dr), pd)
        self.lam = param((dr,), pd)
        self.w_out = param((dr, d), pd)

    def init_weights(self, gen):
        d, dr = self.w_x.shape
        dense_init_(self.w_x, gen, fan_in=d)
        dense_init_(self.w_y, gen, fan_in=d)
        dense_init_(self.conv_w, gen, fan_in=self.conv_w.shape[0])
        const_init_(self.conv_b, np.zeros(dr))
        dense_init_(self.w_r, gen, fan_in=dr)
        dense_init_(self.w_i, gen, fan_in=dr)
        # Lambda init so a^(1/c) ~ U(0.9, 0.999) (griffin appendix)
        const_init_(self.lam,
                    np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, dr)))))
        dense_init_(self.w_out, gen, fan_in=dr)


def init_rglru(gen, cfg: ModelConfig) -> RGLRU:
    with torch.device(gen.device):
        return initialise(RGLRU(cfg), gen)


def _tf():
    """``models.transformer``, whose tensor-parallel autograd Functions
    the block uses (imported where used: it imports this module)."""
    from . import transformer
    return transformer


def _lru_coeffs(p, cfg, u, group=None):
    """u: (B, S, dr) -> per-step decay a and input b = sqrt(1-a^2)*i*u.
    With ``group``, ``u`` is the rank's channels and so are a and b: the
    gates' inputs reduce-scattered over the axis from its rows of
    ``w_r``/``w_i``."""
    lam = p.lam
    if group is None:
        r = torch.sigmoid(u @ p.w_r.to(u.dtype))
        i = torch.sigmoid(u @ p.w_i.to(u.dtype))
    else:
        c = u.shape[-1]
        part = torch.stack([u @ p.w_r.to(u.dtype), u @ p.w_i.to(u.dtype)],
                           dim=-2)
        r, i = torch.sigmoid(_tf()._ReduceScatter.apply(
            part, group, part.ndim - 1)).unbind(dim=-2)
        c0 = dist.get_rank(group) * c
        lam = lam[c0:c0 + c]
    lam = F.softplus(lam.float())
    log_a = (-_C * lam) * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * u).float()
    return a, b


def _conv(u, w, b, width):
    pad = F.pad(u, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + u.shape[1], :] * w[i] for i in range(width))
    return out + b


def _scan(a, b):
    """Inclusive scan along axis 1 of ``(a2, b2) o (a1, b1) = (a1*a2,
    a2*b1 + b2)``: log2(S) out-of-place steps, each combining every
    element with the one ``d`` before it."""
    s = a.shape[1]
    d = 1
    while d < s:
        a_prev = F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        b_prev = F.pad(b[:, :-d], (0, 0, d, 0))
        a, b = a * a_prev, a * b_prev + b
        d *= 2
    return a, b


def _in_proj(p, x, cd, group):
    """(u, gate): ``x`` against ``w_x`` and ``w_y`` (with ``group``, their
    rank's columns; ``x``'s gradient summed over the axis)."""
    if group is not None:
        x = _tf()._CopyToModel.apply(x, group)
    u = torch.einsum("bsd,de->bse", x, p.w_x.to(cd))
    gate = F.gelu(torch.einsum("bsd,de->bse", x, p.w_y.to(cd)),
                  approximate="tanh")
    return u, gate


def _out_proj(p, h, cd, group):
    """``h @ w_out`` (with ``group``, the rank's rows, summed over the
    axis)."""
    out = torch.einsum("bse,ed->bsd", h, p.w_out.to(cd))
    return out if group is None else _tf()._SumOverModel.apply(out, group)


def _whole(t, group):
    """``t``, the rank's block of the channels (the last dimension), made
    whole over ``group``, in storage of its own (a cache leaf that is a
    view would hold the tensor it views)."""
    return t.clone() if group is None else \
        _tf()._Gather.apply(t, group, t.ndim - 1)


def rglru_block(p, cfg: ModelConfig, x, return_tail=False, group=None):
    """x: (B, S, D) -> (out, final_state (B, dr), conv_tail); conv_tail is
    the raw input history decode continues from (None unless
    ``return_tail``).  With ``group`` the block runs on the rank's
    channels (module docstring): the output whole, and the state and
    tail gathered whole where ``return_tail``, else the state the rank's
    channels."""
    cd = cfg.cdtype()
    u_raw, gate = _in_proj(p, x, cd, group)
    conv_tail = (_whole(u_raw[:, -(cfg.hybrid.conv_width - 1):, :], group)
                 if return_tail else None)
    u = _conv(u_raw, p.conv_w.to(cd), p.conv_b.to(cd), cfg.hybrid.conv_width)
    a, bb = _lru_coeffs(p, cfg, u, group)
    _, hh = _scan(a, bb)
    out = _out_proj(p, hh.to(cd) * gate, cd, group)
    state = hh[:, -1].float()
    return out, _whole(state, group) if return_tail else state, conv_tail


def init_rglru_cache(cfg: ModelConfig, batch, dtype, device):
    dr = cfg.hybrid.d_rnn or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.hybrid.conv_width - 1, dr),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, dr), dtype=torch.float32,
                             device=device),
    }


def rglru_decode(p, cfg: ModelConfig, x, cache, group=None):
    """One token. x: (B, 1, D) -> (out, new cache); the conv's taps summed
    in the reference's order in the compute dtype.  With ``group`` the
    step runs on the rank's channels of the whole cache, and the new
    state and history are gathered whole."""
    cd = cfg.cdtype()
    u, gate = _in_proj(p, x, cd, group)
    past, state = cache["conv"], cache["state"]
    if group is not None:
        c = u.shape[-1]
        c0 = dist.get_rank(group) * c
        past, state = past[..., c0:c0 + c], state[..., c0:c0 + c]
    hist = torch.cat([past, u], dim=1)
    w = p.conv_w.to(cd)
    conv = sum(hist[:, i, :] * w[i] for i in range(cfg.hybrid.conv_width))
    u1 = (conv + p.conv_b.to(cd))[:, None, :]
    a, bb = _lru_coeffs(p, cfg, u1, group)
    h = state * a[:, 0] + bb[:, 0]
    out = _out_proj(p, (h.to(cd) * gate[:, 0])[:, None, :], cd, group)
    return out, {"conv": _whole(hist[:, 1:], group), "state": _whole(h, group)}
