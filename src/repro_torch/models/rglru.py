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
"""
from __future__ import annotations

import numpy as np
import torch
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


def _lru_coeffs(p, cfg, u):
    """u: (B, S, dr) -> per-step decay a and input b = sqrt(1-a^2)*i*u."""
    r = torch.sigmoid(u @ p.w_r.to(u.dtype))
    i = torch.sigmoid(u @ p.w_i.to(u.dtype))
    lam = F.softplus(p.lam.float())
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


def rglru_block(p, cfg: ModelConfig, x, return_tail=False):
    """x: (B, S, D) -> (out, final_state (B, dr), conv_tail); conv_tail is
    the raw input history decode continues from (None unless
    ``return_tail``)."""
    cd = cfg.cdtype()
    u_raw = torch.einsum("bsd,de->bse", x, p.w_x.to(cd))
    gate = F.gelu(torch.einsum("bsd,de->bse", x, p.w_y.to(cd)),
                  approximate="tanh")
    conv_tail = (u_raw[:, -(cfg.hybrid.conv_width - 1):, :]
                 if return_tail else None)
    u = _conv(u_raw, p.conv_w.to(cd), p.conv_b.to(cd), cfg.hybrid.conv_width)
    a, bb = _lru_coeffs(p, cfg, u)
    _, hh = _scan(a, bb)
    out = torch.einsum("bse,ed->bsd", hh.to(cd) * gate, p.w_out.to(cd))
    return out, hh[:, -1].float(), conv_tail


def init_rglru_cache(cfg: ModelConfig, batch, dtype, device):
    dr = cfg.hybrid.d_rnn or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.hybrid.conv_width - 1, dr),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, dr), dtype=torch.float32,
                             device=device),
    }


def rglru_decode(p, cfg: ModelConfig, x, cache):
    """One token. x: (B, 1, D) -> (out, new cache); the conv's taps summed
    in the reference's order in the compute dtype."""
    cd = cfg.cdtype()
    u = torch.einsum("bsd,de->bse", x, p.w_x.to(cd))
    gate = F.gelu(torch.einsum("bsd,de->bse", x, p.w_y.to(cd)),
                  approximate="tanh")
    hist = torch.cat([cache["conv"], u], dim=1)
    w = p.conv_w.to(cd)
    conv = sum(hist[:, i, :] * w[i] for i in range(cfg.hybrid.conv_width))
    u1 = (conv + p.conv_b.to(cd))[:, None, :]
    a, bb = _lru_coeffs(p, cfg, u1)
    h = cache["state"] * a[:, 0] + bb[:, 0]
    out = torch.einsum("be,ed->bd", h.to(cd) * gate[:, 0],
                       p.w_out.to(cd))[:, None, :]
    return out, {"conv": hist[:, 1:], "state": h}
