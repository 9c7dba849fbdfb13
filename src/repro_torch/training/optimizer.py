"""AdamW from scratch (+ optional error-feedback int8 gradient compression).

Counterpart of ``repro.training.optimizer``, as plain functions on trees
of tensors: nested dicts (the reference's stacked layout) or flat dicts
keyed by a model's dotted parameter names (``dict(model.named_parameters())``,
one tensor per layer).  A result has its input's structure.  The
optimizer state is ``{m, v}`` in f32 plus the step counter.

Two rules follow the reference's stacked layout whatever the input's
layout (``models.convert.ref_path`` maps a name to its leaf):

- weight decay applies to a leaf of rank >= 2 *in the reference*: every
  per-layer parameter is stacked there, so a per-layer norm scale, bias,
  ``dt_bias``, ``a_log``, ``d_skip``, ``lam`` or ``conv_b`` (1-D per
  layer) is decayed; ``ln_f``, ``ln_enc`` and the hybrid's unstacked
  remainder blocks' 1-D leaves are not;
- ``grad_compress="int8"`` quantizes per reference leaf with one shared
  scale, the max over all its layers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.convert import ref_path


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_compress: str = "none"     # none | int8


def _named(tree, prefix="") -> dict:
    """Nested dicts -> {dotted name: tensor}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _like(tree, named: dict, prefix=""):
    """``tree``'s structure with the leaves of ``named`` (by dotted name)."""
    if isinstance(tree, dict):
        return {k: _like(v, named, f"{prefix}{k}.") for k, v in tree.items()}
    return named[prefix[:-1]]


def _map(fn, tree):
    return _like(tree, {k: fn(v) for k, v in _named(tree).items()})


def init_opt_state(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    first = next(iter(_named(params).values()))
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def init_error_feedback(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def lr_schedule(cfg: AdamWConfig, step):
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup) /
                    max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree):
    return torch.sqrt(sum(g.float().square().sum()
                          for g in _named(tree).values()))


def _quantize(gf, scale):
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, gf - deq


def compress_int8(g, err):
    """Error-feedback int8 quantization of one gradient leaf (rounding
    half to even, as ``jnp.round``)."""
    gf = g.float() + err
    return _quantize(gf, torch.clamp_min(gf.abs().max(), 1e-30) / 127.0)


def apply_compression(cfg: AdamWConfig, grads, err, amax_fn=None):
    """Error-feedback int8 quantization, one scale per reference leaf
    (the max over its layers).  ``amax_fn(path, amax)``, where given,
    returns the leaf's max over the whole logical leaf from this rank's
    share of it (a rank holding a block of the leaf, on a mesh)."""
    if cfg.grad_compress == "none" or err is None:
        return grads, err
    g, e = _named(grads), _named(err)
    gf = {n: g[n].float() + e[n] for n in g}
    leaves: dict = {}
    for n in gf:
        leaves.setdefault(ref_path(n)[0], []).append(n)
    deq, new_err = {}, {}
    for path, names in leaves.items():
        amax = torch.stack([gf[n].abs().max() for n in names]).max()
        if amax_fn is not None:
            amax = amax_fn(path, amax)
        scale = torch.clamp_min(amax, 1e-30) / 127.0
        for n in names:
            deq[n], new_err[n] = _quantize(gf[n], scale)
    return _like(grads, deq), _like(err, new_err)


def _moments(cfg: AdamWConfig, grads, opt_state, gnorm=None):
    """The step, the global norm (``global_norm(grads)`` unless given),
    the clip factor, the learning rate and the bias corrections of one
    update."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                       max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    return step, gnorm, clip, lr_schedule(cfg, step), b1c, b2c


def _leaf(cfg, name, p, g, m, v, clip, lr, b1c, b2c):
    """One leaf's update: (new p, new m, new v)."""
    g = g.float() * clip
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mhat = m / b1c
    vhat = v / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    stacked = ref_path(name)[1] is not None
    if p.ndim + stacked >= 2:                    # the reference leaf's rank
        delta = delta + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m, v


def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """Returns (new_params, new_opt_state, metrics)."""
    step, gnorm, *k = _moments(cfg, grads, opt_state)
    G = _named(grads)
    M, V = _named(opt_state["m"]), _named(opt_state["v"])
    new_p, new_m, new_v = {}, {}, {}
    for n, p in _named(params).items():
        new_p[n], new_m[n], new_v[n] = _leaf(cfg, n, p, G[n], M[n], V[n], *k)
    return _like(params, new_p), {
        "m": _like(opt_state["m"], new_m), "v": _like(opt_state["v"], new_v),
        "step": step}, {"grad_norm": gnorm, "lr": k[1]}


# elements of one leaf updated at a time by ``adamw_update_``
_CHUNK = 1 << 24


def adamw_update_(cfg: AdamWConfig, params, grads, opt_state, gnorm=None):
    """``adamw_update`` in place, with the same bits: writes the new
    parameters into ``params`` and the new moments into ``opt_state``, a
    slice of at most ``_CHUNK`` elements of one leaf at a time (the
    update is elementwise), so its temporaries are a few slices, not a
    second copy of the state nor several copies of the largest leaf (a
    1.05 G-element embedding).  ``gnorm`` is the gradients' global norm
    where the caller computes it (a rank holding a block of a leaf).
    Returns (opt_state with the new step, metrics)."""
    step, gnorm, *k = _moments(cfg, grads, opt_state, gnorm)
    G = _named(grads)
    M, V = _named(opt_state["m"]), _named(opt_state["v"])
    for n, p in _named(params).items():
        rows = max(1, _CHUNK // max(1, p[0].numel()))
        for r in range(0, p.shape[0], rows):
            sl = slice(r, r + rows)
            newp, m, v = _leaf(cfg, n, p[sl], G[n][sl], M[n][sl], V[n][sl],
                               *k)
            p[sl].copy_(newp)
            M[n][sl].copy_(m)
            V[n][sl].copy_(v)
    return dict(opt_state, step=step), {"grad_norm": gnorm, "lr": k[1]}
