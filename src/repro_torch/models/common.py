"""Shared model components: configs, norms, rope, initialisers.

Counterpart of ``repro.models.common``.  The config dataclasses are the
reference's field for field; ``pdtype``/``cdtype`` return torch dtypes.
Parameters live in ``nn.Module``s (``models.transformer``) whose
attribute names are the reference tree's keys, one module per layer where
the reference stacks layers on a leading axis (``models.convert`` maps one
layout onto the other).  Dtypes are explicit throughout: ``param_dtype``
for storage (f32 master), ``compute_dtype`` (bf16) applied on entry to
each block.  Initialisers draw from an explicit ``torch.Generator``, so
they cannot reproduce the reference's threefry bits; parity tests load
the reference's initial parameters through ``models.convert`` instead.

Sharding is expressed as the reference's tree of partition specs
(``P``, ``transformer.param_specs`` / ``cache_specs``) over the logical
mesh axes: ``DATA_AXES`` shard the batch, ``"model"`` shards heads /
ffn / experts / vocab.  ``spec_placements`` maps a spec onto the
``torch.distributed.tensor`` placements of a ``DeviceMesh``.  PyTorch
runs eagerly and multi-controller: every rank holds plain local tensors
and no compiler propagates layouts, so ``maybe_constrain`` returns its
input (the reference's ``with_sharding_constraint`` only guides XLA).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style: pattern of (rec, rec, attn) blocks."""
    d_rnn: int = 0               # lru width (0 -> d_model)
    conv_width: int = 4
    window: int = 2048           # local attention window
    pattern: tuple = ("rec", "rec", "attn")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 128
    act: str = "swiglu"          # swiglu | geglu | gelu | relu2
    norm: str = "rms"            # rms | layer
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0
    tie_embeddings: bool = False
    scale_embed: bool = False    # gemma-style sqrt(d) embedding scale
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    n_enc_layers: int = 0        # encoder layers (whisper)
    n_frontend_tokens: int = 0   # stub modality tokens (audio frames/patches)
    window: int = 0              # sliding-window attention (0 = full)
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "block"         # none | block | full
    scan_layers: bool = True     # no effect: layers run in a Python loop
    unroll_inner: bool = False   # no effect: chunks run in a Python loop
    attn_block: int = 0          # chunked attention q-block (0 = naive)
    attn_ring: bool = False      # ring attention over the model axis
    mlp_weight_gathered: bool = False  # param_specs: MLP replicated over
    # "model" (activations would stay sequence-sharded under XLA)
    seq_parallel: bool = True    # a layout hint: maybe_constrain returns x

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def n_params(self) -> int:
        """Parameter count of the model built on the ``meta`` device."""
        from .transformer import Transformer
        with torch.device("meta"):
            model = Transformer(self)
        return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------

DATA_AXES = ("pod", "data")  # batch shards over these when present


class P(tuple):
    """A partition spec: one entry per tensor dimension, each ``None``
    (replicated), a mesh axis name or a tuple of names (major first).  As
    ``jax.sharding.PartitionSpec`` normalises its entries, an empty tuple
    is ``None`` and a one-name tuple is that name, so ``P(...) ==
    tuple(PartitionSpec(...))`` for the same arguments."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def maybe_constrain(x, *spec):
    """Returns ``x``: the reference's ``with_sharding_constraint`` hints a
    layout to XLA's partitioner; in eager multi-controller PyTorch every
    rank holds its local tensor and nothing propagates a layout."""
    return x


def batch_spec(mesh_names):
    """The data-parallel sharding tuple for the batch dimension."""
    return tuple(a for a in DATA_AXES if a in mesh_names)


def mesh_coord(mesh, axes):
    """``(index, count)``: this rank's block index over ``mesh``'s axes
    among ``axes`` taken together, the major (mesh-order) axis first, and
    the number of blocks (1 where none is present)."""
    dims = tuple(mesh.mesh_dim_names)
    idx, count = 0, 1
    for a in dims:
        if a in axes:
            size = mesh.shape[dims.index(a)]
            idx, count = idx * size + mesh.get_local_rank(a), count * size
    return idx, count


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of ``mesh`` (``{}`` for None)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_entry(spec, k) -> tuple:
    """The mesh axes ``spec`` names on dimension ``k`` (``()`` where it
    names none or ``spec`` is None)."""
    if spec is None or k >= len(spec) or spec[k] is None:
        return ()
    return spec[k] if isinstance(spec[k], tuple) else (spec[k],)


def block_of(a, shape, spec, mesh):
    """This rank's block of ``a`` (a tensor, as a view, or a numpy array)
    for a block of ``shape``: on each dimension where ``shape`` is
    shorter, the block at the rank's coordinate over the mesh axes
    ``spec`` names there (``mesh_coord``, the major axis first).  Raises
    ``ValueError`` where ``a``'s extent is not ``shape``'s times the
    number of blocks."""
    for k, (want, have) in enumerate(zip(shape, a.shape)):
        if want == have:
            continue
        entry = spec_entry(spec, k)
        idx, count = mesh_coord(mesh, entry)
        if want * count != have:
            raise ValueError(f"shape {tuple(a.shape)} has no block of "
                             f"{tuple(shape)} over the mesh axes {entry} on "
                             f"dimension {k}")
        a = (a.narrow(k, idx * want, want) if isinstance(a, torch.Tensor)
             else np.take(a, range(idx * want, (idx + 1) * want), axis=k))
    return a


def spec_placements(spec, mesh):
    """The ``torch.distributed.tensor`` placements (one per mesh
    dimension) that lay a tensor out as ``spec`` says on ``mesh`` (a
    ``DeviceMesh`` with named dimensions): ``Shard(d)`` on each mesh
    dimension named in tensor dimension ``d``'s entry, ``Replicate()``
    on the others.  A name the mesh lacks is an axis of size one (the
    reference's specs name ``"data"`` on a ``{model: 16}`` mesh).  A
    tuple entry must list its names in the mesh's order: the placements
    shard the major mesh dimension first."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) \
            else tuple(entry)
        present = [a for a in axes if a in names]
        if present != sorted(present, key=names.index):
            raise ValueError(f"spec {spec}: dimension {d} lists {axes} "
                             f"against the mesh order {names}")
        for a in present:
            if out[names.index(a)] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {a!r} shards two "
                                 "dimensions")
            out[names.index(a)] = Shard(d)
    return out


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layer_norm(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


class Norm(nn.Module):
    """``scale`` (rms: ``1 + scale``, zero-initialised) or ``scale`` and
    ``bias`` (layer norm, ones and zeros)."""

    def __init__(self, cfg: ModelConfig, d: int):
        super().__init__()
        self.kind, self.eps = cfg.norm, cfg.norm_eps
        self.scale = param((d,), cfg.pdtype())
        if cfg.norm != "rms":
            self.bias = param((d,), cfg.pdtype())

    def init_weights(self, gen):
        with torch.no_grad():
            self.scale.fill_(0.0 if self.kind == "rms" else 1.0)
            if self.kind != "rms":
                self.bias.zero_()

    def forward(self, x):
        if self.kind == "rms":
            return rms_norm(x, self.scale, self.eps)
        return layer_norm(x, self.scale, self.bias, self.eps)


def act_fn(name: str, x, gate=None):
    if name == "swiglu":
        return F.silu(gate) * x
    if name == "geglu":
        return F.gelu(gate, approximate="tanh") * x
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


def rope_freqs(cfg: ModelConfig, positions):
    """positions: int tensor (...,) -> (cos, sin) of shape (..., rot/2),
    float32 (the reference's angles are float32 too unless JAX runs in
    x64, where they are float64)."""
    rot = int(cfg.d_head * cfg.rope_fraction)
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, rot, 2) / rot))
    inv = torch.as_tensor(inv, dtype=torch.float32, device=positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rope_fraction=1.0):
    """x: (..., S, n_heads, d_head); cos/sin: (..., S, rot/2)."""
    dh = x.shape[-1]
    rot = cos.shape[-1] * 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    # broadcast over the heads axis: x is (..., S, H, dh); cos is (..., S, r/2)
    c = cos[..., None, :]
    s = sin[..., None, :]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    out = torch.cat([y1, y2], dim=-1)
    if rot < dh:
        out = torch.cat([out, xp], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n, d, device=None, start=0):
    """Rows ``start .. start + n - 1`` of the sinusoidal table, each
    computed as the reference's full table computes it."""
    pos = np.arange(start, start + n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# parameters and initialisers
# ---------------------------------------------------------------------------

def param(shape, dtype) -> nn.Parameter:
    """An uninitialised parameter on the current default device (``meta``
    under ``torch.device("meta")``); ``init_weights`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype))


def _truncated_normal_(t, gen):
    """Standard normal truncated to [-2, 2], by inverting the CDF of a
    uniform draw (as ``jax.random.truncated_normal`` does)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    t.uniform_(lo, hi, generator=gen)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t


def _scaled_truncated_normal_(p, gen, scale):
    """``p`` <- ``scale`` times a truncated normal drawn in float32: in
    place when ``p`` is float32, so that a 4 GB embedding does not need
    two more of its size."""
    with torch.no_grad():
        t = p if p.dtype == torch.float32 else torch.empty(
            p.shape, dtype=torch.float32, device=p.device)
        _truncated_normal_(t, gen).mul_(scale)
        if t is not p:
            p.copy_(t)


def dense_init_(p, gen, fan_in=None):
    fan_in = fan_in if fan_in is not None else p.shape[0]
    _scaled_truncated_normal_(p, gen, 1.0 / math.sqrt(fan_in))


def embed_init_(p, gen):
    _scaled_truncated_normal_(p, gen, 0.02)


def initialise(module, gen):
    """Fill every parameter of ``module`` from ``gen``, module by module
    in ``module.modules()`` order; returns ``module``."""
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    return module


def replace_param_(model, name, t):
    """Sets ``model``'s parameter ``name`` (dotted) to a new parameter
    holding ``t``, and drops the blocks ``transformer.held_axes`` kept on
    ``model`` (``t`` may be of another shape)."""
    prefix, _, attr = name.rpartition(".")
    setattr(model.get_submodule(prefix), attr, nn.Parameter(t))
    model.__dict__.pop("_held_axes", None)


def const_init_(p, values):
    with torch.no_grad():
        p.copy_(torch.as_tensor(values, dtype=p.dtype))
