"""The reference's parameter trees and training states, to and from the
port's modules.

The reference keeps each uniform stack's layers stacked on a leading axis
(``jax.vmap`` of the block init); the port keeps one module per layer in
a ``ModuleList``.  A parameter's dotted name in the port is its
reference path with the layer index inserted: ``layers.3.attn.wq`` is
``params["layers"]["attn"]["wq"][3]``, ``groups.rec0.5.rec.lam`` is
``params["groups"]["rec0"]["rec"]["lam"][5]``, and an unstacked leaf
(``embed``, ``ln_f.scale``, the hybrid's ``rem.rec0.rec.lam``) has no
index.  ``ref_path`` gives the pair for a name.

``from_reference(tree, cfg)`` loads a reference parameter tree (nested
dicts of arrays, stacked) into a new ``Transformer``; given a training
state (the reference's ``TrainState`` with array leaves, or the tuple
``to_reference`` returns for one) it returns the port's ``TrainState``.
``to_reference`` is the inverse: a model -> the stacked parameter tree of
numpy arrays; a ``TrainState`` -> ``(params, {"m", "step", "v"},
err_fb)``, the reference ``TrainState``'s fields in their order, so
``repro_torch.ckpt.checkpoint`` writes the leaves in the reference's
order and shapes and either package's launcher resumes the other's
checkpoint.  ``reference_like`` is that tuple's shapes and dtypes, with
no data behind them, to restore into.

On a mesh a rank may hold a block of a leaf: its ``"data"`` block
(FSDP, ``training.train_step.shard_state_``) and over ``"model"`` its
own ``E / n`` experts' rows of an MoE expert weight or its
tensor-parallel block of an attention's heads, an MLP's ``d_ff`` or the
vocabulary.  ``to_reference(obj, mesh)``
gathers such a leaf over the axes its ``param_specs`` entry names, so
that every rank gets the whole logical tree; ``reference_like(model)``
gives the rank's own shapes, and ``from_reference`` loads a tree of
blocks into a model whose parameters have the blocks' shapes.
``logical_shapes(cfg)`` gives each parameter's whole shape, against
which a block is recognised.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["ref_path", "from_reference", "to_reference", "reference_like",
           "caches_to_reference", "caches_from_reference", "local_spec",
           "logical_shapes", "expert_weight"]


def ref_path(name: str):
    """``(path, index)`` of a dotted parameter name: the reference tree's
    keys and the layer index (``None`` for an unstacked leaf)."""
    parts = name.split(".")
    idx = [int(p) for p in parts if p.isdigit()]
    return tuple(p for p in parts if not p.isdigit()), \
        (idx[0] if idx else None)


def expert_weight(name: str) -> bool:
    """Whether dotted ``name`` is an MoE expert weight (rows by expert)."""
    path = ref_path(name)[0]
    return path[-2:-1] == ("moe",) and path[-1] != "router"


@functools.lru_cache(maxsize=16)
def logical_shapes(cfg) -> dict:
    """``{dotted name: shape}`` of every parameter of ``Transformer(cfg)``,
    whole (built on the ``meta`` device)."""
    from .transformer import Transformer
    with torch.device("meta"):
        model = Transformer(cfg)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _layout(model):
    """``{path: [(index, tensor), ...]}`` over the model's parameters."""
    out: dict = {}
    for name, p in model.named_parameters():
        path, i = ref_path(name)
        out.setdefault(path, []).append((i, p))
    return out


def nest(flat: dict) -> dict:
    """{path tuple: leaf} -> the nested dict."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _host(t) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 (which numpy lacks) as
    float32, exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor on ``device``; a bfloat16
    array (``ml_dtypes``' type, as JAX hands it out) stays bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _stack_named(named: dict) -> dict:
    """{dotted name: tensor} -> the stacked reference tree of numpy
    arrays."""
    groups: dict = {}
    for name, t in named.items():
        path, i = ref_path(name)
        groups.setdefault(path, []).append((i, t))
    flat = {}
    for path, entries in groups.items():
        if entries[0][0] is None:
            flat[path] = _host(entries[0][1])
        else:
            entries.sort(key=lambda e: e[0])
            flat[path] = np.stack([_host(t) for _, t in entries])
    return nest(flat)


def _unstack_named(model, tree, device) -> dict:
    """The reference tree -> {dotted name: tensor} in the model's layout."""
    flat = _flat(tree)
    out = {}
    for name, p in model.named_parameters():
        path, i = ref_path(name)
        leaf = np.asarray(flat[path])
        v = leaf if i is None else leaf[i]
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference leaf {'/'.join(path)} "
                             f"gives {v.shape}, the model holds "
                             f"{tuple(p.shape)}")
        out[name] = torch.from_numpy(np.array(v)).to(device=device,
                                                      dtype=p.dtype)
    return out


def _model(cfg, tree, device):
    """A ``Transformer(cfg)`` on ``device`` holding ``tree``'s values, each
    parameter of the shape of its leaf in ``tree`` (a rank's block where
    the tree holds one)."""
    from .common import replace_param_
    from .transformer import Transformer
    flat = _flat(tree)
    with torch.device("meta"):
        model = Transformer(cfg)
        for name, p in list(model.named_parameters()):
            path, i = ref_path(name)
            shape = np.shape(flat[path])[0 if i is None else 1:]
            if tuple(shape) != tuple(p.shape):
                replace_param_(model, name, torch.empty(shape,
                                                        dtype=p.dtype))
    model = model.to_empty(device=device)
    values = _unstack_named(model, tree, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(values[name])
    return model


def _fields(state):
    if isinstance(state, (tuple, list)):
        return state
    return state.params, state.opt_state, state.err_fb


def from_reference(tree, cfg, device="cpu"):
    """A reference parameter tree -> ``Transformer``; a reference training
    state -> ``repro_torch.training.train_step.TrainState``."""
    if isinstance(tree, dict):
        return _model(cfg, tree, device)
    from repro_torch.training.train_step import TrainState
    params, opt_state, err_fb = _fields(tree)
    model = _model(cfg, params, device)
    m = _unstack_named(model, opt_state["m"], device)
    v = _unstack_named(model, opt_state["v"], device)
    step = torch.tensor(int(np.asarray(opt_state["step"])),
                        dtype=torch.int32, device=device)
    err = None if err_fb is None else _unstack_named(model, err_fb, device)
    return TrainState(model, {"m": m, "v": v, "step": step}, err)


def _whole(named: dict, cfg, mesh) -> dict:
    """``named`` with each leaf this rank holds a block of gathered over
    the mesh axes its ``param_specs`` entry names on the dimensions where
    it is shorter than the logical leaf (every rank of ``mesh`` calls
    it)."""
    import torch.distributed as dist
    from .transformer import param_specs
    full = logical_shapes(cfg)
    dims = tuple(mesh.mesh_dim_names)
    specs = param_specs(cfg, dict(zip(dims, mesh.shape)))
    out = {}
    for name, t in named.items():
        spec = local_spec(specs, name)
        for k in range(t.ndim):
            if t.shape[k] == full[name][k]:
                continue
            entry = spec[k] if isinstance(spec[k], tuple) else (spec[k],)
            for axis in reversed([a for a in entry if a in dims]):
                group = mesh.get_group(axis)
                parts = [torch.empty_like(t)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, t.contiguous(), group=group)
                t = torch.cat(parts, dim=k)
            if t.shape[k] != full[name][k]:
                raise ValueError(f"{name}: a block of {t.shape[k]} on "
                                 f"dimension {k} after gathering over "
                                 f"{entry}; the leaf has {full[name][k]}")
        out[name] = t
    return out


def to_reference(obj, mesh=None):
    """A model -> its stacked parameter tree (numpy); a ``TrainState`` ->
    ``(params, {"m", "step", "v"}, err_fb)`` in the reference's layout.
    With ``mesh`` (every rank of it calls this) the leaves a rank holds a
    block of are gathered first (``_whole``)."""
    model = obj if isinstance(obj, torch.nn.Module) else obj.params

    def tree(named):
        if mesh is not None:
            named = _whole(named, model.cfg, mesh)
        return _stack_named(named)

    if isinstance(obj, torch.nn.Module):
        return tree(dict(obj.named_parameters()))
    opt = obj.opt_state
    return (tree(dict(obj.params.named_parameters())),
            {"m": tree(opt["m"]), "step": _host(opt["step"]),
             "v": tree(opt["v"])},
            None if obj.err_fb is None else tree(obj.err_fb))


def reference_like(cfg, compress: bool = False):
    """The shapes and dtypes of ``to_reference(state)`` for ``cfg``, as
    numpy arrays with no data behind them (a restore target); given a
    model in place of ``cfg``, its parameters' shapes (a rank's own
    experts' rows where it holds only those)."""
    from .transformer import Transformer
    if isinstance(cfg, torch.nn.Module):
        model = cfg
    else:
        with torch.device("meta"):
            model = Transformer(cfg)
    shapes = {}
    for path, entries in _layout(model).items():
        p = entries[0][1]
        shapes[path] = (tuple(p.shape) if entries[0][0] is None else
                        (len(entries),) + tuple(p.shape),
                        str(p.dtype).replace("torch.", ""))

    def tree(dtype=None):
        return nest({path: np.broadcast_to(np.zeros((), dtype or dt), shape)
                      for path, (shape, dt) in shapes.items()})

    return (tree(),
            {"m": tree("float32"), "step": np.zeros((), np.int32),
             "v": tree("float32")},
            tree("float32") if compress else None)


# ---------------------------------------------------------------------------
# decode caches and partition specs
# ---------------------------------------------------------------------------

def _dotted(tree, prefix="") -> dict:
    """{dotted name: leaf} of nested dicts and lists (a list's items
    named by their index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_dotted(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def cache_leaves(caches) -> dict:
    """{reference path: the first layer's tensor} of the port's caches."""
    out: dict = {}
    for name, t in _dotted(caches).items():
        out.setdefault(ref_path(name)[0], t)
    return out


def caches_to_reference(caches) -> dict:
    """The port's per-layer caches -> the reference's stacked tree of
    numpy arrays."""
    return _stack_named(_dotted(caches))


def caches_from_reference(tree, cfg, device) -> dict:
    """The reference's stacked caches -> the port's per-layer layout on
    ``device``: ``"layers"`` and each of ``"groups"``' stacks become lists
    of per-layer dicts, ``"rem"`` keeps one dict a block.  Every leaf
    takes the dtype ``init_caches`` gives it (``cfg``'s compute dtype,
    float32 for the recurrent states), so bfloat16 caches that travelled
    as float32 arrays come back bit for bit."""
    cd = cfg.cdtype()

    def tensors(t, i=None, key=None):
        """``t``'s leaves as tensors (layer ``i`` of each, if given)."""
        if isinstance(t, dict):
            return {k: tensors(v, i, k) for k, v in t.items()}
        return _tensor(t if i is None else t[i], device).to(
            torch.float32 if key == "state" else cd)

    def unstack(t):
        n = len(next(iter(_flat(t).values())))
        return [tensors(t, i) for i in range(n)]

    out = {}
    for top, sub in tree.items():
        if top == "layers":
            out[top] = unstack(sub)
        elif top == "groups":
            out[top] = {k: unstack(v) for k, v in sub.items()}
        else:
            out[top] = tensors(sub)
    return out


def local_spec(specs, name: str):
    """The partition spec of the port's tensor ``name`` (a parameter's
    dotted name, or a cache leaf's such as ``layers.3.sa.k``) in the
    reference-shaped ``specs``: the leaf at its reference path, less the
    stacked leading axis where the port holds one layer of it."""
    from .common import P
    path, i = ref_path(name)
    node = specs
    for k in path:
        node = node[k]
    return node if i is None else P(*node[1:])
