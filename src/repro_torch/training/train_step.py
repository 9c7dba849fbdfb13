"""Train state + train step (CE loss, AdamW, remat, optional compression).

Counterpart of ``repro.training.train_step``.  Gradients come from
autograd.  The state's ``params`` is the ``Transformer`` itself (its
parameters are the f32 master weights); ``opt_state`` and ``err_fb`` are
flat dicts keyed by its dotted parameter names.  A step updates the
model's parameters and the moments in place and returns a new
``TrainState`` around them: the old state shares them, so snapshot it
(``models.convert.to_reference``) before stepping if it is needed
after.

On a mesh (``train_step_fn(..., mesh=mesh)``, a ``DeviceMesh`` with axes
``"data"`` and ``"model"``, and ``"pod"`` where given) every rank of the
mesh calls the step with its data shard of the global batch
(``data_shard``).  A rank holds the whole model, or after
``shard_state_`` its block of every parameter, both moments and the
error feedback by ``state_specs`` (the training layout rule,
``held_shapes``): over ``"data"`` wherever the spec names it (FSDP),
and over ``"model"`` on an MoE expert weight's experts (expert
parallelism; ``own_experts_`` cuts those alone) and on the attention
heads, the MLP's ``d_ff``, the vocabulary, the SSM's ``d_model``
(``w_in``'s rows, ``w_out``'s columns) and the RG-LRU's ``d_rnn``
(tensor parallelism).  The forward gathers each ``"data"`` block's weights where they
are used and the backward reduce-scatters their gradients over
``"data"``; the tensor-parallel blocks run the Megatron pattern
(``models.transformer``).  The loss is each rank's summed NLL over the
global mask sum, vocab-parallel where the rank holds a block of the
vocabulary (``_MaskedNLL``); the gradients are reduced by
``grad_reduction`` (one rule, by dotted name and the blocks held);
compression, the global-norm clip and AdamW then run as on one process,
on the rank's blocks, so ranks on the same ``"data"`` coordinate hold
the same bits of the leaves they hold alike (and every rank the same
bits of a leaf it holds whole).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models import transformer as tf
from repro_torch.models import convert
from repro_torch.models.common import (DATA_AXES, P, ModelConfig, block_of,
                                       mesh_coord, mesh_sizes,
                                       replace_param_, spec_entry)
from repro_torch.models.convert import expert_weight, ref_path
from . import optimizer as opt


@dataclasses.dataclass
class TrainState:
    params: Any          # the Transformer
    opt_state: Any       # {"m": {name: t}, "v": {name: t}, "step": int32}
    err_fb: Any          # error-feedback residuals (None unless compression)


def make_train_state(gen: torch.Generator, cfg: ModelConfig, lr=3e-4,
                     adam: opt.AdamWConfig | None = None) -> TrainState:
    """The model initialised from ``gen`` on ``gen``'s device, zero
    moments and, under compression, zero error feedback."""
    model = tf.init_params(gen, cfg)
    params = dict(model.named_parameters())
    adam = adam or opt.AdamWConfig(lr=lr)
    err = (opt.init_error_feedback(params)
           if adam.grad_compress != "none" else None)
    return TrainState(model, opt.init_opt_state(params), err)


def _axes(mesh, names):
    """``[(name, group)]`` of ``mesh``'s axes among ``names`` with more
    than one rank, in the mesh's order."""
    if mesh is None:
        return []
    dims = tuple(mesh.mesh_dim_names)
    return [(a, mesh.get_group(a)) for a in dims
            if a in names and mesh.shape[dims.index(a)] > 1]


def _sum_(t, groups):
    """``t`` summed in place over each group in turn; returns ``t``."""
    for _, g in groups:
        dist.all_reduce(t, group=g)
    return t


def data_shard(batch, mesh):
    """This rank's data shard of the global ``batch`` (a dict of tensors,
    batch first): the batch split over the mesh's data axes in rank
    order, the major axis first, as ``P(DATA_AXES, None)`` lays it."""
    idx, count = mesh_coord(mesh, DATA_AXES)

    def take(t):
        if t.shape[0] % count:
            raise ValueError(f"a batch of {t.shape[0]} does not split over "
                             f"the mesh's {count} data shards")
        b = t.shape[0] // count
        return t[idx * b:(idx + 1) * b]
    return {k: take(v) for k, v in batch.items()}


# elements of the logits one chunk of ``_MaskedNLL`` works on at a time
_NLL_CHUNK = 1 << 26


def _labels(labels, v, group):
    """``(labels as (N, 1) indices into the rank's block of v words,
    (N, 1) whether the label is in it)``: every label and all True
    without ``group``."""
    lab = labels.reshape(-1, 1).long()
    if group is None:
        return lab, torch.ones_like(lab, dtype=torch.bool)
    lab = lab - dist.get_rank(group) * v
    own = (lab >= 0) & (lab < v)
    return torch.where(own, lab, 0), own


class _MaskedNLL(torch.autograd.Function):
    """``sum(mask * (logsumexp(logits) - logits[label]))`` over the
    positions, float32.  Its backward writes ``(softmax(logits) -
    onehot(label)) * mask * g`` into one buffer, a chunk of rows at a
    time, so that the logits' gradient costs one copy of the logits (the
    autograd of ``logsumexp`` and ``gather`` holds about three at once:
    at 4 x 2048 tokens and a 151936-word vocabulary, 4.98 GB each).

    With ``group`` (the ``"model"`` axis; tensor parallelism) the logits
    are the rank's block of the vocabulary, and the whole logits are
    never built: each row's max is all-reduced (max) over the axis, then
    its exp sum and gold logit (sum; the gold from the one rank holding
    the label), so every rank of the axis computes the same loss, and the
    backward writes the rank's block of the gradient."""

    @staticmethod
    def forward(ctx, logits, labels, mask, group=None):
        v = logits.shape[-1]
        x = logits.reshape(-1, v)
        lab, own = _labels(labels, v, group)
        rows = max(1, _NLL_CHUNK // v)
        chunks = range(0, x.shape[0], rows)
        if group is None:
            lse = torch.cat([torch.logsumexp(x[i:i + rows], dim=-1)
                             for i in chunks])
            gold = x.gather(-1, lab)[:, 0]
        else:
            top = torch.cat([x[i:i + rows].amax(dim=-1) for i in chunks])
            tf._timed("model", "all_reduce", top, dist.all_reduce, top,
                      op=dist.ReduceOp.MAX, group=group)
            sums = torch.stack([
                torch.cat([torch.exp(x[i:i + rows] - top[i:i + rows, None])
                           .sum(dim=-1) for i in chunks]),
                torch.where(own, x.gather(-1, lab), 0.0)[:, 0]])
            tf._timed("model", "all_reduce", sums, dist.all_reduce, sums,
                      group=group)
            lse, gold = top + torch.log(sums[0]), sums[1]
        ctx.group = group
        ctx.save_for_backward(logits, labels, mask, lse)
        return ((lse - gold) * mask.reshape(-1)).sum()

    @staticmethod
    def backward(ctx, g):
        logits, labels, mask, lse = ctx.saved_tensors
        v = logits.shape[-1]
        x = logits.reshape(-1, v)
        lab, own = _labels(labels, v, ctx.group)
        scale = (mask.reshape(-1) * g).to(logits.dtype)
        grad = torch.empty_like(x)
        rows = max(1, _NLL_CHUNK // v)
        for i in range(0, x.shape[0], rows):
            gi = grad[i:i + rows]
            torch.exp(x[i:i + rows] - lse[i:i + rows, None], out=gi)
            gi.scatter_add_(-1, lab[i:i + rows],
                            -own[i:i + rows].to(gi.dtype))
            gi.mul_(scale[i:i + rows, None])
        return grad.view_as(logits), None, None, None


def loss_fn(model, cfg: ModelConfig, batch, comm=None, mesh=None):
    """Masked mean next-token NLL and the forward's aux.  On a mesh,
    ``batch`` is the rank's data shard and the loss its summed NLL over
    the mask summed over the data axes (not the mean of the shards'
    means, which differ where the shards' masks do); where the rank holds
    a block of the vocabulary, the NLL is vocab-parallel
    (``_MaskedNLL``)."""
    logits, aux, vocab = tf.forward_local(model, batch["inputs"],
                                          batch.get("frontend"), comm, mesh)
    labels = batch["labels"]
    mask = batch["mask"]
    if logits.shape[1] != labels.shape[1]:       # vlm prefix tokens
        logits = logits[:, -labels.shape[1]:]
    count = _sum_(mask.sum().detach(), _axes(mesh, DATA_AXES))
    loss = _MaskedNLL.apply(logits, labels, mask, vocab) / torch.clamp_min(
        count, 1.0)
    return loss, aux


def model_blocks(model, mesh) -> set:
    """The names of ``model``'s parameters of which this rank holds a
    block over ``"model"`` on ``mesh`` (its own experts, its
    tensor-parallel blocks): the leaves that differ between the ranks of
    the axis (``models.transformer.held_axes``)."""
    return {n for n, axes in tf.held_axes(model, mesh).items()
            if "model" in axes}


def grad_reduction(name, cfg: ModelConfig, held: dict, ring: bool) -> str:
    """How a mesh step reduces parameter ``name``'s gradient over the
    ``"model"`` axis (over the data axes it is always summed, by the
    backward's reduce-scatter where the rank holds a ``"data"`` block of
    it), given the blocks the rank holds (``held``,
    ``models.transformer.held_axes``): ``"sum"``, ``"first"`` (the axis's
    first rank's gradient, broadcast) or ``"own"`` (a block of the leaf,
    each rank's its own).

    Every rank of the model axis holds the same data shard and computes
    the same loss.  A block over ``"model"`` -- the rank's own ``E / n``
    experts, which see every token routed to them on this rank, and a
    tensor-parallel block, whose gradient is its heads', columns' or
    words' whole (the ring's gathered blocks' reduce-scattered) -- is
    ``"own"``.  A gradient is summed over the axis where the parameter is
    whole and each rank uses it for its own share: the router and the
    experts where the rank holds all ``E`` (used inside the
    sequence-sharded region, the rows of other ranks' experts zero here);
    a whole leaf of a module that holds blocks over ``"model"`` (the
    router beside the own experts; in a tensor-parallel attention the kv
    heads that do not divide and the qk norms, each rank's query heads
    reading them; the RG-LRU's ``lam``, each rank reading its channels);
    the self-attention weights on the ring (``ring``,
    ``transformer.on_ring``).  The parameters used only in replicated
    compute (the norms outside those regions, the whole leaves of a
    tensor-parallel SSM, whose core runs replicated between its
    projections, and every weight of a model held whole but the above)
    have the whole gradient on every rank: the axis's first rank's is
    taken, so that the ranks stay bit-equal where a kernel's float
    atomics order a sum differently."""
    if "model" in held.get(name, {}):
        return "own"
    path = ref_path(name)[0]
    if cfg.moe is not None and path[-2:-1] == ("moe",):
        return "sum"
    # the modules below the model that hold a block over "model": a
    # whole leaf inside one is read by every rank's share of its region
    regions = {n.rpartition(".")[0] for n, axes in held.items()
               if "model" in axes} - {""}
    if any(name.startswith(r + ".") for r in regions) and "ssm" not in path:
        return "sum"
    if ring and path[0] != "enc" and "attn" in path:
        return "sum"
    return "first"


# elements a flat buffer of one collective holds at most
_BUCKET = 1 << 25


def _bucketed_(tensors, fn):
    """``fn(flat)`` on the tensors in buckets of at most ``_BUCKET``
    elements of one dtype (a tensor alone in its bucket in place),
    writing each bucket's result back."""
    buckets, cur, size = [], [], 0
    for t in tensors:
        if cur and (size + t.numel() > _BUCKET or t.dtype != cur[0].dtype):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += t.numel()
    if cur:
        buckets.append(cur)
    for bucket in buckets:
        if len(bucket) == 1 and bucket[0].is_contiguous():
            fn(bucket[0])
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        fn(flat)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def reduce_grads_(grads, model, mesh, ring: bool):
    """Reduces ``grads`` ({name: tensor} of ``model``'s parameters) in
    place on ``mesh`` as ``grad_reduction`` says: a sum over the data
    axes (over ``"pod"`` only for a ``"data"`` block, whose
    reduce-scatter summed it over ``"data"``), then over ``"model"`` a
    sum, the first rank's, or nothing for a block over the axis."""
    cfg, held = model.cfg, tf.held_axes(model, mesh)
    sharded = {n for n, axes in held.items() if "data" in axes}
    data, pod = _axes(mesh, DATA_AXES), _axes(mesh, ("pod",))
    _bucketed_([g for n, g in grads.items() if n not in sharded],
               lambda t: _sum_(t, data))
    _bucketed_([g for n, g in grads.items() if n in sharded],
               lambda t: _sum_(t, pod))
    model = _axes(mesh, ("model",))
    if not model:
        return
    group = model[0][1]
    how = {n: grad_reduction(n, cfg, held, ring) for n in grads}
    _bucketed_([g for n, g in grads.items() if how[n] == "sum"],
               lambda t: dist.all_reduce(t, group=group))
    src = dist.get_global_rank(group, 0)
    _bucketed_([g for n, g in grads.items() if how[n] == "first"],
               lambda t: dist.broadcast(t, src, group=group))


def _seq_len(cfg: ModelConfig, batch) -> int:
    """The decoder's sequence length (the vlm's frontend prefix
    included)."""
    s = batch["inputs"].shape[1]
    if "frontend" in batch and cfg.family != "encdec":
        s += batch["frontend"].shape[1]
    return s


# the layout rules: which of ``param_specs``' entries a rank holds as
# blocks.  "train": every entry, the reference's layout: FSDP over
# "data", over "model" the MoE experts (expert parallelism) and the
# attention heads, the MLP's d_ff, the vocabulary, the SSM's d_model and
# the RG-LRU's d_rnn (tensor parallelism); the layout a rank trains and
# serves from.  "fsdp": every "data" entry and the experts' "model"
# entry, no tensor parallelism.  "experts": the experts' "model" entry
# alone
LAYOUTS = ("train", "fsdp", "experts")


def _held_over(name, axis, layout) -> bool:
    """Whether the rule ``layout`` holds ``name``'s ``param_specs``
    entries over ``axis`` as blocks."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: not one of {LAYOUTS}")
    if axis == "data":
        return layout != "experts"
    if axis != "model":
        return False
    return layout == "train" or expert_weight(name)


def held_shapes(cfg: ModelConfig, mesh_shape: dict,
                layout: str = "train") -> dict:
    """``{dotted name: shape}`` of the rank's block of each parameter on a
    mesh of axis sizes ``mesh_shape``, by the layout rule ``layout``
    (``LAYOUTS``): each dimension split over the axes its
    ``param_specs`` entry names and the rule holds blocks over; a
    dimension they do not divide stays whole (``param_specs``' ``dd``).
    ``"pod"`` splits no parameter."""
    specs = tf.param_specs(cfg, mesh_shape)
    out = {}
    for name, shape in convert.logical_shapes(cfg).items():
        spec = convert.local_spec(specs, name)
        block = []
        for k, d in enumerate(shape):
            count = math.prod(
                mesh_shape.get(a, 1) for a in spec_entry(spec, k)
                if _held_over(name, a, layout))
            block.append(d // count if d % count == 0 else d)
        out[name] = tuple(block)
    return out


def _cut_(model, trees, mesh, layout):
    """Cuts ``model``'s parameters and the same-named leaves of ``trees``
    (dicts keyed by dotted name) to the rank's blocks by ``held_shapes``
    under ``layout``, in place (a leaf already cut is left as it is)."""
    cfg = model.cfg
    ms = mesh_sizes(mesh)
    specs = tf.param_specs(cfg, ms)
    want = held_shapes(cfg, ms, layout)
    for name, p in list(model.named_parameters()):
        shape = tuple(min(a, b) for a, b in zip(want[name], p.shape))
        if shape == tuple(p.shape):
            continue
        spec = convert.local_spec(specs, name)

        def cut(t):
            return block_of(t.detach(), shape, spec, mesh).clone(
                memory_format=torch.contiguous_format)
        replace_param_(model, name, cut(p))
        for tree in trees:
            tree[name] = cut(tree[name])


def shard_params_(model, mesh, layout="train"):
    """The cut of ``shard_state_`` (by the rule ``layout``, ``LAYOUTS``:
    ``"train"``, ``"fsdp"``, or ``"experts"`` for ``own_experts_``) of
    the parameters alone, with no ``TrainState`` and no moments: a model
    to serve from its blocks (``models.transformer.prefill`` and
    ``decode_step`` on ``mesh``: by ``"train"`` tensor-parallel, by
    ``"fsdp"`` with the dense weights whole over ``"model"``), a model
    whose optimizer state is made after the cut, or a restore target on
    the ``meta`` device.  Returns ``model``."""
    _cut_(model, [], mesh, layout)
    return model


def shard_state_(state: TrainState, mesh, layout="train") -> TrainState:
    """Makes each rank of ``mesh`` hold only its block of the state by the
    layout rule ``layout`` (``held_shapes``; by ``"train"``, as the
    reference lays its state out by ``state_specs``; ``"fsdp"`` keeps
    every tensor-parallel entry whole): the parameters, both moments and the
    error feedback, in place.  A mesh step gathers the ``"data"`` blocks
    where they are used and runs the ``"model"`` blocks tensor- and
    expert-parallel.  Returns ``state``."""
    return _cut_state_(state, mesh, layout)


def own_experts_(state: TrainState, mesh) -> TrainState:
    """``shard_state_`` over ``"model"`` alone: each rank of ``mesh`` holds
    only its own ``E / n`` experts' rows of the expert weights, every
    other leaf whole.  Returns ``state``."""
    return _cut_state_(state, mesh, "experts")


def _cut_state_(state, mesh, layout):
    trees = [state.opt_state["m"], state.opt_state["v"]]
    _cut_(state.params, trees + ([state.err_fb] if state.err_fb else []),
          mesh, layout)
    return state


def held_like(cfg: ModelConfig, mesh, compress: bool = False,
              layout: str = "train"):
    """``convert.reference_like`` (with the error feedback where
    ``compress``) of the state a rank of ``mesh`` holds after
    ``shard_state_`` by ``layout``: a ``checkpoint.restore`` target for
    the rank's blocks, restored with ``specs=held_specs(...)``."""
    with torch.device("meta"):
        model = shard_params_(tf.Transformer(cfg), mesh, layout)
    return convert.reference_like(model, compress)


def held_specs(cfg: ModelConfig, mesh_shape: dict):
    """``state_specs`` with the error feedback laid out as the parameters,
    as the port holds it after ``shard_state_`` (the reference keeps it
    whole: its spec None): the ``specs`` of a ``checkpoint.restore`` of
    the rank's blocks."""
    return dataclasses.replace(state_specs(cfg, mesh_shape),
                               err_fb=tf.param_specs(cfg, mesh_shape))


def held_params_like(cfg: ModelConfig, mesh, layout: str = "train"):
    """The parameters a rank serves from (``shard_params_`` by
    ``layout``), as ``convert.reference_like`` gives them: a
    ``checkpoint.restore`` target for those blocks, with
    ``specs=models.transformer.param_specs(cfg, mesh_shape)`` (the
    parameters' entry of ``held_specs``), restored from a checkpoint of a
    training state (the trainer's, or one saved whole) or of the
    parameters alone."""
    with torch.device("meta"):
        model = shard_params_(tf.Transformer(cfg), mesh, layout)
    return convert.reference_like(model)[0]


def _mesh_norm_and_amax(model, grads, mesh):
    """The global norm of ``grads`` and the compression's ``amax_fn`` on
    ``mesh``: the leaves of which this rank holds a block enter through
    a sum (the norm) and a max (the amax) over the axes of their blocks
    (``models.transformer.held_axes``)."""
    # the axes of each block, "data" first
    over = {n: tuple(a for a in ("data", "model") if a in axes)
            for n, axes in tf.held_axes(model, mesh).items()}

    def norm(g):
        dev = next(iter(g.values())).device
        sq = lambda names: sum((g[n].float().square().sum() for n in names),
                               torch.zeros((), device=dev))
        total = sq([n for n in g if n not in over])
        # the same order on every rank: a float sum's bits depend on it
        for axes in sorted(set(over.values())):
            part = sq(sorted(n for n in over if over[n] == axes))
            for axis in axes:
                _sum_(part, _axes(mesh, (axis,)))
            total = total + part
        return torch.sqrt(total)

    paths = {ref_path(n)[0]: axes for n, axes in over.items()}

    def amax_fn(path, amax):
        for axis in paths.get(path, ()):
            for _, grp in _axes(mesh, (axis,)):
                dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=grp)
        return amax
    return norm, amax_fn


def train_step_fn(cfg: ModelConfig, adam: opt.AdamWConfig | None = None,
                  comm=None, mesh=None, on_grads=None):
    """``step(state, batch) -> (state, metrics)`` with metrics ``loss``,
    ``grad_norm``, ``lr`` and ``moe_drop`` (0-d tensors).  ``on_grads``,
    where given, is called with the step's gradients ({name: tensor}, on
    a mesh reduced) before compression and the update: a hook for checks.

    With ``mesh``, every rank of it calls ``step`` with its data shard
    (``data_shard``) and gets the global batch's loss; the ring attention
    (where ``cfg.attn_ring``) and the expert-parallel MoE run over
    ``"model"``, and the blocks the rank holds over ``"model"``
    tensor-parallel; metrics also hold ``grad_reduce_s``, the seconds of
    the gradient reduction after the backward (the device synchronised
    around it; ``models.transformer.fsdp_timing`` times the FSDP
    collectives over ``"data"``, ``tp_timing`` the tensor-parallel ones
    over ``"model"``)."""
    adam = adam or opt.AdamWConfig()

    def step(state: TrainState, batch):
        model = state.params
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, aux = loss_fn(model, cfg, batch, comm, mesh)
        loss.backward()
        with torch.no_grad():
            grads = {}
            for n, p in params.items():
                grads[n] = torch.zeros_like(p) if p.grad is None else p.grad
                p.grad = None
            extra, gnorm, amax_fn = {}, None, None
            if mesh is not None:
                loss = _sum_(loss.detach(), _axes(mesh, DATA_AXES))
                dev = loss.device
                sync = (torch.cuda.synchronize if dev.type == "cuda"
                        else lambda: None)
                sync()
                t0 = time.perf_counter()
                reduce_grads_(grads, model, mesh,
                              tf.on_ring(cfg, mesh, _seq_len(cfg, batch)))
                sync()
                extra["grad_reduce_s"] = torch.tensor(
                    time.perf_counter() - t0, dtype=torch.float64)
                norm, amax_fn = _mesh_norm_and_amax(model, grads, mesh)
            if on_grads is not None:
                on_grads(grads)
            grads, new_err = opt.apply_compression(adam, grads, state.err_fb,
                                                   amax_fn)
            if mesh is not None:
                gnorm = norm(grads)
            # the model's parameters and the moments are updated in place
            new_opt, om = opt.adamw_update_(
                adam, {n: p.detach() for n, p in params.items()}, grads,
                state.opt_state, gnorm)
        metrics = {"loss": loss.detach(), **om,
                   **{k: v.detach() for k, v in aux.items()}, **extra}
        return TrainState(model, new_opt, new_err), metrics

    return step


def state_specs(cfg: ModelConfig, mesh_shape: dict):
    """Partition-spec tree for the whole TrainState, as the reference's:
    the parameters' (``transformer.param_specs``) for the parameters and
    both moments, ``P()`` for the step.  ``models.convert.local_spec``
    gives a moment's spec from its dotted name."""
    pspec = tf.param_specs(cfg, mesh_shape)
    return TrainState(params=pspec,
                      opt_state={"m": pspec, "v": pspec, "step": P()},
                      err_fb=None)
