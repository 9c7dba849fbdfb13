"""Checkpoint / restore of trees of tensors and arrays.

Counterpart of ``repro.ckpt.checkpoint``, with the same on-disk format,
so a checkpoint written by either package restores in the other:

    <dir>/step_<k>.tmp/...  ->  atomic rename  ->  <dir>/step_<k>/
        manifest.json        step, tree structure, per-leaf shape, dtype
                             and CRC32 content digest
        arr_<i>.npy          one file per leaf (the full logical array)

``keep_last`` checkpoints are retained; an interrupted write never
corrupts a valid step (tmp+rename), and a committed step whose arrays are
truncated or missing is skipped, so a restart falls back to the previous
valid step.  The digest, taken at save time over the leaf's C-contiguous
bytes and checked on restore after the ``ckpt.leaf.<i>`` taint hook that
models storage rot, turns a bit-flipped leaf into ``CheckpointError``
naming it.

A tree is a nest of dicts, lists and tuples whose leaves are torch
tensors or numpy arrays; ``None`` holds no leaf.  It flattens in the
reference's leaf order (dict keys sorted, lists and tuples in order), so
``arr_0`` of ``{"w": .., "b": ..}`` is ``b`` in both packages.  The
manifest's ``treedef`` string is this package's own: restore checks the
leaf count and each leaf's shape, as the reference does.  A tensor is
saved from its host copy; a restored leaf comes back on its like-leaf's
device and in its dtype (a numpy like-leaf as numpy).

A training state on a mesh is saved whole: ``models.convert.to_reference(
state, mesh)`` gathers the leaves a rank holds a block of (its
``"data"`` blocks, its own ``E / n`` experts' rows and its
tensor-parallel blocks over ``"model"``),
and ``save(..., mesh=mesh)`` writes each leaf's full logical array once,
from the mesh's lowest rank, every rank returning once it is committed.
``restore(..., mesh=mesh, specs=specs)`` is the counterpart of the
reference's ``shardings=``: a like-leaf shorter than the stored leaf on
a dimension gets the rank's block there, over the mesh axes its spec
(``train_step.state_specs``, ``convert.local_spec``'s tree) names, major
first (``models.common.block_of``); every other leaf comes back whole.
``train_step.held_like(cfg, mesh)`` is the like-tree of the layout the
port holds on a mesh, ``train_step.held_params_like(cfg, mesh)`` that
of the parameters alone, which a rank serves from: it restores the
parameters of a training state's checkpoint, saved by the mesh trainer
(its FSDP and tensor-parallel blocks) or whole.  A rank of
``DistributedPoissonSolver`` holds the global field, so a solver's
checkpoint restores onto any mesh as it is.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib

import numpy as np
import torch

from repro_torch.models.common import P, block_of
from repro_torch.runtime import faults as _faults

__all__ = ["CheckpointError", "save", "all_steps", "latest_step",
           "step_valid", "restore"]


class CheckpointError(RuntimeError):
    """A checkpoint failed validation on restore (manifest/array mismatch,
    truncated or missing leaf, content digest mismatch).  Deliberately NOT
    an AssertionError: the restart path catches it and falls back to the
    previous valid step."""

    def __init__(self, msg: str, *, path=None, leaf=None):
        super().__init__(msg)
        self.path = path
        self.leaf = leaf
        self.transient = False


def _flatten(tree):
    """``(leaves, treedef)``: the leaves in the reference's order and a
    description of the nest."""
    leaves = []

    def walk(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(v) for v in t)
            if isinstance(t, list):
                return f"[{inner}]"
            return f"({inner}{',' if len(t) == 1 else ''})"
        leaves.append(t)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves):
    """``like``'s nest with its leaves taken in order from ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _host(leaf) -> np.ndarray:
    """The leaf's values as a host numpy array."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().resolve_conj().resolve_neg().numpy()
    return np.asarray(leaf)


def _digest(arr) -> str:
    """Content digest of one leaf (CRC32 over the raw bytes of a
    C-contiguous view; cheap relative to the npy write itself)."""
    a = np.ascontiguousarray(arr)
    return f"{zlib.crc32(a.tobytes()) & 0xffffffff:08x}"


def _mesh_barrier(mesh):
    """A barrier over every rank of ``mesh``: one over each axis in turn
    (a rank leaves the last only after every rank has entered the
    first)."""
    import torch.distributed as dist
    for name in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(name))


def save(directory, step, tree, keep_last=3, mesh=None):
    """Writes ``tree`` as ``<directory>/step_<step>`` and returns that
    path.  With ``mesh`` every rank of it calls ``save`` with the whole
    tree; the mesh's lowest rank writes it, and every rank returns once
    the step is committed."""
    final = os.path.join(directory, f"step_{step}")
    if mesh is not None:
        import torch.distributed as dist
        if dist.get_rank() == int(mesh.mesh.min()):
            save(directory, step, tree, keep_last)
        _mesh_barrier(mesh)
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step}.tmp")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = _flatten(tree)
    manifest = {"step": int(step), "treedef": treedef,
                "n_leaves": len(leaves), "leaves": []}
    for i, leaf in enumerate(leaves):
        # torn-write injection point: a ``torn_write`` spec firing here
        # kills the write mid-leaf, leaving a partial step_<k>.tmp that the
        # tmp+rename protocol keeps invisible to all_steps/restore
        _faults.fail_point(f"ckpt.leaf.{i}")
        arr = _host(leaf)
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": str(arr.dtype),
             "crc32": _digest(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic commit
    _gc(directory, keep_last)
    return final


def _gc(directory, keep_last):
    steps = sorted(_listed_steps(directory))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"))


def _listed_steps(directory):
    """Step numbers with a committed dir + manifest (no array validation --
    gc must see damaged steps too, or it would never reclaim them)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name,
                                            "manifest.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def _validate_step(path):
    """Full integrity check of one committed step dir against its manifest:
    every leaf present, loadable, and matching the recorded shape/dtype.
    ``np.load(mmap_mode="r")`` validates the npy header AND that the file
    holds all its bytes (truncation raises) without reading the data."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        entries = manifest["leaves"]
        if manifest["n_leaves"] != len(entries):
            raise CheckpointError(
                f"manifest inconsistent: n_leaves={manifest['n_leaves']} "
                f"but {len(entries)} leaf entries", path=path)
        for i, ent in enumerate(entries):
            arr = np.load(os.path.join(path, f"arr_{i}.npy"), mmap_mode="r")
            if tuple(arr.shape) != tuple(ent["shape"]) or \
                    str(arr.dtype) != ent["dtype"]:
                raise CheckpointError(
                    f"leaf {i} is {arr.shape}/{arr.dtype} on disk but the "
                    f"manifest records {tuple(ent['shape'])}/{ent['dtype']}",
                    path=path, leaf=i)
        return manifest
    except CheckpointError:
        raise
    except Exception as e:   # missing/truncated file, unreadable manifest
        raise CheckpointError(
            f"checkpoint at {path} is damaged: {e}", path=path) from e


def step_valid(directory, step) -> bool:
    try:
        _validate_step(os.path.join(directory, f"step_{step}"))
        return True
    except CheckpointError:
        return False


def all_steps(directory):
    """Steps that would actually restore: committed AND integrity-valid.
    A step whose arrays are truncated or missing (torn write past the
    rename, disk rot) is skipped, so restart falls back to the previous
    valid step."""
    return [s for s in _listed_steps(directory) if step_valid(directory, s)]


def latest_step(directory):
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _leaf_specs(like, specs):
    """The spec of each of ``like``'s leaves, in its leaf order, from the
    same-shaped tree ``specs`` (a ``train_step.TrainState`` of specs
    counts as the tuple of its fields); None where ``specs`` has no
    entry (a leaf held whole)."""
    if dataclasses.is_dataclass(specs):
        specs = tuple(getattr(specs, f.name)
                      for f in dataclasses.fields(specs))
    out = []

    def walk(t, s):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], s.get(k) if isinstance(s, dict) else None)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, s[i] if isinstance(s, (list, tuple))
                     and not _is_spec(s) else None)
        else:
            out.append(s if _is_spec(s) else None)

    walk(like, specs)
    return out


def _is_spec(s) -> bool:
    return isinstance(s, P)


def _block(arr, shape, spec, mesh, i):
    """The rank's block of ``arr`` for a like-leaf of ``shape``
    (``models.common.block_of``)."""
    try:
        return block_of(arr, shape, spec, mesh)
    except ValueError as e:
        raise CheckpointError(f"leaf {i}: checkpoint {e}", leaf=i) from e


def _params_first(stored: str, like: str) -> bool:
    """Whether a checkpoint's tree (its manifest's ``treedef``) begins
    with the tree ``like`` describes (a dict: a model's parameters), as
    a training state does in either package's layout (its first field is
    the parameters), so that ``like``'s leaves are its first leaves."""
    inner = like[len("PyTreeDef("):-1]
    at = stored.find("{")
    return inner.startswith("{") and at >= 0 and stored.startswith(inner, at)


def restore(directory, step, like_tree, mesh=None, specs=None):
    """Restore into the structure of ``like_tree``: each leaf on its
    like-leaf's device and in its dtype (a numpy like-leaf as numpy).
    With ``mesh`` and ``specs`` a like-leaf may be a block of the stored
    leaf: the rank gets its block (``_block``).  A ``like_tree`` of a
    model's parameters alone (``train_step.held_params_like`` to serve
    from blocks) also restores from a checkpoint of a training state,
    whose parameters it takes (``_params_first``).

    The manifest is validated against both the on-disk arrays and
    ``like_tree`` (leaf count, per-leaf shape) before anything is loaded;
    mismatches raise :class:`CheckpointError` with the offending leaf, as
    does a leaf whose bytes no longer match their digest."""
    path = os.path.join(directory, f"step_{step}")
    manifest = _validate_step(path)
    leaves, treedef = _flatten(like_tree)
    spec_of = (_leaf_specs(like_tree, specs) if mesh is not None
               else [None] * len(leaves))
    if manifest["n_leaves"] != len(leaves) and not (
            manifest["n_leaves"] > len(leaves)
            and _params_first(manifest["treedef"], treedef)):
        raise CheckpointError(
            f"tree structure changed: checkpoint has "
            f"{manifest['n_leaves']} leaves, restore target has "
            f"{len(leaves)}", path=path)
    for i, (leaf, ent) in enumerate(zip(leaves, manifest["leaves"])):
        if tuple(ent["shape"]) != tuple(leaf.shape) and (
                spec_of[i] is None or len(ent["shape"]) != leaf.ndim):
            raise CheckpointError(
                f"leaf {i}: checkpoint shape {tuple(ent['shape'])} != "
                f"restore target shape {tuple(leaf.shape)}",
                path=path, leaf=i)
    out = []
    for i, (leaf, ent) in enumerate(zip(leaves, manifest["leaves"])):
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        # storage-rot injection point (host-side); the digest check below
        # is what must catch it
        arr = _faults.taint_host(f"ckpt.leaf.{i}", arr)
        want = ent.get("crc32")
        if want is not None and _digest(arr) != want:
            raise CheckpointError(
                f"leaf {i} content digest mismatch (got {_digest(arr)}, "
                f"manifest records {want}): checkpoint bytes rotted "
                f"between save and restore", path=path, leaf=i)
        if tuple(arr.shape) != tuple(leaf.shape):
            arr = _block(arr, leaf.shape, spec_of[i], mesh, i)
        if torch.is_tensor(leaf):
            out.append(torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype))
        else:
            out.append(np.asarray(arr, dtype=leaf.dtype))
    return _unflatten(like_tree, out)
