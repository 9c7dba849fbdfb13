"""Topology-switch communication strategies on ``torch.distributed``.

Counterpart of ``repro.core.comm``.  A topology switch moves the pencil
from one active direction to the next: the local block splits its
(previously full) active axis across the ranks of ONE mesh axis and
gathers the next axis.  Each mesh axis of a
``torch.distributed.device_mesh.DeviceMesh`` is one process group
(``mesh.get_group(name)``), the paper's sub-communicator, and every switch
is one ``all_to_all_single`` on it (per chunk for the chunked strategies).

The exchange keeps the reference's tiled semantics
(``lax.all_to_all(..., tiled=True)``): chunk k of the split axis goes to
the axis's rank k, and the chunk received from rank k lands at block k of
the concat axis.  ``all_to_all_single`` only splits and concatenates dim
0, so the pack moves the split axis's P rank blocks to the front of a
contiguous send buffer, and the unpack merges the received blocks into
the concat axis (``_a2a``).

The four strategies are numerically identical and differ in the copies
and the overlap they make:

* ``a2a``       -- packs into a dedicated contiguous send buffer (the
                   split axis's rank blocks leading), one collective, and
                   unpacks the received blocks into a contiguous output
                   in the incoming axis order (flups' a2a buffers; on one
                   rank, or with a major concat axis, the receive buffer
                   already is that output).
* ``pipelined`` -- the paper's ``nb``: the block is cut into ``n_chunks``
                   along an uninvolved axis; every chunk's collective is
                   issued (``async_op=True``), then all are waited on, and
                   one concatenation unpacks them.
* ``fused``     -- the paper's ``isr``: the pack only, laid out
                   ``(P, concat, split / P, rest...)`` so the received
                   blocks merge into the concat axis as a VIEW; the
                   switched block is a transposed view of the receive
                   buffer and the next transform's ``.contiguous()``
                   takes the unpack, with any crop of the gathered axis
                   (the MPI_Datatype role).
* ``overlap``   -- software-pipelined switch+transform stage: chunk k+1's
                   collective is issued before ``post(chunk k)`` runs, and
                   its handle is waited on before the chunk is used.  On
                   NCCL the collective runs on NCCL's stream and ``wait()``
                   orders the current stream after it, so the kernels of
                   chunk k overlap chunk k+1's wire time.

``autotune_comm`` times candidate (strategy, n_chunks, fold) triples and
caches the winner in memory and in the reference's schema-2 JSON file
(``$REPRO_COMM_CACHE``).  Ranks decide alone in torch, and ranks that
disagree issue mismatched collectives and hang, so with ``agree`` (a
max-reduction over the mesh) every candidate's time and failure flag is
reduced across ranks before the choice, and the budget is applied after
each timed candidate by the same agreement: a collective in flight is
never abandoned.  Only the rank told to ``persist`` writes the JSON file.

Not ported here: the ABFT checksum sidecar (``abft=``, ROADMAP queue 1
item 6), which raises ``NotImplementedError``.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.runtime import faults as _faults

STRATEGIES = ("a2a", "pipelined", "fused", "overlap")

__all__ = [
    "STRATEGIES", "FOLDS", "CHUNK_AXES", "CACHE_SCHEMA",
    "CommConfig", "CommStrategy", "as_comm",
    "make_strategy", "cfg_label", "label_to_cfg",
    "topology_switch", "pad_axis", "crop_axis",
    "autotune_comm", "autotune_candidates",
    "cache_load_entries", "cache_store_entry",
    "clear_autotune_cache", "all_reduce_mean", "reset_warn_once",
]


FOLDS = ("pack", "unpack")
# chunk-axis policy of the chunked strategies: "auto" honors the caller's
# preferred free axis (the in-block multi-RHS batch) when it divides
# n_chunks, "grid" always cuts the uninvolved grid axis
CHUNK_AXES = ("auto", "grid")


@dataclass(frozen=True)
class CommConfig:
    strategy: str = "a2a"
    n_chunks: int = 2          # pipelined/overlap granularity (paper n_batch)
    # which side of the collective the layout-scheduled relayout is folded
    # into: "pack" permutes BEFORE the all-to-all, "unpack" permutes each
    # switched block AFTER it
    fold: str = "pack"
    chunk_axis: str = "auto"   # see CHUNK_AXES

    def __post_init__(self):
        assert self.strategy in STRATEGIES, self.strategy
        assert self.n_chunks >= 1, self.n_chunks
        assert self.fold in FOLDS, self.fold
        assert self.chunk_axis in CHUNK_AXES, self.chunk_axis


def cfg_label(cfg: CommConfig) -> str:
    """Canonical candidate label: ``strategy:n_chunks`` plus non-default
    knobs (``:unpack``, ``:ca=grid``); cache-key material."""
    lbl = f"{cfg.strategy}:{cfg.n_chunks}"
    if cfg.fold != "pack":
        lbl += f":{cfg.fold}"
    if cfg.chunk_axis != "auto":
        lbl += f":ca={cfg.chunk_axis}"
    return lbl


def label_to_cfg(label: str) -> CommConfig:
    parts = label.split(":")
    fold, ca = "pack", "auto"
    for p in parts[2:]:
        if p.startswith("ca="):
            ca = p[3:]
        elif p in FOLDS:
            fold = p
    return CommConfig(parts[0], int(parts[1]), fold, ca)


def as_comm(comm) -> CommConfig:
    """Accept ``CommConfig`` / strategy name / None (``"auto"`` is resolved
    by the solver via ``autotune_comm`` before this point)."""
    if comm is None:
        return CommConfig()
    if isinstance(comm, CommConfig):
        return comm
    return CommConfig(strategy=str(comm))


# ---------------------------------------------------------------------------
# chunking helpers
# ---------------------------------------------------------------------------

def _uninvolved_axis(ndim: int, split_axis: int, concat_axis: int) -> int:
    for ax in range(ndim - 1, -1, -1):
        if ax not in (split_axis, concat_axis):
            return ax
    raise ValueError("need >= 3 axes for a chunked strategy")


_WARNED: set = set()


def _warn_once(msg: str):
    if msg not in _WARNED:
        _WARNED.add(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=4)


def reset_warn_once():
    """Re-arm every one-shot diagnostic of this module; wired into
    ``solver.clear_solver_cache`` and the test fixtures."""
    _WARNED.clear()


def _split_chunks(x, ax: int, n: int):
    """Cut ``x`` into ``n`` equal chunks (views) along ``ax``, zero-padding
    the axis to the next multiple when it does not divide (warned once
    per shape)."""
    ln = x.shape[ax]
    if ln % n:
        target = -(-ln // n) * n
        _warn_once(
            f"comm: chunk axis {ax} (length {ln}) does not divide into "
            f"{n} chunks; zero-padding to {target} (cropped after the "
            f"switch)")
        x = pad_axis(x, ax, target)
    return list(torch.split(x, x.shape[ax] // n, dim=ax)), ln


def pad_axis(x, ax: int, target: int):
    """Zero-pad ``ax`` up to ``target`` (no-op when already there)."""
    if x.shape[ax] == target:
        return x
    shape = list(x.shape)
    shape[ax] = target
    out = x.new_zeros(shape)
    out.narrow(ax, 0, x.shape[ax]).copy_(x)
    return out


def crop_axis(x, ax: int, ln: int):
    """Slice ``ax`` down to ``ln`` (a view; no-op when already there)."""
    if x.shape[ax] == ln:
        return x
    return x.narrow(ax, 0, ln)


def _a2a(x, group, p: int, split_axis: int, concat_axis: int,
         async_op: bool = False, view: bool = False):
    """Tiled all-to-all of ``x`` over ``group`` (``p`` ranks, group rank
    == mesh coordinate): returns ``(y, work)``, ``y`` valid once ``work``
    (None when synchronous) is waited on.  The pack is one copy.

    By default the send buffer is ``x`` with the split axis cut into
    ``(p, split / p)`` and ``p`` moved first, the other axes in order;
    ``y`` is the receive buffer with its leading ``p`` moved in front of
    the concat axis: the BLOCKED switched block, which
    ``y.flatten(c, c + 1)`` merges (a view when ``p == 1`` or the concat
    axis is major, one blocked copy otherwise).  With ``view`` the send
    buffer is ``(p, concat, split / p, rest...)`` and ``y`` is the merged
    switched block itself, a transposed view of the receive buffer that
    the consumer's ``.contiguous()`` materializes."""
    nd = x.ndim
    s, c = split_axis % nd, concat_axis % nd
    q = x.shape[s] // p
    if q * p != x.shape[s]:
        raise ValueError(f"split axis {s} of length {x.shape[s]} does not "
                         f"divide over {p} ranks")
    xs = x.unflatten(s, (p, q))        # p at s, q at s + 1
    if view:
        cc = c if c < s else c + 1
        rest = [a for a in range(nd + 1) if a not in (s, s + 1, cc)]
        send = xs.permute([s, cc, s + 1] + rest).contiguous()
    else:
        send = xs.movedim(s, 0).contiguous()
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group,
                                  async_op=async_op)
    if not view:
        return recv.movedim(0, c), work
    # (p, C, q, rest) -> (p * C, q, rest): the received blocks stacked
    # along the concat axis, then back to the incoming axis order
    merged = recv.flatten(0, 1)
    order = [c, s] + [a for a in range(nd) if a not in (s, c)]
    return merged.permute([order.index(a) for a in range(nd)]), work


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

class CommStrategy:
    """One topology-switch execution policy.

    ``stage(x, axis_name, split_axis, concat_axis, post=...)`` performs the
    switch and then applies ``post`` -- the crop + next direction's 1-D
    transform continuation handed down by the solver.  Monolithic
    strategies run ``post`` on the whole switched block; ``overlap``
    interleaves it chunk-wise with the collectives.  ``switch`` is the
    plain transpose (``post=None``).

    ``groups`` maps each mesh axis name to its process group (the
    solver passes ``mesh.get_group(name)`` for every axis); the rank
    order inside a group must be the mesh coordinate along that axis.
    ``axis_sizes`` ({axis name: size}) enables the ``valid_extent`` re-pad.

    ``chunk_axis`` (stage/switch keyword) is a PREFERRED chunk axis for the
    chunked strategies -- the batched multi-RHS solve passes its leading
    batch axis here; it is honored when ``n_chunks`` divides it, otherwise
    the uninvolved grid axis is cut.

    ``valid_extent`` is the number of LIVE entries along ``split_axis``:
    the strategy crops the split axis down to it and re-pads to the
    equal-split multiple of the axis size.  ``None`` ships the axis as-is.

    ``permute`` is an axis permutation over the FULL rank applied as part
    of the switch: before the collective under ``fold="pack"`` (it then
    composes with the pack into one copy), to each switched block under
    ``fold="unpack"``.  ``split_axis``/``concat_axis``/``chunk_axis`` are
    in the PERMUTED frame.
    """

    name: str = "?"

    def __init__(self, n_chunks: int = 1, axis_sizes=None,
                 fold: str = "pack", abft=None, groups=None):
        if abft is not None:
            raise NotImplementedError(
                "the ABFT checksum sidecar needs runtime/abft.py, not "
                "ported yet (ROADMAP queue 1 item 6)")
        self.n_chunks = max(int(n_chunks), 1)
        self.axis_sizes = dict(axis_sizes or {})
        assert fold in FOLDS, fold
        self.fold = fold
        self.abft = None
        self.groups = dict(groups or {})

    def _collective(self, x, axis_name, split_axis, concat_axis,
                    async_op: bool = False, view: bool = False):
        """One tiled all-to-all over ``axis_name``'s group (see ``_a2a``
        for what it returns).  The wire fault hook sits just before the
        exchange."""
        group = self.groups[axis_name]
        if _faults.armed():
            x = _faults.taint(f"comm.wire.{self.name}", x)
        return _a2a(x, group, dist.get_world_size(group), split_axis,
                    concat_axis, async_op=async_op, view=view)

    @staticmethod
    def _permute(x, permute):
        return x if permute is None else x.permute(permute)

    def _pack(self, x, split_axis, concat_axis, chunk_axis, permute):
        """Resolve the relayout fold: returns ``(x, split, concat, chunk,
        unpack)`` where the coordinates address the frame the collective
        runs in and ``unpack`` is the permutation still owed AFTER it
        (None under fold="pack")."""
        if permute is None:
            return x, split_axis, concat_axis, chunk_axis, None
        if self.fold == "pack":
            return (self._permute(x, permute), split_axis, concat_axis,
                    chunk_axis, None)
        return (x, permute[split_axis], permute[concat_axis],
                None if chunk_axis is None else permute[chunk_axis],
                permute)

    def _prepare(self, x, axis_name, split_axis: int, valid_extent):
        """Crop ``split_axis`` to its valid extent, then zero-pad to the
        equal-split length of ``axis_name`` (no-ops when already there)."""
        if valid_extent is None:
            return x
        x = crop_axis(x, split_axis, valid_extent)
        p = self.axis_sizes.get(axis_name)
        if p:
            x = pad_axis(x, split_axis, -(-x.shape[split_axis] // p) * p)
        return x

    def _chunk_axis(self, x, split_axis: int, concat_axis: int,
                    chunk_axis) -> int:
        if (chunk_axis is not None
                and chunk_axis not in (split_axis, concat_axis)
                and x.shape[chunk_axis] % self.n_chunks == 0):
            return chunk_axis
        return _uninvolved_axis(x.ndim, split_axis, concat_axis)

    def _plain(self, x, axis_name, split_axis, concat_axis):
        """One collective; the received blocks merged into a contiguous
        output (in place in the receive buffer on one rank or with a
        major concat axis)."""
        y, _ = self._collective(x, axis_name, split_axis, concat_axis)
        c = concat_axis % x.ndim
        return y.flatten(c, c + 1).contiguous()

    def _chunked(self, x, axis_name, split_axis, concat_axis, chunk_axis):
        """Every chunk's collective issued, then all waited on; the blocked
        chunks concatenated (one copy) and merged (a view)."""
        ax = self._chunk_axis(x, split_axis, concat_axis, chunk_axis)
        chunks, ln = _split_chunks(x, ax, self.n_chunks)
        sent = [self._collective(c, axis_name, split_axis, concat_axis,
                                 async_op=True) for c in chunks]
        for _, work in sent:
            work.wait()
        c = concat_axis % x.ndim
        y = torch.cat([b for b, _ in sent], dim=ax if ax < c else ax + 1)
        return crop_axis(y.flatten(c, c + 1), ax, ln)

    # -- to be overridden -------------------------------------------------
    def _switch(self, x, axis_name, split_axis, concat_axis,
                chunk_axis=None):
        raise NotImplementedError

    # -- shared surface ----------------------------------------------------
    def switch(self, x, axis_name, split_axis, concat_axis,
               chunk_axis=None, valid_extent=None, permute=None):
        return self.stage(x, axis_name, split_axis, concat_axis, post=None,
                          chunk_axis=chunk_axis, valid_extent=valid_extent,
                          permute=permute)

    def stage(self, x, axis_name, split_axis, concat_axis, post=None,
              chunk_axis=None, valid_extent=None, permute=None):
        # fault-injection hook: an armed spec for this strategy simulates
        # the collective dying before it is issued (no-op otherwise)
        if _faults.armed():
            _faults.fail_point(f"comm.{self.name}")
        x, split_axis, concat_axis, chunk_axis, unpack = self._pack(
            x, split_axis, concat_axis, chunk_axis, permute)
        x = self._prepare(x, axis_name, split_axis, valid_extent)
        y = self._switch(x, axis_name, split_axis, concat_axis,
                         chunk_axis=chunk_axis)
        y = self._permute(y, unpack)
        return post(y) if post is not None else y


class A2AStrategy(CommStrategy):
    name = "a2a"

    def _switch(self, x, axis_name, split_axis, concat_axis,
                chunk_axis=None):
        return self._plain(x, axis_name, split_axis, concat_axis)


class FusedStrategy(CommStrategy):
    name = "fused"

    def _switch(self, x, axis_name, split_axis, concat_axis,
                chunk_axis=None):
        return self._collective(x, axis_name, split_axis, concat_axis,
                                view=True)[0]


class PipelinedStrategy(CommStrategy):
    """Chunked collectives only; neighboring transforms stay monolithic."""

    name = "pipelined"

    def _switch(self, x, axis_name, split_axis, concat_axis,
                chunk_axis=None):
        if self.n_chunks <= 1:
            return self._plain(x, axis_name, split_axis, concat_axis)
        return self._chunked(x, axis_name, split_axis, concat_axis,
                             chunk_axis)


class OverlapStrategy(PipelinedStrategy):
    """Software-pipelined switch: collective k+1 is issued before the
    post-stage (next direction's transform) of chunk k, so the transform of
    one chunk overlaps the wire time of the next.  A plain transpose (no
    continuation) is the pipelined wire pattern."""

    name = "overlap"

    def stage(self, x, axis_name, split_axis, concat_axis, post=None,
              chunk_axis=None, valid_extent=None, permute=None):
        if _faults.armed():
            _faults.fail_point(f"comm.{self.name}")
        x, split_axis, concat_axis, chunk_axis, unpack = self._pack(
            x, split_axis, concat_axis, chunk_axis, permute)
        x = self._prepare(x, axis_name, split_axis, valid_extent)
        if post is None or self.n_chunks <= 1:
            y = self._switch(x, axis_name, split_axis, concat_axis,
                             chunk_axis=chunk_axis)
            y = self._permute(y, unpack)
            return post(y) if post is not None else y
        ax = self._chunk_axis(x, split_axis, concat_axis, chunk_axis)
        # under fold="unpack" each chunk is permuted as it lands and the
        # concat axis rides the same permutation into the post frame
        ax_out = ax if unpack is None else unpack.index(ax)
        chunks, ln = _split_chunks(x, ax, self.n_chunks)
        c = concat_axis % x.ndim

        def land(sent):
            blocks, work = sent
            work.wait()
            return post(self._permute(blocks.flatten(c, c + 1), unpack))

        outs = []
        inflight = self._collective(chunks[0], axis_name, split_axis,
                                    concat_axis, async_op=True)
        for k in range(1, self.n_chunks):
            nxt = self._collective(chunks[k], axis_name, split_axis,
                                   concat_axis, async_op=True)
            # chunk k-1's transform runs while chunk k is on the wire
            outs.append(land(inflight))
            inflight = nxt
        outs.append(land(inflight))
        return crop_axis(torch.cat(outs, dim=ax_out), ax_out, ln)


_STRATEGY_CLASSES = {
    cls.name: cls
    for cls in (A2AStrategy, PipelinedStrategy, FusedStrategy,
                OverlapStrategy)
}


def make_strategy(cfg: CommConfig, axis_sizes=None, abft=None,
                  groups=None) -> CommStrategy:
    return _STRATEGY_CLASSES[cfg.strategy](cfg.n_chunks,
                                           axis_sizes=axis_sizes,
                                           fold=cfg.fold, abft=abft,
                                           groups=groups)


def topology_switch(x, axis_name, split_axis: int, concat_axis: int,
                    cfg: CommConfig, chunk_axis=None, valid_extent=None,
                    axis_sizes=None, permute=None, groups=None):
    """Distributed transpose: split ``split_axis`` over ``axis_name``'s
    ranks (``groups[axis_name]``), gather ``concat_axis``.  Every rank of
    the group must call it with the same arguments."""
    return make_strategy(cfg, axis_sizes=axis_sizes, groups=groups).switch(
        x, axis_name, split_axis, concat_axis, chunk_axis=chunk_axis,
        valid_extent=valid_extent, permute=permute)


# ---------------------------------------------------------------------------
# plan-time autotuner (flups switchsort analogue)
# ---------------------------------------------------------------------------

_AUTOTUNE_CACHE: dict = {}
_AUTOTUNE_LOCK = threading.Lock()


def autotune_candidates(max_chunks: int = 4, folds=("pack",)):
    """Default (strategy, n_chunks) sweep: monolithic strategies once,
    chunked strategies at 2, 4, ... up to ``max_chunks``, per fold side."""
    cands = []
    for fold in folds:
        cands += [CommConfig("a2a", 1, fold), CommConfig("fused", 1, fold)]
        nc = 2
        while nc <= max_chunks:
            cands.append(CommConfig("pipelined", nc, fold))
            cands.append(CommConfig("overlap", nc, fold))
            nc *= 2
    return tuple(cands)


def clear_autotune_cache():
    with _AUTOTUNE_LOCK:
        _AUTOTUNE_CACHE.clear()


# on-disk JSON layout: {"schema": CACHE_SCHEMA, "entries": {key: entry}};
# the legacy flat schema-1 file is migrated in memory on load
CACHE_SCHEMA = 2


def _cache_file_load(path: str) -> dict:
    try:
        with open(path) as fh:
            data = json.load(fh)
    except OSError:                 # absent cache: normal first-run state
        return {}
    except ValueError:
        _warn_once(f"comm: autotune cache {path} is corrupt/truncated; "
                   "ignoring it (a live sweep will rewrite it)")
        return {}
    if not isinstance(data, dict):
        _warn_once(f"comm: autotune cache {path} holds non-dict JSON; "
                   "ignoring it (a live sweep will rewrite it)")
        return {}
    # chaos hook: an armed ``corrupt_cache`` spec rots the loaded entries
    return _faults.mangle_cache_entry(data)


def cache_load_entries(path: str, census=None) -> dict:
    """Load the cache file and return its ENTRIES dict, migrating legacy
    (schema-1, flat) files in memory.  ``census["migrated"]`` counts the
    entries carried across a migration (0 on a current-schema file)."""
    data = _cache_file_load(path)
    if census is not None:
        census.setdefault("migrated", 0)
    if not data:
        return {}
    if "schema" in data or "entries" in data:
        entries = data.get("entries")
        if data.get("schema") == CACHE_SCHEMA and isinstance(entries, dict):
            return entries
        _warn_once(f"comm: autotune cache {path} has unsupported schema "
                   f"{data.get('schema')!r}; ignoring it (a live sweep "
                   "will rewrite it)")
        return {}
    entries = {}
    for k, v in data.items():
        if isinstance(v, dict):
            e = dict(v)
            if "strategy" in e:
                e.setdefault("fold", "pack")
            entries[k] = e
    if entries:
        _warn_once(f"comm: autotune cache {path} uses the legacy flat "
                   f"schema; migrated {len(entries)} entries in memory "
                   f"(rewritten as schema {CACHE_SCHEMA} on the next "
                   "store)")
    if census is not None:
        census["migrated"] += len(entries)
    return entries


_CACHE_FILE_LOCK = threading.Lock()


def cache_store_entry(path: str, key: str, entry: dict):
    """Read-merge-write one entry into the schema-versioned JSON cache,
    atomically (tmp file + ``os.replace``); best-effort, never fatal."""
    with _CACHE_FILE_LOCK:
        entries = cache_load_entries(path)
        entries[key] = entry
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as fh:
                json.dump({"schema": CACHE_SCHEMA, "entries": entries},
                          fh, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError as e:
            _warn_once(f"comm: cannot persist autotune cache to {path}: {e}")
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _cache_file_store(path: str, key: str, cfg: CommConfig, timings: dict,
                      skipped=()):
    entry = {"strategy": cfg.strategy, "n_chunks": cfg.n_chunks,
             "fold": cfg.fold,
             "timings_us": {k: round(v * 1e6, 1)
                            for k, v in timings.items()}}
    if cfg.chunk_axis != "auto":
        entry["chunk_axis"] = cfg.chunk_axis
    if skipped:
        entry["skipped_budget"] = list(skipped)
    cache_store_entry(path, key, entry)


def _entry_cfg(entry):
    """The CommConfig of one cached entry, or None when it is malformed."""
    if entry is None:
        return None
    try:
        return CommConfig(entry["strategy"], int(entry["n_chunks"]),
                          str(entry.get("fold", "pack")),
                          str(entry.get("chunk_axis", "auto")))
    except (KeyError, TypeError, ValueError, AssertionError):
        return None


def _agreed_hit(cfg, labels, agree):
    """``cfg`` when every rank holds the same cached candidate, else None.
    Without ``agree`` (one process) the local hit stands."""
    if agree is None:
        return cfg
    lbl = None if cfg is None else cfg_label(cfg)
    idx = float(labels.index(lbl)) if lbl in labels else -1.0
    hi, neg_lo = agree([idx, -idx])
    return cfg if hi == -neg_lo >= 0 else None


def autotune_comm(key, time_fn, candidates=None, cache_path=None,
                  results=None, budget_s=None, census=None, agree=None,
                  persist: bool = True) -> CommConfig:
    """Pick the fastest (strategy, n_chunks, fold) for one plan/mesh key.

    ``time_fn(cfg) -> seconds`` runs and times one solve under ``cfg`` (the
    solver provides it); the winner is cached in memory per ``key`` and,
    when ``cache_path`` (default $REPRO_COMM_CACHE) is set, persisted as
    JSON (by this process only when ``persist``).  ``results``, when a
    dict, receives the live sweep's timings (empty on a cache hit).  A
    candidate that raises is skipped; if every candidate fails the default
    ``a2a`` is returned.

    ``agree(values) -> values`` reduces a list of floats with MAX over
    every rank of the mesh.  With it, a cache hit counts only when every
    rank holds the same winner, and each candidate's time and failure flag
    are reduced before they are recorded, so every rank picks the same
    winner.  ``budget_s`` (default $REPRO_COMM_BUDGET, unset = unlimited)
    is applied after each candidate: one whose (agreed) time exceeds it is
    skipped.  ``census`` records ``timed``, ``failed``, ``skipped_budget``
    and ``migrated``.
    """
    if candidates is None:
        candidates = autotune_candidates()
    if budget_s is None:
        try:
            budget_s = float(os.environ.get("REPRO_COMM_BUDGET", "") or 0)
        except ValueError:
            budget_s = 0
    labels = tuple(cfg_label(c) for c in candidates)
    key = repr((key, labels))
    if cache_path is None:
        cache_path = os.environ.get("REPRO_COMM_CACHE") or None
    with _AUTOTUNE_LOCK:
        hit = _AUTOTUNE_CACHE.get(key)
    hit = _agreed_hit(hit, labels, agree)
    if hit is not None:
        return hit
    if cache_path:
        cfg = _entry_cfg(cache_load_entries(cache_path, census=census)
                         .get(key))
        cfg = _agreed_hit(cfg, labels, agree)
        if cfg is not None:
            with _AUTOTUNE_LOCK:
                _AUTOTUNE_CACHE[key] = cfg
            return cfg

    timings: dict = {}
    skipped, failed = [], {}
    for cfg, label in zip(candidates, labels):
        err = None
        try:
            t = float(time_fn(cfg))
        except Exception as e:      # noqa: BLE001 -- a candidate may fail
            err, t = e, 0.0
        if agree is not None:
            t, any_failed = agree([t, float(err is not None)])
            if any_failed and err is None:
                err = RuntimeError("failed on another rank")
        if err is not None:
            failed[label] = f"{type(err).__name__}: {err}"[:200]
            _warn_once(f"comm: autotune candidate {label} failed: {err}")
            continue
        if budget_s and budget_s > 0 and t > budget_s:
            skipped.append(label)
            _warn_once(f"comm: autotune candidate {label} exceeded the "
                       f"{budget_s:g}s budget; skipped")
            continue
        timings[label] = t
    if results is not None:
        results.update(timings)
    if census is not None:
        census.update(timed=dict(timings), failed=failed,
                      skipped_budget=list(skipped))
    if not timings:
        return CommConfig()
    best_label = min(timings, key=timings.get)
    best = label_to_cfg(best_label)
    with _AUTOTUNE_LOCK:
        _AUTOTUNE_CACHE[key] = best
    if cache_path and persist:
        _cache_file_store(cache_path, key, best, timings, skipped)
    return best


def all_reduce_mean(x, group=None):
    """Mean of ``x`` over ``group``'s ranks (a new tensor; SUM then divide,
    which every backend supports)."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y / dist.get_world_size(group)
