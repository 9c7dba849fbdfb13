"""Collective bytes, transform FLOPs, interleave and relayout censuses,
and the op census, read from a torch trace.

Counterpart of ``repro.launch.hlo_stats``, with its six public names.  The
reference parses the HLO of a lowered or compiled jit; the port runs
eagerly, and its call sites record what one rank issues, in program
order, into a ``core.trace.Trace`` (``DistributedPoissonSolver.lower``,
``launch.flops_probe.measure``).  Every function here takes such a trace
or its ``as_text()``: one event a line, ``<op> key=value ...``.
"""
from __future__ import annotations

import math

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

__all__ = ["COLLECTIVES", "events", "collective_stats", "comm_bytes_stats",
           "fft_flops", "comm_interleave_stats", "transpose_stats",
           "op_census"]


def _value(v: str):
    return int(v) if v.lstrip("-").isdigit() else v


def events(trace) -> list:
    """The trace's events as dicts (``op`` and the line's fields, ints
    where they are numbers), from a ``Trace`` or its text."""
    text = trace.as_text() if hasattr(trace, "as_text") else trace
    out = []
    for line in text.splitlines():
        tok = line.split()
        if tok:
            ev = {"op": tok[0]}
            ev.update((k, _value(v)) for k, v in
                      (t.split("=", 1) for t in tok[1:]))
            out.append(ev)
    return out


def _collectives(trace):
    return [e for e in events(trace) if e["op"] in COLLECTIVES]


def collective_stats(trace) -> dict:
    """Count and operand bytes of every collective, by kind, with
    ``total_bytes`` and ``total_count`` (checksum sidecars included: they
    are collectives of their own)."""
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for e in _collectives(trace):
        out[e["op"]]["count"] += 1
        out[e["op"]]["bytes"] += e["bytes"]
    out["total_bytes"] = sum(out[k]["bytes"] for k in COLLECTIVES)
    out["total_count"] = sum(out[k]["count"] for k in COLLECTIVES)
    return out


def comm_bytes_stats(trace) -> dict:
    """Per-collective operand bytes in PROGRAM ORDER.

    The valid-extent / deferred-doubling acceptance probe: a pruned plan's
    first forward topology switch ships fewer bytes than the dense
    (up-front Hockney doubling) plan's.  Returns ``per_collective`` (a
    list of ``{op, bytes}`` dicts, ``sidecar: True`` on an ABFT checksum
    sidecar), ``first_bytes`` / ``last_bytes`` (0 when none) and
    ``total_bytes``.  Chunked strategies give one entry per chunk."""
    per = []
    for e in _collectives(trace):
        p = {"op": e["op"], "bytes": e["bytes"]}
        if e.get("sidecar"):
            p["sidecar"] = True
        per.append(p)
    return {
        "per_collective": per,
        "first_bytes": per[0]["bytes"] if per else 0,
        "last_bytes": per[-1]["bytes"] if per else 0,
        "total_bytes": sum(p["bytes"] for p in per),
    }


def fft_flops(trace) -> float:
    """Analytic FLOPs of the transforms (``FlopCounterMode`` counts none
    for ``torch.fft``, as XLA's cost analysis counts about none for its
    fft ops): 5 x the transform's output points x log2 of its length,
    the reference's formula."""
    total = 0.0
    for e in events(trace):
        if e["op"] == "fft":
            total += 5.0 * e["rows"] * e["out"] * max(
                math.log2(max(e["length"], 2)), 1.0)
    return total


def comm_interleave_stats(trace) -> dict:
    """Program-order census of topology-switch collectives vs transforms.

    Returns ``all_to_all`` (collective count), ``fft`` (transforms seen
    between the first and the last collective), ``gaps_with_compute``
    (consecutive-collective pairs with >= 1 transform between them -- the
    ``overlap`` strategy's signature: chunk k's transform issued between
    chunk k and k+1's collectives) and ``adjacent_pairs`` (pairs with
    none)."""
    seq = [("a2a" if e["op"] == "all-to-all" else "fft")
           for e in events(trace) if e["op"] in ("all-to-all", "fft")]
    gaps = adjacent = fft_between = pending = 0
    seen_first = False
    for tok in seq:
        if tok == "fft":
            if seen_first:
                pending += 1
            continue
        if seen_first:
            if pending:
                gaps += 1
                fft_between += pending
            else:
                adjacent += 1
        seen_first = True
        pending = 0
    return {"all_to_all": seq.count("a2a"), "fft": fft_between,
            "gaps_with_compute": gaps, "adjacent_pairs": adjacent}


def transpose_stats(trace) -> dict:
    """Program-order census of relayouts vs transforms and collectives.

    The layout-scheduling acceptance probe (DESIGN.md #9).  Each
    transpose is classified as

    * ``edge``         -- before the first or after the last transform:
                          the adapters between the user's natural layout
                          and the scheduled one;
    * ``switch_fused`` -- attributable to a topology switch: no transform
                          sits between it and an adjacent collective, and
                          it is that collective's FIRST attributed
                          transpose (the one relayout a switch's pack or
                          unpack performs anyway);
    * ``standalone``   -- everything else: transposes strictly between
                          two transforms with no collective to fold into,
                          plus any beyond the 1-per-collective budget (the
                          baseline pipeline's moveaxis round trips).

    The scheduled distributed solve shows ``standalone == 0``; the
    baseline shows one per switch.  ``*_bytes`` sum each class's bytes.

    Census limitation (the reference's): a CHUNKED ``overlap`` switch
    under ``fold="unpack"`` permutes each chunk as it lands, between the
    chunks' transforms (``... C C T F T F ...``); on a linear stream the
    later chunks' transposes look standalone and are counted so.  Gates
    on ``standalone == 0`` run monolithic or ``fold="pack"``
    configurations.
    """
    seq = []
    for e in events(trace):
        if e["op"] in COLLECTIVES:
            seq.append(("C", 0))
        elif e["op"] == "fft":
            seq.append(("F", 0))
        elif e["op"] == "transpose":
            seq.append(("T", e["bytes"]))
    kinds = [t for t, _ in seq]
    f_idx = [i for i, t in enumerate(kinds) if t == "F"]
    out = {"total": 0, "edge": 0, "switch_fused": 0, "standalone": 0,
           "total_bytes": 0, "edge_bytes": 0, "switch_fused_bytes": 0,
           "standalone_bytes": 0, "collectives": kinds.count("C"),
           "transforms": len(f_idx)}
    first_f = f_idx[0] if f_idx else len(kinds)
    last_f = f_idx[-1] if f_idx else -1
    budget_used = set()

    def adjacent_collective(i: int):
        """Index of a collective reachable from ``i`` without crossing a
        transform, or None."""
        for j in range(i - 1, -1, -1):
            if kinds[j] == "C":
                return j
            if kinds[j] == "F":
                break
        for j in range(i + 1, len(kinds)):
            if kinds[j] == "C":
                return j
            if kinds[j] == "F":
                break
        return None

    for i, (t, nbytes) in enumerate(seq):
        if t != "T":
            continue
        out["total"] += 1
        out["total_bytes"] += nbytes
        if i < first_f or i > last_f:
            cls = "edge"
        else:
            c = adjacent_collective(i)
            if c is not None and c not in budget_used:
                budget_used.add(c)
                cls = "switch_fused"
            else:
                cls = "standalone"
        out[cls] += 1
        out[cls + "_bytes"] += nbytes
    return out


def op_census(trace, ops=None) -> dict:
    """Calls by name: every aten op (``aten.mm``, ...) and every hand
    kernel (``fft_stockham``, ...); only the names in ``ops`` where
    given."""
    counts = {}
    for e in events(trace):
        if e["op"] == "aten":
            name, n = e["name"], e["count"]
        elif e["op"] == "kernel":
            name, n = e["name"], 1
        else:
            continue
        if ops is None or name in ops:
            counts[name] = counts.get(name, 0) + n
    return counts
