"""Program-order trace of what one rank issues: the collectives, the 1-D
transforms, the relayouts, the Green multiply and the hand kernels'
calls.

The reference reads these from the lowered HLO of its jitted solve
(``repro.launch.hlo_stats``).  The port runs eagerly, so its call sites
say what they issue: while a ``tracing()`` block is open,

* the comm layer appends one ``all-to-all`` per ``all_to_all_single``
  with its send buffer's bytes (the operand the reference's HLO census
  bills; an ABFT checksum sidecar is marked ``sidecar=1``), as
  ``collective_census()`` records them;
* ``torch.fft`` calls of ``core.transforms`` and the Stockham kernels'
  calls append one ``fft`` each (``kind``, transform ``length``,
  ``rows``, ``out`` points a row, ``dtype``);
* every relayout appends a ``transpose`` with the bytes it reads and
  what it folded into (``pack`` / ``unpack``: a topology switch's send
  or receive side; ``edge``: the scheduled pipeline's adapters;
  ``moveaxis``: the baseline's per-direction round trip);
* the Green multiply appends one ``green`` (``fused=1`` where it runs in
  the FFT kernel's epilogue);
* a hand kernel's call appends one ``kernel`` and counts in
  ``Trace.kernels`` (a kernel's fake-tensor path records here and
  launches nothing);
* the other collectives (all-reduce, all-gather, the ring's sends,
  broadcast) and every aten op are seen at the dispatcher: one event per
  collective with its operand bytes, and a count per op name in
  ``Trace.ops``.

Outside a block every hook is one check of an empty list.
``Trace.as_text()`` writes one event per line (``<op> key=value ...``),
then one ``aten`` line per op name; ``launch.hlo_stats`` reads either.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Trace", "tracing", "active", "emit", "kernel_call", "nbytes",
           "tensors"]

# the open traces; empty (and so never touched) outside a block
_OPEN: list = []

# c10d ops -> the reference's collective names.  An all_to_all_single is
# billed by the comm layer (``alltoall_base_`` is not listed); a ring
# shift is billed on its send, as a permute's operand.
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "send": "collective-permute", "broadcast_": "broadcast"}
# the argument holding each op's operand tensors
_C10D_ARG = {"allgather_": 1, "_allgather_base_": 1,
             "allgather_into_tensor_coalesced_": 1, "reduce_scatter_": 1,
             "_reduce_scatter_base_": 1}


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def tensors(x):
    """The tensors in ``x``: a tensor, or lists, tuples, dicts,
    dataclasses and modules (their parameters and buffers) of them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from tensors(v)
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
        yield from x.buffers()
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from tensors(getattr(x, f.name))


class Trace:
    """``events``: dicts in program order, each with its ``op``;
    ``kernels``: hand-kernel calls by name; ``ops``: aten ops by name;
    ``inputs`` / ``outputs``: the traced function's ``(shape, dtype)``
    pairs where its caller sets them (``DistributedPoissonSolver.lower``
    does)."""

    def __init__(self):
        self.events: list = []
        self.kernels = collections.Counter()
        self.ops = collections.Counter()
        self.inputs: list = []
        self.outputs: list = []

    def as_text(self) -> str:
        lines = []
        for e in self.events:
            kv = " ".join(f"{k}={_fmt(v)}" for k, v in e.items() if k != "op")
            lines.append(f"{e['op']} {kv}".rstrip())
        lines += [f"aten name={k} count={v}" for k, v in sorted(
            self.ops.items())]
        return "\n".join(lines) + "\n"


def _fmt(v):
    if isinstance(v, bool):
        return int(v)
    return str(v).replace("torch.", "")


class _Dispatch(TorchDispatchMode):
    """Counts every aten op of the block into ``trace`` and records there
    the collectives the comm layer does not bill (each open trace has its
    own mode, so nested traces each see an op once)."""

    def __init__(self, trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        if ns == "c10d":
            name = func._opname
            op = _C10D.get(name)
            if op is not None:
                arg = args[_C10D_ARG.get(name, 0)]
                self.trace.events.append({"op": op, "bytes": sum(
                    nbytes(t) for t in tensors(arg))})
        elif ns == "aten":
            self.trace.ops[str(func.overloadpacket)] += 1
        return out


@contextlib.contextmanager
def tracing(trace: Trace | None = None):
    """Record into ``trace`` (a new one by default) everything the block
    issues (module docstring).  Traces nest; each sees the whole
    block."""
    trace = Trace() if trace is None else trace
    _OPEN.append(trace)
    try:
        with _Dispatch(trace):
            yield trace
    finally:
        _OPEN.remove(trace)


def active() -> bool:
    return bool(_OPEN)


def emit(op: str, **fields):
    """Append the event ``{"op": op, **fields}`` to every open trace."""
    for t in _OPEN:
        t.events.append({"op": op, **fields})


def kernel_call(name: str, x, out):
    """A hand kernel's call on ``x``, ``out`` its result: counted by name
    and recorded with the bytes it reads and writes."""
    for t in _OPEN:
        t.kernels[name] += 1
    emit("kernel", name=name, bytes=nbytes(x) + nbytes(out))
