"""Per-device costs of a cell's step, counted on fake tensors.

Counterpart of ``repro.launch.flops_probe``.  XLA's ``cost_analysis``
counts a scanned layer stack's body once, so the reference lowers small
python-unrolled probes and extrapolates in the layer count.  The port's
layers run in a Python loop, so one traced step counts every layer: no
probe and no extrapolation (``tests/test_torch_launch_dryrun.py`` shows
the count affine in the layer count).

``measure(fn, *args)`` runs ``fn`` once on this rank's fake tensors
(``FakeTensorMode``: nothing is allocated or computed) under

* ``torch.utils.flop_counter.FlopCounterMode``: the matmul, convolution
  and attention FLOPs (it counts none for ``torch.fft``; ``fft_flops``
  adds the transforms' analytic count from the trace);
* ``core.trace.tracing()``: the collectives in program order with their
  operand bytes, the transforms, the kernel calls and the aten op counts;
* a byte and memory probe: the input plus output bytes of every aten op
  that is not a view or an empty allocation, and of every hand kernel's
  call -- an unfused upper bound, each op's operands read from memory
  and its results written back, as XLA counts bytes accessed before
  fusion -- and the live bytes of the storages the step itself allocates
  (their peak, and what is left at its end).
"""
from __future__ import annotations

import dataclasses
import gc
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import trace as _trace
from repro_torch.core.comm import CommConfig
from repro_torch.launch import hlo_stats

__all__ = ["Measurement", "measure", "costs", "probed_costs", "held_bytes"]


def held_bytes(*args) -> int:
    """Bytes of the distinct storages behind ``args``' tensors (modules,
    dicts, lists and dataclasses are walked)."""
    seen = {}
    for t in _trace.tensors(args):
        st = t.untyped_storage()
        seen[id(st)] = st
    return sum(st.nbytes() for st in seen.values())


_ALLOCATIONS = ("empty", "new_empty")


class _Probe(TorchDispatchMode):
    """Bytes each aten op reads and writes, and the live and peak bytes of
    the storages allocated inside the block (``args``' excluded)."""

    def __init__(self, args):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs = {}
        self._known = weakref.WeakSet()
        for t in _trace.tensors(args):
            self._known.add(t.untyped_storage())

    def _free(self, key, n):
        self.live -= n
        self._refs.pop(key, None)

    def _track(self, t):
        st = t.untyped_storage()
        if st in self._known:
            return
        self._known.add(st)
        n = st.nbytes()
        key = id(st)
        self._refs[key] = weakref.ref(st, lambda _, k=key, n=n:
                                      self._free(k, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "aten" and not func.is_view:
            outs = list(_trace.tensors(out))
            # an empty tensor is an allocation: it moves no bytes
            if not func._opname.startswith(_ALLOCATIONS):
                self.bytes += sum(_trace.nbytes(t) for t in _trace.tensors(
                    (args, list(kwargs.values())))) + sum(
                        _trace.nbytes(t) for t in outs)
            for t in outs:
                self._track(t)
        return out


@dataclasses.dataclass
class Measurement:
    """One traced step on one rank: ``flops`` counted by
    ``FlopCounterMode``, ``fft_flops`` from the trace, ``bytes`` the
    unfused upper bound, ``peak_bytes`` / ``end_bytes`` the live bytes the
    step allocated at their peak and at its end, ``seconds`` the trace's
    wall time, ``trace`` the ``core.trace.Trace``, ``out`` what ``fn``
    returned."""
    flops: float
    fft_flops: float
    bytes: float
    peak_bytes: int
    end_bytes: int
    seconds: float
    trace: object
    out: object


def measure(fn, *args) -> Measurement:
    """``fn(*args)`` once under the counters (module docstring).  ``args``
    are fake tensors, or modules and containers of them, in the
    ``FakeTensorMode`` that is open around the call."""
    probe = _Probe(args)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, _trace.tracing() as tr, \
            probe:
        out = fn(*args)
        gc.collect()          # the step's dead cycles free their storages
    seconds = time.perf_counter() - t0
    # a hand kernel's fake call reads its input and writes its output
    kernel_bytes = sum(e["bytes"] for e in tr.events if e["op"] == "kernel")
    return Measurement(flops=float(fc.get_total_flops()),
                       fft_flops=hlo_stats.fft_flops(tr),
                       bytes=float(probe.bytes + kernel_bytes),
                       peak_bytes=probe.peak,
                       end_bytes=probe.live, seconds=seconds, trace=tr,
                       out=out)


def costs(m: Measurement) -> dict:
    """``{flops, bytes, coll_bytes, coll_count}`` per device, the
    reference's keys: FLOPs counted plus the transforms' analytic ones."""
    coll = hlo_stats.collective_stats(m.trace)
    return {"flops": m.flops + m.fft_flops, "bytes": m.bytes,
            "coll_bytes": float(coll["total_bytes"]),
            "coll_count": float(coll["total_count"])}


def probed_costs(arch, shape_name, mesh, comm: CommConfig = CommConfig(),
                 remat=None, extra_cfg=None, device: str = "cuda"):
    """``costs`` of one traced step of the cell (``cells.build_cell``)."""
    from repro_torch.launch.cells import build_cell
    cell = build_cell(arch, shape_name, mesh, comm=comm, remat=remat,
                      extra_cfg=extra_cfg, device=device)
    with cell.mode:
        return costs(measure(cell.fn, *cell.args))
