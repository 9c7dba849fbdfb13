"""Read a ``torch.profiler`` trace of a stretch of steps: every device
operation with its kind, the stretch's length and the device's busy time.

Kinds, by the operation's name:

* ``nccl``: NCCL's kernels (the topology switches' all-to-alls);
* ``glue``: kernels in PyTorch's own namespaces (``at::``: elementwise,
  copy, cat, pad, index) and every memcpy and memset;
* ``cufft``: cuFFT's kernels (``torch.fft``: the ladder's fallback rung);
* ``hand``: every other kernel, so a hand kernel a later change adds, in
  CUDA or Triton, counts here without a change to this file;
* ``readback``: whatever the harness's own read-back launched (the max|u|
  reduction, its all-reduce and its copy to the host): the operations
  inside the device-side span of a ``flupsbench.readback`` range.

Ranges a ``record_function`` opens (the harness's, and any the program
adds) also show as device-side spans; they are not operations and are
left out.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

STRETCH = "flupsbench.stretch"
READBACK = "flupsbench.readback"

_CUFFT = re.compile(r"^(void )?(vector_fft|regular_fft|vector_fft_symm|"
                    r"spRadix|dpRadix|spVector|dpVector|composite_fft|"
                    r"cufft)", re.IGNORECASE)


def kind(name: str) -> str:
    if "nccl" in name.lower():
        return "nccl"
    if name.startswith(("Memcpy", "Memset")) or "at::" in name:
        return "glue"
    if _CUFFT.search(name):
        return "cufft"
    return "hand"


@dataclass
class Stretch:
    """What the profiler saw of ``steps`` steps: ``ops`` as ``(name, kind,
    start_us, end_us)``, the stretch's ``[t0_us, t1_us]`` on the trace's
    clock, and the CPU ops as ``(name, start_us, end_us)`` (for naming idle
    gaps)."""
    steps: int
    t0_us: float
    t1_us: float
    ops: list = field(default_factory=list)
    cpu: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    def ms_per_step(self, *kinds) -> float:
        us = sum(e - s for _, k, s, e in self.ops if k in kinds)
        return us / 1e3 / self.steps

    def busy_intervals(self):
        """The union of every device operation's interval, clipped to the
        stretch, sorted."""
        spans = sorted((max(s, self.t0_us), min(e, self.t1_us))
                       for _, _, s, e in self.ops)
        out = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def top_ops(self, k: int = 10):
        """The ``k`` device operations (by name) that took most time:
        ``[[name, seconds], ...]``."""
        tot = {}
        for name, _, s, e in self.ops:
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(tot.items(), key=lambda x: -x[1])
                [:k]]

    def idle_gaps(self, k: int = 10):
        """The ``k`` longest gaps in which the device ran nothing, each named
        by the innermost CPU op running when it opened:
        ``[[name, seconds], ...]``."""
        busy = self.busy_intervals()
        edges = [self.t0_us] + [x for s, e in busy for x in (s, e)] + [
            self.t1_us]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:k]
        out = []
        for dur, at in gaps:
            host = [(e - s, n) for n, s, e in self.cpu if s <= at < e]
            out.append([min(host)[1] if host else "host: no op", dur / 1e6])
        return out


def read(prof, steps: int) -> Stretch:
    """The stretch (the ``flupsbench.stretch`` range) of a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    marks = [e for e in cpu if e.name == STRETCH]
    if not marks:
        raise RuntimeError(f"the trace holds no {STRETCH!r} range")
    t0, t1 = marks[0].time_range.start, marks[0].time_range.end
    device = [e for e in events if e.device_type != DeviceType.CPU]
    spans = [e for e in device if _annotation(e)]
    rb = sorted((e.time_range.start, e.time_range.end) for e in spans
                if e.name == READBACK)
    starts = [s for s, _ in rb]

    def in_rb_span(t) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < rb[i][1]

    st = Stretch(steps, t0, t1)
    for e in cpu:
        if t0 <= e.time_range.start < t1 and e.name != STRETCH:
            st.cpu.append((e.name, e.time_range.start, e.time_range.end))
    for e in device:
        s, en = e.time_range.start, e.time_range.end
        if _annotation(e) or en <= t0 or s >= t1:
            continue
        st.ops.append((e.name, "readback" if in_rb_span(s) else kind(e.name),
                       s, en))
    return st


def _annotation(e) -> bool:
    """A ``record_function`` range's device-side span, not an operation."""
    return (bool(getattr(e, "is_user_annotation", False))
            or "annotation" in str(getattr(e, "activity_type", "")).lower()
            or e.name.startswith("flupsbench."))
