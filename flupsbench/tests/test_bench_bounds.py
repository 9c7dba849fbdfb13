"""The compulsory bytes ``kernels.roofline_pct`` divides by: the figures
PERF.md states, from the configurations alone."""
from __future__ import annotations

import json

import pytest

from flupsbench import bounds, catalog


def _config(name):
    return json.loads((catalog.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,world,want", [
    # 2 fields x 257^3 float32, read once and written once
    ("flups_poisson", 1, 271_593_488),
    ("flups_poisson", 4, 67_898_372),
    # 1 field x 512^3 float32
    ("flups_periodic", 1, 1_073_741_824),
])
def test_compulsory_bytes(name, world, want):
    cfg = _config(name)
    assert bounds.compulsory_bytes(cfg, cfg["batch"], world) == want


def test_the_h100_peak():
    assert bounds.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert bounds.hbm_bytes_per_s("some other card") is None


def test_roofline_reader_on_a_made_up_stretch():
    from flupsbench import devtrace, stepper
    cfg = _config("flups_poisson")
    run = stepper.Run(cfg, {}, 1, 2, "NVIDIA H100 80GB HBM3")
    # two steps of 1 ms of hand kernels and 1 ms of glue each
    run.stretch = devtrace.Stretch(2, 0.0, 5000.0, ops=[
        ("stockham_kernel", "hand", 0.0, 1000.0),
        ("void at::native::elementwise_kernel", "glue", 1000.0, 2000.0),
        ("stockham_kernel", "hand", 2500.0, 3500.0),
        ("Memcpy DtoD (Device -> Device)", "glue", 3500.0, 4500.0),
        ("ncclDevKernel_SendRecv", "nccl", 4500.0, 4600.0)])
    pct = catalog.reader("kernels.roofline_pct")(run)
    assert pct == pytest.approx(100 * 271_593_488 / 3.35e12 / 2e-3)
    assert catalog.reader("engine.glue_ms")(run) == pytest.approx(1.0)
    assert catalog.reader("kernels.device_ms")(run) == pytest.approx(1.0)
    assert catalog.reader("comm.nccl_ms")(run) is None   # one rank
    # busy 4.1 ms of the 5 ms stretch
    assert catalog.reader("device.idle_pct")(run) == pytest.approx(18.0)
    assert run.stretch.idle_gaps()[0][1] == pytest.approx(0.0005)


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::stockham_kernel<float, 9>(float const*)",
     "hand"),
    ("triton_poi_fused_mul_0", "hand"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "glue"),
    ("Memset (Device)", "glue"),
    ("void vector_fft<512u, EPT<8u>, 1u, 32u>", "cufft"),
    ("ncclDevKernel_AllToAll_RING_LL", "nccl"),
])
def test_device_op_kinds(name, kind):
    from flupsbench import devtrace
    assert devtrace.kind(name) == kind


class _Ev:
    """A profiler event as ``devtrace.read`` reads it."""

    def __init__(self, name, start, end, device, parent=None):
        from torch.autograd import DeviceType

        class _Range:
            pass
        self.name, self.cpu_parent = name, parent
        self.time_range = _Range()
        self.time_range.start, self.time_range.end = start, end
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU


def test_annotation_spans_are_not_ops_and_mark_the_readback():
    from flupsbench import devtrace
    stretch = _Ev(devtrace.STRETCH, 0.0, 100.0, False)
    rb_cpu = _Ev(devtrace.READBACK, 60.0, 90.0, False, stretch)
    evs = [stretch, rb_cpu,
           _Ev(devtrace.STRETCH, 1.0, 99.0, True),        # device-side span
           _Ev(devtrace.READBACK, 70.0, 80.0, True),
           _Ev("stockham_kernel", 5.0, 50.0, True),
           _Ev("void at::native::reduce_kernel<...>", 70.0, 75.0, True),
           _Ev("Memcpy DtoH (Device -> Pinned)", 76.0, 80.0, True)]

    class _Prof:
        def events(self):
            return evs
    st = devtrace.read(_Prof(), 1)
    assert [(n, k) for n, k, _, _ in st.ops] == [
        ("stockham_kernel", "hand"),
        ("void at::native::reduce_kernel<...>", "readback"),
        ("Memcpy DtoH (Device -> Pinned)", "readback")]
    assert st.ms_per_step("hand") == pytest.approx(0.045)
    assert st.busy_s() == pytest.approx(54e-6)
