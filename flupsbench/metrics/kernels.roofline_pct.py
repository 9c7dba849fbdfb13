"""kernels.roofline_pct: the least time the card could take for a step's
compulsory bytes (``bounds.compulsory_bytes``: each right-hand side read
once, each solution written once, a rank its share) at its peak bandwidth,
as a share of the device time a step of all its kernels took (hand
kernels, PyTorch's glue and cuFFT; not NCCL, not the harness's
read-back)."""
from flupsbench import bounds


def read(run):
    st = run.stretch
    peak = bounds.hbm_bytes_per_s(run.device_kind)
    if st is None or peak is None:
        return None
    busy_ms = st.ms_per_step("hand", "glue", "cufft")
    if busy_ms <= 0:
        return None
    need = bounds.compulsory_bytes(run.config, run.batch, run.world)
    return 100.0 * need / peak * 1e3 / busy_ms
