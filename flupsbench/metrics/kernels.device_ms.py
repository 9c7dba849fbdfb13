"""kernels.device_ms: device ms a step of every kernel that is neither
PyTorch's, NCCL's nor cuFFT's (the hand kernels, CUDA or Triton), in the
traced stretch."""


def read(run):
    st = run.stretch
    if st is None or not any(k == "hand" for _, k, _, _ in st.ops):
        return None
    return st.ms_per_step("hand")
