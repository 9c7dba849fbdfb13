"""engine.glue_ms: device ms a step of the kernels in PyTorch's own
namespaces (elementwise, copy, cat, pad, index) and of every memcpy and
memset, in the traced stretch."""


def read(run):
    st = run.stretch
    if st is None or not any(k == "glue" for _, k, _, _ in st.ops):
        return None
    return st.ms_per_step("glue")
