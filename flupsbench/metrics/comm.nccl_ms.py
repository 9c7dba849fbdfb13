"""comm.nccl_ms: device ms a step of NCCL's kernels on rank 0 in the
traced stretch: the topology switches' all-to-alls (the harness's own
all-reduce of max|u| is the read-back's, not counted)."""


def read(run):
    st = run.stretch
    if st is None or run.world == 1 or not any(
            k == "nccl" for _, k, _, _ in st.ops):
        return None
    return st.ms_per_step("nccl")
