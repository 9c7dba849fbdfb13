"""device.idle_pct: the share of the traced stretch in which no operation
ran on rank 0's card."""


def read(run):
    st = run.stretch
    if st is None or not st.ops or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s() / st.window_s)
