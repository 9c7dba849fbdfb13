"""solve_ms: the window's wall time over the steps it completed, each step
a solve and its read-back."""


def read(run):
    if not run.steps:
        return None
    return run.window_s / len(run.steps) * 1e3
