"""solve_p95_ms: the 95th percentile (nearest rank) of the wall times of
all the window's steps, on rank 0 of a mesh."""
from flupsbench.stats import percentile


def read(run):
    if not run.steps:
        return None
    return percentile(run.steps, 95) * 1e3
