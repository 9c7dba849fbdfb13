"""solver.host_ms: host clock from the solve call to its return, with no
synchronise, averaged over the untraced half of a traced run's window:
the enqueue cost that the per-step read-back exposes."""


def read(run):
    if not run.host:
        return None
    return sum(run.host) / len(run.host) * 1e3
