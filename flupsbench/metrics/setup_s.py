"""setup_s: seconds from the start of the process that reports to the
first timed step: imports, the kernel library's load (its build in a
checkout's first run), the plan, the host Green's function, the upload,
the ring of right-hand sides and the warm-up steps."""


def read(run):
    return run.setup_s
