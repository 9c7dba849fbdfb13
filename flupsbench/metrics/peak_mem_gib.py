"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over set-up and
window, on the fullest card of a mesh."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
