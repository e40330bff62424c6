"""Peak device memory over set-up and window,
``torch.cuda.max_memory_allocated()``, in GiB (none off the card)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
