"""Card 0's peak device memory over the window's builds, in GiB:
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start."""


def read(rec):
    if not rec["peak_bytes"] or rec["peak_bytes"][0] <= 0:
        return None
    return rec["peak_bytes"][0] / 2**30
