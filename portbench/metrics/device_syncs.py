"""Blocking host-device transfers a build: the program's counters
``sync.d2h`` and ``sync.h2d`` (``npge_tpu_torch.device.to_host`` and
``to_device``), summed over the window's builds, over their number.
Nothing to read where the program counts neither."""

KEYS = ("sync.d2h", "sync.h2d")


def read(rec):
    counters = rec["counters"]
    if not any(k in counters for k in KEYS):
        return None
    return sum(counters.get(k, 0) for k in KEYS) / rec["n_builds"]
