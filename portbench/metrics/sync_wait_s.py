"""Seconds a build in which the host waits on blocking host-device
transfers: the program's books ``sync.d2h`` and ``sync.h2d`` (the spans of
``npge_tpu_torch.device.to_host`` and ``to_device``), summed over the
window's builds, over their number. Nothing to read where the program
books neither."""

KEYS = ("sync.d2h", "sync.h2d")


def read(rec):
    books = rec["books"]
    if not any(k in books for k in KEYS):
        return None
    return sum(books.get(k, 0.0) for k in KEYS) / rec["n_builds"]
