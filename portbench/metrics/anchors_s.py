"""Seconds a build in the anchor scans: the stage books ``anchors`` and
``reseed.scan``, summed over the window's builds, over their number."""


def read(rec):
    books = rec["books"]
    return sum(books.get(k, 0.0) for k in ("anchors", "reseed.scan")) / rec["n_builds"]
