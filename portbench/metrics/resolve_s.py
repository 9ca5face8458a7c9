"""Seconds a build in overlap resolution: the stage books ``resolve`` and
``reseed.resolve``, over the window's builds."""


def read(rec):
    books = rec["books"]
    return sum(books.get(k, 0.0) for k in ("resolve", "reseed.resolve")) / rec["n_builds"]
