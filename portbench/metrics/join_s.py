"""Seconds a build in the joiner: the stage books ``join`` and
``reseed.join``, over the window's builds."""


def read(rec):
    books = rec["books"]
    return sum(books.get(k, 0.0) for k in ("join", "reseed.join")) / rec["n_builds"]
