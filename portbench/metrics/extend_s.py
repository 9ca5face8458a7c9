"""Seconds a build in the gapless extensions: the stage books ``extend``
and ``reseed.extend.ext``, over the window's builds."""


def read(rec):
    books = rec["books"]
    return sum(books.get(k, 0.0) for k in ("extend", "reseed.extend.ext")) / rec["n_builds"]
