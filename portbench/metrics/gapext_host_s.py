"""Seconds a build in the gapped extension's host work, over every pass:
the stage books ``gapext.assemble``, ``gapext.nw`` and ``gapext.apply``,
over the window's builds."""


def read(rec):
    books = rec["books"]
    return sum(books.get(k, 0.0) for k in ("gapext.assemble", "gapext.nw", "gapext.apply")) / rec["n_builds"]
