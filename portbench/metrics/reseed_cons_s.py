"""Seconds a build in the consensus re-seed's host work: the stage books
``reseed.occ``, ``reseed.cons`` and ``reseed.extend.deconseq``, over the
window's builds."""


def read(rec):
    books = rec["books"]
    return sum(books.get(k, 0.0) for k in ("reseed.occ", "reseed.cons", "reseed.extend.deconseq")) / rec["n_builds"]
