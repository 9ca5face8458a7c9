"""Seconds a build in the gapless extension's mesh slices: the program's
span ``mesh.extend.slice`` (each shard's uploads, rounds and readback, in
the first extension and every re-seed round's), over the window's builds.
Nothing to read where the program books no such span."""


def read(rec):
    books = rec["books"]
    if "mesh.extend.slice" not in books:
        return None
    return books["mesh.extend.slice"] / rec["n_builds"]
