"""Seconds a build in the first anchor scan sharded over the mesh: the
program's span ``mesh.scan`` (every shard's slice and the host merge),
over the window's builds. Nothing to read where the program books no
such span: a one-card build, or a program whose mesh carries no tracer."""


def read(rec):
    books = rec["books"]
    if "mesh.scan" not in books:
        return None
    return books["mesh.scan"] / rec["n_builds"]
