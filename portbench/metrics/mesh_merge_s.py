"""Seconds a build in the host merge of the sharded scan's slices: the
program's span ``mesh.scan.merge`` (the (key, position) sort of every
shard's occurrence rows and the group formation), over the window's
builds. Nothing to read where the program books no such span."""


def read(rec):
    books = rec["books"]
    if "mesh.scan.merge" not in books:
        return None
    return books["mesh.scan.merge"] / rec["n_builds"]
