"""How evenly the mesh's shards share the gapless extension, in %: 100
times the largest shard's padded slot rounds over the mean shard's, from
the program's counters ``mesh.extend.slot_rounds.s<i>`` summed over the
window's builds (100 is an even split; 400 on four shards is all of it on
one). Nothing to read where the program counts no shard."""

PREFIX = "mesh.extend.slot_rounds.s"


def read(rec):
    shards = [v for k, v in rec["counters"].items() if k.startswith(PREFIX)]
    if not shards or sum(shards) <= 0:
        return None
    return 100.0 * max(shards) * len(shards) / sum(shards)
