"""``build_s`` as a per-layer metric, for cells whose builds' time spreads
too widely from run to run to be held end to end: the window's builds'
own time over their number (under the profiler, in a traced run). It
moves ``setup_s``, whose warm-up build is one such build."""


def read(rec):
    return sum(rec["walls"]) / rec["n_builds"]
