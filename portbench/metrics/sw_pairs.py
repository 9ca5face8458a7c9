"""Pairs a build passes to the SW entry (``ops.sw.sw_extend_windows``), as
the harness's wrapper counts them in the build the check reads."""


def read(rec):
    return rec["sw_pairs"]
