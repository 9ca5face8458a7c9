"""Share, in %, of the candidates eligible for admission that overlap
resolution admits one at a time in Python (gapped or wrapping ones) rather
than in the C++ call over gapless runs: the program's counters
``resolve.python_cands`` over ``resolve.native_cands`` +
``resolve.python_cands``, summed over the window's builds. Nothing to read
where the program counts no candidate."""


def read(rec):
    counters = rec["counters"]
    python = counters.get("resolve.python_cands", 0)
    total = counters.get("resolve.native_cands", 0) + python
    if total <= 0:
        return None
    return 100.0 * python / total
