"""Share, in %, of the re-seed's candidates that map back to the genomes
by the per-piece general path of ``deconseq`` rather than the vectorised
fast one: the program's counters ``deconseq.general`` over
``deconseq.fast`` + ``deconseq.general``, summed over the window's builds.
Nothing to read where the program counts no candidate."""


def read(rec):
    counters = rec["counters"]
    general = counters.get("deconseq.general", 0)
    total = counters.get("deconseq.fast", 0) + general
    if total <= 0:
        return None
    return 100.0 * general / total
