"""Share, in %, of the padded fragment slots that the gapless extension
rounds compute which belong to a group still extending as the round
starts: the program's counters ``<p>.useful_slot_rounds`` over
``<p>.slot_rounds``, for ``p`` in ``extend`` and ``reseed.extend``, summed
over the window's builds. Nothing to read where the program counts no
slot."""

PREFIXES = ("extend", "reseed.extend")


def read(rec):
    counters = rec["counters"]
    slots = sum(counters.get(f"{p}.slot_rounds", 0) for p in PREFIXES)
    if slots <= 0:
        return None
    useful = sum(counters.get(f"{p}.useful_slot_rounds", 0) for p in PREFIXES)
    return 100.0 * useful / slots
