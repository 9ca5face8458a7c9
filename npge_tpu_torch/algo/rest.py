# mirrors npge_tpu/algo/rest.py
"""Rest — cover every unclaimed position with unique 1-fragment blocks.

Equivalent of the reference's ``Rest`` processor (``src/algo/Rest.cpp``
⚠[B], SURVEY.md §2.3): establishes the *partition* invariant — after Rest,
every genome position belongs to exactly one block.
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch import native
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import Block
from npge_tpu_torch.model.fragments import FragmentTable


def rest_blocks(
    arena: GenomeArena, occ: list[np.ndarray], cache: dict | None = None,
    stats: dict | None = None,
) -> list[Block]:
    """One unique block per maximal uncovered interval (ori=+1).

    On a circular sequence, uncovered runs touching both the end and the
    start of the coordinate axis are one *cyclic* run: they merge into a
    single wrap fragment (start + length > seq_len) so no unique-block
    boundary is pinned at position 0 (SURVEY §2.1 circularity [A]).

    ``cache`` ((seq, start, len) -> Block) reuses the Block OBJECT for an
    interval seen in an earlier call: uncovered runs barely change across
    reseed rounds, and stable objects let the per-object consensus/join
    caches hit (blocks are immutable, entries pin their block)."""
    out = []
    for seq_id in range(arena.n_seqs):
        starts, ends = native.uncovered_runs(
            np.ascontiguousarray(occ[seq_id], np.uint8)
        )
        starts, ends = starts.tolist(), ends.tolist()
        L = arena.seq_len(seq_id)
        if (
            arena.circular(seq_id)
            and len(starts) >= 2
            and starts[0] == 0
            and ends[-1] == L
        ):
            # merge last+first into one wrap run
            starts[0] = starts[-1]
            ends[0] = L + ends[0]
            starts.pop()
            ends.pop()
        for st, en in zip(starts, ends):
            key = (seq_id, st, en - st)
            b = cache.get(key) if cache is not None else None
            if b is None:
                b = Block(
                    FragmentTable.from_rows([(seq_id, st, en - st, 1)])
                )
                if cache is not None:
                    cache[key] = b
                    if stats is not None:
                        stats["cache.rest_miss"] = (
                            stats.get("cache.rest_miss", 0) + 1
                        )
            elif stats is not None:
                stats["cache.rest_hit"] = stats.get("cache.rest_hit", 0) + 1
            out.append(b)
    if cache is not None and len(cache) > 2 * len(out) + 64:
        # bound the cache to the current cover's scale (vanished runs
        # only recur after a revert; rebuilding those is cheap)
        used = {(int(b.frags.seq_id[0]), int(b.frags.start[0]),
                 int(b.frags.length[0])) for b in out}
        for k in [k for k in cache if k not in used]:
            del cache[k]
    return out
