# mirrors npge_tpu/algo/stick.py
"""Stick — snap nearby block boundaries to a common cut point.

Equivalent of the reference's ``Stick`` processor (``src/algo/Stick.cpp``
⚠[B], SURVEY.md §2.3). Blocks BORN from this pipeline never need it: anchor
extension produces exactly-consistent boundaries and the resolver admits an
overlap-free set. Stick exists for *imported / re-read* blocksets whose block
edges disagree by a few positions (the classic source in the reference is
inconsistent BLAST hit ends): fragments of two blocks that overlap by at
most ``STICK_MAX_SHIFT`` positions are reconciled by trimming the
lower-priority block back to the higher-priority block's boundary — the
"common cut point". Larger overlaps are out of Stick's scope (that is
OverlapsResolver's job).

Deterministic: blocks are ranked by the resolver's canonical priority; the
loser of every conflict trims. Runs to a fixpoint (total overlap strictly
decreases). Trimmed blocks are re-checked against the good-block predicate
(best good slice) and dropped if nothing good remains.

``snappable_pairs`` doubles as the IsPangenome predicate "no snappable
boundaries remain" (VERDICT round-1 item 7).
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.config import Config
from npge_tpu_torch.model.blocks import Block, BlockSet, normalize_wrap_starts
from npge_tpu_torch.model.fragindex import FragmentIndex
from npge_tpu_torch.model.stats import column_classes, is_good_block
from npge_tpu_torch.algo.filter import best_good_slice
from npge_tpu_torch.algo.overlaps import _block_score_key


def snappable_pairs(bs: BlockSet, cfg: Config):
    """(block_i, block_j, max_overlap) for block pairs whose fragments
    overlap on some sequence by 1..STICK_MAX_SHIFT positions. Empty on any
    valid (overlap-free) blockset."""
    if len(bs.blocks) < 2:
        return []
    idx = FragmentIndex(bs.arena, bs.blocks)
    if len(idx) < 2:
        return []
    same = idx.seq[1:] == idx.seq[:-1]
    ov = idx.end[:-1] - idx.start[1:]
    hit = (
        same
        & (ov > 0)
        & (ov <= cfg.STICK_MAX_SHIFT)
        & (idx.block[1:] != idx.block[:-1])
    )
    out: dict[tuple[int, int], int] = {}
    for i in np.flatnonzero(hit):
        a, b = int(idx.block[i]), int(idx.block[i + 1])
        key = (min(a, b), max(a, b))
        out[key] = max(out.get(key, 0), int(ov[i]))
    return [(a, b, o) for (a, b), o in sorted(out.items())]


def _trim_block(b: Block, arena, head: int, tail: int, cfg: Config):
    """Cut `head` leading / `tail` trailing COLUMNS off a block; re-filter
    goodness. Returns the trimmed block or None.

    Callers convert text-position overlaps to exact column counts through
    the conflicting fragment's alignment row (see ``stick_blocks``), so a
    snap removes exactly the overlapping text positions — no gap-column
    over-trim (VERDICT r2 weak #8 closed; exactness is asserted by
    ``tests/test_stick.py::test_gapped_snap_exact_boundary``)."""
    n = b.n_cols
    c0, c1 = head, n - tail
    if c1 - c0 < cfg.MIN_LENGTH:
        return None
    piece = normalize_wrap_starts(b.slice(c0, c1), arena)
    if piece is None:
        return None
    if piece.n_frags >= 2 and not is_good_block(piece, arena, cfg):
        ident, gapless = column_classes(piece.rows(arena))
        sl = best_good_slice(ident & gapless, cfg)
        if sl is None:
            return None
        piece = normalize_wrap_starts(piece.slice(*sl), arena)
    piece.name = b.name
    return piece


def stick_blocks(bs: BlockSet, cfg: Config) -> int:
    """Snap all small boundary overlaps; returns the number of trims.

    For every conflicting pair the canonically higher-priority block keeps
    its boundary; the other is trimmed on the overlapping column side by the
    maximum overlap it has there. Iterates to a fixpoint."""
    arena = bs.arena
    total = 0
    for _ in range(64):  # fixpoint bound; each round strictly reduces overlap
        if len(bs.blocks) < 2:
            return total
        idx = FragmentIndex(arena, bs.blocks)
        if len(idx) < 2:
            return total
        same = idx.seq[1:] == idx.seq[:-1]
        ov = idx.end[:-1] - idx.start[1:]
        hit = (
            same
            & (ov > 0)
            & (ov <= cfg.STICK_MAX_SHIFT)
            & (idx.block[1:] != idx.block[:-1])
        )
        rows = np.flatnonzero(hit)
        if len(rows) == 0:
            return total
        rank = {
            bi: r
            for r, bi in enumerate(
                sorted(
                    range(len(bs.blocks)),
                    key=lambda i: _block_score_key(bs.blocks[i], arena),
                )
            )
        }
        # per loser block: required trim (in COLUMNS) on each column side.
        # For gapped blocks, the columns needed to shed `o` text positions of
        # the conflicting fragment are counted on its own alignment row, so
        # every round strictly shrinks the conflicting interval.
        trims: dict[int, list[int]] = {}
        for i in rows:
            a, b = int(idx.block[i]), int(idx.block[i + 1])
            o = int(ov[i])
            loser, li = (
                (a, i) if rank[a] > rank[b] else (b, i + 1)
            )
            blk = bs.blocks[loser]
            fi = int(idx.frag[li])
            ori = int(blk.frags.ori[fi])
            # overlap sits at the loser fragment's interval END if it is the
            # earlier row (li == i), else at its interval START; map to the
            # block's column side via orientation
            at_end = li == i
            col_tail = at_end == (ori == 1)
            if blk.alignment is None:
                cols = o
            else:  # columns consuming o non-gap chars from that side
                from npge_tpu_torch.util import codes as C

                r = blk.alignment[fi]
                nongap = np.flatnonzero(r != C.GAP)
                if col_tail:
                    cols = blk.n_cols - int(nongap[len(nongap) - o])
                else:
                    cols = int(nongap[o - 1]) + 1
            t = trims.setdefault(loser, [0, 0])
            t[1 if col_tail else 0] = max(t[1 if col_tail else 0], cols)
        new_blocks = list(bs.blocks)
        drop = []
        for loser, (head, tail) in sorted(trims.items()):
            piece = _trim_block(bs.blocks[loser], arena, head, tail, cfg)
            total += 1
            if piece is None:
                drop.append(loser)
            else:
                new_blocks[loser] = piece
        bs.blocks = [
            b for i, b in enumerate(new_blocks) if i not in set(drop)
        ]
    return total
