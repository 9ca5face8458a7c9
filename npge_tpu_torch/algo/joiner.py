# mirrors npge_tpu/algo/joiner.py
"""Joiner — merge neighboring blocks that are adjacent in every genome.

Equivalent of the reference's ``Joiner`` processor (``src/algo/Joiner.hpp``
⚠[B], SURVEY.md §2.3): two blocks are joinable when their fragments pair up
one-to-one such that every pair sits on the same sequence with the same
orientation, in one consistent direction, separated by at most MAX_JOIN_GAP
positions with *no other fragment in between* (guaranteed here by deriving
links from consecutive entries of the per-sequence sorted fragment index).
Nonzero gap regions are aligned with the SimilarAligner patch MSA
(algo/similar.py) and spliced in as gapped columns — the reference's
"join within gap limits" [B]/[C]. A join is only performed if the joined
block still satisfies the good-block predicate, so Joiner never breaks the
IsPangenome quality invariant.

``joinable_pairs`` doubles as IsPangenome's dry-run "no joinable
neighbors" check [B].
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.config import Config
from npge_tpu_torch.model.blocks import Block, BlockSet
from npge_tpu_torch.model.fragments import FragmentTable
from npge_tpu_torch.model.stats import is_good_block
from npge_tpu_torch.algo.similar import msa_short
from npge_tpu_torch.util import codes as C


def _adjacency_links(bs: BlockSet, max_gap: int):
    """Arrays (bi, fi, bj, fj, flip_i, flip_j, wrap) for fragment pairs of
    different blocks that are consecutive on a sequence (nothing between)
    and separated by a gap in [0, max_gap]. (bi, fi) precedes (bj, fj) in
    block i's COLUMN space; flip means block j must be inverted before
    concatenation. wrap marks an *origin pair* on a circular sequence: the
    first fragment ends at the sequence end (cyclically) and the second
    starts after the origin; joining produces a wrap fragment
    (start + length > seq_len, model/fragments.frag_spans).

    Orientation-general: a block and its inverse represent the same aligned
    object, so joinability must not depend on the stored representation
    (anchor canonicalization makes representations arbitrary). For the
    earlier-on-sequence fragment with ori +1, the later fragment continues
    its columns; for the later fragment with ori -1 (reading right-to-left),
    the earlier fragment continues its columns.

    Adjacency comes from :meth:`FragmentIndex.adjacent_pairs` (the shared
    sorted per-sequence backbone — VERDICT r2 item 6), including the cyclic
    origin pairs of circular sequences."""
    from npge_tpu_torch.model.fragindex import FragmentIndex

    idx = FragmentIndex(bs.arena, bs.blocks)
    ia, ib, _gap, wraps = idx.adjacent_pairs(max_gap)
    o_a, o_b = idx.u_ori[ia], idx.u_ori[ib]
    bl_a, bl_b = idx.u_block[ia], idx.u_block[ib]
    fr_a, fr_b = idx.u_frag[ia], idx.u_frag[ib]
    # three vectorized link families (order is irrelevant: joinable_pairs
    # sorts both the pair groups and the pairings within each group)
    m1 = o_a == 1              # (b1,f1)+(b2,f2), flip2 iff o2 != 1
    m2 = o_b == -1             # (b2,f2)+(b1,f1), flip2 iff o1 != -1
    m3 = (o_a == -1) & (o_b == 1)  # both point outward: flip the FIRST
    b1 = np.concatenate([bl_a[m1], bl_b[m2], bl_a[m3]])
    f1 = np.concatenate([fr_a[m1], fr_b[m2], fr_a[m3]])
    b2 = np.concatenate([bl_b[m1], bl_a[m2], bl_b[m3]])
    f2 = np.concatenate([fr_b[m1], fr_a[m2], fr_b[m3]])
    flip1 = np.zeros(len(b1), bool)
    flip1[len(b1) - int(m3.sum()):] = True
    flip2 = np.concatenate(
        [o_b[m1] != 1, o_a[m2] != -1, np.zeros(int(m3.sum()), bool)]
    )
    wrap = np.concatenate([wraps[m1], wraps[m2], wraps[m3]])
    return b1, f1, b2, f2, flip1, flip2, wrap


class _StatCache:
    """Per-block good-column stats for incremental join goodness checks:
    (good_count, total, head_good[:m], tail_good[-m:]) with good = identical
    AND gapless columns (exactly model.stats.column_classes semantics).
    Blocks are immutable; entries are keyed by object id AND pin the block
    object itself, so an id can never be recycled onto a stale entry. The
    cache may therefore outlive a single join pass — the pangenome reseed
    loop carries one across rounds (VERDICT r3 weak #1/#3)."""

    def __init__(self, bs: BlockSet, m: int, stats: dict | None = None):
        self.bs = bs
        self.m = m
        self.d: dict[int, tuple] = {}  # id -> (block, stats-tuple)
        self.stats = stats  # shared hit/miss counter dict (VERDICT r4 #10)

    def _bump(self, key: str) -> None:
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + 1

    def get(self, block: Block):
        key = id(block)
        hit = self.d.get(key)
        if hit is not None:
            self._bump("cache.join_stat_hit")
            return hit[1]
        self._bump("cache.join_stat_miss")
        from npge_tpu_torch.model.stats import column_classes

        rows = block.rows(self.bs.arena)
        ident, gapless = column_classes(rows)
        good = ident & gapless
        m = min(self.m, len(good))
        val = (
            int(good.sum()),
            int(len(good)),
            good[:m].copy(),
            good[len(good) - m :].copy(),
        )
        self.d[key] = (block, val)
        return val

    def put_joined(self, joined: Block, b1: Block, b2: Block,
                   flip1: bool, flip2: bool, mid_good: int, mid_w: int):
        g1, t1, h1, ta1 = self.get(b1)
        g2, t2, h2, ta2 = self.get(b2)
        if flip1:
            h1, ta1 = ta1[::-1], h1[::-1]
        if flip2:
            h2, ta2 = ta2[::-1], h2[::-1]
        self.d[id(joined)] = (
            joined, (g1 + g2 + mid_good, t1 + t2 + mid_w, h1, ta2)
        )


def _pair_gap_geometry(arena, s, st1, ln1, st2, ln2, o, wrap):
    """(gap_start_mod_L, gap_width, joined_start) for one fragment pair in
    the joined column orientation. With wrap the gap crosses the origin of
    circular sequence s and the joined fragment wraps."""
    L = arena.seq_len(s)
    en1, en2 = st1 + ln1, st2 + ln2
    if not wrap:
        if o == 1:
            return en1, st2 - en1, min(st1, st2)
        return en2, st1 - en2, min(st1, st2)
    if o == 1:  # f1 at the high end, f2 after the origin
        return en1 % L, st2 + L - en1, st1
    # o == -1: f1 at the low end; column-leftward crosses the origin to f2
    return en2 % L, st1 + L - en2, st2


def _gap_segments(bs: BlockSet, b1: Block, b2: Block, pairing, flip1, flip2):
    """Per-pair gap texts in the joined column orientation."""
    arena = bs.arena
    o1s = -b1.frags.ori if flip1 else b1.frags.ori
    gaps = []
    for f1, f2, wrap in pairing:
        s, st1, ln1, _ = b1.frags.row(f1)
        _, st2, ln2, _ = b2.frags.row(f2)
        o = int(o1s[f1])
        glo, gw, _ = _pair_gap_geometry(arena, s, st1, ln1, st2, ln2, o, wrap)
        seg = arena.circ_codes(s, glo, gw) if gw else arena.seq_codes(s)[:0]
        if o != 1:
            seg = C.revcomp(seg)
        gaps.append(np.asarray(seg, np.uint8))
    return gaps


def _join_good_incremental(
    bs: BlockSet, b1: Block, b2: Block, pairing, flip1, flip2,
    cfg: Config, cache: _StatCache, gaps=None,
) -> tuple[bool, int, int, "np.ndarray | None"]:
    """Good-block predicate of the joined block WITHOUT materializing it.
    Returns (good, mid_good_count, mid_width, mid_msa). Exactly equivalent
    to is_good_block(_join_two(...)) for blocks of length >= m on both
    sides. ``gaps`` (from :func:`_gap_segments`, same args) and the
    returned mid MSA let callers skip recomputing either — joinable_pairs
    computed the segments for the N-guard already, and _join_two splices
    the identical MSA."""
    from npge_tpu_torch.model.stats import column_classes

    g1, t1, h1, ta1 = cache.get(b1)
    g2, t2, h2, ta2 = cache.get(b2)
    if flip1:
        h1, ta1 = ta1[::-1], h1[::-1]
    if flip2:
        h2, ta2 = ta2[::-1], h2[::-1]
    if gaps is None:
        gaps = _gap_segments(bs, b1, b2, pairing, flip1, flip2)
    mid = None
    if all(len(g) == 0 for g in gaps):
        mid_good, mid_w = 0, 0
    else:
        sw = dict(match=cfg.SW_MATCH, mismatch=cfg.SW_MISMATCH, gap=cfg.SW_GAP)
        mid = msa_short(gaps, **sw)
        ident, gapless = column_classes(mid)
        mid_good, mid_w = int((ident & gapless).sum()), mid.shape[1]
    total = t1 + t2 + mid_w
    goodn = g1 + g2 + mid_good
    m = min(cfg.MIN_END, total)
    if t1 >= m and t2 >= m:
        ends_ok = bool(h1[:m].all() and ta2[len(ta2) - m :].all())
    else:
        # caller falls back to full build
        return (None, mid_good, mid_w, mid)
    ok = (
        total >= cfg.MIN_LENGTH
        and ends_ok
        and cfg.MIN_IDENTITY.le_ratio(goodn, total)
    )
    return (ok, mid_good, mid_w, mid)


def joinable_pairs(
    bs: BlockSet,
    cfg: Config | None = None,
    cache: _StatCache | None = None,
    rejected: set | None = None,
) -> list[tuple[int, int, list[tuple[int, int]]]]:
    """All (block_i, block_j, pairing) where j can be appended after i and
    the joined block remains good. pairing: list of (frag_of_i, frag_of_j).
    Requires a perfect 1:1 pairing covering every fragment of both blocks."""
    max_gap = cfg.MAX_JOIN_GAP if cfg else 0
    lb1, lf1, lb2, lf2, lfl1, lfl2, lwrap = _adjacency_links(bs, max_gap)
    nfr = np.fromiter(
        (b.n_frags for b in bs.blocks), np.int64, len(bs.blocks)
    ) if bs.blocks else np.zeros(0, np.int64)
    # group links by (b1, b2, flip1, flip2); only groups whose link count
    # equals BOTH block sizes can form the required perfect 1:1 pairing,
    # so mismatched groups drop out before any per-pair Python work
    if len(lb1) == 0:
        return []
    order = np.lexsort((lf2, lf1, lfl2, lfl1, lb2, lb1))
    lb1, lf1, lb2, lf2 = lb1[order], lf1[order], lb2[order], lf2[order]
    lfl1, lfl2, lwrap = lfl1[order], lfl2[order], lwrap[order]
    newg = np.ones(len(lb1), bool)
    if len(lb1) > 1:
        newg[1:] = (
            (lb1[1:] != lb1[:-1]) | (lb2[1:] != lb2[:-1])
            | (lfl1[1:] != lfl1[:-1]) | (lfl2[1:] != lfl2[:-1])
        )
    gstarts = np.flatnonzero(newg)
    gends = np.concatenate([gstarts[1:], [len(lb1)]])
    sizes_ok = np.flatnonzero(
        (nfr[lb1[gstarts]] == nfr[lb2[gstarts]])
        & (gends - gstarts == nfr[lb1[gstarts]])
    )
    out = []
    for gi in sizes_ok:
        a, e = int(gstarts[gi]), int(gends[gi])
        b1, b2 = int(lb1[a]), int(lb2[a])
        flip1, flip2 = bool(lfl1[a]), bool(lfl2[a])
        n1 = int(nfr[b1])
        pairs = list(zip(lf1[a:e].tolist(), lf2[a:e].tolist(),
                         map(bool, lwrap[a:e])))
        if len({p[0] for p in pairs}) != n1 or len({p[1] for p in pairs}) != n1:
            continue
        pairing = sorted(pairs)
        # rejected keys hold the Block OBJECTS (not bare ids): entries pin
        # their blocks so a recycled id can never alias a stale rejection,
        # which lets the set persist across join passes and reseed rounds
        rkey = (
            bs.blocks[b1], bs.blocks[b2], flip1, flip2, tuple(pairing)
        )
        if rejected is not None and rkey in rejected:
            if cache is not None:
                cache._bump("cache.join_rejected_skip")
            continue
        mid_stats = None
        gaps = mid = None
        if cfg is not None and n1 >= 2:
            # assembly-gap guard: a gap containing N is unknown sequence —
            # bridging it would assert homology across an assembly gap and
            # produce all-N alignment columns (tests/test_fuzz.py). Such a
            # pair is never joinable.
            gaps = _gap_segments(
                bs, bs.blocks[b1], bs.blocks[b2], pairing, flip1, flip2
            )
            if any((g >= 4).any() for g in gaps):
                if rejected is not None:
                    rejected.add(rkey)
                continue
            if cache is not None:
                ok, mg, mw, mid = _join_good_incremental(
                    bs, bs.blocks[b1], bs.blocks[b2], pairing,
                    flip1, flip2, cfg, cache, gaps=gaps,
                )
                if ok is not None:
                    mid_stats = (mg, mw)
            else:
                ok = None
            if ok is None:  # short block or no cache: full construction
                joined = _join_two(
                    bs, bs.blocks[b1], bs.blocks[b2], pairing, cfg,
                    flip1, flip2, gaps=gaps, mid=mid,
                )
                ok = is_good_block(joined, bs.arena, cfg)
            if not ok:
                if rejected is not None:
                    rejected.add(rkey)
                continue
        out.append((b1, b2, pairing, flip1, flip2, mid_stats, gaps, mid))
    return out


def _join_two(
    bs: BlockSet,
    b1: Block,
    b2: Block,
    pairing,
    cfg: Config | None = None,
    flip1: bool = False,
    flip2: bool = False,
    gaps: list | None = None,
    mid: np.ndarray | None = None,
) -> Block:
    """Join b2 after b1 in b1's column space, bridging per-pair gaps.
    flip1/flip2 invert the respective block first (fragment row order is
    preserved by inverse, so pairing indices stay valid). ``gaps`` / ``mid``
    accept the segment texts and their MSA already computed by
    joinable_pairs/_join_good_incremental (identical by construction —
    inverse preserves fragment intervals, so the gap geometry matches)."""
    arena = bs.arena
    if flip1:
        b1 = b1.inverse()
    if flip2:
        b2 = b2.inverse()
    have_gaps = gaps is not None
    if not have_gaps:
        gaps = []
    frows = []
    for f1, f2, wrap in pairing:
        s, st1, ln1, o = b1.frags.row(f1)
        _, st2, ln2, _ = b2.frags.row(f2)
        glo, gw, jstart = _pair_gap_geometry(
            arena, s, st1, ln1, st2, ln2, o, wrap
        )
        if not have_gaps:
            seg = (
                arena.circ_codes(s, glo, gw) if gw else arena.seq_codes(s)[:0]
            )
            if o != 1:
                seg = C.revcomp(seg)
            gaps.append(np.asarray(seg, np.uint8))
        frows.append((s, jstart, ln1 + gw + ln2, o))
    no_gaps = all(len(g) == 0 for g in gaps)
    if no_gaps and b1.is_gapless and b2.is_gapless:
        # gapless fast path: the joined block is gapless; its rows are
        # implicit — no alignment materialization needed
        return Block(FragmentTable.from_rows(frows), None)
    rows1 = b1.rows(arena)
    rows2 = b2.rows(arena)
    if no_gaps:
        aln = np.concatenate(
            [rows1[[p[0] for p in pairing]], rows2[[p[1] for p in pairing]]],
            axis=1,
        )
    else:
        if mid is None:
            sw = dict(match=cfg.SW_MATCH, mismatch=cfg.SW_MISMATCH, gap=cfg.SW_GAP) if cfg else {}
            mid = msa_short(gaps, **sw)
        aln = np.concatenate(
            [
                rows1[[p[0] for p in pairing]],
                mid,
                rows2[[p[1] for p in pairing]],
            ],
            axis=1,
        )
    gapless = not (aln == C.GAP).any()
    return Block(FragmentTable.from_rows(frows), None if gapless else aln)


def join_blocks(
    bs: BlockSet,
    cfg: Config | None = None,
    cache: _StatCache | None = None,
    rejected: set | None = None,
) -> int:
    """Greedily apply joins until none remain. Returns number of joins.

    Deterministic: candidate pairs are processed in sorted block-index
    order; chains (A+B then (AB)+C) are handled by iterating to fixpoint.
    ``cache`` / ``rejected`` may be carried across calls (both pin their
    Block objects, so entries stay valid): the pangenome reseed loop
    passes one pair for the whole run, so re-join passes after each
    reseed round only pay for blocks that actually changed."""
    total = 0
    if cache is None and cfg is not None:
        cache = _StatCache(bs, cfg.MIN_END)
    if rejected is None:
        rejected = set()  # probe results persist across fixpoint rounds
    while True:
        cands = joinable_pairs(bs, cfg, cache, rejected)
        if not cands:
            return total
        consumed: set[int] = set()
        new_blocks: list[Block] = []
        for b1, b2, pairing, flip1, flip2, mid_stats, gaps, mid in cands:
            if b1 in consumed or b2 in consumed:
                continue
            joined = _join_two(
                bs, bs.blocks[b1], bs.blocks[b2], pairing, cfg, flip1, flip2,
                gaps=gaps, mid=mid,
            )
            if cache is not None and mid_stats is not None:
                cache.put_joined(
                    joined, bs.blocks[b1], bs.blocks[b2],
                    flip1, flip2, *mid_stats,
                )
            new_blocks.append(joined)
            consumed.update((b1, b2))
            total += 1
        bs.blocks = [
            b for i, b in enumerate(bs.blocks) if i not in consumed
        ] + new_blocks
