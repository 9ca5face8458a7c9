"""Blocks that the joiner should have merged, in NumPy: IsPangenome's
check 3 ("no two neighbouring blocks are joinable"), as far as it can be
decided without aligning a gap.

Two blocks of equal size n >= 2 are joinable when their fragments pair up
one to one, each pair on one sequence with nothing between and at most
``max_gap`` bases apart, in one consistent direction, with no N in a gap,
and the joined block is still good: the first block's rows, the gap texts
aligned, the second block's rows. The joiner aligns the gap texts only
where they differ; a text found in every gap stands alone in the alignment.
So this module decides a join exactly where every gap is empty or holds
the same text, and otherwise counts it only when it stays good however
wide the alignment grows (at most the sum of the distinct texts' lengths)
and with none of its columns good. Every pair it counts is one that the
full check counts too, and a join pass leaves none.

Directions follow the joiner's own links. For fragments a then b on one
sequence, with strands oa and ob:
  oa = +1:           a's block, then b's (b's inverted when ob = -1);
  ob = -1:           b's block, then a's (a's inverted when oa = +1), the
                     gap read on the reverse strand;
  oa = -1, ob = +1:  a's block inverted, then b's.
Links are grouped by (first block, second block, inversions); a group is a
join when it pairs every fragment of both blocks once.

On a circular sequence the origin joins its ends: the fragment that starts
last on it (a, which may itself cross the origin) is followed by the one
that starts first (b), with nothing between, and the gap between them runs
from a's end to the sequence's end and on from the origin to b's start
(end - L to b's start where a crosses the origin). Such a pair is a link
as any other pair is, with the same directions, the same decisions and the
same rule for N in its gap, where the gap is 0 .. ``max_gap`` bases wide,
the blocks differ, and the fragment they would join into is at most L long
(it cannot go round twice).

Blocks are read as the arrays of ``check.plain_blocks``, their fragments as
``blockset`` reads them (``circular``: a flag per sequence, None for linear
sequences only).
"""

from __future__ import annotations

import numpy as np

from portbench.reference.blockset import COMP, block_rows, good_columns


def _links(offsets, blocks, max_gap, circular=None):
    """(b1, f1, b2, f2, inv1, inv2, gap sequence, gap start within it (the
    first fragment's end), gap width, gap reversed) of every link."""
    seq, start, end, ori, blk, frg = [], [], [], [], [], []
    for bi, ((s, st, ln, o), _rows) in enumerate(blocks):
        seq.append(s)
        start.append(st)
        end.append(st + ln)
        ori.append(o)
        blk.append(np.full(len(s), bi, np.int64))
        frg.append(np.arange(len(s), dtype=np.int64))
    if not seq:
        return [np.zeros(0, np.int64)] * 10
    seq, start, end, ori, blk, frg = (np.concatenate(a) for a in (seq, start, end, ori, blk, frg))
    order = np.lexsort((start, seq))
    seq, start, end, ori, blk, frg = (a[order] for a in (seq, start, end, ori, blk, frg))
    a = np.flatnonzero(seq[1:] == seq[:-1])
    b = a + 1
    gap = start[b] - end[a]
    if circular is not None:  # the origin pairs: the last on a sequence, then its first
        offsets = np.asarray(offsets, np.int64)
        last = np.flatnonzero(np.append(seq[1:] != seq[:-1], True))
        first = np.flatnonzero(np.insert(seq[1:] != seq[:-1], 0, True))
        L = offsets[seq[last] + 1] - offsets[seq[last]]
        ring = np.asarray(circular, bool)[seq[last]] & (first != last)
        g0 = start[first] + L - end[last]
        ring &= (end[last] - start[last]) + g0 + (end[first] - start[first]) <= L
        a = np.concatenate([a, last[ring]])
        b = np.concatenate([b, first[ring]])
        gap = np.concatenate([gap, g0[ring]])
    ok = (gap >= 0) & (gap <= max_gap) & (blk[b] != blk[a])
    a, b, gap = a[ok], b[ok], gap[ok]
    oa, ob = ori[a], ori[b]
    fam = [oa == 1, ob == -1, (oa == -1) & (ob == 1)]
    gs, lo = seq[a], end[a]

    def cat(x, y, z):
        return np.concatenate([x[fam[0]], y[fam[1]], z[fam[2]]])

    n0, n1, n2 = (int(f.sum()) for f in fam)
    return (cat(blk[a], blk[b], blk[a]), cat(frg[a], frg[b], frg[a]),
            cat(blk[b], blk[a], blk[b]), cat(frg[b], frg[a], frg[b]),
            np.repeat(np.array([0, 0, 1], np.int64), [n0, n1, n2]),
            np.concatenate([ob[fam[0]] == -1, oa[fam[1]] == 1,
                            np.zeros(n2, bool)]).astype(np.int64),
            cat(gs, gs, gs), cat(lo, lo, lo), cat(gap, gap, gap),
            np.repeat(np.array([False, True, False]), [n0, n1, n2]))


def _gap_text(codes, offsets, seq, lo, width):
    """``width`` bases of a sequence from ``lo`` (taken round its length),
    on round its origin where they pass its end."""
    off, end = int(offsets[seq]), int(offsets[seq + 1])
    if end > off:
        lo %= end - off
    over = off + lo + width - end
    if over <= 0:
        return codes[off + lo : off + lo + width]
    return np.concatenate([codes[off + lo : end], codes[off : off + over]])


def _inverted(rows):
    return COMP[rows[:, ::-1]]


def joinable_pairs(codes, offsets, blocks, min_length, min_end, num, den,
                   max_gap: int = 0, circular=None) -> int:
    """Joins of blocks of two or more fragments that would give a good
    block, as far as this module decides them."""
    return len(joins(codes, offsets, blocks, min_length, min_end, num, den,
                     max_gap, circular))


def joins(codes, offsets, blocks, min_length, min_end, num, den, max_gap,
          circular=None):
    """(first block, second block, first inverted, second inverted) of
    each join that ``joinable_pairs`` counts."""
    links = _links(offsets, blocks, max_gap, circular)
    if len(links[0]) == 0:
        return []
    b1, f1, b2, f2, inv1, inv2, gs, lo, gw, rev = links
    order = np.lexsort((f2, f1, inv2, inv1, b2, b1))
    b1, f1, b2, f2, inv1, inv2, gs, lo, gw, rev = (
        x[order] for x in (b1, f1, b2, f2, inv1, inv2, gs, lo, gw, rev))
    size = np.array([len(fr[0]) for fr, _r in blocks], np.int64)
    key = np.stack([b1, b2, inv1, inv2], 1)
    new = np.ones(len(b1), bool)
    new[1:] = (key[1:] != key[:-1]).any(axis=1)
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], len(b1))
    found = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        x, y = int(b1[s]), int(b2[s])
        n = int(size[x])
        if n < 2 or size[y] != n or e - s != n:
            continue
        if len(set(f1[s:e].tolist())) != n or len(set(f2[s:e].tolist())) != n:
            continue
        gaps = (_gap_text(codes, offsets, q, g0, g) for q, g0, g in
                zip(gs[s:e], lo[s:e], gw[s:e]))
        texts = {bytes(COMP[t[::-1]] if r else t) for t, r in zip(gaps, rev[s:e])}
        if any(max(t, default=0) >= 4 for t in texts):
            continue  # a gap over unknown bases is never bridged
        rx = block_rows(codes, offsets, *blocks[x], circular)
        ry = block_rows(codes, offsets, *blocks[y], circular)
        if rx is None or ry is None:
            continue
        if inv1[s]:
            rx = _inverted(rx)
        if inv2[s]:
            ry = _inverted(ry)
        gx, gy = good_columns(rx), good_columns(ry)
        lens = [len(t) for t in texts]
        if len(texts) == 1:  # no gap, or one text in every gap: exact
            mid_w = mid_good = lens[0]
        else:  # the widest the alignment can grow, none of it good
            mid_w, mid_good = sum(lens), 0
        tx, ty = len(gx), len(gy)
        m = min(min_end, tx + ty + max(lens))
        if tx < m or ty < m:
            continue
        good = int(gx.sum()) + int(gy.sum()) + mid_good
        if (tx + ty + max(lens) >= min_length and gx[:m].all()
                and gy[ty - m :].all() and good * den >= num * (tx + ty + mid_w)):
            found.append((x, y, int(inv1[s]), int(inv2[s])))
    return found
