"""Plain anchor groups in NumPy: the yardstick for the program's anchor scan.

It states what an anchor group is and imports nothing of the program.

Over linear sequences laid end to end (``codes``, ``offsets``), a k-mer at
position p is valid when p + k stays in p's sequence and the window holds
no N (code >= 4). Its key is the smaller of the window's 2-bit value (first
base most significant) and that of its reverse complement; its strand is
+1 when the forward value is the smaller, -1 when the reverse complement
is, and a palindrome (equal values) is never an anchor. Positions are
sampled as (w, k)-minimizers: a valid position is kept when its key is the
least key of some run of w consecutive positions that holds it (every tie
kept). Runs are taken over the arena's positions end to end: a run may
reach past the last position, where nothing is valid, and from the end of
one sequence into the next, where the last k - 1 positions of the first
are not valid. So with w <= k a run never holds valid positions of two
sequences, and every sequence but the first of the arena also has the
short runs 0 .. j (j < w - 1) at its start, as every sequence has the
short runs at its end.

On a circular sequence (``circular``) of length L >= k the window at p
reads the k bases p, p + 1, ... round the origin (mod L), so each of its L
positions has a window, valid when it holds no N. A window that crosses the
origin (p + k > L) is never an anchor (the program drops them: a fragment
born across the origin could not be extended), but it takes part in the
runs, where it can be the least key. The runs are those of the sequence
read once round from position 0 and on again over its first
m = min(w - 1, L - k + 1) positions, the last of them the last whose window
stays inside the sequence, followed by k - 1 slots where nothing is valid
(in all L + min(k + w - 2, L) slots in the arena's run order):

  * L >= k + w - 2: m = w - 1. Every run of w cyclically consecutive
    positions is a run, the L of them that start at each position, those
    across the origin among them; the empty slots add the short runs
    j .. w - 2 (0 <= j <= w - 2) at the seam, as the end of a linear
    sequence adds its short runs.
  * k <= L < k + w - 2: m = L - k + 1. The second reading stops at position
    L - k, so a run that starts at s holds s, s + 1, ... round the origin
    and stops after w positions or at position L - k of the second reading,
    whichever comes first; the short runs at the seam are j .. L - k.
  * L < k: no window, and the sequence is L slots where nothing is valid,
    as a linear sequence of that length is.

Between sequences the runs are as in the linear rule, over the sequences'
readings laid end to end in arena order. A position kept in either of its
readings is one anchor, listed once.

An anchor group is the set of kept positions of one key, in position
order, kept when it has 2 .. max_fragments members, and the groups are in
key order. With ``dedupe_window`` > 0, groups whose members lie on the same
sequences with the same strands and the same distances between consecutive
members are shifted copies of each other: among those, in order of their
first position, a group is dropped when its first position lies within
``dedupe_window`` of the last one kept.
"""

from __future__ import annotations

import numpy as np

FILL = np.iinfo(np.int64).max


def _window_values(c: np.ndarray, T: int, k: int):
    """(forward, reverse complement) 2-bit values of the k-windows at
    positions 0 .. T-1 of ``c`` (real bases 0..3, padded past T), built by
    doubling: a 2m-window is an m-window shifted up by 2m bits joined to
    the m-window after it."""
    fwd = {1: c.copy()}
    rev = {1: 3 - c}
    m = 1
    while 2 * m <= k:
        n = len(c) - 2 * m + 1
        fwd[2 * m] = (fwd[m][:n] << (2 * m)) | fwd[m][m : m + n]
        rev[2 * m] = rev[m][:n] | (rev[m][m : m + n] << (2 * m))
        m *= 2
    f = np.zeros(T, np.int64)
    r = np.zeros(T, np.int64)
    at = 0
    for m in sorted(fwd, reverse=True):  # k as a sum of powers of two
        if k - at >= m:
            f = (f << (2 * m)) | fwd[m][at : at + T]
            r = r | (rev[m][at : at + T] << (2 * at))
            at += m
    return f, r


def kmer_keys(codes: np.ndarray, offsets: np.ndarray, k: int, circular=None):
    """(key int64 [T], strand int8 [T], valid bool [T]) for 1 <= k <= 31;
    the windows of ``circular`` sequences of length >= k read round their
    origin."""
    if not 1 <= k <= 31:
        raise ValueError(f"the plain scan takes 1 <= k <= 31, got {k}")
    T = len(codes)
    lens = np.diff(offsets)
    turn = _turning(lens, k, circular)
    if turn.any():
        # each circular sequence followed by its first k - 1 bases again
        parts = []
        for i, L in enumerate(lens.tolist()):
            s = codes[offsets[i] : offsets[i] + L]
            parts.append(np.concatenate([s, s[: k - 1]]) if turn[i] else s)
        read = np.concatenate(parts)
        extra = np.where(turn, k - 1, 0)
        at = np.arange(T) + np.repeat(np.cumsum(extra) - extra, lens)
    else:
        read, extra, at = codes, np.zeros(len(lens), np.int64), None
    n = len(read)
    c = np.concatenate([read.astype(np.int64), np.full(k, 4, np.int64)])
    is_n = c >= 4
    n_before = np.concatenate([[0], np.cumsum(is_n)])
    has_n = n_before[k : k + n] - n_before[:n] > 0
    fwd, rev = _window_values(np.where(is_n, 0, c), n, k)
    if at is not None:
        fwd, rev, has_n = fwd[at], rev[at], has_n[at]
    seq_end = np.repeat(offsets[1:] + extra, lens)
    valid = ~has_n & (np.arange(T) + k <= seq_end)
    key = np.minimum(fwd, rev)
    strand = np.sign(rev - fwd).astype(np.int8)
    return key, strand, valid


def _turning(lens, k: int, circular) -> np.ndarray:
    """bool per sequence: circular and at least k long."""
    if circular is None:
        return np.zeros(len(lens), bool)
    return np.asarray(circular, bool) & (lens >= k)


def reading(offsets, k: int, w: int, circular) -> np.ndarray:
    """The arena's run order (module docstring): the position each slot
    reads, -1 for a slot where nothing is valid."""
    lens = np.diff(offsets)
    turn = _turning(lens, k, circular)
    parts = []
    for i, L in enumerate(lens.tolist()):
        own = np.arange(offsets[i], offsets[i] + L, dtype=np.int64)
        if turn[i]:
            m = min(w - 1, L - k + 1)
            own = np.concatenate([own, own[:m], np.full(k - 1, -1, np.int64)])
        parts.append(own)
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def minimizers(key: np.ndarray, valid: np.ndarray, w: int) -> np.ndarray:
    """bool [T]: valid positions whose key is the least of some run of w
    consecutive positions holding them."""
    if w <= 1:
        return valid.copy()
    T = len(key)
    h = np.where(valid, key, FILL)
    hp = np.concatenate([h, np.full(w - 1, FILL, np.int64)])
    runs = np.lib.stride_tricks.sliding_window_view(hp, w)  # run s: [s, s+w)
    run_min = runs.min(axis=1)  # [T]
    keep = np.zeros(T, bool)
    for o in range(w):  # position s + o of run s
        n = T - o
        keep[o:] |= hp[o : o + n] == run_min[:n]
    return keep & valid


def _dedupe(pos, seq_id, strand, offs, window: int) -> np.ndarray:
    """Keep mask over groups (see the module docstring)."""
    G = len(offs) - 1
    delta = np.zeros(len(pos), np.int64)
    delta[1:] = pos[1:] - pos[:-1]
    delta[offs[:-1]] = 0
    rows = np.stack([seq_id.astype(np.int64), strand.astype(np.int64), delta], 1)
    buf = np.ascontiguousarray(rows).tobytes()
    rs = rows.shape[1] * 8
    classes: dict[bytes, list[int]] = {}
    for g in range(G):
        classes.setdefault(buf[offs[g] * rs : offs[g + 1] * rs], []).append(g)
    keep = np.ones(G, bool)
    first = pos[offs[:-1]]
    for members in classes.values():
        if len(members) < 2:
            continue
        members.sort(key=lambda g: first[g])
        last = first[members[0]]
        for g in members[1:]:
            if first[g] - last <= window:
                keep[g] = False
            else:
                last = first[g]
    return keep


def anchor_groups(codes, offsets, k: int, w: int, max_fragments: int,
                  dedupe_window: int, circular=None):
    """(offsets int64 [G+1], pos int64 [M], seq_id int32 [M], strand int8
    [M]) of the anchor groups; ``circular``: a flag per sequence, or None
    for linear sequences only."""
    codes = np.asarray(codes)
    offsets = np.asarray(offsets, np.int64)
    key, strand, valid = kmer_keys(codes, offsets, k, circular)
    if _turning(np.diff(offsets), k, circular).any():
        slot = reading(offsets, k, w, circular)
        filled = slot >= 0
        at = np.where(filled, slot, 0)
        won = minimizers(key[at], valid[at] & filled, w)
        sel = np.zeros(len(codes), bool)
        sel[slot[won]] = True
        # a window across the origin competes in the runs, but is no anchor
        seq_of = np.searchsorted(offsets, np.arange(len(codes)), side="right") - 1
        sel &= np.arange(len(codes)) + k <= offsets[seq_of + 1]
    else:
        sel = minimizers(key, valid, w)
    sel &= strand != 0
    pos = np.flatnonzero(sel).astype(np.int64)
    order = np.lexsort((pos, key[pos]))
    pos = pos[order]
    key, strand = key[pos], strand[pos]
    new = np.ones(len(key), bool)
    new[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(new)
    sizes = np.diff(np.append(starts, len(key)))
    keep_g = (sizes >= 2) & (sizes <= max_fragments)
    keep_m = np.repeat(keep_g, sizes)
    pos, strand = pos[keep_m], strand[keep_m]
    offs = np.zeros(int(keep_g.sum()) + 1, np.int64)
    np.cumsum(sizes[keep_g], out=offs[1:])
    seq_id = (np.searchsorted(offsets, pos, side="right") - 1).astype(np.int32)
    if dedupe_window > 0 and len(offs) > 1:
        kg = _dedupe(pos, seq_id, strand, offs, dedupe_window)
        km = np.repeat(kg, np.diff(offs))
        pos, seq_id, strand = pos[km], seq_id[km], strand[km]
        sizes = np.diff(offs)[kg]
        offs = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(sizes, out=offs[1:])
    return offs, pos, seq_id, strand.astype(np.int8)


def groups_differing(a, b) -> int:
    """Groups in one of two (offsets, pos, seq_id, strand) sets and not in
    the other, each group taken as its members' (position, sequence,
    strand) in order."""
    if all(np.array_equal(x, y) for x, y in zip(a, b)):
        return 0

    def as_set(g):
        offs, pos, sid, st = g
        rows = np.stack([np.asarray(pos, np.int64), np.asarray(sid, np.int64),
                         np.asarray(st, np.int64)], 1)
        buf = np.ascontiguousarray(rows).tobytes()
        return {buf[offs[i] * 24 : offs[i + 1] * 24] for i in range(len(offs) - 1)}

    return len(as_set(a) ^ as_set(b))
