"""Plain gapless extension of anchor groups, one group at a time, in NumPy.

The yardstick for the program's extension. It states the rule and imports
nothing of the program.

Every member of a group is a k-long window at ``pos`` on its sequence,
read on its strand. A group whose members overlap on one sequence (a
tandem repeat shorter than k) makes no candidate. Each member may grow by
at most the room to its sequence's ends, and where two members of the group
lie on one sequence they share the room between them: the earlier takes
half of it rounded up, the later half rounded down; no side grows past
``max_extend``.

The group grows on each side column by column, all members in lockstep, in
rounds of ``chunk`` columns: column c of a member on a side is its c-th
base outward from the window, read as the reverse complement where the
member runs against the sequence. A column is usable when every member
still has room and a real base (A, C, G, T) there, and identical when all
those bases are equal. In a round the side takes the longest length L that
reaches past the earlier rounds, crosses only usable columns, ends on an
identical one, and has identical columns / L >= num / den over the whole
side (exact integers). Only a round that takes all its ``chunk`` columns is
followed by another, up to ``max_extend`` columns.

A candidate block is the group's members grown by the two sides' lengths:
(sequence, start on the sequence, length, strand) per member.
"""

from __future__ import annotations

import numpy as np

COMP = np.array([3, 2, 1, 0, 4, 5], np.uint8)


def bad_groups(offs, pos, seq_id, k: int) -> np.ndarray:
    """bool [G]: the groups (members offs[g] .. offs[g+1] - 1) whose
    members overlap on one sequence."""
    G = len(offs) - 1
    gid = np.repeat(np.arange(G), np.diff(offs))
    order = np.lexsort((pos, seq_id, gid))
    g, s, p = gid[order], np.asarray(seq_id)[order], np.asarray(pos)[order]
    hit = (g[1:] == g[:-1]) & (s[1:] == s[:-1]) & (p[1:] - (p[:-1] + k) < 0)
    bad = np.zeros(G, bool)
    bad[g[1:][hit]] = True
    return bad


def rooms(pos, seq_id, k: int, offsets) -> tuple[np.ndarray, np.ndarray]:
    """(room toward larger positions, room toward smaller positions) of
    each member, the room to a neighbour on its sequence shared."""
    lo, hi = offsets[seq_id], offsets[seq_id + 1]
    up = hi - (pos + k)
    down = pos - lo
    order = np.lexsort((pos, seq_id))
    for a, b in zip(order[:-1], order[1:]):
        if seq_id[a] != seq_id[b]:
            continue
        room = pos[b] - (pos[a] + k)
        up[a] = min(up[a], room // 2 + room % 2)
        down[b] = min(down[b], room // 2)
    return np.maximum(up, 0), np.maximum(down, 0)


def side_columns(codes, pos, k: int, forward: np.ndarray, c0: int, c1: int):
    """uint8 [F, c1 - c0]: columns c0 .. c1 - 1 outward of each member, in
    the member's reading direction (``forward``: toward larger positions)."""
    c = np.arange(c0, c1, dtype=np.int64)[None, :]
    ahead = pos[:, None] + k + c
    behind = pos[:, None] - 1 - c
    idx = np.where(forward[:, None], ahead, behind)
    idx = np.clip(idx, 0, len(codes) - 1)
    ch = codes[idx]
    return np.where(forward[:, None], ch, COMP[ch])


def extend_side(codes, pos, k, forward, cap, num, den, chunk, max_extend) -> int:
    total, ident = 0, 0
    limit = int(cap.min()) if len(cap) else 0
    while total < max_extend:
        c0, c1 = total, min(total + chunk, limit)
        if c1 <= c0:
            break
        ch = side_columns(codes, pos, k, forward, c0, c1)
        usable = (ch < 4).all(axis=0)
        same = usable & (ch == ch[:1]).all(axis=0)
        n_use = int(np.argmin(usable)) if not usable.all() else len(usable)
        cnt = np.cumsum(same)
        L = np.arange(1, c1 - c0 + 1)
        ok = same & (L <= n_use) & ((ident + cnt) * den >= num * (total + L))
        if not ok.any():
            break
        take = int(L[ok].max())
        ident += int(cnt[take - 1])
        total += take
        if take < chunk:
            break
    return total


def extend_group(codes, offsets, pos, seq_id, strand, k: int, num: int,
                 den: int, chunk: int, max_extend: int):
    """(start within sequence, length, strand) per member, or None for a
    group that makes no candidate."""
    pos = np.asarray(pos, np.int64)
    seq_id = np.asarray(seq_id, np.int64)
    strand = np.asarray(strand, np.int64)
    if bad_groups(np.array([0, len(pos)]), pos, seq_id, k)[0]:
        return None
    up, down = rooms(pos, seq_id, k, offsets)
    plus = strand == 1
    # the right side runs with the strand, the left side against it
    cap_r = np.minimum(np.where(plus, up, down), max_extend)
    cap_l = np.minimum(np.where(plus, down, up), max_extend)
    gr = extend_side(codes, pos, k, plus, cap_r, num, den, chunk, max_extend)
    gl = extend_side(codes, pos, k, ~plus, cap_l, num, den, chunk, max_extend)
    start = np.where(plus, pos - gl, pos - gr) - offsets[seq_id]
    length = np.full(len(pos), k + gl + gr, np.int64)
    return start, length, strand
