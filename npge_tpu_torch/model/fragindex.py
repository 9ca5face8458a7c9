# mirrors npge_tpu/model/fragindex.py
"""FragmentIndex — sorted per-sequence fragment interval index.

Equivalent of the reference's ``FragmentCollection``
(``src/model/FragmentCollection.hpp`` ⚠[B], SURVEY.md §2.1): the sorted
per-sequence index of all fragments of a blockset, supporting O(1) vectorized
neighbor/gap queries. It is the shared backbone for the gapped flank extender
(algo/gapext), Joiner adjacency, MergeUnique and Stick — each previously
rebuilt an ad-hoc index per call (VERDICT round 1, FragmentCollection row).

Array-native: one lexsort over (seq_id, start) of every fragment of every
block; neighbor gaps fall out of adjacent rows.
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.model.arena import GenomeArena

_FAR = np.int64(1) << 40


class FragmentIndex:
    """Flat sorted view of all fragments in a list of blocks.

    Attributes (all length M = total fragments, sorted by (seq, start, end)):
        seq, start, end:  int64 interval columns
        ori:              int32
        block, frag:      source block index (into the input list) and
                          fragment row within that block
        seq_off:          int64[n_seqs+1] CSR offsets into the sorted rows
    """

    def __init__(self, arena: GenomeArena, blocks):
        self.arena = arena
        self.blocks = blocks
        n = sum(b.n_frags for b in blocks)
        seq = np.empty(n, np.int64)
        start = np.empty(n, np.int64)
        length = np.empty(n, np.int64)
        ori = np.empty(n, np.int32)
        block = np.empty(n, np.int64)
        frag = np.empty(n, np.int64)
        o = 0
        for bi, b in enumerate(blocks):
            f = b.frags
            m = len(f)
            seq[o : o + m] = f.seq_id
            start[o : o + m] = f.start
            length[o : o + m] = f.length
            ori[o : o + m] = f.ori
            block[o : o + m] = bi
            frag[o : o + m] = np.arange(m)
            o += m
        end = start + length
        # wrap fragments (start+length > seq_len on circular sequences)
        # index as TWO span rows so neighbor/gap queries near the origin
        # see both occupied pieces; wrap fragments themselves earn no
        # growth room (is_wrap_part marks their rows)
        seq_len = arena.offsets[seq + 1] - arena.offsets[seq] if n else end
        wrapm = end > seq_len if n else np.zeros(0, bool)
        is_wrap = wrapm.copy()
        if wrapm.any():
            wi = np.flatnonzero(wrapm)
            # head span [start, L), tail span [0, end-L)
            seq = np.concatenate([seq, seq[wi]])
            start = np.concatenate([start, np.zeros(len(wi), np.int64)])
            tail_end = end[wi] - seq_len[wi]
            end = np.concatenate([np.where(wrapm, seq_len, end), tail_end])
            ori = np.concatenate([ori, ori[wi]])
            block = np.concatenate([block, block[wi]])
            frag = np.concatenate([frag, frag[wi]])
            is_wrap = np.concatenate([is_wrap, np.ones(len(wi), bool)])
        order = np.lexsort((end, start, seq))
        self.seq = seq[order]
        self.start = start[order]
        self.end = end[order]
        self.ori = ori[order]
        self.block = block[order]
        self.frag = frag[order]
        self.is_wrap_part = is_wrap[order]
        self.seq_off = np.searchsorted(
            self.seq, np.arange(arena.n_seqs + 1)
        ).astype(np.int64)
        # ---- UNSPLIT adjacency view: wrap fragments stay single rows with
        # end > seq_len (they sort last by start — the cyclic-successor
        # formula in adjacent_pairs relies on it). Sort key mirrors the
        # Python tuple order (start, end, ori, block, frag) the Joiner
        # historically used, so link order is bit-stable across the r3
        # migration (VERDICT r2 item 6).
        m = n
        u_end = start[:m] + length[:m]
        uorder = np.lexsort(
            (frag[:m], block[:m], ori[:m], u_end, start[:m], seq[:m])
        )
        self.u_seq = seq[:m][uorder]
        self.u_start = start[:m][uorder]
        self.u_end = u_end[uorder]
        self.u_ori = ori[:m][uorder]
        self.u_block = block[:m][uorder]
        self.u_frag = frag[:m][uorder]
        self.u_seq_off = np.searchsorted(
            self.u_seq, np.arange(arena.n_seqs + 1)
        ).astype(np.int64)

    def __len__(self) -> int:
        return len(self.seq)

    # ---- neighbor gaps ----
    def neighbor_gaps(self) -> tuple[np.ndarray, np.ndarray]:
        """(gap_before, gap_after) per sorted row: free positions between this
        fragment and its sequence predecessor/successor (sequence boundary
        rooms where there is no neighbor). Negative values mean overlapping
        fragments (possible for candidate sets; callers clamp)."""
        n = len(self)
        gap_before = np.empty(n, np.int64)
        gap_after = np.empty(n, np.int64)
        seq_lo = self.arena.offsets[self.seq] - self.arena.offsets[self.seq]
        # distance to sequence bounds by default
        seq_len = (
            self.arena.offsets[self.seq + 1] - self.arena.offsets[self.seq]
        )
        gap_before[:] = self.start
        gap_after[:] = seq_len - self.end
        if n > 1:
            same = self.seq[1:] == self.seq[:-1]
            g = self.start[1:] - self.end[:-1]
            gap_after[:-1] = np.where(same, g, gap_after[:-1])
            gap_before[1:] = np.where(same, g, gap_before[1:])
        del seq_lo
        return gap_before, gap_after

    def split_rooms(self) -> tuple[np.ndarray, np.ndarray]:
        """(room_rev, room_fwd) per sorted row: how far this fragment may grow
        toward smaller / larger sequence positions without ever colliding with
        a neighbor that grows too — shared gaps are split deterministically
        (earlier fragment gets ceil(g/2), later gets floor(g/2); the same
        convention as the anchor extender's caps). Sequence-boundary rooms are
        not split."""
        gap_before, gap_after = self.neighbor_gaps()
        n = len(self)
        has_prev = np.zeros(n, bool)
        has_next = np.zeros(n, bool)
        if n > 1:
            same = self.seq[1:] == self.seq[:-1]
            has_prev[1:] = same
            has_next[:-1] = same
        gb = np.maximum(gap_before, 0)
        ga = np.maximum(gap_after, 0)
        room_fwd = np.where(has_next, ga // 2 + ga % 2, ga)
        room_rev = np.where(has_prev, gb // 2, gb)
        return room_rev, room_fwd

    def per_block_rooms(self):
        """Rooms keyed back to (block, frag): returns two lists-of-arrays
        rr[bi][fi], rf[bi][fi] (reverse/forward room per fragment)."""
        room_rev, room_fwd = self.split_rooms()
        rr = [np.zeros(b.n_frags, np.int64) for b in self.blocks]
        rf = [np.zeros(b.n_frags, np.int64) for b in self.blocks]
        for i in range(len(self)):
            if self.is_wrap_part[i]:
                continue  # wrap fragments earn no growth room
            rr[self.block[i]][self.frag[i]] = room_rev[i]
            rf[self.block[i]][self.frag[i]] = room_fwd[i]
        return rr, rf

    # ---- adjacency (Joiner / MergeUnique backbone) ----
    def adjacent_pairs(self, max_gap: int | None = None):
        """Consecutive same-sequence fragment pairs in the UNSPLIT view.

        Returns (ia, ib, gap, wrap): unsplit-row index arrays where row ia
        immediately precedes row ib on the sequence (nothing between), gap
        is the free distance between them, and wrap marks the cyclic origin
        pair of a circular sequence (the last fragment precedes the first
        across the origin; emitted only when the joined span would fit
        without double-wrapping). With ``max_gap`` given, pairs are filtered
        to 0 <= gap <= max_gap and different source blocks (the Joiner
        candidate predicate)."""
        z = np.zeros(0, np.int64)
        M = len(self.u_seq)
        if M < 2:
            return z, z, z, np.zeros(0, bool)
        same = self.u_seq[1:] == self.u_seq[:-1]
        ia = np.flatnonzero(same)
        ib = ia + 1
        gap = self.u_start[ib] - self.u_end[ia]
        wrap = np.zeros(len(ia), bool)
        # origin pairs on circular sequences with >= 2 fragments
        counts = np.diff(self.u_seq_off)
        circ = np.array(
            [self.arena.circular(s) for s in range(len(counts))], bool
        )
        cs = np.flatnonzero(circ & (counts >= 2))
        if len(cs):
            last = self.u_seq_off[cs + 1] - 1
            first = self.u_seq_off[cs]
            L = self.arena.offsets[cs + 1] - self.arena.offsets[cs]
            g0 = self.u_start[first] + L - self.u_end[last]
            ln1 = self.u_end[last] - self.u_start[last]
            ln2 = self.u_end[first] - self.u_start[first]
            keep = ln1 + g0 + ln2 <= L  # a fragment must not wrap twice
            ia = np.concatenate([ia, last[keep]])
            ib = np.concatenate([ib, first[keep]])
            gap = np.concatenate([gap, g0[keep]])
            wrap = np.concatenate([wrap, np.ones(int(keep.sum()), bool)])
        if max_gap is not None:
            ok = (
                (gap >= 0)
                & (gap <= max_gap)
                & (self.u_block[ia] != self.u_block[ib])
            )
            ia, ib, gap, wrap = ia[ok], ib[ok], gap[ok], wrap[ok]
        return ia, ib, gap, wrap
