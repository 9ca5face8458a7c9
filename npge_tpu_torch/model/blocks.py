# mirrors npge_tpu/model/blocks.py
"""Block / BlockSet — the central objects of the engine.

Equivalent of the reference's ``Block`` + ``BlockSet`` + ``AlignmentRow``
(``src/model/Block.hpp``, ``BlockSet.hpp``, ``AlignmentRow.hpp`` ⚠[B],
SURVEY.md §2.1), redesigned array-native:

  - A block's alignment is a dense uint8 matrix ``[n_frags, n_cols]`` of base
    codes with GAP entries (instead of per-fragment AlignmentRow coordinate
    maps). Row r read with gaps removed equals the fragment's text.
  - ``alignment is None`` means the block is *gapless*: all fragments have
    equal length and row r == fragment text (the common case for blocks born
    from exact-anchor group extension; stored implicitly to save memory).
  - BlockSet holds the arena plus a plain list of blocks; it is the single
    mutable "world" object passed between pipeline stages, like the
    reference's target blockset slot [B].
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.fragments import FragmentTable
from npge_tpu_torch.util import codes as C


def column_consensus(rows: np.ndarray) -> np.ndarray:
    """THE per-column consensus rule — single source of truth.

    [C] decision, unified in round 3 (VERDICT r2 weak #7 flagged two
    divergent definitions in ``consensus_with_map`` vs ``mutations``):

      - if non-gap entries strictly outnumber gaps in the column, the
        consensus char is the most frequent real base (ties broken toward
        the smallest code, i.e. A<C<G<T), or N when the column has no real
        base at all (all non-gaps are N);
      - otherwise the consensus char is GAP.

    Both ConSeq (via :meth:`Block.consensus_with_map`, which drops the GAP
    columns) and PrintMutations (which keeps them as '-' consensus chars)
    consume this one function, so mutations.tsv is always consistent with
    the consensus sequence the reseed stage searches.
    """
    f = rows.shape[0]
    counts = np.stack(
        [(rows == b).sum(axis=0) for b in range(C.N_REAL_BASES)]
    )  # [4, n_cols]
    nongap = (rows != C.GAP).sum(axis=0)
    keep = nongap * 2 > f
    best = counts.argmax(axis=0).astype(np.uint8)
    has_base = counts.max(axis=0) > 0
    char = np.where(has_base, best, np.uint8(C.N))
    return np.where(keep, char, np.uint8(C.GAP))


class Block:
    __slots__ = ("frags", "alignment", "name", "_nongap_cum")

    def __init__(
        self,
        frags: FragmentTable,
        alignment: np.ndarray | None = None,
        name: str | None = None,
    ):
        self.frags = frags
        self.alignment = alignment
        self.name = name
        self._nongap_cum = None  # lazy [F, n_cols+1] cumsum, see slice()
        if alignment is not None:
            if alignment.shape[0] != len(frags):
                raise ValueError("alignment rows != n_frags")
        elif len(frags) > 1 and len(set(frags.length.tolist())) > 1:
            raise ValueError("gapless block requires equal fragment lengths")

    @classmethod
    def trusted(
        cls, frags: FragmentTable, alignment: np.ndarray | None = None,
    ) -> "Block":
        """A block the program built consistent by construction (gapless
        fragments of one length, or alignment rows one a fragment), made
        without ``__init__``'s checks."""
        self = cls.__new__(cls)
        self.frags = frags
        self.alignment = alignment
        self.name = None
        self._nongap_cum = None
        return self

    # ---- shape ----
    @property
    def n_frags(self) -> int:
        return len(self.frags)

    @property
    def n_cols(self) -> int:
        if self.alignment is not None:
            return int(self.alignment.shape[1])
        return int(self.frags.length[0]) if len(self.frags) else 0

    @property
    def is_gapless(self) -> bool:
        return self.alignment is None

    # ---- materialization ----
    def rows(self, arena: GenomeArena) -> np.ndarray:
        """Dense [n_frags, n_cols] code matrix (with GAP where gapped)."""
        if self.alignment is not None:
            return self.alignment
        out = np.empty((self.n_frags, self.n_cols), dtype=np.uint8)
        for i in range(self.n_frags):
            s, st, ln, o = self.frags.row(i)
            out[i] = arena.fragment_codes(s, st, ln, o)
        return out

    def consensus_with_map(
        self, arena: GenomeArena
    ) -> tuple[np.ndarray, np.ndarray]:
        """(consensus codes, column index of each consensus position).

        Columns whose :func:`column_consensus` char is GAP are dropped; the
        rest keep their consensus char. Deterministic. The map lets DeConSeq
        translate consensus coordinates back to alignment columns.
        """
        if self.n_frags == 1 and self.alignment is None:
            # fast path: a unique gapless block IS its own consensus
            s, st, ln, o = self.frags.row(0)
            return arena.fragment_codes(s, st, ln, o), np.arange(ln)
        cons = column_consensus(self.rows(arena))
        keep = cons != C.GAP
        return cons[keep], np.flatnonzero(keep)

    def consensus(self, arena: GenomeArena) -> np.ndarray:
        """Ungapped consensus codes (the reference's ConSeq, ⚠[B]/[C])."""
        return self.consensus_with_map(arena)[0]

    # ---- coordinate transforms (convert_position equivalent, ⚠[B]) ----
    def row_positions_consumed(self, row: int, col: int) -> int:
        """Number of non-gap chars of row `row` strictly before column `col`."""
        if self.alignment is None:
            return col
        return int((self.alignment[row, :col] != C.GAP).sum())

    def _subfragment(self, i: int, t0: int, t1: int):
        """Fragment row i restricted to *text* range [t0, t1) -> (s,st,ln,o)."""
        s, st, ln, o = self.frags.row(i)
        if o == 1:
            return (s, st + t0, t1 - t0, o)
        return (s, st + ln - t1, t1 - t0, o)

    def slice(self, c0: int, c1: int) -> "Block | None":
        """Columns [c0, c1) as a new block; rows with no bases are dropped.

        Returns None if no fragment survives. Equivalent to the reference's
        ``Block::slice`` used by Filter's good-slice logic ⚠[B].

        Fully vectorized: per-row consumed-text boundaries come from a
        LAZY cached [F, n_cols+1] nongap cumsum (blocks are immutable),
        so a block sliced k times pays the O(F*n_cols) scan once instead
        of per slice — DeConSeq/FindLowSimilar slice hot blocks thousands
        of times at the 50-100-genome scales.
        """
        if not (0 <= c0 < c1 <= self.n_cols):
            raise ValueError(f"bad slice [{c0},{c1}) of {self.n_cols}")
        f = self.frags
        if self.alignment is None:
            st = np.where(
                f.ori == 1,
                f.start + c0,
                f.start.astype(np.int64) + f.length - c1,
            )
            return Block(
                FragmentTable(
                    f.seq_id, st.astype(np.int32),
                    np.full(len(f), c1 - c0, np.int32), f.ori,
                ),
                None,
            )
        sub = self.alignment[:, c0:c1]
        keep = (sub != C.GAP).any(axis=1)
        if not keep.any():
            return None
        cum = self._nongap_cum
        if cum is None:
            nong = self.alignment != C.GAP
            # int32: n_cols < 2^31 always; the cache can pin for the
            # block's lifetime, so don't double its footprint with int64
            cum = np.zeros((nong.shape[0], nong.shape[1] + 1), np.int32)
            np.cumsum(nong, axis=1, out=cum[:, 1:])
            self._nongap_cum = cum
        t0s = cum[:, c0][keep]
        t1s = cum[:, c1][keep]
        st = f.start[keep].astype(np.int64)
        ln = f.length[keep].astype(np.int64)
        o = f.ori[keep]
        new_st = np.where(o == 1, st + t0s, st + ln - t1s)
        return Block(
            FragmentTable(
                f.seq_id[keep], new_st.astype(np.int32),
                (t1s - t0s).astype(np.int32), o,
            ),
            sub[keep].copy(),
        )

    def inverse(self) -> "Block":
        """Reverse-complement view of the block (``Block::inverse`` ⚠[B])."""
        f = self.frags
        inv = FragmentTable(f.seq_id, f.start, f.length, -f.ori)
        aln = None
        if self.alignment is not None:
            aln = C.COMPLEMENT[self.alignment][:, ::-1].copy()
        return Block(inv, aln)

    def canonicalize(self) -> "Block":
        """Sort fragments into the canonical deterministic order and fix
        block orientation so the first fragment reads forward. Returns
        SELF when already canonical (object stability feeds the
        per-object caches that persist across reseed rounds)."""
        order = self.frags.sort_order()
        if (
            np.array_equal(order, np.arange(len(order)))
            and (len(self.frags) == 0 or self.frags.ori[0] != -1)
        ):
            return self
        aln = self.alignment[order] if self.alignment is not None else None
        b = Block(self.frags.take(order), aln, self.name)
        if len(b.frags) and b.frags.ori[0] == -1:
            inv = b.inverse()
            inv.name = b.name
            return inv
        return b


def normalize_wrap_starts(b: Block, arena: GenomeArena) -> Block:
    """Renormalize fragment starts into [0, seq_len).

    Slicing a wrap block (start + length > seq_len, circular sequences —
    see model/fragments.frag_spans) can produce pieces whose start falls past
    the origin; every slice consumer must pass the piece through here.
    Raises on a start beyond a *linear* sequence (a coordinate bug)."""
    st = b.frags.start.astype(np.int64)
    sl = arena.offsets[b.frags.seq_id + 1] - arena.offsets[b.frags.seq_id]
    over = st >= sl
    if not over.any():
        return b
    for fi in np.flatnonzero(over):
        if not arena.circular(int(b.frags.seq_id[fi])):
            raise ValueError("fragment start beyond a linear sequence")
    nf = FragmentTable(
        b.frags.seq_id,
        np.where(over, st - sl, st).astype(np.int32),
        b.frags.length,
        b.frags.ori,
    )
    return Block(nf, b.alignment, b.name)


class BlockSet:
    """Arena + blocks; the world object threaded through pipeline stages."""

    def __init__(self, arena: GenomeArena, blocks: list[Block] | None = None):
        self.arena = arena
        self.blocks: list[Block] = blocks or []

    def __len__(self) -> int:
        return len(self.blocks)

    def add(self, block: Block) -> None:
        self.blocks.append(block)

    def all_fragments(self) -> FragmentTable:
        t = FragmentTable.empty()
        for b in self.blocks:
            t = t.concat(b.frags)
        return t

    def canonicalize(self, memo: dict | None = None,
                     stats: dict | None = None) -> None:
        """Deterministic global order: canonical fragments within blocks,
        blocks sorted by their first fragment key. Makes hashes/outputs
        independent of construction order (SURVEY §7 hard part 4).

        ``memo`` (id -> (source block, canonical block)) keeps the
        canonical OBJECT stable for a block canonicalized before — the
        reseed loop re-canonicalizes mostly-unchanged blocksets every
        round, and stable objects are what the per-object consensus/join
        caches key on. Entries pin both blocks, so ids cannot alias."""
        out = []
        for b in self.blocks:
            hit = memo.get(id(b)) if memo is not None else None
            if hit is not None:
                out.append(hit[1])
                if stats is not None:
                    stats["cache.canon_hit"] = (
                        stats.get("cache.canon_hit", 0) + 1
                    )
                continue
            cb = b.canonicalize()
            if memo is not None:
                memo[id(b)] = (b, cb)
                if stats is not None:
                    stats["cache.canon_miss"] = (
                        stats.get("cache.canon_miss", 0) + 1
                    )
            out.append(cb)
        # sort by the first fragment's (seq, start, len, ori) — vectorized
        # key build + stable lexsort, identical order to sorting by the
        # row(0) tuple (both stable; empty blocks sort last via the BIG
        # seq key, matching the (1<<30,) tuple which exceeds any real
        # 4-tuple on its first element)
        G = len(out)
        BIG = np.int64(1) << 30
        ks = np.empty(G, np.int64)
        kst = np.zeros(G, np.int64)
        kln = np.zeros(G, np.int64)
        ko = np.zeros(G, np.int64)
        for i, b in enumerate(out):
            if len(b.frags):
                ks[i] = b.frags.seq_id[0]
                kst[i] = b.frags.start[0]
                kln[i] = b.frags.length[0]
                ko[i] = b.frags.ori[0]
            else:
                ks[i] = BIG
        order = np.lexsort((ko, kln, kst, ks))
        self.blocks = [out[int(i)] for i in order]

    def coverage_per_seq(self) -> list[np.ndarray]:
        """For each sequence: int32 count of covering fragments per position."""
        cov = [
            np.zeros(self.arena.seq_len(i), dtype=np.int32)
            for i in range(self.arena.n_seqs)
        ]
        for b in self.blocks:
            f = b.frags
            for i in range(len(f)):
                s, st, ln, _ = f.row(i)
                L = len(cov[s])
                if st + ln > L:  # wrap fragment on a circular sequence
                    cov[s][st:] += 1
                    cov[s][: st + ln - L] += 1
                else:
                    cov[s][st : st + ln] += 1
        return cov
