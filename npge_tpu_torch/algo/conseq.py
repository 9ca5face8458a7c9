"""ConSeq / DeConSeq — search the compressed (consensus) representation.

Counterpart of ``npge_tpu/algo/conseq.py``, with the same results.
Equivalent of the reference's consensus stage (``src/algo/ConSeq.cpp``,
``DeConSeq.cpp`` ⚠[B], SURVEY.md §2.3): build one consensus sequence per
block, search for similarity *between* consensuses, then map hits back
through the originating blocks to genome fragments. In the reference the
search is external BLAST; here it is the same k-mer anchor machinery run on
the consensus arena (the north star explicitly replaces BLAST with hashed
k-mer anchors + extension).

Gapped source blocks are supported through the consensus column map
(Block.consensus_with_map): a consensus interval maps to the enclosing
alignment-column range. Candidates whose mapped pieces end up with unequal
column widths (possible only across gapped sources) are skipped — columns
could not be concatenated consistently without a re-alignment pass.

Both directions read one flat fragment table of the round's blockset
(``overlaps._FlatCandidates`` over its blocks, CSR by block): the
consensus of every single-fragment gapless block is its own text, taken
for all of them by one gather over the doubled arena, and the mapping
back expands candidate fragments over gapless sources into source
fragments in one pass over the same table. No Python object is made per
consensus sequence, source block or gapless piece.
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.algo.gapext import host_codes2
from npge_tpu_torch.algo.overlaps import _FlatCandidates
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import (
    Block, BlockSet, column_consensus, normalize_wrap_starts,
)
from npge_tpu_torch.model.fragments import FragmentTable
from npge_tpu_torch.trace import span
from npge_tpu_torch.util.csr import csr_gather


class ConsSources:
    """Where each sequence of a consensus arena comes from: ``flat`` is
    the flat fragment table of the blockset's blocks (``flat.cand``),
    ``block[j]`` the index of the block whose consensus sequence j is,
    ``length[j]`` its length, ``cmaps`` the column maps that are not the
    identity (gapped sources), by sequence. Iterating yields the ``(block
    index, column map)`` pairs: a missing map is the identity, handed out
    as a read-only view."""

    __slots__ = ("flat", "block", "length", "cmaps", "_ident")

    def __init__(self, flat: _FlatCandidates, block: np.ndarray,
                 length: np.ndarray, cmaps: dict[int, np.ndarray]):
        self.flat = flat
        self.block = block
        self.length = length
        self.cmaps = cmaps
        self._ident = None

    def __len__(self) -> int:
        return len(self.block)

    def _identity(self, n: int) -> np.ndarray:
        if self._ident is None:
            self._ident = np.arange(self.length.max(initial=0), dtype=np.int64)
            self._ident.flags.writeable = False
        return self._ident[:n]

    def __iter__(self):
        cmaps = self.cmaps
        for j, (bi, n) in enumerate(
            zip(self.block.tolist(), self.length.tolist())
        ):
            cmap = cmaps.get(j)
            yield bi, self._identity(n) if cmap is None else cmap


def _run_indices(start: np.ndarray, length: np.ndarray) -> np.ndarray:
    """``start[k] .. start[k] + length[k] - 1`` for every k, laid end to
    end: a run of ones whose cumulative sum steps to the next start at the
    first position of each run."""
    keep = length > 0
    start, length = start[keep], length[keep]
    idx = np.ones(int(length.sum()), np.int64)
    if len(idx):
        idx[0] = start[0]
        idx[np.cumsum(length[:-1])] = start[1:] - start[:-1] - length[:-1] + 1
        np.cumsum(idx, out=idx)
    return idx


def _gather_texts(
    arena: GenomeArena, seq, start, length, ori,
    out: np.ndarray | None = None, at: np.ndarray | None = None,
) -> np.ndarray:
    """The texts of fragments, each as ``arena.fragment_codes`` gives it,
    by one gather over the doubled arena (``host_codes2``): laid end to
    end in a new array, or fragment k written to ``out[at[k]:at[k] +
    length[k]]``. Wrap fragments (across the origin of a circular
    sequence) are read one by one."""
    seq = np.asarray(seq, np.int64)
    start = np.asarray(start, np.int64)
    length = np.asarray(length, np.int64)
    ori = np.asarray(ori, np.int64)
    if out is None:
        out = np.empty(int(length.sum()), np.uint8)
        at = np.cumsum(length) - length
    lo = arena.offsets[seq] + start
    wrap = lo + length > arena.offsets[seq + 1]
    if wrap.any():
        for k in np.flatnonzero(wrap).tolist():
            out[at[k] : at[k] + length[k]] = arena.fragment_codes(
                int(seq[k]), int(start[k]), int(length[k]), int(ori[k])
            )
        keep = ~wrap
        lo, length, ori, at = lo[keep], length[keep], ori[keep], at[keep]
    if len(lo):
        # codes2 = codes ++ revcomp(codes): the reverse complement of
        # codes[lo:lo + len] is codes2[2T - lo - len:2T - lo]
        base = np.where(ori == -1, 2 * arena.total_length - lo - length, lo)
        out[_run_indices(at, length)] = host_codes2(arena)[
            _run_indices(base, length)
        ]
    return out


def _count(stats: dict | None, key: str, n: int) -> None:
    if stats is not None and n:
        stats[key] = stats.get(key, 0) + n


def consensus_arena(
    bs: BlockSet,
    cache: dict | None = None,
    stats: dict | None = None,
) -> tuple[GenomeArena, ConsSources]:
    """One consensus sequence per block (canonical block order).

    Returns (arena of consensus sequences, :class:`ConsSources`: the
    (block index, column map) pair of each consensus sequence). Blocks with
    empty consensus are skipped.

    A single-fragment gapless block is its own consensus: all of them are
    taken by one gather from the arena. Multi-fragment gapless blocks vote
    (:func:`column_consensus`) on rows gathered in one pass; gapped blocks
    go through :meth:`Block.consensus_with_map`.

    ``cache`` (id -> (block, cons, cmap or None for the identity)) carries
    the consensus of multi-fragment and gapped blocks across calls: blocks
    are immutable and the reseed loop preserves object identity for
    unchanged blocks, so successive rounds only recompute the consensus of
    blocks that actually changed. Entries pin their block object, so ids
    cannot be recycled onto stale rows. ``stats`` counts the sequences by
    origin: ``reseed.cons.gathered``, ``.voted`` and ``.cached``.
    """
    arena = bs.arena
    blocks = bs.blocks
    flat = _FlatCandidates(blocks, arena)
    G = len(blocks)
    single = (flat.nfr == 1) & flat.gapless
    lens = np.zeros(G, np.int64)
    lens[single] = flat.length[flat.offs[:-1][single]]
    conses: dict[int, tuple] = {}  # block index -> (cons, cmap or None)
    vote: list[int] = []  # multi-fragment gapless blocks not in the cache
    missed: list[int] = []  # gapped blocks not in the cache
    n_cached = 0
    for i in np.flatnonzero((flat.nfr >= 2) | ~flat.gapless).tolist():
        b = blocks[i]
        hit = cache.get(id(b)) if cache is not None else None
        if hit is not None:
            conses[i] = hit[1:]
            n_cached += len(hit[1]) > 0
            _count(stats, "cache.cons_hit", 1)
        elif not flat.gapless[i]:
            conses[i] = b.consensus_with_map(arena)
            missed.append(i)
        else:
            vote.append(i)
    if vote:
        ids = np.array(vote, np.int64)
        idx, row_off = csr_gather(flat.offs, ids)
        texts = _gather_texts(
            arena, flat.seq[idx], flat.start[idx], flat.length[idx],
            flat.ori[idx],
        )
        width = flat.length[idx[row_off[:-1]]].tolist()
        t0 = 0
        for i, f, w in zip(vote, np.diff(row_off).tolist(), width):
            # gapless rows hold no gap, so the vote keeps every column
            conses[i] = (
                column_consensus(texts[t0 : t0 + f * w].reshape(f, w)), None
            )
            t0 += f * w
    if cache is not None:
        for i in missed + vote:
            cache[id(blocks[i])] = (blocks[i],) + tuple(conses[i])
        _count(stats, "cache.cons_miss", len(missed) + len(vote))
    for i, (cons, _cmap) in conses.items():
        lens[i] = len(cons)
    # the arena: nonempty consensus sequences in block order
    src = np.flatnonzero(lens)
    offsets = np.zeros(len(src) + 1, np.int64)
    np.cumsum(lens[src], out=offsets[1:])
    codes = np.empty(int(offsets[-1]), np.uint8)
    seq_of = np.full(G, -1, np.int64)
    seq_of[src] = np.arange(len(src))
    one = src[single[src]]
    fi = flat.offs[one]
    _gather_texts(
        arena, flat.seq[fi], flat.start[fi], flat.length[fi], flat.ori[fi],
        out=codes, at=offsets[seq_of[one]],
    )
    cmaps: dict[int, np.ndarray] = {}
    for i, (cons, cmap) in conses.items():
        if len(cons):
            j = int(seq_of[i])
            codes[offsets[j] : offsets[j + 1]] = cons
            if cmap is not None:
                cmaps[j] = cmap
    if stats is not None:
        _count(stats, "reseed.cons.gathered", len(one))
        _count(stats, "reseed.cons.cached", n_cached)
        _count(stats, "reseed.cons.voted", len(src) - len(one) - n_cached)
    names = [f"cons{i}&b&l" for i in src.tolist()]
    cons_arena = GenomeArena.from_flat(
        names, codes, offsets, np.zeros(len(src), bool)
    )
    return cons_arena, ConsSources(flat, src, lens[src], cmaps)


def _expand(src: ConsSources, bs: BlockSet, ci, st, ln, o, sel=None):
    """Each candidate fragment (consensus sequence ``ci``, start, length,
    strand) over a gapless source stands for every fragment of its source
    block over the same columns (the column map is the identity, so cons
    coords ARE alignment columns), on the strand of both; a start past
    the end of its sequence (a wrap source) is taken back by the
    sequence's length. Returns the CSR offsets of the expansions over the
    candidate fragments and their int32 (seq, start, length, ori)
    columns; fragments outside ``sel`` expand to nothing."""
    flat = src.flat
    blk = src.block[ci]
    counts = flat.nfr[blk]
    if sel is not None:
        counts = np.where(sel, counts, 0)
    k_off = np.zeros(len(ci) + 1, np.int64)
    np.cumsum(counts, out=k_off[1:])
    rep = np.repeat(np.arange(len(ci)), counts)
    rows = np.arange(int(k_off[-1])) + np.repeat(
        flat.offs[blk] - k_off[:-1], counts
    )
    c0 = st[rep]
    c1 = c0 + ln[rep]
    seq = flat.seq[rows]
    fo = flat.ori[rows]
    start = np.where(
        fo == 1, flat.start[rows] + c0, flat.start[rows] + flat.length[rows] - c1
    )
    seq_off = bs.arena.offsets
    seq_len = seq_off[seq + 1] - seq_off[seq]
    start = np.where(start >= seq_len, start - seq_len, start)
    return (
        k_off, seq.astype(np.int32), start.astype(np.int32),
        (c1 - c0).astype(np.int32),
        (fo * np.where(o[rep] == -1, -1, 1)).astype(np.int32),
    )


def _map_fast(src: ConsSources, bs: BlockSet, fc) -> list:
    """The fast mapping of flat candidates ``fc`` whose sources are all
    gapless. A list aligned with the candidates, None where one expands to
    fewer than 2 fragments."""
    c_off, ci, st, ln, o = fc
    k_off, seq, start, length, ori = _expand(src, bs, ci, st, ln, o)
    e = k_off[c_off].tolist()
    # a gapless candidate's fragments share one length, and so do their
    # expansions
    out: list = [None] * (len(c_off) - 1)
    for c, (a, b) in enumerate(zip(e[:-1], e[1:])):
        if b - a >= 2:
            out[c] = Block.trusted(FragmentTable.trusted(
                seq[a:b], start[a:b], length[a:b], ori[a:b]
            ))
    return out


def _map_general(
    src: ConsSources, bs: BlockSet, fc, slice_memo: dict | None,
) -> list:
    """The mapping of flat candidates ``fc`` that touch gapped sources (or
    are gapped): a list aligned with the candidates, None where one was
    dropped. A fragment over a gapless source expands as on the fast
    path; one over a gapped source is the source block sliced to the
    enclosing alignment columns (rows with no bases dropped), normalized
    and turned to the fragment's strand. Pieces concatenate column-wise in
    candidate order; a candidate whose pieces differ in width, or that
    stands for fewer than 2 fragments, is dropped. The rows of the gapless
    pieces of gapped results come from one gather.

    ``slice_memo`` ((id(src block), c0, c1, ori) -> (src block, piece))
    carries sliced pieces across calls: source blocks are immutable and
    keep object identity across reseed rounds, and successive rounds map
    near-identical candidate sets. Entries pin the source block (id-alias
    safety); pieces are immutable and only ever read, so sharing one object
    across candidates is safe."""
    blocks = bs.blocks
    cmaps = src.cmaps
    c_off, ci, st, ln, o = fc
    gapped = ~src.flat.gapless[src.block[ci]]
    k_off, seq, start, length, ori = _expand(src, bs, ci, st, ln, o, ~gapped)
    cols = (seq, start, length, ori)
    k_off = k_off.tolist()
    blk = src.block[ci].tolist()
    ci, st, ln, o, gapped = (a.tolist() for a in (ci, st, ln, o, gapped))
    out: list = []
    need_rows: list[tuple[int, list, int]] = []
    c_off = c_off.tolist()
    for a, e in zip(c_off[:-1], c_off[1:]):
        # a piece: a (lo, hi) range of expanded rows, or a sliced Block
        pieces: list = []
        width = None
        nf = 0
        ok = e > a
        for k in range(a, e):
            if gapped[k]:
                src_block = blocks[blk[k]]
                cmap = cmaps[ci[k]]  # a gapped source's map is kept
                c0 = int(cmap[st[k]])
                c1 = int(cmap[st[k] + ln[k] - 1]) + 1
                mkey = (id(src_block), c0, c1, o[k])
                hit = slice_memo.get(mkey) if slice_memo is not None else None
                if hit is not None:
                    piece = hit[1]
                else:
                    piece = src_block.slice(c0, c1)
                    if piece is not None:
                        piece = normalize_wrap_starts(piece, bs.arena)
                        if o[k] == -1:
                            piece = piece.inverse()
                    if slice_memo is not None:
                        slice_memo[mkey] = (src_block, piece)
                if piece is None:
                    ok = False
                    break
                pieces.append(piece)
                w = piece.n_cols
                nf += piece.n_frags
            else:
                lo, hi = k_off[k], k_off[k + 1]
                if pieces and type(pieces[-1]) is tuple and pieces[-1][1] == lo:
                    pieces[-1] = (pieces[-1][0], hi)
                else:
                    pieces.append((lo, hi))
                w = ln[k]
                nf += hi - lo
            if width is None:
                width = w
            elif w != width:
                width = -1
        if not ok or width == -1 or nf < 2:
            # a slice with no bases, unequal-width gapped pieces, or
            # fewer than 2 fragments
            out.append(None)
            continue
        # column-wise concat of the pieces' fragment tables
        ft = FragmentTable.trusted(*(
            np.concatenate([
                col[p[0] : p[1]] if type(p) is tuple else getattr(p.frags, name)
                for p in pieces
            ])
            for col, name in zip(cols, ("seq_id", "start", "length", "ori"))
        ))
        if all(type(p) is tuple for p in pieces):
            out.append(Block.trusted(ft))
        else:
            need_rows.append((len(out), pieces, width))
            out.append(ft)
    if need_rows:
        # the rows of every gapless piece of a gapped result, in one gather
        idx = np.concatenate([
            np.arange(p[0], p[1]) for _, ps, _ in need_rows for p in ps
            if type(p) is tuple
        ] or [np.zeros(0, np.int64)])
        texts = _gather_texts(bs.arena, *(col[idx] for col in cols))
        t0 = 0
        for j, pieces, w in need_rows:
            rows = []
            for p in pieces:
                if type(p) is tuple:
                    f = p[1] - p[0]
                    rows.append(texts[t0 : t0 + f * w].reshape(f, w))
                    t0 += f * w
                else:
                    rows.append(p.alignment)
            out[j] = Block.trusted(out[j], np.concatenate(rows, axis=0))
    return out


def deconseq(
    cand, cons_src, bs: BlockSet,
    slice_memo: dict | None = None, timings=None,
) -> list[Block]:
    """Map candidate blocks found on the consensus arena back to genome
    space: a consensus fragment (cons_i, start, len, ori) expands to *all*
    fragments of source block i sliced to the enclosing alignment columns
    (orientation flips applied via Block.inverse). Pieces of one candidate
    concatenate column-wise into a single genome-space block.

    ``cand`` may be a list of Blocks or the extender's CandidateBatch;
    ``cons_src`` the :class:`ConsSources` that :func:`consensus_arena`
    returned for ``bs``. Candidates are split
    PER CANDIDATE: those whose touched source blocks are all gapless (and
    that are themselves gapless) run the fully vectorized fast path; only
    the rest pay the per-piece general path. ``timings`` receives spans
    and counters ``deconseq.fast`` and ``deconseq.general``, the
    candidates by path."""
    n = len(cand)
    if n == 0:
        return []
    src = cons_src
    if src.flat.cand is not bs.blocks:
        raise ValueError("cons_src was made over another blockset")
    fc = _FlatCandidates(cand, bs.arena)
    frag_gapped = ~src.flat.gapless[src.block[fc.seq]]
    cid = np.repeat(np.arange(n), fc.nfr)
    any_gapped = np.zeros(n, bool)
    np.logical_or.at(any_gapped, cid, frag_gapped)
    fast_mask = fc.gapless & ~any_gapped
    n_fast = int(fast_mask.sum())
    if timings is not None:
        timings.count("deconseq.fast", n_fast)
        timings.count("deconseq.general", n - n_fast)
    if n_fast == n:
        with span(timings, "deconseq.fast"):
            out = _map_fast(
                src, bs, (fc.offs, fc.seq, fc.start, fc.length, fc.ori)
            )
        return [b for b in out if b is not None]
    fast_ids = np.flatnonzero(fast_mask)
    slow_ids = np.flatnonzero(~fast_mask)
    with span(timings, "deconseq.fast"):
        fast_out = _map_fast(src, bs, fc.frag_rows(fast_ids))
    with span(timings, "deconseq.general"):
        slow_out = _map_general(src, bs, fc.frag_rows(slow_ids), slice_memo)
    # merge preserving candidate order (admission determinism). Both
    # paths return ALIGNED lists (None where a candidate was dropped —
    # <2 fragments or ragged widths); filter after the merge.
    merged: list = [None] * n
    for i, b in zip(fast_ids.tolist(), fast_out):
        merged[i] = b
    for i, b in zip(slow_ids.tolist(), slow_out):
        merged[i] = b
    return [b for b in merged if b is not None]
