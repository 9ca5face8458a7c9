# mirrors npge_tpu/algo/conseq.py
"""ConSeq / DeConSeq — search the compressed (consensus) representation.

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
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import Block, BlockSet, normalize_wrap_starts
from npge_tpu_torch.model.fragments import FragmentTable
from npge_tpu_torch.trace import span


def consensus_arena(
    bs: BlockSet,
    cache: dict | None = None,
    stats: dict | None = None,
) -> tuple[GenomeArena, list[tuple[int, np.ndarray]]]:
    """One consensus sequence per block (canonical block order).

    Returns (arena of consensus sequences, list of (block index, column map)
    per consensus sequence). Blocks with empty consensus are skipped.

    ``cache`` (id -> (block, cons, cmap)) carries per-block consensus rows
    across calls: blocks are immutable and the reseed loop preserves object
    identity for unchanged blocks, so successive rounds only recompute the
    consensus of blocks that actually changed (VERDICT r3 weak #3). Entries
    pin their block object, so ids cannot be recycled onto stale rows.
    """
    names, seqs, src = [], [], []
    for i, b in enumerate(bs.blocks):
        # unique gapless blocks (the per-round Rest fillers, fresh objects
        # every round) read their consensus straight from the arena — not
        # worth pinning in the cache
        cacheable = cache is not None and (
            b.n_frags >= 2 or b.alignment is not None
        )
        hit = cache.get(id(b)) if cacheable else None
        if hit is not None:
            cons, cmap = hit[1], hit[2]
            if stats is not None:
                stats["cache.cons_hit"] = stats.get("cache.cons_hit", 0) + 1
        else:
            cons, cmap = b.consensus_with_map(bs.arena)
            if cacheable:
                cache[id(b)] = (b, cons, cmap)
                if stats is not None:
                    stats["cache.cons_miss"] = (
                        stats.get("cache.cons_miss", 0) + 1
                    )
        if len(cons) == 0:
            continue
        names.append(f"cons{i}&b&l")
        seqs.append(cons)
        src.append((i, cmap))
    return GenomeArena(names, seqs), src


def _deconseq_fast(
    cand, cons_src: list[tuple[int, np.ndarray]], bs: BlockSet,
    assume_gapless: bool = False,
) -> list | None:
    """Vectorized DeConSeq for the common case: every candidate and every
    (touched) source block gapless. Returns None when any source is gapped
    and ``assume_gapless`` is not set (caller falls back to the general
    path). For a gapless source the consensus column map is the identity,
    so cons coords ARE alignment columns.

    Returns a list ALIGNED with ``cand`` — None where a candidate was
    dropped (fewer than 2 expanded fragments)."""
    from npge_tpu_torch.algo.extender import CandidateBatch

    blocks = bs.blocks
    srcs = [bi for bi, _ in cons_src]
    is_batch = isinstance(cand, CandidateBatch)
    if not assume_gapless:
        if any(blocks[bi].alignment is not None for bi in srcs):
            return None
        if not is_batch and any(not cb.is_gapless for cb in cand):
            return None
    if not len(cand):
        return []
    # source fragment tables, CSR over cons seq index
    nsrc = len(srcs)
    s_off = np.zeros(nsrc + 1, np.int64)
    np.cumsum([blocks[bi].n_frags for bi in srcs], out=s_off[1:])
    s_seq = np.concatenate([blocks[bi].frags.seq_id for bi in srcs])
    s_start = np.concatenate([blocks[bi].frags.start for bi in srcs])
    s_len = np.concatenate([blocks[bi].frags.length for bi in srcs])
    s_ori = np.concatenate([blocks[bi].frags.ori for bi in srcs])
    # flatten candidate fragments (free for a CandidateBatch)
    if is_batch:
        c_off = np.asarray(cand.offsets, np.int64)
        ci = np.asarray(cand.seq, np.int64)
        st = np.asarray(cand.start, np.int64)
        ln = np.asarray(cand.length, np.int64)
        o = np.asarray(cand.ori, np.int64)
    else:
        c_off = np.zeros(len(cand) + 1, np.int64)
        np.cumsum([cb.n_frags for cb in cand], out=c_off[1:])
        ci = np.concatenate([cb.frags.seq_id for cb in cand]).astype(np.int64)
        st = np.concatenate([cb.frags.start for cb in cand]).astype(np.int64)
        ln = np.concatenate([cb.frags.length for cb in cand]).astype(np.int64)
        o = np.concatenate([cb.frags.ori for cb in cand]).astype(np.int64)
    cid = np.repeat(np.arange(len(cand)), np.diff(c_off))
    # expand each candidate-fragment into its source block's fragments
    counts = (s_off[ci + 1] - s_off[ci]).astype(np.int64)
    rep = np.repeat(np.arange(len(ci)), counts)
    # index of the source fragment within the source block
    inner = np.arange(len(rep)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    sfi = s_off[ci[rep]] + inner
    c0 = st[rep]
    c1 = st[rep] + ln[rep]
    fo = s_ori[sfi].astype(np.int64)
    out_seq = s_seq[sfi]
    out_start = np.where(
        fo == 1, s_start[sfi] + c0, s_start[sfi] + s_len[sfi] - c1
    )
    # wrap sources (start+length > seq_len, circular) can push derived
    # starts past the origin; renormalize into [0, seq_len)
    seq_lens = (
        bs.arena.offsets[out_seq + 1] - bs.arena.offsets[out_seq]
    ).astype(np.int64)
    out_start = np.where(out_start >= seq_lens, out_start - seq_lens, out_start)
    out_len = c1 - c0
    out_ori = (fo * np.where(o[rep] == -1, -1, 1)).astype(np.int32)
    out_cid = cid[rep]
    # assemble per-candidate blocks (>= 2 fragments), aligned with cand
    out: list = [None] * len(cand)
    bounds = np.flatnonzero(np.diff(out_cid, prepend=-1, append=-2))
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        if b1 - b0 < 2:
            continue
        out[int(out_cid[b0])] = Block(
            FragmentTable(
                out_seq[b0:b1],
                out_start[b0:b1].astype(np.int32),
                out_len[b0:b1].astype(np.int32),
                out_ori[b0:b1],
            )
        )
    return out


def deconseq(
    cand, cons_src: list[tuple[int, np.ndarray]], bs: BlockSet,
    slice_memo: dict | None = None, timings=None,
) -> list[Block]:
    """Map candidate blocks found on the consensus arena back to genome
    space: a consensus fragment (cons_i, start, len, ori) expands to *all*
    fragments of source block i sliced to the enclosing alignment columns
    (orientation flips applied via Block.inverse). Pieces of one candidate
    concatenate column-wise into a single genome-space block.

    ``cand`` may be a list of Blocks or the extender's CandidateBatch.
    Candidates are split PER CANDIDATE: those whose touched source blocks
    are all gapless (and that are themselves gapless) run the fully
    vectorized fast path; only the rest pay the per-piece general path —
    at the 50-100-genome scales most candidates map through gapless
    uniques/stems, and the all-or-nothing split made one gapped source
    push every candidate onto the slow path (VERDICT r4 profiling).
    ``timings`` receives spans and counters ``deconseq.fast`` and
    ``deconseq.general``, the candidates by path."""
    from npge_tpu_torch.algo.extender import CandidateBatch

    n = len(cand)
    if n == 0:
        return []
    gapped_src = np.fromiter(
        (bs.blocks[bi].alignment is not None for bi, _ in cons_src),
        bool, len(cons_src),
    )
    is_batch = isinstance(cand, CandidateBatch)
    if is_batch:
        c_off = np.asarray(cand.offsets, np.int64)
        ci_all = np.asarray(cand.seq, np.int64)
        cand_gapless = np.ones(n, bool)
    else:
        nfr = np.fromiter((cb.n_frags for cb in cand), np.int64, n)
        c_off = np.zeros(n + 1, np.int64)
        np.cumsum(nfr, out=c_off[1:])
        ci_all = (
            np.concatenate([cb.frags.seq_id for cb in cand]).astype(np.int64)
            if n else np.zeros(0, np.int64)
        )
        cand_gapless = np.fromiter((cb.is_gapless for cb in cand), bool, n)
    frag_gapped = gapped_src[ci_all]
    cid = np.repeat(np.arange(n), np.diff(c_off))
    any_gapped = np.zeros(n, bool)
    np.logical_or.at(any_gapped, cid, frag_gapped)
    fast_mask = cand_gapless & ~any_gapped
    n_fast = int(fast_mask.sum())
    if timings is not None:
        timings.count("deconseq.fast", n_fast)
        timings.count("deconseq.general", n - n_fast)
    if n_fast == n:
        with span(timings, "deconseq.fast"):
            out = _deconseq_fast(cand, cons_src, bs, assume_gapless=True)
        return [b for b in out if b is not None]
    fast_ids = np.flatnonzero(fast_mask)
    slow_ids = np.flatnonzero(~fast_mask)
    with span(timings, "deconseq.fast"):
        sub_fast = (
            cand.select(fast_ids) if is_batch
            else [cand[int(i)] for i in fast_ids]
        )
        fast_out = (
            _deconseq_fast(sub_fast, cons_src, bs, assume_gapless=True)
            if len(sub_fast) else []
        )
    with span(timings, "deconseq.general"):
        sub_slow = [cand[int(i)] for i in slow_ids]
        slow_out = _deconseq_general(sub_slow, cons_src, bs, slice_memo)
    # merge preserving candidate order (admission determinism). Both
    # paths return ALIGNED lists (None where a candidate was dropped —
    # <2 fragments or ragged widths); filter after the merge.
    merged: list = [None] * n
    for i, b in zip(fast_ids, fast_out):
        merged[int(i)] = b
    for i, b in zip(slow_ids, slow_out):
        merged[int(i)] = b
    return [b for b in merged if b is not None]


def _deconseq_general(
    cand: list[Block], cons_src: list[tuple[int, np.ndarray]], bs: BlockSet,
    slice_memo: dict | None = None,
) -> list:
    """Per-piece mapping path (gapped sources). Returns a list ALIGNED
    with ``cand`` — None where a candidate was dropped.

    ``slice_memo`` ((id(src block), c0, c1, ori) -> (src block, piece))
    carries sliced pieces across calls: source blocks are immutable and
    keep object identity across reseed rounds, and successive rounds map
    near-identical candidate sets — at the 100-genome scale the repeated
    slice/normalize/inverse chain dominated the reseed mapping cost.
    Entries pin the source block (id-alias safety); pieces are immutable
    and only ever read, so sharing one object across candidates is safe."""
    out: list = []
    for cb in cand:
        pieces: list[Block] = []
        ok = True
        for fi in range(cb.n_frags):
            ci, st, ln, o = cb.frags.row(fi)
            bi, cmap = cons_src[ci]
            src_block = bs.blocks[bi]
            c0, c1 = int(cmap[st]), int(cmap[st + ln - 1]) + 1
            mkey = (id(src_block), c0, c1, int(o))
            hit = slice_memo.get(mkey) if slice_memo is not None else None
            if hit is not None:
                piece = hit[1]
                if piece is None:
                    ok = False
                    break
                pieces.append(piece)
                continue
            piece = src_block.slice(c0, c1)
            if piece is not None:
                piece = normalize_wrap_starts(piece, bs.arena)
                if o == -1:
                    piece = piece.inverse()
            if slice_memo is not None:
                slice_memo[mkey] = (src_block, piece)
            if piece is None:
                ok = False
                break
            pieces.append(piece)
        if not ok or not pieces:
            out.append(None)
            continue
        widths = {p.n_cols for p in pieces}
        if len(widths) != 1:
            out.append(None)  # unequal-width gapped pieces: skip
            continue
        nf = sum(p.n_frags for p in pieces)
        if nf < 2:
            out.append(None)
            continue
        gapless = all(p.is_gapless for p in pieces)
        aln = (
            None if gapless
            else np.concatenate([p.rows(bs.arena) for p in pieces], axis=0)
        )
        # column-wise concat of the pieces' fragment tables (same order as
        # the per-row append it replaces; ~1M Block.frags.row calls per
        # reseed round at the 100-genome scale)
        ft = FragmentTable(
            np.concatenate([p.frags.seq_id for p in pieces]),
            np.concatenate([p.frags.start for p in pieces]),
            np.concatenate([p.frags.length for p in pieces]),
            np.concatenate([p.frags.ori for p in pieces]),
        )
        out.append(Block(ft, aln))
    return out
