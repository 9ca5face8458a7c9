"""DeConSeq — map consensus-arena candidates back to genome space.

Copies of the two functions of ``npge_tpu/algo/conseq.py`` that reach the
reference's ``CandidateBatch`` (a jax module); here they test against the
port's own class. The general (gapped) mapping path comes from the
reference by import.
"""

from __future__ import annotations

import numpy as np

from npge_tpu.algo.conseq import _deconseq_general
from npge_tpu.model.blocks import Block, BlockSet
from npge_tpu.model.fragments import FragmentTable
from npge_tpu_torch.algo.extender import CandidateBatch


# mirrors npge_tpu/algo/conseq.py:_deconseq_fast
def _deconseq_fast(
    cand, cons_src: list[tuple[int, np.ndarray]], bs: BlockSet,
    assume_gapless: bool = False,
) -> list | None:
    """Vectorized DeConSeq when every candidate and every touched source
    block is gapless (the consensus column map is then the identity).
    Returns None when a source is gapped and ``assume_gapless`` is not
    set; otherwise a list aligned with ``cand`` (None where a candidate
    expands to fewer than 2 fragments)."""
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


# mirrors npge_tpu/algo/conseq.py:deconseq
def deconseq(
    cand, cons_src: list[tuple[int, np.ndarray]], bs: BlockSet,
    slice_memo: dict | None = None,
) -> list[Block]:
    """Map candidates found on the consensus arena back to genome space.
    Candidates whose touched source blocks are all gapless (and that are
    gapless themselves) take the vectorized path, the rest the per-piece
    general path; the merged result keeps candidate order."""
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
    if fast_mask.all():
        out = _deconseq_fast(cand, cons_src, bs, assume_gapless=True)
        return [b for b in out if b is not None]
    fast_ids = np.flatnonzero(fast_mask)
    slow_ids = np.flatnonzero(~fast_mask)
    sub_fast = (
        cand.select(fast_ids) if is_batch
        else [cand[int(i)] for i in fast_ids]
    )
    sub_slow = [cand[int(i)] for i in slow_ids]
    fast_out = (
        _deconseq_fast(sub_fast, cons_src, bs, assume_gapless=True)
        if len(sub_fast) else []
    )
    slow_out = (
        _deconseq_general(sub_slow, cons_src, bs, slice_memo)
        if sub_slow else []
    )
    # merge preserving candidate order (admission determinism)
    merged: list = [None] * n
    for i, b in zip(fast_ids, fast_out):
        merged[int(i)] = b
    for i, b in zip(slow_ids, slow_out):
        merged[int(i)] = b
    return [b for b in merged if b is not None]
