"""The consensus arena of the re-seed rounds, in NumPy.

Each round of the consensus re-seed searches one consensus sequence per
block of the blockset it starts from, in block order. A column's consensus
is its most frequent real base (ties to the smallest code, A < C < G < T),
or N where the column holds no real base, when its bases outnumber its gaps,
and a gap otherwise; gap columns are dropped. A block whose consensus is
empty adds no sequence.

Blocks are read as the arrays of ``check.plain_blocks``; a fragment that
crosses the origin of a circular sequence is read as ``blockset`` reads it.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.blockset import GAP, block_rows

N = 4


def consensus(rows: np.ndarray) -> np.ndarray:
    counts = np.stack([(rows == b).sum(axis=0) for b in range(4)])
    keep = (rows != GAP).sum(axis=0) * 2 > rows.shape[0]
    char = np.where(counts.max(axis=0) > 0, counts.argmax(axis=0), N).astype(np.uint8)
    return char[keep]


def block_consensus(codes, offsets, frags, rows, circular=None):
    """The block's consensus sequence, or None when its rows cannot be
    read."""
    rows = block_rows(codes, offsets, frags, rows, circular)
    return None if rows is None else consensus(rows)


def consensus_arena(conses):
    """(codes, offsets, source block of each sequence) of the consensus
    arena of blocks whose consensus sequences are ``conses``, in block
    order; None when one of them is None."""
    if any(c is None for c in conses):
        return None
    src = [i for i, c in enumerate(conses) if len(c)]
    seqs = [conses[i] for i in src]
    out_offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=out_offsets[1:])
    out_codes = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    return out_codes, out_offsets, np.array(src, np.int64)


def sequences_differing(want, codes, offsets, src) -> int:
    """Consensus sequences of the program's arena that are not the
    reference's, plus the difference in their number."""
    if want is None:
        return max(len(offsets) - 1, 1)
    w_codes, w_offsets, w_src = want
    n, m = len(w_offsets) - 1, len(offsets) - 1
    bad = abs(n - m)
    for i in range(min(n, m)):
        a = w_codes[w_offsets[i] : w_offsets[i + 1]]
        b = codes[offsets[i] : offsets[i + 1]]
        bad += not (w_src[i] == src[i] and np.array_equal(a, b))
    return bad


def block_keys(offsets, frags) -> list:
    """One bytes key a block: its fragments (sequence, start, length,
    strand) in order, as int64. ``frags``: four arrays over all blocks,
    ``offsets`` their CSR bounds."""
    table = np.ascontiguousarray(np.stack([np.asarray(a, np.int64) for a in frags], 1))
    return [table[offsets[i] : offsets[i + 1]].tobytes() for i in range(len(offsets) - 1)]


def mapped_back(cand, src, blocks, offsets=None, circular=None) -> list:
    """The genome-space blocks of the candidates found on a consensus arena
    whose fragments all lie on gapless blocks: each candidate fragment
    (consensus sequence, start, length, strand) stands for every fragment
    of its source block over the same columns, on the strand of both; a
    candidate that stands for fewer than two fragments gives nothing. Over
    a source fragment that crosses the origin of a circular sequence, a
    start that falls past the sequence's end lies that far past the
    origin: the sequence's length is taken off it. ``cand``: (offsets,
    seq, start, length, strand) arrays; ``src``: the source block of each
    consensus sequence; ``offsets``, ``circular``: the genomes' sequences
    (None for linear sequences only). One ``block_keys`` key a block."""
    offs, cseq, cstart, clen, cori = (np.asarray(a, np.int64) for a in cand)
    src = np.asarray(src, np.int64)
    nfr = np.array([len(blocks[b][0][0]) for b in src], np.int64)
    gapless = np.array([blocks[b][1] is None for b in src], bool)
    s_off = np.zeros(len(src) + 1, np.int64)
    np.cumsum(nfr, out=s_off[1:])
    s_frags = [np.concatenate([np.asarray(blocks[b][0][k], np.int64) for b in src])
               if len(src) else np.zeros(0, np.int64) for k in range(4)]
    s_seq, s_start, s_len, s_ori = s_frags
    counts = nfr[cseq]
    rep = np.repeat(np.arange(len(cseq)), counts)
    inner = np.arange(len(rep)) - np.repeat(np.cumsum(counts) - counts, counts)
    sfi = s_off[cseq[rep]] + inner
    st, ln = cstart[rep], clen[rep]
    fo = s_ori[sfi]
    start = np.where(fo == 1, s_start[sfi] + st, s_start[sfi] + s_len[sfi] - st - ln)
    ori = fo * np.where(cori[rep] == -1, -1, 1)
    if circular is not None:
        seq = s_seq[sfi]
        seq_len = np.diff(np.asarray(offsets, np.int64))[seq]
        start = np.where(np.asarray(circular, bool)[seq] & (start >= seq_len),
                         start - seq_len, start)
    # per candidate: its expanded fragments' bounds, and whether it is kept
    cid = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
    per_frag = np.bincount(cid, weights=counts, minlength=len(offs) - 1).astype(np.int64)
    all_gapless = np.bincount(cid, weights=~gapless[cseq], minlength=len(offs) - 1) == 0
    e_off = np.zeros(len(offs), np.int64)
    np.cumsum(per_frag, out=e_off[1:])
    keys = block_keys(e_off, (s_seq[sfi], start, ln, ori))
    keep = all_gapless & (per_frag >= 2)
    return [k for k, ok in zip(keys, keep) if ok]


def mapped_missing(want, got) -> int:
    """Blocks of ``want`` not among ``got`` (both ``block_keys``), each
    block of ``got`` matching one of ``want`` at most."""
    from collections import Counter

    have = Counter(got)
    missing = 0
    for b in want:
        if have[b] > 0:
            have[b] -= 1
        else:
            missing += 1
    return missing
