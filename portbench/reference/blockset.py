"""Plain checks of a pangenome's guarantees, in NumPy, and its digest.

The yardstick for the program's answer. It imports nothing of the program
and reads the answer as plain arrays: per block, its fragments
(sequence, start, length, strand) and its alignment rows (a uint8 matrix
with gap code 5, or None for a gapless block, whose rows are the fragments'
texts).

A fragment (sequence, start, length, strand) covers start .. start +
length - 1. On a circular sequence of length L (``circular``: a flag per
sequence, None for linear sequences only) a fragment with start < L and
start + length > L, at most L long, crosses the origin: it covers
start .. L - 1 and then 0 .. start + length - L - 1, and its text is read in
that order. On a linear sequence, and beyond those bounds, a fragment that
leaves its sequence is an error.

The guarantees checked:
  * partition: every base of every sequence lies in exactly one fragment;
  * rows: each alignment row, gaps removed, is its fragment's text (the
    reverse complement for strand -1), and a gapless block's fragments are
    all as long;
  * good blocks: a block of two or more fragments has at least
    ``min_length`` columns, its first and last ``min(min_end, columns)``
    columns are identical and gapless, and identical gapless columns /
    columns >= num / den (exact integers).
"""

from __future__ import annotations

import hashlib

import numpy as np

GAP = 5
COMP = np.array([3, 2, 1, 0, 4, 5], np.uint8)


def _crosses_ok(circular, seq, start, length, seq_len):
    """Whether fragments may cross the origin where they overrun: on a
    circular sequence, from a start inside it and at most its length
    long."""
    if circular is None:
        return np.zeros(np.shape(seq), bool)
    return np.asarray(circular, bool)[seq] & (start < seq_len) & (length <= seq_len)


def fragment_text(codes, offsets, seq, start, length, ori, circular=None) -> np.ndarray | None:
    """The fragment's text, or None when it leaves its sequence."""
    off, end = int(offsets[seq]), int(offsets[seq + 1])
    L = end - off
    if start < 0 or length < 0:
        return None
    over = int(start) + int(length) - L
    if over <= 0:
        s = codes[off + start : off + start + length]
    elif _crosses_ok(circular, seq, start, length, L):
        s = np.concatenate([codes[off + start : end], codes[off : off + over]])
    else:
        return None
    return COMP[s[::-1]] if ori == -1 else s


def partition_errors(offsets, blocks, circular=None) -> int:
    """Bases covered by no fragment plus bases covered more than once."""
    T = int(offsets[-1])
    diff = np.zeros(T + 1, np.int64)
    outside = 0
    for frags, _rows in blocks:
        seq, start, length = frags[0], frags[1], frags[2]
        off, end = offsets[seq], offsets[seq + 1]
        over = start + length - (end - off)
        cross = (over > 0) & _crosses_ok(circular, seq, start, length, end - off)
        bad = (start < 0) | (length <= 0) | ((over > 0) & ~cross)
        outside += int(length[bad].clip(min=0).sum())
        lo = off + start
        hi = np.where(cross, end, lo + length)
        np.add.at(diff, lo[~bad], 1)
        np.add.at(diff, hi[~bad], -1)
        # the part after the origin of a fragment that crosses it
        np.add.at(diff, off[cross], 1)
        np.add.at(diff, (off + over)[cross], -1)
    cover = np.cumsum(diff[:-1])
    return int((cover != 1).sum()) + outside


def block_rows(codes, offsets, frags, rows, circular=None):
    """The block's alignment rows: its own, or for a gapless block its
    fragments' texts; None when a fragment leaves its sequence or the
    fragments of a gapless block are not all as long."""
    seq, start, length, ori = frags
    if rows is not None:
        return rows
    texts = [fragment_text(codes, offsets, seq[i], start[i], length[i], ori[i], circular)
             for i in range(len(seq))]
    if any(t is None for t in texts) or len(set(int(x) for x in length)) > 1:
        return None
    return np.stack(texts) if texts else np.zeros((0, 0), np.uint8)


def good_columns(rows):
    """Columns that are gapless and one real base in every row."""
    return (rows != GAP).all(axis=0) & (rows == rows[:1]).all(axis=0) & (rows[0] < 4)


def good_fault(rows, min_length, min_end, num, den):
    """None when rows of two or more fragments make a good block, else the
    rule they break."""
    n = rows.shape[1]
    if n < min_length:
        return "shorter than MIN_LENGTH"
    good = good_columns(rows)
    m = min(min_end, n)
    if not (good[:m].all() and good[n - m :].all()):
        return "ends not identical"
    if int(good.sum()) * den < num * n:
        return "identity below MIN_IDENTITY"
    return None


def block_fault(codes, offsets, frags, rows, min_length, min_end, num, den,
                circular=None):
    """None for a sound block, else what breaks a guarantee."""
    seq, start, length, ori = frags
    texts = []
    for i in range(len(seq)):
        t = fragment_text(codes, offsets, seq[i], start[i], length[i], ori[i], circular)
        if t is None:
            return "fragment leaves its sequence"
        texts.append(t)
    if rows is None:
        if len(set(int(x) for x in length)) > 1:
            return "gapless block with unequal fragments"
        rows = np.stack(texts) if texts else np.zeros((0, 0), np.uint8)
    else:
        if rows.shape[0] != len(seq):
            return "alignment rows != fragments"
        for r, t in zip(rows, texts):
            if not np.array_equal(r[r != GAP], t):
                return "alignment row is not its fragment's text"
    if len(seq) < 2:
        return None
    return good_fault(rows, min_length, min_end, num, den)


def bad_blocks(codes, offsets, blocks, min_length, min_end, num, den,
               circular=None):
    """(count, first few faults) of blocks that break a guarantee."""
    faults = []
    for frags, rows in blocks:
        f = block_fault(codes, offsets, frags, rows, min_length, min_end, num, den,
                        circular)
        if f is not None:
            faults.append(f)
    return len(faults), faults[:3]


def digest(blocks) -> str:
    """sha256 of the blockset, independent of block and fragment order."""
    items = []
    for (seq, start, length, ori), rows in blocks:
        order = np.lexsort((ori, length, start, seq))
        f = np.stack([seq, start, length, ori], 1).astype(np.int64)[order]
        r = b"" if rows is None else np.ascontiguousarray(rows[order]).tobytes()
        items.append(f.tobytes() + b"|" + r)
    h = hashlib.sha256()
    for it in sorted(items):
        h.update(hashlib.sha256(it).digest())
    return h.hexdigest()
