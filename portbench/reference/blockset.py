"""Plain checks of a pangenome's guarantees, in NumPy, and its digest.

The yardstick for the program's answer. It imports nothing of the program
and reads the answer as plain arrays: per block, its fragments
(sequence, start, length, strand) and its alignment rows (a uint8 matrix
with gap code 5, or None for a gapless block, whose rows are the fragments'
texts).

The guarantees checked, over linear sequences:
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


def fragment_text(codes, offsets, seq, start, length, ori) -> np.ndarray | None:
    """The fragment's text, or None when it leaves its sequence."""
    lo = int(offsets[seq]) + int(start)
    if start < 0 or length < 0 or lo + length > int(offsets[seq + 1]):
        return None
    s = codes[lo : lo + length]
    return COMP[s[::-1]] if ori == -1 else s


def partition_errors(offsets, blocks) -> int:
    """Bases covered by no fragment plus bases covered more than once."""
    T = int(offsets[-1])
    diff = np.zeros(T + 1, np.int64)
    outside = 0
    for frags, _rows in blocks:
        seq, start, length = frags[0], frags[1], frags[2]
        lo = offsets[seq] + start
        hi = lo + length
        bad = (start < 0) | (length <= 0) | (hi > offsets[seq + 1])
        outside += int(length[bad].clip(min=0).sum())
        np.add.at(diff, lo[~bad], 1)
        np.add.at(diff, hi[~bad], -1)
    cover = np.cumsum(diff[:-1])
    return int((cover != 1).sum()) + outside


def block_rows(codes, offsets, frags, rows):
    """The block's alignment rows: its own, or for a gapless block its
    fragments' texts; None when a fragment leaves its sequence or the
    fragments of a gapless block are not all as long."""
    seq, start, length, ori = frags
    if rows is not None:
        return rows
    texts = [fragment_text(codes, offsets, seq[i], start[i], length[i], ori[i])
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


def block_fault(codes, offsets, frags, rows, min_length, min_end, num, den):
    """None for a sound block, else what breaks a guarantee."""
    seq, start, length, ori = frags
    texts = []
    for i in range(len(seq)):
        t = fragment_text(codes, offsets, seq[i], start[i], length[i], ori[i])
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


def bad_blocks(codes, offsets, blocks, min_length, min_end, num, den):
    """(count, first few faults) of blocks that break a guarantee."""
    faults = []
    for frags, rows in blocks:
        f = block_fault(codes, offsets, frags, rows, min_length, min_end, num, den)
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
