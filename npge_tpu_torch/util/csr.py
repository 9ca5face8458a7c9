# mirrors npge_tpu/util/csr.py
"""CSR gather — the one idiom behind every columnar group selection.

Candidate batches, flat candidate views and the extender's ragged->flat
assembly all need "the row indices of groups ``ids`` in a CSR layout";
keeping one implementation avoids divergent copies of the base+within
arithmetic (round-4 review finding)."""

from __future__ import annotations

import numpy as np


def csr_gather(offsets: np.ndarray, ids: np.ndarray):
    """(idx, sub_offsets): ``idx`` are the flat row indices of CSR groups
    ``ids`` concatenated in ids-order; ``sub_offsets`` is the CSR offsets
    array of the gathered selection (len(ids)+1)."""
    ids = np.asarray(ids, np.int64)
    offsets = np.asarray(offsets, np.int64)
    cnt = offsets[ids + 1] - offsets[ids]
    sub = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(cnt, out=sub[1:])
    idx = (
        np.repeat(offsets[ids], cnt)
        + np.arange(int(sub[-1]), dtype=np.int64)
        - np.repeat(sub[:-1], cnt)
    )
    return idx, sub
