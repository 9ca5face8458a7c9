# mirrors npge_tpu/algo/filter.py
"""Filter — enforce block quality; extract the best "good slice".

Equivalent of the reference's ``Filter`` / ``LiteFilter``
(``src/algo/Filter.cpp`` ⚠[B], SURVEY.md §2.3): a good block has
length >= MIN_LENGTH, identity >= MIN_IDENTITY, and identical first/last
MIN_END columns; a failing block may be excised down to its best good
sub-slice. All threshold comparisons are exact integer arithmetic.

``best_good_slice`` finds the *longest* column window [c0, c1) whose
identity >= MIN_IDENTITY, whose first and last MIN_END columns are all
identical-and-gapless, and whose length >= MIN_LENGTH — O(n log n) via
prefix sums + running-min binary search (ties -> leftmost window,
deterministic).
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.config import Config
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import Block, normalize_wrap_starts
from npge_tpu_torch.model.stats import column_classes, is_good_block


def _window_all(x: np.ndarray, m: int) -> np.ndarray:
    """out[i] = x[i..i+m-1].all(); length n-m+1."""
    if m <= 1:
        return x.copy()
    c = np.cumsum(np.concatenate([[0], x.astype(np.int64)]))
    return (c[m:] - c[:-m]) == m


def best_good_slice(good_col: np.ndarray, cfg: Config) -> tuple[int, int] | None:
    """Longest [c0, c1) window meeting the good-block predicate, given the
    per-column identical-and-gapless bool array. None if no window exists."""
    n = len(good_col)
    m = max(1, min(cfg.MIN_END, n))
    minlen = max(cfg.MIN_LENGTH, m)
    if n < minlen:
        return None
    num, den = cfg.MIN_IDENTITY.num, cfg.MIN_IDENTITY.den
    wall = _window_all(good_col, m)  # [n-m+1]
    start_ok = np.flatnonzero(wall)            # l candidates
    end_ok = np.flatnonzero(wall) + m - 1      # r candidates (inclusive)
    if len(start_ok) == 0:
        return None
    w = den * good_col.astype(np.int64) - num
    P = np.concatenate([[0], np.cumsum(w)])  # P[i] = sum w[:i]
    Pl = P[start_ok]
    prefmin = np.minimum.accumulate(Pl)
    best_len, best = 0, None
    for r in end_ok:
        max_l = r - minlen + 1
        if max_l < start_ok[0]:
            continue
        # number of start candidates with l <= max_l
        hi = int(np.searchsorted(start_ok, max_l, side="right"))
        if hi == 0:
            continue
        target = P[r + 1]
        # first j in [0, hi) with prefmin[j] <= target;
        # prefmin is non-increasing; searchsorted needs ascending — negate
        j = int(np.searchsorted(-prefmin[:hi], -target, side="left"))
        if j >= hi:
            continue
        l = int(start_ok[j])
        length = r - l + 1
        if length > best_len:
            best_len, best = length, (l, r + 1)
    return best


def filter_block(block: Block, arena: GenomeArena, cfg: Config) -> Block | None:
    """Return the block itself if good, else its best good slice, else None.
    Unique (1-fragment) blocks pass through untouched."""
    if block.n_frags <= 1:
        return block
    if is_good_block(block, arena, cfg):
        return block
    ident, gapless = column_classes(block.rows(arena))
    sl = best_good_slice(ident & gapless, cfg)
    if sl is None:
        return None
    return normalize_wrap_starts(block.slice(*sl), arena)


def filter_blocks(blocks: list[Block], arena: GenomeArena, cfg: Config) -> list[Block]:
    out = []
    for b in blocks:
        fb = filter_block(b, arena, cfg)
        if fb is not None:
            out.append(fb)
    return out
