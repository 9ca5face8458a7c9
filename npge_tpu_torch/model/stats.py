# mirrors npge_tpu/model/stats.py
"""Alignment-column classification and block identity.

Equivalent of the reference's ``block_stat`` (``src/model/block_stat.hpp``
⚠[B], SURVEY.md §2.1). The exact reference column-counting formula is tier
[C] (unverified — reference mount empty); the definition implemented here is:

  - a column is *gapless* if no row holds GAP;
  - a column is *identical* if all non-gap entries are equal and are a real
    base (N never matches anything, including N);
  - block identity = identical-and-gapless columns / total columns, kept as
    an exact integer rational (mirroring the reference's fixed-point Decimal
    determinism posture, SURVEY §2.4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from npge_tpu_torch.config import Config
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import Block
from npge_tpu_torch.util import codes as C


@dataclass(frozen=True)
class AlignmentStat:
    ident_nogap: int
    ident_gap: int
    noident_nogap: int
    noident_gap: int
    total: int
    gc_at: tuple[int, int]  # (#G+C, #A+T) over non-gap real bases

    @property
    def identity(self) -> tuple[int, int]:
        """(numerator, denominator) — exact."""
        return (self.ident_nogap, max(self.total, 1))


def column_classes(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(identical[bool, n_cols], gapless[bool, n_cols]) for a code matrix."""
    gapless = (rows != C.GAP).all(axis=0)
    # identical: all non-gap equal & real base. Compute min/max over non-gap.
    masked_hi = np.where(rows == C.GAP, np.uint8(0), rows)
    masked_lo = np.where(rows == C.GAP, np.uint8(C.N), rows)
    col_max = masked_hi.max(axis=0)
    col_min = masked_lo.min(axis=0)
    any_base = (rows != C.GAP).any(axis=0)
    identical = any_base & (col_min == col_max) & (col_max < C.N)
    return identical, gapless


def make_stat(block: Block, arena: GenomeArena) -> AlignmentStat:
    rows = block.rows(arena)
    if rows.size == 0:
        return AlignmentStat(0, 0, 0, 0, 0, (0, 0))
    ident, gapless = column_classes(rows)
    gc = int(((rows == C.G) | (rows == C.C)).sum())
    at = int(((rows == C.A) | (rows == C.T)).sum())
    return AlignmentStat(
        ident_nogap=int((ident & gapless).sum()),
        ident_gap=int((ident & ~gapless).sum()),
        noident_nogap=int((~ident & gapless).sum()),
        noident_gap=int((~ident & ~gapless).sum()),
        total=int(rows.shape[1]),
        gc_at=(gc, at),
    )


def block_identity(block: Block, arena: GenomeArena) -> tuple[int, int]:
    return make_stat(block, arena).identity


def is_good_block(block: Block, arena: GenomeArena, cfg: Config) -> bool:
    """The reference's "good block" predicate (Filter / IsPangenome ⚠[B]):
    length >= MIN_LENGTH, identity >= MIN_IDENTITY, first/last MIN_END
    columns identical-and-gapless. Unique (1-fragment) blocks are exempt."""
    if block.n_frags <= 1:
        return True
    n = block.n_cols
    if n < cfg.MIN_LENGTH:
        return False
    rows = block.rows(arena)
    ident, gapless = column_classes(rows)
    good_col = ident & gapless
    m = min(cfg.MIN_END, n)
    if not (good_col[:m].all() and good_col[-m:].all()):
        return False
    num, den = int(good_col.sum()), n
    # identity >= MIN_IDENTITY  <=>  num/den >= MIN_IDENTITY (exact ints)
    return cfg.MIN_IDENTITY.le_ratio(num, den)
