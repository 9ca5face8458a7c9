# mirrors npge_tpu/model/naming.py
"""Canonical block naming: ``<type><nFragments>x<length>``.

Equivalent of the reference's ``UniqueNames`` processor ⚠[B] (SURVEY.md
§2.3). Type letters (the exact letter set is tier [C] — verify against the
reference when mounted):

    s — stem:   exactly one fragment in *every* genome
    h — half:   at most one fragment per genome, but not all genomes
    r — repeat: some genome contributes >= 2 fragments
    u — unique: single-fragment block

Name collisions are disambiguated with an appended ``n<k>`` counter,
assigned in the blockset's canonical order (deterministic).
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.model.blocks import Block, BlockSet


def block_type(block: Block, genome_of_seq: np.ndarray, n_genomes: int) -> str:
    if block.n_frags <= 1:
        return "u"
    g = genome_of_seq[block.frags.seq_id]
    counts = np.bincount(g, minlength=n_genomes)
    if (counts > 1).any():
        return "r"
    if (counts == 1).all():
        return "s"
    return "h"


def assign_names(bs: BlockSet) -> None:
    """Assign canonical unique names to all blocks (in canonical order)."""
    bs.canonicalize()
    genome_of_seq = bs.arena.genome_id_of_seq()
    n_genomes = len(bs.arena.genomes())
    used: dict[str, int] = {}
    for b in bs.blocks:
        base = f"{block_type(b, genome_of_seq, n_genomes)}{b.n_frags}x{b.n_cols}"
        k = used.get(base, 0)
        used[base] = k + 1
        b.name = base if k == 0 else f"{base}n{k}"
