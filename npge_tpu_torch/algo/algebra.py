# mirrors npge_tpu/algo/algebra.py
"""Blockset set algebra: Union / Subtract / Clear / Stem / OneByOne.

Equivalent of the reference's blockset-algebra processors
(``src/algo/Union.cpp``, ``Subtract.cpp``, ``Clear.cpp``, ``OneByOne.cpp``,
``Stem.cpp`` ⚠[B], SURVEY.md §2.3). All operate on host BlockSets sharing
one arena.
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.model.blocks import Block, BlockSet
from npge_tpu_torch.model.fragments import frag_spans
from npge_tpu_torch.model.naming import block_type


def _spans(bs: BlockSet, b: Block, fi: int):
    s, st, ln, _ = b.frags.row(fi)
    return s, frag_spans(st, ln, bs.arena.seq_len(s))


def union(target: BlockSet, other: BlockSet) -> BlockSet:
    """All blocks of both (same arena)."""
    if target.arena is not other.arena:
        raise ValueError("union requires a shared arena")
    return BlockSet(target.arena, list(target.blocks) + list(other.blocks))


def clear(target: BlockSet) -> BlockSet:
    return BlockSet(target.arena, [])


def _occ_of(bs: BlockSet) -> list[np.ndarray]:
    occ = [
        np.zeros(bs.arena.seq_len(i), dtype=bool)
        for i in range(bs.arena.n_seqs)
    ]
    for b in bs.blocks:
        for fi in range(b.n_frags):
            s, spans = _spans(bs, b, fi)
            for a0, a1 in spans:
                occ[s][a0:a1] = True
    return occ


def subtract(target: BlockSet, other: BlockSet) -> BlockSet:
    """Drop target blocks having any fragment overlapping other's blocks
    (the reference's Subtract removes overlapping content ⚠[B])."""
    occ = _occ_of(other)
    keep = []
    for b in target.blocks:
        hit = False
        for fi in range(b.n_frags):
            s, spans = _spans(target, b, fi)
            if any(occ[s][a0:a1].any() for a0, a1 in spans):
                hit = True
                break
        if not hit:
            keep.append(b)
    return BlockSet(target.arena, keep)


def one_by_one(target: BlockSet, other: BlockSet) -> BlockSet:
    """Add other's blocks into target one at a time, skipping any block that
    overlaps what target already holds (deterministic order)."""
    occ = _occ_of(target)
    out = list(target.blocks)
    for b in other.blocks:
        conflict = False
        for fi in range(b.n_frags):
            s, spans = _spans(target, b, fi)
            if any(occ[s][a0:a1].any() for a0, a1 in spans):
                conflict = True
                break
        if conflict:
            continue
        out.append(b)
        for fi in range(b.n_frags):
            s, spans = _spans(target, b, fi)
            for a0, a1 in spans:
                occ[s][a0:a1] = True
    return BlockSet(target.arena, out)


def subset_arena(bs: BlockSet, names: list[str]) -> BlockSet:
    """New BlockSet over a sub-arena of the named sequences, keeping blocks
    all of whose fragments lie on them (``SequencesFromOther`` parity ⚠[B]:
    copy sequences between blocksets)."""
    from npge_tpu_torch.model.arena import GenomeArena

    old_ids = [bs.arena.seq_id(n) for n in names]
    remap = {o: i for i, o in enumerate(old_ids)}
    arena = GenomeArena(
        list(names), [bs.arena.seq_codes(i).copy() for i in old_ids]
    )
    out = BlockSet(arena, [])
    for b in bs.blocks:
        if not all(int(s) in remap for s in b.frags.seq_id):
            continue
        f = b.frags
        nf = np.array([remap[int(s)] for s in f.seq_id], np.int32)
        from npge_tpu_torch.model.fragments import FragmentTable

        out.add(
            Block(
                FragmentTable(nf, f.start, f.length, f.ori),
                b.alignment,
                b.name,
            )
        )
    return out


def stem(bs: BlockSet, exact: bool = True) -> BlockSet:
    """Keep blocks with exactly one fragment in every genome (``Stem``
    with the ``exact`` option ⚠[B]); exact=False keeps blocks covering all
    genomes (repeats allowed)."""
    genome_of_seq = bs.arena.genome_id_of_seq()
    n_genomes = len(bs.arena.genomes())
    keep = []
    for b in bs.blocks:
        g = genome_of_seq[b.frags.seq_id]
        counts = np.bincount(g, minlength=n_genomes)
        if exact:
            ok = bool((counts == 1).all())
        else:
            ok = bool((counts >= 1).all())
        if ok:
            keep.append(b)
    return BlockSet(bs.arena, keep)
