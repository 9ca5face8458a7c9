# mirrors npge_tpu/util/synthetic.py
"""Synthetic genome generator with planted homology.

Development/test data source while the reference's bundled Brucella example is
unavailable (SURVEY.md §0, §4): derive n genomes from one random ancestor by
substitutions, short indels, and optional segment inversions, so the true
homology structure is known by construction and anchor/extension/partition
stages have realistic (~MIN_IDENTITY) signal. Fully deterministic per seed.
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.model.arena import GenomeArena


def random_ancestor(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)


def mutate(
    rng: np.random.Generator,
    seq: np.ndarray,
    sub_rate: float = 0.01,
    indel_rate: float = 0.0005,
    max_indel: int = 5,
    n_inversions: int = 0,
    min_inv: int = 300,
    max_inv: int = 2000,
) -> np.ndarray:
    """Apply substitutions, short indels, and large inversions to a copy."""
    seq = seq.copy()
    n = len(seq)
    # substitutions: code -> (code + shift) % 4, shift in {1,2,3}
    subs = rng.random(n) < sub_rate
    shifts = rng.integers(1, 4, size=n).astype(np.uint8)
    seq = np.where(subs, (seq + shifts) % 4, seq).astype(np.uint8)
    # inversions (reverse complement of a random segment)
    for _ in range(n_inversions):
        ln = int(rng.integers(min_inv, max_inv + 1))
        if ln >= len(seq):
            continue
        st = int(rng.integers(0, len(seq) - ln))
        seg = seq[st : st + ln]
        seq[st : st + ln] = (3 - seg)[::-1]
    # indels: rebuild via piecewise copy
    if indel_rate > 0:
        sites = np.flatnonzero(rng.random(len(seq)) < indel_rate)
        if len(sites):
            parts = []
            prev = 0
            for pos in sites:
                parts.append(seq[prev:pos])
                ln = int(rng.integers(1, max_indel + 1))
                if rng.random() < 0.5:  # insertion
                    parts.append(
                        rng.integers(0, 4, size=ln, dtype=np.int64).astype(np.uint8)
                    )
                    prev = pos
                else:  # deletion
                    prev = min(pos + ln, len(seq))
            parts.append(seq[prev:])
            seq = np.concatenate(parts)
    return seq


def synthetic_arena(
    n_genomes: int = 2,
    length: int = 20000,
    seed: int = 0,
    sub_rate: float = 0.01,
    indel_rate: float = 0.0005,
    n_inversions: int = 0,
    circular: bool = False,
) -> GenomeArena:
    rng = np.random.default_rng(seed)
    anc = random_ancestor(rng, length)
    names, seqs = [], []
    flag = "c" if circular else "l"
    for i in range(n_genomes):
        names.append(f"GEN{i}&chr1&{flag}")
        seqs.append(
            mutate(
                rng,
                anc,
                sub_rate=sub_rate,
                indel_rate=indel_rate,
                n_inversions=n_inversions,
            )
        )
    return GenomeArena(names, seqs)
