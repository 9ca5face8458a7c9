"""The benchmark's worlds: genomes made from ``--seed``.

``random_ancestor`` and ``mutate`` are a frozen copy of the generator of the
program under test (``npge_tpu_torch/util/synthetic.py``), kept here so that
no later change to the program can move the benchmark's inputs. The tests
hold the copy to the arena digests of the reference's pinned worlds, so it
makes those worlds bit for bit.

A world is a configuration (genome count and length, linear or circular,
its chromosomes) under a traffic mix (substitution and indel rates,
inversions): one random ancestor, and each genome a mutated copy of it.
With ``chromosome_lengths`` (ints summing to ``genome_length``) the
ancestor is drawn whole and cut at their running sums, and each genome's
chromosome j is a mutated copy of the ancestor's piece j, drawn in
(genome, chromosome) order. With ``rotate_origins``, each circular
chromosome of each genome is then turned to start at an offset drawn
uniformly from its length by a generator of its own (the world's seed and
a fixed salt), as assemblies of one species each start their circles at
their own origin; the mutations are drawn as without it.

Where the traffic mix names a ``world_seed``, its genomes are made from
that seed and ``--seed`` lays them out in another order: every seed then
gives the pipeline the same genomes, so the same work (a world made from
each seed changes the number of re-seed rounds and SW pairs, and with them
a build's time, by up to 50 % on 100 x 50 kb). Without one, the genomes
are made from ``--seed``. The order moves whole genomes: a genome's
chromosomes stay together, in order.
"""

from __future__ import annotations

import numpy as np

# salt of the generator that draws the origins' offsets
ROTATE_SALT = 0x0415C1

# traffic keys that ``mutate`` takes, with their defaults
MUTATION_KEYS = {
    "sub_rate": 0.01, "indel_rate": 0.0005, "max_indel": 5,
    "n_inversions": 0, "min_inv": 300, "max_inv": 2000,
}


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
    """Substitutions, short indels and large inversions, on a copy."""
    seq = seq.copy()
    n = len(seq)
    # substitutions: code -> (code + shift) % 4, shift in {1, 2, 3}
    subs = rng.random(n) < sub_rate
    shifts = rng.integers(1, 4, size=n).astype(np.uint8)
    seq = np.where(subs, (seq + shifts) % 4, seq).astype(np.uint8)
    # inversions: the reverse complement of a random segment
    for _ in range(n_inversions):
        ln = int(rng.integers(min_inv, max_inv + 1))
        if ln >= len(seq):
            continue
        st = int(rng.integers(0, len(seq) - ln))
        seg = seq[st : st + ln]
        seq[st : st + ln] = (3 - seg)[::-1]
    # indels, rebuilt piece by piece
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


def make_world(config: dict, traffic: dict, seed: int):
    """(names, seqs) of the world of ``config`` under ``traffic`` at
    ``seed``: sequence names ``GEN<i>&chr<j>&l`` (``&c`` when circular; i
    numbers the genomes as they were made, j their chromosomes from 1) and
    uint8 base codes. The same seed gives the same world."""
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    kw = {key: traffic.get(key, default) for key, default in MUTATION_KEYS.items()}
    world_seed = traffic.get("world_seed", seed)
    rng = np.random.default_rng(world_seed)
    genome_length = int(config["genome_length"])
    chrom = [int(x) for x in config.get("chromosome_lengths", [genome_length])]
    if sum(chrom) != genome_length or min(chrom) <= 0:
        raise ValueError(f"chromosome_lengths {chrom} must be positive and "
                         f"sum to genome_length {genome_length}")
    anc = random_ancestor(rng, genome_length)
    pieces = np.split(anc, np.cumsum(chrom)[:-1])
    circular = bool(config.get("circular", False))
    flag = "c" if circular else "l"
    turn = None
    if circular and config.get("rotate_origins", False):
        turn = np.random.default_rng([world_seed, ROTATE_SALT])
    genomes = []
    for i in range(int(config["n_genomes"])):
        chroms = []
        for j, piece in enumerate(pieces):
            seq = mutate(rng, piece, **kw)
            if turn is not None:
                seq = np.roll(seq, -int(turn.integers(0, len(seq))))
            chroms.append((f"GEN{i}&chr{j + 1}&{flag}", seq))
        genomes.append(chroms)
    if "world_seed" in traffic:
        order = np.random.default_rng(seed).permutation(len(genomes))
        genomes = [genomes[i] for i in order]
    names = [name for g in genomes for name, _seq in g]
    seqs = [seq for g in genomes for _name, seq in g]
    return names, seqs


def concat(seqs) -> tuple[np.ndarray, np.ndarray]:
    """(codes, offsets) of the sequences laid end to end."""
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    codes = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    return codes.astype(np.uint8, copy=False), offsets
