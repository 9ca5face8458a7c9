"""npge_tpu_torch anchors vs the JAX reference: same arena in, equal
anchor groups out (exact; every value is an integer)."""

import numpy as np
import pytest
import torch

from npge_tpu.algo.anchors import find_anchors as ref_find_anchors
from npge_tpu.config import default_config
from npge_tpu.model.arena import GenomeArena
from npge_tpu.ops.kmers import find_anchor_occurrences as ref_occurrences
from npge_tpu.util.synthetic import mutate, random_ancestor, synthetic_arena
from npge_tpu_torch.algo.anchors import find_anchors
from npge_tpu_torch.ops.kmers import find_anchor_occurrences, kmer_scan


def _with_n_runs(arena: GenomeArena, seed: int) -> GenomeArena:
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(arena.n_seqs):
        s = arena.seq_codes(i).copy()
        for _ in range(4):
            a = int(rng.integers(0, len(s) - 40))
            s[a : a + int(rng.integers(1, 40))] = 4
        seqs.append(s)
    return GenomeArena(arena.names, seqs)


def _world(kind: str) -> GenomeArena:
    if kind == "linear":
        return synthetic_arena(
            n_genomes=3, length=5000, seed=5, sub_rate=0.01, indel_rate=0.0005
        )
    if kind == "nruns":
        return _with_n_runs(
            synthetic_arena(n_genomes=3, length=5000, seed=6), seed=6
        )
    if kind == "multiseq":
        rng = np.random.default_rng(7)
        c1, c2 = random_ancestor(rng, 3000), random_ancestor(rng, 2000)
        return GenomeArena(
            ["GA&chr1&l", "GA&chr2&l", "GB&chr1&l", "GB&chr2&l", "GC&chr1&l"],
            [mutate(rng, c1), mutate(rng, c2), mutate(rng, c1),
             mutate(rng, c2), mutate(rng, c1, n_inversions=1)],
        )
    assert kind == "circular"
    return synthetic_arena(
        n_genomes=3, length=4000, seed=8, sub_rate=0.01,
        n_inversions=1, circular=True,
    )


KINDS = ["linear", "nruns", "multiseq", "circular"]


@pytest.mark.parametrize("w", [1, 8])
@pytest.mark.parametrize("k", [13, 15, 17, 21, 31])
@pytest.mark.parametrize("kind", KINDS)
def test_find_anchors_matches_reference(kind, k, w):
    arena = _world(kind)
    cfg = default_config().replace(ANCHOR_SIZE=k, MINIMIZER_WINDOW=w)
    want = ref_find_anchors(arena, cfg)
    got = find_anchors(arena, cfg, "cpu")
    assert want.n_groups > 0
    assert got.k == want.k
    for attr in ("offsets", "pos", "seq_id", "strand"):
        np.testing.assert_array_equal(
            getattr(got, attr), getattr(want, attr), err_msg=attr
        )


@pytest.mark.parametrize("k,w", [(13, 1), (17, 8), (31, 8)])
def test_occurrences_keys_match_reference(k, w):
    """The sorted occurrence rows (key, position, strand) equal the
    reference's, with the int64 key equal to its (hi << 32) | lo."""
    arena = _with_n_runs(synthetic_arena(n_genomes=2, length=3000, seed=9), 9)
    h, l, pos, strand = ref_occurrences(
        arena.codes, None, k, w, offsets=arena.offsets
    )
    key, pos2, strand2 = find_anchor_occurrences(
        arena.codes, None, k, w, "cpu", offsets=arena.offsets
    )
    assert len(key) > 0
    want_key = (h.astype(np.int64) << 32) | l.astype(np.int64)
    np.testing.assert_array_equal(key, want_key)
    np.testing.assert_array_equal(pos2, pos)
    np.testing.assert_array_equal(strand2, strand)


def test_k32_is_refused():
    codes = torch.zeros(64, dtype=torch.uint8)
    sid = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        kmer_scan(codes, sid, 32)
