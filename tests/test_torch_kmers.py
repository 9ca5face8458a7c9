"""npge_tpu_torch anchors vs the JAX reference: same arena in, equal
anchor groups out (exact; every value is an integer), for 1 <= k <= 32."""

import numpy as np
import pytest
import torch

from npge_tpu.algo.anchors import find_anchors as ref_find_anchors
from npge_tpu.algo.pangenome import build_pangenome as ref_build
from npge_tpu.config import default_config
from npge_tpu.model.arena import GenomeArena
from npge_tpu.model.hashing import blockset_hash
from npge_tpu.ops.kmers import find_anchor_occurrences as ref_occurrences
from npge_tpu.util.synthetic import mutate, random_ancestor, synthetic_arena
from npge_tpu_torch.algo.anchors import find_anchors
from npge_tpu_torch.algo.pangenome import build_pangenome
from npge_tpu_torch.model.hashing import blockset_hash as port_hash
from npge_tpu_torch.ops.kmers import (
    _KEY_FILL, _KEY_FLOOR, find_anchor_occurrences, kmer_scan,
)
from torch_carry import port_arena, port_config

# reference build of the k = 32 world below (3 x 5000 linear, seed 4)
K32_HASH = 0x53EE0976D143B7A1


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
@pytest.mark.parametrize("k", [13, 15, 17, 21, 31, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_find_anchors_matches_reference(kind, k, w):
    arena = _world(kind)
    cfg = default_config().replace(ANCHOR_SIZE=k, MINIMIZER_WINDOW=w)
    want = ref_find_anchors(arena, cfg)
    got = find_anchors(port_arena(arena), port_config(cfg), "cpu")
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
    """k = 32 is the widest key the scan takes: 0 and 33 are refused."""
    codes = torch.zeros(64, dtype=torch.uint8)
    sid = torch.zeros(64, dtype=torch.int32)
    for k in (0, 33):
        with pytest.raises(ValueError):
            kmer_scan(codes, sid, k)


def _with_homopolymers(arena: GenomeArena, seed: int) -> GenomeArena:
    """All-A and all-T runs longer than 32 (the k = 32 key extremes) and N
    runs planted in every sequence."""
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(arena.n_seqs):
        s = arena.seq_codes(i).copy()
        for base in (0, 3, 0, 3, 4, 4):
            a = int(rng.integers(0, len(s) - 80))
            s[a : a + int(rng.integers(20, 80))] = base
        seqs.append(s)
    return GenomeArena(arena.names, seqs)


@pytest.mark.parametrize("w", [1, 8])
def test_occurrences_k32_match_reference(w):
    """At k = 32 the int64 key, with its top bit flipped back, equals the
    reference's (hi, lo) pair as one unsigned 64-bit value."""
    arena = _with_homopolymers(
        synthetic_arena(n_genomes=3, length=3000, seed=10), 10
    )
    h, l, pos, strand = ref_occurrences(
        arena.codes, None, 32, w, offsets=arena.offsets
    )
    key, pos2, strand2 = find_anchor_occurrences(
        arena.codes, None, 32, w, "cpu", offsets=arena.offsets
    )
    want = (h.astype(np.uint64) << np.uint64(32)) | l.astype(np.uint64)
    got = key.view(np.uint64) ^ np.uint64(1 << 63)
    assert (want == 0).sum() > 3  # all-A windows, the smallest key
    assert (want >> np.uint64(63)).any()  # keys with the top bit set
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pos2, pos)
    np.testing.assert_array_equal(strand2, strand)


def test_k32_key_extremes():
    """All-A is the smallest key (the window-max fill); all-T is never
    canonical, so no valid key reaches the window-min fill."""
    for base, strand in ((0, 1), (3, -1)):
        codes = torch.full((40,), base, dtype=torch.uint8)
        key, st, valid = kmer_scan(codes, torch.zeros(40, dtype=torch.int32), 32)
        assert int(valid.sum()) == 9
        assert (key[valid] == _KEY_FLOOR).all() and (st[valid] == strand).all()
    codes = torch.randint(0, 4, (4000,), generator=torch.Generator().manual_seed(3))
    key, _, valid = kmer_scan(
        codes.to(torch.uint8), torch.zeros(4000, dtype=torch.int32), 32
    )
    assert (key[valid] < _KEY_FILL).all()


def test_k32_build_matches_reference():
    arena = synthetic_arena(
        n_genomes=3, length=5000, seed=4, sub_rate=0.006, indel_rate=0.001,
        n_inversions=1,
    )
    cfg = default_config().replace(
        ANCHOR_SIZE=32, MIN_LENGTH=60, MIN_END=3, GAPPED_FLANK=64, MAX_LOOPS=2
    )
    ref, _ = ref_build(arena, cfg)
    got, tm = build_pangenome(port_arena(arena), port_config(cfg), "cpu")
    assert tm.counters["gapext_pairs"] > 0
    assert port_hash(got) == blockset_hash(ref) == K32_HASH
    assert len(got.blocks) == 16
