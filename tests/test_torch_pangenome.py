"""npge_tpu_torch build_pangenome (device="cpu") vs the JAX reference on
three worlds with the default gapped extension: equal canonical blockset
hashes, and a valid pangenome."""

import numpy as np
import pytest

from npge_tpu.algo.is_pangenome import check_is_pangenome
from npge_tpu.algo.pangenome import build_pangenome as ref_build
from npge_tpu.config import default_config
from npge_tpu.model.arena import GenomeArena
from npge_tpu.model.hashing import blockset_hash
from npge_tpu.util.synthetic import synthetic_arena
from npge_tpu_torch.algo.pangenome import build_pangenome

# hash of the 5 x 20 kb circular world recorded by the JAX package's
# 8-device dry run (equal to its single-device build)
MULTICHIP_HASH = 14129187163991902977


def small_cfg(**kw):
    return default_config().replace(
        ANCHOR_SIZE=17, MINIMIZER_WINDOW=8, MIN_LENGTH=60, MIN_END=3, **kw
    )


def _n_run_world() -> GenomeArena:
    arena = synthetic_arena(
        n_genomes=3, length=12_000, seed=31, sub_rate=0.006,
        indel_rate=0.0006,
    )
    rng = np.random.default_rng(31)
    seqs = []
    for i in range(arena.n_seqs):
        s = arena.seq_codes(i).copy()
        for _ in range(5):
            a = int(rng.integers(0, len(s) - 60))
            s[a : a + int(rng.integers(1, 60))] = 4
        seqs.append(s)
    return GenomeArena(arena.names, seqs)


WORLDS = {
    # linear genomes with indels; default GAPPED_FLANK = 512
    "linear_indels": lambda: (
        synthetic_arena(
            n_genomes=3, length=15_000, seed=23, sub_rate=0.005,
            indel_rate=0.0008,
        ),
        small_cfg(),
    ),
    # circular genomes with inversions (the JAX package's multi-device
    # dry run world and config)
    "multichip": lambda: (
        synthetic_arena(
            n_genomes=5, length=20_000, seed=11, sub_rate=0.004,
            indel_rate=0.0008, n_inversions=2, circular=True,
        ),
        small_cfg(MAX_LOOPS=2, GAPPED_FLANK=64),
    ),
    "n_runs": lambda: (_n_run_world(), small_cfg(GAPPED_FLANK=128)),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_build_matches_reference(world):
    arena, cfg = WORLDS[world]()
    assert cfg.GAPPED_EXTEND
    ref, _ = ref_build(arena, cfg)
    got, tm = build_pangenome(arena, cfg, "cpu")
    assert tm.counters["gapext_pairs"] > 0  # the SW pass ran
    assert tm.counters["gapext.sw_launches"] == 0  # plain version on CPU
    rep = check_is_pangenome(got, cfg)
    assert rep.ok, rep.messages
    if world == "multichip":
        assert blockset_hash(got) == MULTICHIP_HASH
    assert sum(1 for b in got.blocks if not b.is_gapless) > 0
    ref.canonicalize()
    got.canonicalize()
    assert blockset_hash(got) == blockset_hash(ref)
