"""npge_tpu_torch gapless extension vs the JAX reference: the same anchor
groups give the same CandidateBatch arrays, and the op-level chunk and
round loop give the reference's per-group extensions (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npge_tpu.algo import extender as ref_extender
from npge_tpu.algo.anchors import find_anchors as ref_find_anchors
from npge_tpu.config import default_config
from npge_tpu.ops import extend as ref_extend
from npge_tpu.util.synthetic import synthetic_arena
from npge_tpu_torch.algo.anchors import find_anchors
from npge_tpu_torch.algo.extender import extend_anchor_groups
from npge_tpu_torch.ops.extend import (
    bases_for_groups, extend_chunk, extend_rounds, make_codes2,
)
from torch_carry import port_arena, port_config


@pytest.mark.parametrize("split_tail", [False, True])
def test_candidates_match_reference(split_tail):
    """Port CandidateBatch == reference CandidateBatch, array for array,
    with the reference's split-tail path forced on and off."""
    arena = synthetic_arena(
        n_genomes=3, length=20_000, seed=19, sub_rate=0.004,
        indel_rate=0.0004, n_inversions=2,
    )
    cfg = default_config().replace(EXTEND_CHUNK=128, MAX_EXTEND=1024)
    ref_groups = ref_find_anchors(arena, cfg)
    old = ref_extender._SPLIT_TAIL_MIN_GROUPS[0]
    try:
        ref_extender._SPLIT_TAIL_MIN_GROUPS[0] = 1 if split_tail else 1 << 60
        want = ref_extender.extend_anchor_groups(arena, ref_groups, cfg)
    finally:
        ref_extender._SPLIT_TAIL_MIN_GROUPS[0] = old
    parena, pcfg = port_arena(arena), port_config(cfg)
    groups = find_anchors(parena, pcfg, "cpu")
    got = extend_anchor_groups(parena, groups, pcfg, "cpu")
    assert len(want) > 100
    for attr in ("offsets", "seq", "start", "length", "ori"):
        np.testing.assert_array_equal(
            getattr(got, attr), getattr(want, attr), err_msg=attr
        )


def test_extend_chunk_matches_reference():
    """extend_chunk == the reference's byte-gather extend_chunk on random
    inputs with N codes, carries, and windows straddling the arena end."""
    rng = np.random.default_rng(7)
    T = 3000
    codes = rng.integers(0, 5, T, dtype=np.uint8)
    codes2_ref = ref_extend.make_codes2(jnp.asarray(codes))
    codes2 = make_codes2(torch.from_numpy(codes))
    np.testing.assert_array_equal(codes2.numpy(), np.asarray(codes2_ref))
    for chunk in (64, 256):
        B, F = 16, 3
        base = rng.integers(0, 2 * T, (B, F)).astype(np.int32)
        base[0] = 2 * T - chunk // 2
        fmask = rng.random((B, F)) < 0.8
        fmask[:, 0] = True
        cap = rng.integers(0, chunk + 1, (B, F)).astype(np.int32)
        cl = rng.integers(0, 100, B).astype(np.int32)
        ci = (cl * 9) // 10
        want = ref_extend.extend_chunk(
            codes2_ref, jnp.asarray(base), jnp.asarray(fmask),
            jnp.asarray(cap), jnp.asarray(cl), jnp.asarray(ci), 9, 10, chunk,
        )
        got = extend_chunk(
            codes2, torch.from_numpy(base.astype(np.int64)),
            torch.from_numpy(fmask), torch.from_numpy(cap),
            torch.from_numpy(cl), torch.from_numpy(ci), 9, 10, chunk,
        )
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_extend_rounds_matches_reference_host_loop():
    """The freeze-rule round loop == the reference's extend_side host
    loop, including groups that run through several chunks."""
    rng = np.random.default_rng(21)
    T = 6000
    codes = rng.integers(0, 4, T).astype(np.uint8)
    codes[3000:3800] = codes[200:1000]  # planted repeat spanning chunks
    B, F, chunk, max_rounds = 12, 2, 128, 6
    lo = rng.integers(100, T - 1500, (B, F)).astype(np.int64)
    lo[0] = [250, 3050]
    ori = np.where(rng.random((B, F)) < 0.5, -1, 1).astype(np.int64)
    ori[0] = 1
    fmask = np.ones((B, F), bool)
    cr = rng.integers(0, 700, (B, F)).astype(np.int32)
    cr[0] = 700
    _, base_r = bases_for_groups(lo, lo + 15, ori, T)
    want = ref_extend.extend_side(
        ref_extend.make_codes2(jnp.asarray(codes)),
        jnp.asarray(base_r.astype(np.int32)), jnp.asarray(fmask), cr,
        9, 10, chunk, max_rounds,
    )
    got, rounds = extend_rounds(
        make_codes2(torch.from_numpy(codes)), torch.from_numpy(base_r),
        torch.from_numpy(fmask), torch.from_numpy(cr), 9, 10, chunk,
        max_rounds,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) > chunk and rounds > 1
