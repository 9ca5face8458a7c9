"""npge_tpu_torch's ``_admit_python`` against the JAX package's on the same
candidates and occupancy, whatever backs the port's occupancy: independent
per-sequence arrays, views of one arena buffer with and without that
buffer passed, and views laid out otherwise (a longer buffer at an offset,
or the arena's length in another order), which must take the per-sequence
gather. The reference reads independent per-sequence arrays. The
candidates are a gapped block whose alignment holds the gap code and a
gapless one."""

import numpy as np
import pytest

from npge_tpu.algo import overlaps as ref_overlaps
from npge_tpu.config import default_config
from npge_tpu.model import blocks as ref_blocks
from npge_tpu.model import fragments as ref_fragments
from npge_tpu.model.arena import GenomeArena
from npge_tpu.util import codes as ref_codes
from npge_tpu.util.synthetic import synthetic_arena
from npge_tpu_torch.algo.overlaps import _admit_python
from npge_tpu_torch.model import blocks as port_blocks
from npge_tpu_torch.model import fragments as port_fragments
from npge_tpu_torch.util import codes as port_codes
from torch_carry import port_arena, port_config

CFG = default_config().replace(MIN_LENGTH=60, MIN_END=3)
# occupied (seq, start, stop) spans, both on sequence 1: columns 100-160
# of the gapped candidate, columns 151-201 of the gapless one
OCCUPIED = [(1, 200, 260), (1, 650, 700)]
ROWS = {
    "gapped": [(0, 100, 300, 1), (1, 100, 299, 1), (2, 100, 300, 1)],
    "gapless": [(0, 500, 300, 1), (1, 499, 300, 1), (2, 500, 300, 1)],
}


def _ref_arena():
    """Three sequences: 0 and 2 equal, 1 with base 350 deleted."""
    rng = np.random.default_rng(5)
    s0 = rng.integers(0, 4, 1000).astype(np.uint8)
    names = synthetic_arena(n_genomes=3, length=100, seed=1).names
    return GenomeArena(names, [s0, np.delete(s0, 350), s0.copy()])


def _candidates(arena, blocks, fragments, gap):
    """A gapped candidate over [100, 400) whose row 1 holds a gap at
    column 250, and a gapless one over [500, 800), in one package's
    classes."""
    s0, s1 = arena.seq_codes(0), arena.seq_codes(1)
    row1 = np.insert(s1[100:399], 250, gap)
    gapped = blocks.Block(
        fragments.FragmentTable.from_rows(ROWS["gapped"]),
        np.stack([s0[100:400], row1, s0[100:400]]),
    )
    gapless = blocks.Block(fragments.FragmentTable.from_rows(ROWS["gapless"]))
    return [gapped, gapless]


def _occupancy(arena, form: str):
    """The occupancy of ``OCCUPIED`` in the given form, and the buffer
    passed to ``_admit_python`` (None unless the form vouches for it)."""
    off = arena.offsets
    spans = [(int(off[s]), int(off[s + 1])) for s in range(arena.n_seqs)]
    total = arena.total_length
    buf = None
    if form in ("aligned", "aligned_passed"):
        whole = np.zeros(total, np.uint8)
        occ = [whole[a:e] for a, e in spans]
        if form == "aligned_passed":  # as resolve_overlaps does
            buf = whole
    elif form == "independent":
        occ = [np.zeros(e - a, np.uint8) for a, e in spans]
    elif form == "longer_at_offset":
        whole = np.zeros(total + 81, np.uint8)[64 : 64 + total]
        occ = [whole[a:e] for a, e in spans]
    else:  # "rotated": the arena's length, the sequences in order 1, 2, 0
        whole = np.zeros(total, np.uint8)
        occ, at = [None] * arena.n_seqs, 0
        for s in (1, 2, 0):
            n = spans[s][1] - spans[s][0]
            occ[s], at = whole[at : at + n], at + n
    for s, a, e in OCCUPIED:
        occ[s][a:e] = 1
    return occ, buf


def _pieces(accepted):
    return [
        (b.frags.seq_id.tolist(), b.frags.start.tolist(),
         b.frags.length.tolist(), b.frags.ori.tolist(),
         None if b.alignment is None else b.alignment.tobytes())
        for b in accepted
    ]


def _ref_admit():
    """The reference's admitted pieces and final occupancy, on independent
    per-sequence arrays."""
    arena = _ref_arena()
    cands = _candidates(arena, ref_blocks, ref_fragments, ref_codes.GAP)
    occ, _ = _occupancy(arena, "independent")
    accepted = []
    for b in cands:
        ref_overlaps._admit_python(b, arena, CFG, occ, accepted)
    return _pieces(accepted), occ


def _port_admit(form: str):
    arena = port_arena(_ref_arena())
    cands = _candidates(arena, port_blocks, port_fragments, port_codes.GAP)
    occ, buf = _occupancy(arena, form)
    accepted = []
    for b in cands:
        _admit_python(b, arena, port_config(CFG), occ, accepted, buf)
    return _pieces(accepted), occ


@pytest.mark.parametrize(
    "form",
    ["independent", "aligned", "aligned_passed", "longer_at_offset", "rotated"],
)
def test_admit_matches_reference_whatever_backs_occupancy(form):
    want, want_occ = _ref_admit()
    # the free column runs: gapped [0, 100) and [160, 300) (the gap column
    # 250 in the second), gapless [0, 151) and [201, 300)
    assert [p[1][0] for p in want] == [100, 260, 500, 701]
    assert [(np.frombuffer(p[4], np.uint8) == ref_codes.GAP).sum()
            for p in want[:2]] == [0, 1]
    got, got_occ = _port_admit(form)
    assert got == want
    for g, w in zip(got_occ, want_occ):
        np.testing.assert_array_equal(g, w)
