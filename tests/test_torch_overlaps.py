"""npge_tpu_torch's overlap resolution against the JAX package's.

``resolve_overlaps``, its one C++ pass, on hand-made cases (gapped runs,
a gap-code column, dropped rows, one-row pieces, the good-slice fallback,
self-overlap, wraps, mixed lists) and on re-seed rounds recorded from CPU
builds: the same pieces in the same order as the reference's
``resolve_overlaps``, and whole admissions as the candidate objects
themselves."""

import numpy as np
import pytest

from npge_tpu.algo import overlaps as ref_overlaps
from npge_tpu.config import default_config
from npge_tpu.model import blocks as ref_blocks
from npge_tpu.model import fragments as ref_fragments
from npge_tpu.model.arena import GenomeArena
from npge_tpu.util import codes as ref_codes
from npge_tpu.util.synthetic import synthetic_arena
from npge_tpu_torch.model import blocks as port_blocks
from npge_tpu_torch.model import fragments as port_fragments
from torch_carry import port_arena, port_config

CFG = default_config().replace(MIN_LENGTH=60, MIN_END=3)


def _pieces(accepted):
    return [
        (b.frags.seq_id.tolist(), b.frags.start.tolist(),
         b.frags.length.tolist(), b.frags.ori.tolist(),
         None if b.alignment is None else b.alignment.tobytes())
        for b in accepted
    ]


# ---- resolve_overlaps against the reference, case by case. Five copies
# of one random sequence: 1 lacks base 1350 (linear world) or base 50
# (circular world), 3 is the reverse complement in the circular world.

def _world(circular: bool):
    rng = np.random.default_rng(14)
    s0 = rng.integers(0, 4, 3000).astype(np.uint8)
    s1 = np.delete(s0, 50 if circular else 1350)
    s3 = ref_codes.revcomp(s0) if circular else s0.copy()
    kind = "c" if circular else "l"
    names = [f"G{i}&chr1&{kind}" for i in range(5)]
    return GenomeArena(names, [s0, s1, s0.copy(), s3, s0.copy()])


def _aligned(arena, rows, gaps):
    """A gapped block's (rows, alignment): row r's text with GAP at the
    columns ``gaps.get(r, ())``."""
    texts = [arena.fragment_codes(*row) for row in rows]
    n = len(texts[0]) + len(gaps.get(0, ()))
    aln = np.full((len(rows), n), ref_codes.GAP, np.uint8)
    for r, t in enumerate(texts):
        keep = np.ones(n, bool)
        keep[list(gaps.get(r, ()))] = False
        aln[r, keep] = t
    return rows, aln


def _gapless(*rows):
    return list(rows), None


RESOLVE_CASES = {
    # a 4-row blocker on columns 100-160 cuts the gapped candidate into
    # [0, 100) and [160, 600); the second holds row 1's gap at column 350
    "occupancy_runs": (False, lambda a: [
        _gapless(*[(s, 1100, 60, 1) for s in (0, 2, 3, 4)]),
        _aligned(a, [(0, 1000, 600, 1), (1, 1000, 599, 1), (2, 1000, 600, 1)],
                 {1: [350]}),
    ]),
    # a gapped candidate whose row 1 holds the gap code at column 250 (the
    # deleted base 1350) and a gapless one, both on rows 0-2, cut by 4-row
    # blockers: the first on columns 100-160 of the gapped, the second on
    # columns 151-211 of the gapless (row 1 starts one base early there)
    "blocked_pair": (False, lambda a: [
        _gapless(*[(s, 1200, 60, 1) for s in (1, 2, 3, 4)]),
        _gapless((1, 1650, 60, 1), *[(s, 1651, 60, 1) for s in (2, 3, 4)]),
        _aligned(a, [(0, 1100, 300, 1), (1, 1100, 299, 1), (2, 1100, 300, 1)],
                 {1: [250]}),
        _gapless((0, 1500, 300, 1), (1, 1499, 300, 1), (2, 1500, 300, 1)),
    ]),
    # row 1 has no base in the run [0, 80), which drops it; the run
    # [145, 300) starts on its gaps and falls back to the good slice
    "row_without_base": (False, lambda a: [
        _gapless(*[(s, 1080, 65, 1) for s in (0, 2, 3, 4)]),
        _aligned(a, [(0, 1000, 300, 1), (1, 1150, 150, 1), (2, 1000, 300, 1)],
                 {1: range(150)}),
    ]),
    # only row 0 has bases in the run [80, 200): a piece of one row
    "one_row_left": (False, lambda a: [
        _gapless(*[(s, 1020, 60, 1) for s in (0, 3, 4)]),
        _aligned(a, [(0, 1000, 200, 1), (2, 1000, 60, 1)],
                 {1: range(60, 200)}),
    ]),
    # row 1's gap sits 40 columns after its deletion: the whole candidate
    # fails identity and only its best good slice is admitted
    "fallback_slice": (False, lambda a: [
        _aligned(a, [(0, 1200, 200, 1), (1, 1200, 199, 1), (2, 1200, 200, 1)],
                 {1: [190]}),
    ]),
    # rows 0 and 1 overlap on sequence 0: rejected whole, leaving its
    # positions to the gapless candidate after it
    "self_overlap": (False, lambda a: [
        _aligned(a, [(0, 1000, 100, 1), (0, 1050, 100, 1), (2, 1000, 100, 1)],
                 {}),
        _gapless((0, 1000, 100, 1), (4, 1000, 100, 1)),
    ]),
    # a gapless candidate across the origin, cut by a blocker to columns
    # [100, 300), which start past the end and wrap round to 0
    "wrap_gapless": (True, lambda a: [
        _gapless((0, 2940, 60, 1), (1, 2939, 60, 1), (2, 2940, 60, 1),
                 (4, 2940, 60, 1)),
        _gapless((0, 2900, 300, 1), (2, 2900, 300, 1), (4, 2900, 300, 1)),
    ]),
    # a gapped candidate across the origin, row 3 reverse, cut by a
    # 5-row blocker to columns [0, 220)
    "wrap_gapped": (True, lambda a: [
        _gapless((0, 120, 65, 1), (1, 119, 65, 1), (2, 120, 65, 1),
                 (3, 2815, 65, -1), (4, 120, 65, 1)),
        _aligned(a, [(0, 2900, 300, 1), (1, 2899, 299, 1), (2, 2900, 300, 1),
                     (3, 2800, 300, -1)], {1: [150]}),
    ]),
    # gapless and gapped candidates alternate in admission order (5, 4,
    # 3 and 2 rows), apart from one another
    "alternating": (False, lambda a: [
        _aligned(a, [(0, 1000, 200, 1), (2, 1000, 200, 1)], {}),
        _gapless(*[(s, 200, 100, 1) for s in (0, 1, 2, 3, 4)]),
        _gapless(*[(s, 2000, 100, 1) for s in (0, 2, 4)]),
        _aligned(a, [(0, 1200, 600, 1), (1, 1200, 599, 1), (2, 1200, 600, 1),
                     (3, 1200, 600, 1)], {1: [150]}),
    ]),
}
# pieces admitted, each as (rows, the candidate it is, or None), per case
RESOLVE_WANT = {
    # the gapped runs [0, 100) and [160, 300), the second with the gap
    # column, and the gapless runs [0, 151) and [211, 300)
    "blocked_pair": [(4, 0), (4, 1), (3, None), (3, None), (3, None),
                     (3, None)],
    "occupancy_runs": [(4, 0), (3, None), (3, None)],
    "row_without_base": [(4, 0), (2, None), (3, None)],
    "one_row_left": [(3, 0), (1, None)],
    "fallback_slice": [(3, None)],
    "self_overlap": [(2, 1)],
    "wrap_gapless": [(4, 0), (3, None)],
    "wrap_gapped": [(5, 0), (4, None)],
    "alternating": [(5, 1), (4, 3), (3, 2), (2, 0)],
}


def _made(specs, blocks, fragments):
    return [
        blocks.Block(fragments.FragmentTable.from_rows(rows),
                     None if aln is None else aln.copy())
        for rows, aln in specs
    ]


def _resolved(accepted, cands):
    """The admitted pieces, and for each the index of the candidate
    OBJECT it is (None for a new block)."""
    ids = {id(b): i for i, b in enumerate(cands)}
    return _pieces(accepted), [ids.get(id(b)) for b in accepted]


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_native_matches_python_and_reference(case):
    from npge_tpu_torch.algo.overlaps import resolve_overlaps
    from npge_tpu_torch.trace import StageTimings

    circular, make = RESOLVE_CASES[case]
    ref_arena = _world(circular)
    specs = make(ref_arena)
    ref_cands = _made(specs, ref_blocks, ref_fragments)
    want = _resolved(
        ref_overlaps.resolve_overlaps(ref_cands, ref_arena, CFG),
        ref_cands,
    )
    assert [(len(p[0]), i) for p, i in zip(*want)] == RESOLVE_WANT[case]
    arena, cfg = port_arena(ref_arena), port_config(CFG)
    cands = _made(specs, port_blocks, port_fragments)
    t = StageTimings()
    got = resolve_overlaps(cands, arena, cfg, timings=t)
    assert _resolved(got, cands) == want
    c = t.counters
    n_gapped = sum(
        aln is not None
        or any(st + ln > arena.seq_len(s) for s, st, ln, _ in rows)
        for rows, aln in specs
    )
    assert c["resolve.native_calls"] == 1
    assert c["resolve.native_cands"] == len(specs)
    assert c["resolve.native_gapped_cands"] == n_gapped


RESEED_WORLDS = {
    "divergent": dict(n_genomes=4, length=12_000, seed=7, sub_rate=0.02,
                      indel_rate=0.003),
    "circular": dict(n_genomes=6, length=8_000, seed=3, sub_rate=0.01,
                     indel_rate=0.002, n_inversions=1, circular=True),
}


@pytest.mark.parametrize("world", sorted(RESEED_WORLDS))
def test_reseed_round_input_matches_reference(world, monkeypatch):
    """The first re-seed round's resolve input recorded from a CPU build
    (the blockset's multi-fragment blocks, gapped ones among them, and the
    mapped candidates): the native pass gives the reference's pieces,
    whole admissions as the same objects, and cuts some gapped candidate; the build makes one native call per resolve."""
    from npge_tpu_torch.algo import pangenome
    from npge_tpu_torch.algo.overlaps import resolve_overlaps

    ref_arena = synthetic_arena(**RESEED_WORLDS[world])
    ref_cfg = default_config().replace(
        ANCHOR_SIZE=17, MINIMIZER_WINDOW=8, MIN_LENGTH=60, MIN_END=3,
    )
    arena, cfg = port_arena(ref_arena), port_config(ref_cfg)
    inputs = []

    def recording(cand, *a, **kw):
        inputs.append(cand)
        return resolve_overlaps(cand, *a, **kw)

    monkeypatch.setattr(pangenome, "resolve_overlaps", recording)
    _, t = pangenome.build_pangenome(arena, cfg, "cpu")
    assert t.counters["resolve.native_calls"] == len(inputs) > 1
    cands = next(c for c in inputs if isinstance(c, list))
    ref_cands = [
        ref_blocks.Block(
            ref_fragments.FragmentTable(
                b.frags.seq_id, b.frags.start, b.frags.length, b.frags.ori),
            None if b.alignment is None else b.alignment.copy(),
        )
        for b in cands
    ]
    want = _resolved(
        ref_overlaps.resolve_overlaps(ref_cands, ref_arena, ref_cfg),
        ref_cands,
    )
    assert any(p[4] is not None and i is None for p, i in zip(*want))
    got = resolve_overlaps(cands, arena, cfg)
    assert _resolved(got, cands) == want
