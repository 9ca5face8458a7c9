"""npge_tpu_torch's gapped extension against the JAX package's.

``native.gapext_paths``, the one C++ pass of path recovery (the fixed-query
NW, its traceback and the center-star merge of each job's rows), held job
by job against the reference's ``_nw_fixed_query`` and
``_merge_center_star``: hand-made cases, random pairs on 512-base flanks,
and a pass whose column buffer has to grow. Then the port's
``gapped_extend_blocks`` against the reference's on the worlds of
``tests/test_gapext.py``, and the pass's counters on a small indel build."""

import numpy as np
import pytest

from npge_tpu.algo import gapext as ref_gapext
from npge_tpu.config import default_config
from npge_tpu.model.arena import GenomeArena
from npge_tpu.model.blocks import Block as RefBlock
from npge_tpu.model.blocks import BlockSet as RefBlockSet
from npge_tpu.model.fragments import FragmentTable as RefFragments
from npge_tpu.util import codes as ref_codes
from npge_tpu_torch import native, synthetic_arena
from npge_tpu_torch.algo import gapext, pangenome
from npge_tpu_torch.model.blocks import Block, BlockSet
from npge_tpu_torch.model.fragments import FragmentTable
from npge_tpu_torch.util import codes as C
from torch_carry import port_arena, port_config

SCORES = (1, -2, -3)  # the default SW_MATCH, SW_MISMATCH, SW_GAP


def _seq(text):
    return ref_codes.encode(text)


def _rand(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


def _native(jobs, scores=SCORES):
    """Every (q, targets) job through one ``gapext_paths`` pass over a
    codes2 that holds the texts end to end: (each job's columns, dp pairs,
    dp cells, native calls)."""
    texts, q_base, t_base, pair_off, pos = [], [], [], [0], 0
    for q, targets in jobs:
        for text, bases in [(q, q_base)] + [(t, t_base) for t in targets]:
            bases.append(pos)
            texts.append(np.asarray(text, np.uint8))
            pos += len(text)
        pair_off.append(pair_off[-1] + len(targets))
    t_len = [len(t) for _q, ts in jobs for t in ts]
    cols, off, n_cols, dp_pairs, dp_cells, calls = native.gapext_paths(
        np.concatenate(texts), q_base, [len(q) for q, _t in jobs], pair_off,
        t_base, t_len, *scores, C.GAP,
    )
    out = [
        cols[off[k] : off[k + 1]].reshape(len(ts) + 1, n_cols[k])
        for k, (_q, ts) in enumerate(jobs)
    ]
    return out, dp_pairs, dp_cells, calls


def _reference(q, targets, scores=SCORES):
    return ref_gapext._merge_center_star(
        q, [ref_gapext._nw_fixed_query(q, t, *scores) for t in targets]
    )


def _exact(q, t):
    """The reference's exact-prefix predicate."""
    return len(t) >= len(q) and (q < 4).all() and np.array_equal(t[: len(q)], q)


def _check(jobs, scores=SCORES):
    got, dp_pairs, dp_cells, calls = _native(jobs, scores)
    for (q, targets), cols in zip(jobs, got):
        np.testing.assert_array_equal(cols, _reference(q, targets, scores))
    dp = [(len(q), len(t)) for q, ts in jobs for t in ts if not _exact(q, t)]
    assert dp_pairs == len(dp)
    assert dp_cells == sum((a + 1) * (b + 1) for a, b in dp)
    return calls


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    q = _rand(rng, 40)
    ins = _rand(rng, 5)
    if name == "exact_prefix":
        return q, [np.concatenate([q, _rand(rng, 20)]), q.copy()], SCORES
    if name == "target_shorter":
        return q, [q[:25].copy(), q[:39].copy()], SCORES
    if name == "empty_target":
        return q, [np.zeros(0, np.uint8)], SCORES
    if name == "n_codes":
        qn = q.copy()
        qn[[3, 10, 11]] = C.N
        tn = q.copy()
        tn[20] = C.N
        # an N never matches, not even an N
        return qn, [qn.copy(), tn, np.full(40, C.N, np.uint8)], SCORES
    if name == "repeat_ties":
        rep = _seq("AC" * 20)
        return rep, [_seq("AC" * 9 + "AC" * 10), _seq("AC" * 10 + "CA" + "AC" * 10),
                     _seq("A" + "CA" * 21)], SCORES
    if name == "mismatch_or_two_gaps":
        # a mismatch costs as much as a deletion and an insertion
        t = q.copy()
        t[[7, 30]] = (t[[7, 30]] + 1) % 4
        return q, [t, np.concatenate([t[:15], t[16:]])], (1, -2, -1)
    if name == "insertion_first":
        return q, [np.concatenate([ins, q])], SCORES
    if name == "insertion_last":
        return q, [np.concatenate([q[:-1], ins, q[-1:]])], SCORES
    if name == "one_fragment":
        return q, [np.concatenate([q[:12], ins[:2], q[12:30], q[33:]])], SCORES
    if name == "slot_widths_differ":
        return q, [
            np.concatenate([q[:10], ins[:2], q[10:]]),
            np.concatenate([q[:10], _rand(rng, 4), q[10:]]),
            np.concatenate([q[:20], ins[:3], q[20:]]),
            q.copy(),
            np.concatenate([q[:5], q[8:]]),
        ], SCORES
    raise KeyError(name)


CASES = (
    "exact_prefix", "target_shorter", "empty_target", "n_codes", "repeat_ties",
    "mismatch_or_two_gaps", "insertion_first", "insertion_last",
    "one_fragment", "slot_widths_differ",
)


@pytest.mark.parametrize("name", CASES)
def test_paths_match_the_reference(name):
    q, targets, scores = _case(name)
    # each pair alone (its path in full), then the job merged
    assert _check([(q, [t]) for t in targets] + [(q, targets)], scores) == 1


def test_paths_on_random_flanks():
    """240 pairs with short indels on 512-base flanks, in one pass: 120
    one-fragment jobs, then twelve jobs of ten fragments, each target
    window the advance plus 64 bases of slack."""
    rng = np.random.default_rng(16)

    def target(q):
        t = np.concatenate([q, _rand(rng, 64)])
        for _ in range(int(rng.integers(0, 4))):
            at, n = int(rng.integers(0, len(q))), int(rng.integers(1, 6))
            if rng.random() < 0.5:
                t = np.concatenate([t[:at], _rand(rng, n), t[at:]])
            else:
                t = np.concatenate([t[:at], t[at + n :]])
        subs = rng.random(len(t)) < 0.01
        t[subs] = (t[subs] + 1) % 4
        return t[: len(q) + 64]

    jobs = []
    for k in range(132):
        q = _rand(rng, 512 if k % 3 else int(rng.integers(4, 512)))
        jobs.append((q, [target(q) for _ in range(1 if k < 120 else 10)]))
    assert sum(len(ts) for _q, ts in jobs) == 240
    assert _check(jobs) == 1


def test_column_buffer_grows_once():
    """Eight fragments insert eight bases each in eight different slots:
    the first buffer, sized for insertions that share their slots, is
    short, and the second call fills the columns."""
    rng = np.random.default_rng(8)
    q = _rand(rng, 40)
    targets = [
        np.concatenate([q[: 4 * i + 2], _rand(rng, 8), q[4 * i + 2 :]])
        for i in range(8)
    ]
    assert _check([(q, targets)]) == 2


def test_paths_refuse_texts_outside_codes2():
    codes2 = np.zeros(100, np.uint8)
    with pytest.raises(ValueError):
        native.gapext_paths(codes2, [0], [10], [0, 1], [95], [10], *SCORES, C.GAP)
    with pytest.raises(ValueError):  # a job without pairs
        native.gapext_paths(codes2, [0], [10], [0, 0], [], [], *SCORES, C.GAP)


# ---- gapped_extend_blocks against the reference, on the worlds of
# tests/test_gapext.py

CFG = default_config().replace(MIN_END=5, MIN_LENGTH=50)


def _insertion_world():
    rng = np.random.default_rng(3)
    x, y, ins = _rand(rng, 400), _rand(rng, 400), _rand(rng, 5)
    arena = GenomeArena(["A&c&l", "B&c&l"], [np.concatenate([x, y]),
                                              np.concatenate([x, ins, y])])
    return arena, [[(0, 100, 100, 1), (1, 100, 100, 1)]]


def _rooms_world():
    s = _rand(np.random.default_rng(4), 1000)
    arena = GenomeArena(["A&c&l", "B&c&l"], [s, s.copy()])
    return arena, [[(0, 100, 200, 1), (1, 100, 200, 1)],
                   [(0, 320, 200, 1), (1, 320, 200, 1)]]


def _minus_world():
    s1 = _rand(np.random.default_rng(5), 600)
    arena = GenomeArena(["A&c&l", "B&c&l"], [s1, ref_codes.revcomp(s1).copy()])
    return arena, [[(0, 200, 100, 1), (1, 300, 100, -1)]]


def _blocksets(arena, blocks):
    def make(block_cls, frags_cls, set_cls, ar):
        return set_cls(ar, [block_cls(frags_cls(*map(list, zip(*rows))))
                            for rows in blocks])

    return (make(RefBlock, RefFragments, RefBlockSet, arena),
            make(Block, FragmentTable, BlockSet, port_arena(arena)))


def _same_blocks(ref_bs, port_bs):
    assert len(ref_bs.blocks) == len(port_bs.blocks)
    for rb, pb in zip(ref_bs.blocks, port_bs.blocks):
        for f in ("seq_id", "start", "length", "ori"):
            np.testing.assert_array_equal(getattr(pb.frags, f), getattr(rb.frags, f))
        assert (pb.alignment is None) == (rb.alignment is None)
        if rb.alignment is not None:
            np.testing.assert_array_equal(pb.alignment, rb.alignment)


@pytest.mark.parametrize("world", [_insertion_world, _rooms_world, _minus_world],
                         ids=["insertion", "neighbour_rooms", "minus_strand"])
def test_extend_blocks_matches_the_reference(world):
    arena, blocks = world()
    ref_bs, port_bs = _blocksets(arena, blocks)
    n_ref = ref_gapext.gapped_extend_blocks(ref_bs, CFG)
    n_port = gapext.gapped_extend_blocks(port_bs, port_config(CFG), "cpu")
    assert n_port == n_ref >= 1
    _same_blocks(ref_bs, port_bs)


def test_probe_cache_replay_matches_the_reference():
    """The reference's probe-cache world: pass 1 caches the right side's
    no-extension probe, pass 2 (the left neighbour gone) extends the left
    side and re-runs the right probe against the spliced block."""
    rng = np.random.default_rng(11)
    a = _rand(rng, 400)
    b = a.copy()
    b[220:230] = (b[220:230] + 1) % 4
    b[300] = (b[300] + 1) % 4
    arena = GenomeArena(["A&c&l", "B&c&l"], [a, b])
    blk = [(0, 200, 100, 1), (1, 200, 100, 1)]
    l_nb = [(0, 150, 50, 1), (1, 150, 50, 1)]
    r_nb = [(0, 310, 50, 1), (1, 310, 50, 1)]
    cfg = default_config().replace(MIN_END=3, MIN_LENGTH=50)
    ref1, port1 = _blocksets(arena, [blk, l_nb, r_nb])
    ref_blk, _, ref_r = ref1.blocks
    port_blk, _, port_r = port1.blocks
    ref_cache, port_cache = {}, {}
    assert (ref_gapext.gapped_extend_blocks(ref1, cfg, probe_cache=ref_cache)
            == gapext.gapped_extend_blocks(port1, port_config(cfg), "cpu",
                                           probe_cache=port_cache))
    _same_blocks(ref1, port1)
    assert port1.blocks[0] is port_blk
    assert ({k[1:] for k in port_cache} == {k[1:] for k in ref_cache} != set())
    # pass 2 on the same block objects, the left neighbour removed
    ref2 = RefBlockSet(arena, [ref_blk, ref_r])
    port2 = BlockSet(port1.arena, [port_blk, port_r])
    n_ref = ref_gapext.gapped_extend_blocks(ref2, cfg, probe_cache=ref_cache)
    n_port = gapext.gapped_extend_blocks(port2, port_config(cfg), "cpu",
                                         probe_cache=port_cache)
    assert n_port == n_ref >= 1
    _same_blocks(ref2, port2)
    assert port2.blocks[0].frags.end[0] == 305


def test_indel_build_books_the_path_counters(monkeypatch):
    """Every gapext pass of a small indel build that has work makes one
    native call, and the four counters add up over the passes."""
    lib = native.load_library()
    real_c, real_pass = lib.npge_gapext_paths, pangenome.gapped_extend_blocks
    c_calls, passes = [], []

    def counted_c(*args):
        c_calls.append(1)
        return real_c(*args)

    def counted_pass(bs, cfg, dev, timings, probe_cache):
        before = dict(timings.counters)
        n = real_pass(bs, cfg, dev, timings=timings, probe_cache=probe_cache)
        passes.append({k: timings.counters.get(k, 0) - before.get(k, 0)
                       for k in ("gapext.nw_calls", "gapext.nw_pairs")})
        return n

    monkeypatch.setattr(lib, "npge_gapext_paths", counted_c)
    monkeypatch.setattr(pangenome, "gapped_extend_blocks", counted_pass)
    arena = synthetic_arena(n_genomes=3, length=12_000, seed=77, sub_rate=0.005,
                            indel_rate=0.002)
    _, t = pangenome.build_pangenome(arena, port_config(default_config()), "cpu")
    c = t.counters
    worked = [p for p in passes if p["gapext.nw_pairs"] > 0]
    assert len(worked) >= 2
    assert all(p["gapext.nw_calls"] == 1 for p in worked)
    assert c["gapext.nw_calls"] == len(worked) == len(c_calls)
    assert 0 < c["gapext.nw_dp_pairs"] <= c["gapext.nw_pairs"]
    assert c["gapext.nw_cells"] > 0
