"""npge_tpu_torch's consensus re-seed round trip (``consensus_arena`` and
``deconseq``) against the JAX package's on the same blocks and candidates:
single-fragment fillers on both strands, multi-fragment gapless blocks
whose columns tie or hold N, gapped blocks (one whose consensus is empty),
wrap fragments across the origin of a circular sequence, candidates as
Blocks and as a CandidateBatch, and a second round that reuses the caches
after blocks changed; the layer's gathers, and its refusal of sources made
over another blockset. Then the contract the benchmark's harness reads, on a
small CPU build: ``src`` yields (int, ndarray) pairs, ``deconseq`` returns
Blocks, the layer's books are there, and the consensus counters add up."""

import numpy as np
import pytest

from npge_tpu.algo import conseq as ref_conseq
from npge_tpu.algo import extender as ref_extender
from npge_tpu.model import blocks as ref_blocks
from npge_tpu.model import fragments as ref_fragments
from npge_tpu.model import hashing as ref_hashing
from npge_tpu.model.arena import GenomeArena
from npge_tpu_torch.algo import conseq as port_conseq
from npge_tpu_torch.algo import extender as port_extender
from npge_tpu_torch.model import blocks as port_blocks
from npge_tpu_torch.model import fragments as port_fragments
from npge_tpu_torch.model import hashing as port_hashing
from npge_tpu_torch.model.arena import GenomeArena as PortArena
from torch_carry import port_arena

GAP = 5
L = 400


def _ref_arena():
    """Sequence 0 circular, 1 and 2 linear; 1 and 2 are mutated copies of
    0 (so multi-fragment columns agree, disagree and tie), each with a run
    of N."""
    rng = np.random.default_rng(12)
    s0 = rng.integers(0, 4, L).astype(np.uint8)
    seqs = []
    for i in range(3):
        s = s0.copy()
        if i:
            hit = rng.random(L) < 0.3
            s[hit] = rng.integers(0, 4, int(hit.sum()))
        s[100 + 40 * i : 108 + 40 * i] = 4
        seqs.append(s)
    return GenomeArena(["A&chr1&c", "B&chr1&l", "C&chr1&l"], seqs)


def _gapped_rows(arena, rows, gaps, width):
    """Alignment rows: each fragment's text with GAP at its columns."""
    out = np.full((len(rows), width), GAP, np.uint8)
    for r, ((s, st, ln, o), cols) in enumerate(zip(rows, gaps)):
        keep = np.setdiff1d(np.arange(width), cols)
        assert len(keep) == ln
        out[r, keep] = arena.fragment_codes(s, st, ln, o)
    return out


def _specs(arena, second_round: bool):
    """(name, fragment rows, alignment or None) of each block, in order."""
    specs = [
        ("fill_fwd", [(1, 0, 50, 1)], None),
        ("fill_rev", [(2, 0, 50, -1)], None),
        ("fill_wrap", [(0, 380, 40, 1)], None),
        ("fill_wrap_rev", [(0, 390, 30, -1)], None),
        ("multi3", [(0, 50, 120, 1), (1, 50, 120, -1), (2, 60, 120, 1)], None),
        ("multi2", [(1, 200, 80, 1), (2, 200, 80, 1)], None),
        ("multi_wrap", [(0, 370, 60, 1), (1, 300, 60, -1)], None),
    ]
    grows = [(0, 200, 100, 1), (1, 150, 98, -1), (2, 300, 100, 1)]
    specs.append(("gapped", grows, _gapped_rows(
        arena, grows, [[10, 11, 70, 71], [10, 11, 40, 41, 70, 71], [40, 41, 90, 91]],
        104)))
    srows = [(2, 120, 40, 1)]
    specs.append(("gapped_one", srows, _gapped_rows(arena, srows, [[5]], 41)))
    erows = [(1, 330, 2, 1), (2, 330, 2, 1)]
    specs.append(("gapped_empty", erows,
                  _gapped_rows(arena, erows, [[2, 3], [0, 1]], 4)))
    if second_round:
        specs[5] = ("multi2", [(1, 210, 70, 1), (2, 210, 70, -1)], None)
        specs[0] = ("fill_fwd", [(1, 0, 60, 1)], None)
        specs.append(("fill_late", [(2, 330, 40, -1)], None))
    return specs


# candidate fragments: (source block name, start, length, strand)
CANDIDATES = [
    [("fill_fwd", 0, 30, 1), ("multi3", 10, 30, -1)],
    [("fill_wrap", 5, 30, 1), ("multi_wrap", 0, 30, 1)],
    [("multi2", 0, 20, 1), ("multi2", 40, 20, -1), ("fill_rev", 3, 20, -1)],
    [("gapped", 20, 15, 1), ("multi3", 0, 15, -1)],
    [("gapped", 5, 40, 1), ("multi3", 0, 40, -1)],
    [("gapped", 20, 15, 1), ("gapped_one", 10, 15, -1), ("multi2", 5, 15, 1)],
    [("fill_fwd", 0, 10, 1)],
    [("fill_wrap_rev", 0, 25, -1), ("multi_wrap", 30, 25, -1)],
]


class _World:
    """One round's blocks in both packages' classes, from the same specs;
    blocks kept from ``prev`` (same name and rows) keep their objects, as
    the re-seed loop keeps unchanged blocks."""

    def __init__(self, second_round: bool, prev: "_World | None" = None):
        self.ref_arena = prev.ref_arena if prev else _ref_arena()
        self.port_arena = prev.port_arena if prev else port_arena(self.ref_arena)
        self.specs = _specs(self.ref_arena, second_round)
        old = {} if prev is None else {
            (n, tuple(r)): (rb, pb) for (n, r, _a), rb, pb
            in zip(prev.specs, prev.ref_blocks, prev.port_blocks)
        }
        self.ref_blocks, self.port_blocks = [], []
        for name, rows, aln in self.specs:
            kept = old.get((name, tuple(rows)))
            if kept is None:
                kept = (
                    ref_blocks.Block(ref_fragments.FragmentTable.from_rows(rows),
                                     None if aln is None else aln.copy()),
                    port_blocks.Block(port_fragments.FragmentTable.from_rows(rows),
                                      None if aln is None else aln.copy()),
                )
            self.ref_blocks.append(kept[0])
            self.port_blocks.append(kept[1])
        self.ref_bs = ref_blocks.BlockSet(self.ref_arena, self.ref_blocks)
        self.port_bs = port_blocks.BlockSet(self.port_arena, self.port_blocks)

    def candidate_rows(self, cons_names):
        """Each candidate's fragments on the consensus arena."""
        index = {int(n[4:].split("&")[0]): j for j, n in enumerate(cons_names)}
        names = [n for n, _r, _a in self.specs]
        return [[(index[names.index(src)], st, ln, o) for src, st, ln, o in cand]
                for cand in CANDIDATES]


def _as_candidates(rows, form, fragments, blocks, extender):
    if form == "batch":
        flat = np.array([r for cand in rows for r in cand], np.int64)
        offs = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([len(c) for c in rows], out=offs[1:])
        return extender.CandidateBatch(
            offs, flat[:, 0], flat[:, 1].astype(np.int32),
            flat[:, 2].astype(np.int32), flat[:, 3].astype(np.int32))
    out = [blocks.Block(fragments.FragmentTable.from_rows(c)) for c in rows]
    if form == "gapped_candidate":
        # a candidate with an alignment takes the general path whatever
        # its sources
        c = rows[0]
        out[0] = blocks.Block(fragments.FragmentTable.from_rows(c),
                              np.zeros((len(c), c[0][2]), np.uint8))
    return out


def _rounds():
    """Both rounds of the world, and each package's consensus and mapping
    of every candidate form, round 2 with the caches of round 1."""
    caches = {"port": ({}, {}), "ref": ({}, {})}
    out, prev = [], None
    for second in (False, True):
        w = _World(second, prev)
        stats = {}
        p_cons, p_src = port_conseq.consensus_arena(
            w.port_bs, caches["port"][0], stats=stats)
        r_cons, r_src = ref_conseq.consensus_arena(w.ref_bs, caches["ref"][0])
        rows = w.candidate_rows(r_cons.names)
        mapped = {}
        for form in ("blocks", "batch", "gapped_candidate"):
            p_cand = _as_candidates(rows, form, port_fragments, port_blocks,
                                    port_extender)
            r_cand = _as_candidates(rows, form, ref_fragments, ref_blocks,
                                    ref_extender)
            mapped[form] = (
                port_conseq.deconseq(p_cand, p_src, w.port_bs, caches["port"][1]),
                ref_conseq.deconseq(r_cand, r_src, w.ref_bs, caches["ref"][1]),
            )
        out.append(dict(world=w, port=(p_cons, p_src), ref=(r_cons, r_src),
                        stats=stats, mapped=mapped))
        prev = w
    return out


@pytest.fixture(scope="module")
def rounds():
    return _rounds()


@pytest.mark.parametrize("round_no", [0, 1])
def test_consensus_arena_matches_reference(rounds, round_no):
    r = rounds[round_no]
    (p_cons, p_src), (r_cons, r_src) = r["port"], r["ref"]
    assert p_cons.names == r_cons.names
    assert np.array_equal(p_cons.offsets, r_cons.offsets)
    assert p_cons.offsets.dtype == r_cons.offsets.dtype
    assert np.array_equal(p_cons.codes, r_cons.codes)
    assert p_cons.codes.dtype == np.uint8
    pairs = list(p_src)
    assert len(pairs) == len(r_src) == len(p_src)
    for (pi, pm), (ri, rm) in zip(pairs, r_src):
        assert type(pi) is int and pi == ri
        assert np.array_equal(pm, rm)
    # the arena answers as one made by the checked constructor
    assert p_cons.n_seqs == r_cons.n_seqs
    for i in range(p_cons.n_seqs):
        assert p_cons.seq_len(i) == r_cons.seq_len(i)
        assert p_cons.circular(i) is False
    assert [str(p) for p in p_cons.parsed] == [str(p) for p in r_cons.parsed]
    assert p_cons.seq_id(p_cons.names[-1]) == p_cons.n_seqs - 1
    # the empty consensus of gapped_empty adds no sequence
    names = [n for n, _r, _a in r["world"].specs]
    assert names.index("gapped_empty") not in {i for i, _m in pairs}


@pytest.mark.parametrize("form", ["blocks", "batch", "gapped_candidate"])
@pytest.mark.parametrize("round_no", [0, 1])
def test_deconseq_matches_reference(rounds, round_no, form):
    r = rounds[round_no]
    got, want = r["mapped"][form]
    assert type(got) is list
    assert len(got) == len(want) > 0
    p_arena, r_arena = r["world"].port_arena, r["world"].ref_arena
    for g, w in zip(got, want):
        assert isinstance(g, port_blocks.Block)
        assert port_hashing.block_hash(g, p_arena) == ref_hashing.block_hash(w, r_arena)
        for col in ("seq_id", "start", "length", "ori"):
            a, b = getattr(g.frags, col), getattr(w.frags, col)
            assert a.dtype == np.int32 and np.array_equal(a, b), col
        if w.alignment is None:
            assert g.alignment is None
        else:
            assert np.array_equal(g.alignment, w.alignment)
    if form != "gapped_candidate":
        # at least one block through a gapped source survives the widths
        assert any(w.alignment is not None for w in want)


def test_second_round_reuses_the_caches(rounds):
    first, second = rounds[0]["stats"], rounds[1]["stats"]
    assert "cache.cons_hit" not in first
    # every hit but gapped_empty's, whose consensus adds no sequence
    assert second["cache.cons_hit"] == second["reseed.cons.cached"] + 1 > 1
    assert second["cache.cons_miss"] == 1  # the changed multi2
    for st, r in ((first, rounds[0]), (second, rounds[1])):
        n = r["port"][0].n_seqs
        assert sum(st.get(f"reseed.cons.{k}", 0)
                   for k in ("gathered", "voted", "cached")) == n
        assert st["reseed.cons.gathered"] == sum(
            1 for _n, rows, aln in r["world"].specs if len(rows) == 1 and aln is None)


def test_deconseq_refuses_sources_of_another_blockset(rounds):
    first, second = rounds
    cand = _as_candidates(first["world"].candidate_rows(first["ref"][0].names),
                          "blocks", port_fragments, port_blocks, port_extender)
    with pytest.raises(ValueError):
        port_conseq.deconseq(cand, first["port"][1], second["world"].port_bs)


@pytest.mark.parametrize("runs", [
    [(0, 10)],
    [(40, 3), (7, 0), (7, 5), (0, 1), (100, 20)],
    [(5, 0), (9, 0)],
    [],
    [(3, 4), (3, 4), (2, 6)],
])
def test_run_indices_lay_every_run_end_to_end(runs):
    start = np.array([r[0] for r in runs], np.int64)
    length = np.array([r[1] for r in runs], np.int64)
    want = np.array([i for s, n in runs for i in range(s, s + n)], np.int64)
    got = port_conseq._run_indices(start, length)
    assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("strand", [1, -1])
def test_gather_texts_reads_like_fragment_codes(strand):
    """Every fragment of a circular and a linear sequence, wraps included,
    laid end to end or written to given places."""
    arena = port_arena(_ref_arena())
    frags = [(s, st, ln, strand) for s in range(3)
             for st, ln in ((0, 17), (383, 17), (150, 0), (250, 100))]
    frags.append((0, 390, 30, strand))  # across the origin
    seq, start, length, ori = (np.array(c, np.int64) for c in zip(*frags))
    want = [arena.fragment_codes(*f) for f in frags]
    got = port_conseq._gather_texts(arena, seq, start, length, ori)
    assert np.array_equal(got, np.concatenate(want))
    # in reverse order, two bytes apart
    at = np.zeros(len(frags), np.int64)
    pos = 0
    for k in reversed(range(len(frags))):
        at[k] = pos
        pos += int(length[k]) + 2
    out = np.full(pos, 9, np.uint8)
    port_conseq._gather_texts(arena, seq, start, length, ori, out=out, at=at)
    for a, w in zip(at.tolist(), want):
        assert np.array_equal(out[a : a + len(w)], w)


def test_from_flat_arena_answers_like_a_checked_one():
    names = ["x&1&c", "y&2&l", "z"]
    seqs = [np.array([0, 1, 2], np.uint8), np.array([3], np.uint8),
            np.array([4, 4], np.uint8)]
    checked = PortArena(names, seqs)
    flat = PortArena.from_flat(list(names), checked.codes.copy(),
                               checked.offsets.copy(), np.array([1, 0, 0], bool))
    assert flat.n_seqs == checked.n_seqs == 3
    assert flat.total_length == checked.total_length
    for i in range(3):
        assert flat.circular(i) == checked.circular(i)
        assert flat.seq_len(i) == checked.seq_len(i)
        assert flat.seq_id(names[i]) == i
        assert np.array_equal(flat.fragment_codes(i, 0, flat.seq_len(i), -1),
                              checked.fragment_codes(i, 0, checked.seq_len(i), -1))
    assert flat.parsed == checked.parsed
    assert flat.genomes() == checked.genomes()
    assert np.array_equal(flat.circ_codes(0, 2, 3), [2, 0, 1])


# ---- the contract of the benchmark's harness, on a small CPU build ----


@pytest.fixture(scope="module")
def traced_build():
    from npge_tpu_torch import default_config, synthetic_arena
    from npge_tpu_torch.algo import pangenome

    seen = {"src": [], "mapped": [], "n_seqs": 0}
    inner_cons, inner_map = pangenome.consensus_arena, pangenome.deconseq

    def consensus_arena(bs, *args, **kw):
        cons, src = inner_cons(bs, *args, **kw)
        seen["src"].append(list(src))
        seen["n_seqs"] += cons.n_seqs
        return cons, src

    def deconseq(cand, src, bs, *args, **kw):
        out = inner_map(cand, src, bs, *args, **kw)
        seen["mapped"].append(out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(pangenome, "consensus_arena", consensus_arena)
    mp.setattr(pangenome, "deconseq", deconseq)
    try:
        # indels enough that re-seed hits cross gapped blocks
        arena = synthetic_arena(n_genomes=5, length=15_000, seed=7, sub_rate=0.01,
                                indel_rate=0.001, n_inversions=1)
        _bs, t = pangenome.build_pangenome(arena, default_config(), "cpu")
    finally:
        mp.undo()
    return t, seen


def test_harness_contract_on_a_build(traced_build):
    t, seen = traced_build
    assert seen["src"] and seen["mapped"]
    for pairs in seen["src"]:
        for i, cmap in pairs:
            assert type(i) is int and isinstance(cmap, np.ndarray)
    for out in seen["mapped"]:
        assert type(out) is list
        assert all(isinstance(b, port_blocks.Block) for b in out)
    for book in ("reseed.cons.arena", "deconseq.fast", "deconseq.general"):
        assert t.seconds.get(book, 0.0) > 0.0, book
    c = t.counters
    assert sum(c.get(f"reseed.cons.{k}", 0) for k in ("gathered", "voted", "cached")) \
        == seen["n_seqs"] > 0
    assert c["reseed.cons.gathered"] > 0 and c["reseed.cons.voted"] > 0
    assert c["deconseq.general"] > 0
