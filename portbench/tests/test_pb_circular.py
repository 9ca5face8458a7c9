"""Circular, multi-chromosome worlds: the generator's new keys leave the
existing cells' worlds as they were, the cyclic plain scan agrees with the
program's scan, fragments across an origin and the origin's pairs are read
as the references state, and a tiny circular cell runs through the harness
from files alone."""

import hashlib
import json

import numpy as np
import pytest

from conftest import REPO
from portbench import world
from portbench.reference import anchors as ref_anchors
from portbench.reference import blockset as ref_blockset
from portbench.reference import consensus as ref_consensus
from portbench.reference import joins as ref_joins

# sha256 of each cell's world (names, offsets, codes) at seeds 0 and 1,
# made by the generator before it took chromosome_lengths and rotate_origins
PINNED = [
    ("brucella17.species-div", 0, "7dc6eed617b31b6f507195a1c564eac6b1e2ba74bd0979c8fa5a0a0dcc182303"),
    ("brucella17.species-div", 1, "5a614103984646f6ed9eee810ea7e0e6bd710600643a678fbaade2e05deae5fc"),
    ("strains100.strain-div", 0, "114495c46cd92714350858c20cd1301bf9533e0f3851684b66a21de4f564c70a"),
    ("strains100.strain-div", 1, "d21665b20b6dbeeabe07a2727bf9a526e8b0bd27c4dd6fc8ec6f54e074ae2930"),
    ("brucella17-4gpu.species-div", 0, "7dc6eed617b31b6f507195a1c564eac6b1e2ba74bd0979c8fa5a0a0dcc182303"),
    ("brucella17-4gpu.species-div", 1, "5a614103984646f6ed9eee810ea7e0e6bd710600643a678fbaade2e05deae5fc"),
]


def world_digest(names, seqs) -> str:
    codes, offsets = world.concat(seqs)
    h = hashlib.sha256()
    h.update("\n".join(names).encode())
    h.update(b"\0")
    h.update(offsets.astype("<i8").tobytes())
    h.update(codes.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell,seed,digest", PINNED,
                         ids=[f"{c}-{s}" for c, s, _d in PINNED])
def test_existing_cells_make_the_same_worlds(cell, seed, digest):
    from portbench import harness

    _bench, _cell, config, traffic = harness.load_cell(REPO, cell)
    assert world_digest(*world.make_world(config, traffic, seed)) == digest


TWO = {"n_genomes": 3, "genome_length": 3000, "chromosome_lengths": [2000, 1000],
       "circular": True}
MIX = {"world_seed": 5, "sub_rate": 0.01, "indel_rate": 0.001, "n_inversions": 1}


def test_two_chromosome_worlds_name_and_keep_their_genomes_together():
    names, seqs = world.make_world(TWO, MIX, 2**31 + 9)
    assert len(names) == 6 and len(set(names)) == 6
    genomes = [n.split("&")[0] for n in names]
    assert [n.split("&", 1)[1] for n in names] == ["chr1&c", "chr2&c"] * 3
    assert genomes[0::2] == genomes[1::2]  # a genome's chromosomes stay together
    assert sorted(genomes[0::2]) == ["GEN0", "GEN1", "GEN2"]
    for n, s in zip(names, seqs):
        want = 2000 if n.endswith("chr1&c") else 1000
        assert abs(len(s) - want) < 60  # indels move a length by a few bases
    # the same seed, the same world; another seed, the same genomes reordered
    again = world.make_world(TWO, MIX, 2**31 + 9)
    assert world_digest(names, seqs) == world_digest(*again)
    other = dict(zip(*world.make_world(TWO, MIX, 3)))
    assert all((other[n] == s).all() for n, s in zip(names, seqs))
    with pytest.raises(ValueError):
        world.make_world(dict(TWO, chromosome_lengths=[2000, 999]), MIX, 1)


def test_rotated_origins_turn_each_chromosome_and_change_no_base():
    plain = dict(zip(*world.make_world(TWO, MIX, 4)))
    names, seqs = world.make_world(dict(TWO, rotate_origins=True), MIX, 4)
    turned = 0
    for n, s in zip(names, seqs):
        p = plain[n]
        assert len(s) == len(p)
        assert (np.bincount(s, minlength=5) == np.bincount(p, minlength=5)).all()
        shift = next(r for r in range(len(p)) if (np.roll(p, -r) == s).all())
        turned += shift > 0
    assert turned >= 5
    again = world.make_world(dict(TWO, rotate_origins=True), MIX, 4)
    assert world_digest(names, seqs) == world_digest(*again)
    # linear chromosomes are never turned
    lin = dict(TWO, circular=False)
    assert world_digest(*world.make_world(dict(lin, rotate_origins=True), MIX, 4)) \
        == world_digest(*world.make_world(lin, MIX, 4))


def _port_groups(names, seqs, k, w):
    import npge_tpu_torch as P
    from npge_tpu_torch.algo.anchors import find_anchors

    cfg = P.default_config().replace(MINIMIZER_WINDOW=w)
    g = find_anchors(P.GenomeArena(names, seqs), cfg, "cpu", k=k)
    return g.offsets, g.pos, g.seq_id, g.strand


@pytest.mark.parametrize("k,w", [(21, 8), (13, 8), (11, 3), (7, 1), (5, 5), (3, 6)])
def test_cyclic_plain_scan_matches_the_programs_scan(k, w):
    """Two-chromosome rotated genomes with N in them, beside a circular
    sequence shorter than k + w - 2, one shorter than k and a linear one,
    in an order drawn from the seed."""
    rng = np.random.default_rng(k * 100 + w)
    names, seqs = world.make_world(
        {"n_genomes": 3, "genome_length": 900, "chromosome_lengths": [600, 300],
         "circular": True, "rotate_origins": True},
        {"sub_rate": 0.02, "indel_rate": 0.002}, k)
    names += ["S&chr1&c", "T&chr1&c", "U&chr1&l"]
    seqs += [seqs[0][: k + max(w - 3, 0)].copy(), seqs[1][: k - 1].copy(),
             seqs[2][:80].copy()]
    for s in seqs[:3]:
        s[rng.integers(0, len(s), 2)] = 4
    order = rng.permutation(len(seqs))
    names, seqs = [names[i] for i in order], [seqs[i] for i in order]
    codes, offsets = world.concat(seqs)
    circular = np.array([n.endswith("&c") for n in names])
    want = ref_anchors.anchor_groups(codes, offsets, k, w, 256, 32, circular)
    assert len(want[1]) > 0
    assert ref_anchors.groups_differing(want, _port_groups(names, seqs, k, w)) == 0


def test_cyclic_reading_at_the_seam():
    """The run order of one circular sequence, by the module's cases."""
    off = np.array([0, 40])
    k, w = 5, 4
    slots = ref_anchors.reading(off, k, w, [True])
    assert slots.tolist() == list(range(40)) + [0, 1, 2] + [-1] * 4
    short = ref_anchors.reading(np.array([0, 6]), k, w, [True])  # k <= L < k + w - 2
    assert short.tolist() == list(range(6)) + [0, 1] + [-1] * 4
    assert ref_anchors.reading(np.array([0, 4]), k, w, [True]).tolist() == [0, 1, 2, 3]
    assert ref_anchors.reading(off, k, w, [False]).tolist() == list(range(40))


# hand-made fragments over a circular sequence 0 (10 bases) and a linear
# sequence 1 (10 bases)
CODES = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 2, 0, 3, 0, 1, 2, 3, 3, 1], np.uint8)
OFFSETS = np.array([0, 10, 20])
CIRC = np.array([True, False])


def _blk(*frags, rows=None):
    return tuple(np.array(col, np.int64) for col in zip(*frags)), rows


def test_wrap_fragments_partition_and_text():
    across = [_blk((0, 7, 5, 1)), _blk((0, 2, 5, 1)), _blk((1, 0, 10, 1))]
    assert ref_blockset.partition_errors(OFFSETS, across, CIRC) == 0
    # without the flags, or on the linear sequence, the overrun counts
    assert ref_blockset.partition_errors(OFFSETS, across) == 10
    on_linear = [_blk((0, 0, 10, 1)), _blk((1, 7, 5, 1)), _blk((1, 2, 5, 1))]
    assert ref_blockset.partition_errors(OFFSETS, on_linear, CIRC) == 10
    # a start past the end, or longer than the sequence, is no crossing
    assert ref_blockset.partition_errors(OFFSETS, [_blk((0, 10, 3, 1))] + across[1:], CIRC) > 0
    assert ref_blockset.fragment_text(CODES, OFFSETS, 0, 7, 11, 1, CIRC) is None
    t = ref_blockset.fragment_text(CODES, OFFSETS, 0, 7, 5, 1, CIRC)
    assert t.tolist() == [3, 0, 1, 0, 1]
    r = ref_blockset.fragment_text(CODES, OFFSETS, 0, 7, 5, -1, CIRC)
    assert r.tolist() == [2, 3, 2, 3, 0]
    assert ref_blockset.fragment_text(CODES, OFFSETS, 1, 7, 5, 1, CIRC) is None


def test_wrap_fragments_rows_blocks_and_consensus():
    # 3 0 1 0 1 round the origin of 0, and the same text on 1 at 3..7
    frags = _blk((0, 7, 5, 1), (1, 3, 5, 1))[0]
    rows = ref_blockset.block_rows(CODES, OFFSETS, frags, None, CIRC)
    assert rows.tolist() == [[3, 0, 1, 0, 1], [3, 0, 1, 2, 3]]
    assert ref_blockset.block_rows(CODES, OFFSETS, frags, None) is None
    cons = ref_consensus.block_consensus(CODES, OFFSETS, frags, None, CIRC)
    assert cons.tolist() == [3, 0, 1, 0, 1]
    gapped = np.array([[3, 0, 1, 0, 1], [3, 0, 1, 2, 3]], np.uint8)
    n, faults = ref_blockset.bad_blocks(CODES, OFFSETS, [(frags, gapped)], 1, 0, 1, 2, CIRC)
    assert n == 0, faults
    n, faults = ref_blockset.bad_blocks(CODES, OFFSETS, [(frags, gapped)], 1, 0, 1, 2)
    assert faults == ["fragment leaves its sequence"]
    wrong = gapped.copy()
    wrong[0, 4] = 0  # not the text read round the origin
    assert ref_blockset.bad_blocks(CODES, OFFSETS, [(frags, wrong)], 1, 0, 1, 2, CIRC)[0] == 1


def test_mapped_back_over_a_source_across_the_origin():
    """A candidate over a source fragment that crosses the origin lands
    after it, its start taken round the sequence."""
    blocks = [_blk((0, 7, 5, 1), (1, 3, 5, 1)), _blk((0, 7, 5, -1), (1, 3, 5, -1))]
    cand = ([0, 2], [0, 1], [3, 0], [2, 2], [1, 1])  # one candidate, two fragments
    got = ref_consensus.mapped_back(cand, [0, 1], blocks, OFFSETS, CIRC)
    table = np.frombuffer(got[0], np.int64).reshape(-1, 4).tolist()
    # source 0 columns 3..4: 10 -> 0 on sequence 0; source 1 (strand -1)
    # columns 0..1: 7 + 5 - 2 = 10 -> 0
    assert table == [[0, 0, 2, 1], [1, 6, 2, 1], [0, 0, 2, -1], [1, 6, 2, -1]]
    raw = ref_consensus.mapped_back(cand, [0, 1], blocks)
    assert np.frombuffer(raw[0], np.int64).reshape(-1, 4)[0, 1] == 10


def _ring_pair(gap, x_start=None, n_at=None, y_len=70):
    """Circular sequence A (600 bases) and linear B, B[i] = A[(i + 300) %
    600]; block X ends ``gap`` bases before A's origin (or starts at
    ``x_start``, crossing it), block Y starts at A's 0; their copies on B
    are one run with the same gaps."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, 600).astype(np.uint8)
    if n_at is not None:
        a[n_at] = 4
    b = np.roll(a, -300)
    codes = np.concatenate([a, b])
    offsets = np.array([0, 600, 1200])
    xs = 600 - gap - 50 if x_start is None else x_start
    x_len = 50 if x_start is None else 600 - x_start + 20
    ys = 0 if x_start is None else 20 + gap
    X = _blk((0, xs, x_len, 1), (1, (xs + 300) % 600, x_len, 1))
    Y = _blk((0, ys, y_len, 1), (1, ys + 300, y_len, 1))
    return codes, offsets, [X, Y]


@pytest.mark.parametrize("gap,x_start,n_at,want", [
    (0, None, None, 1),     # touching across the origin: joinable
    (100, None, None, 1),   # at MAX_JOIN_GAP
    (101, None, None, 0),   # past it
    (10, None, 595, 0),     # an N in the gap (in both copies)
    (9, 590, None, 1),      # the first fragment itself crosses the origin
])
def test_origin_pairs_are_joined_as_other_pairs(gap, x_start, n_at, want):
    codes, offsets, blocks = _ring_pair(gap, x_start, n_at)
    rules = (100, 10, 9, 10, 100)
    assert ref_joins.joinable_pairs(codes, offsets, blocks, *rules, [True, False]) == want
    # read as linear sequences, the origin separates the pair
    assert ref_joins.joinable_pairs(codes, offsets, blocks, *rules) == 0


def test_tiny_circular_cell_from_files_alone(tiny_root):
    """A circular, two-chromosome, rotated configuration added as a file is
    found by name, and its run is correct with every count 0."""
    import time

    from portbench import harness

    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    assert "tinyc.tinymix" in {w["name"] for w in bench["workloads"]}
    line = harness.run("tinyc.tinymix", 7, 0.0, False, t_start=time.perf_counter(),
                       root=tiny_root, device="cpu", log=lambda *a, **k: None,
                       min_builds=2)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"build_s", "setup_s", "device_peak_gib"}
    assert all(c["value"] == 0 for c in line["checks"].values()), line["checks"]
