"""The port's copies of the reference's host modules give the reference's
results: the same synthetic worlds, .bs text that round-trips across both
packages, equal hashes, fragment rooms and column classes, and its own
host library in its own build directory. After a build every object is the
port's own class."""

import io
from pathlib import Path

import numpy as np
import pytest

from npge_tpu.algo.pangenome import build_pangenome as ref_build
from npge_tpu.config import default_config
from npge_tpu.io.bs import read_blockset as ref_read
from npge_tpu.io.bs import write_blockset as ref_write
from npge_tpu.model.fragindex import FragmentIndex as RefFragmentIndex
from npge_tpu.model.hashing import blockset_hash as ref_hash
from npge_tpu.model.stats import column_classes as ref_column_classes
from npge_tpu.util.synthetic import synthetic_arena as ref_synthetic
from npge_tpu_torch import native
from npge_tpu_torch.algo.pangenome import build_pangenome
from npge_tpu_torch.carry import blockset_from_bs_text
from npge_tpu_torch.io.bs import write_blockset
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import Block, BlockSet
from npge_tpu_torch.model.fragindex import FragmentIndex
from npge_tpu_torch.model.fragments import FragmentTable
from npge_tpu_torch.model.hashing import blockset_hash
from npge_tpu_torch.model.stats import column_classes
from npge_tpu_torch.util.synthetic import synthetic_arena
from torch_carry import port_arena, port_blockset, port_config

ROOT = Path(__file__).resolve().parents[1]
WORLDS = {
    "linear": dict(n_genomes=3, length=4000, seed=4, sub_rate=0.006,
                   indel_rate=0.001),
    "circular": dict(n_genomes=4, length=3000, seed=11, sub_rate=0.004,
                     indel_rate=0.0008, circular=True),
    "inversions": dict(n_genomes=3, length=5000, seed=7, sub_rate=0.01,
                       indel_rate=0.002, n_inversions=2),
    "circular_inversions": dict(n_genomes=5, length=2000, seed=50,
                                sub_rate=0.001, indel_rate=0.00005,
                                n_inversions=1, circular=True),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_synthetic_arena_codes_equal(world):
    want = ref_synthetic(**WORLDS[world])
    got = synthetic_arena(**WORLDS[world])
    assert got.names == want.names
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.codes.tobytes() == want.codes.tobytes()


@pytest.fixture(scope="module")
def built():
    """A reference build with gapped blocks over circular genomes with an
    inversion, and its config."""
    cfg = default_config().replace(
        ANCHOR_SIZE=17, MIN_LENGTH=60, MIN_END=3, GAPPED_FLANK=64,
        MAX_LOOPS=1,
    )
    arena = ref_synthetic(
        n_genomes=3, length=5000, seed=4, sub_rate=0.006, indel_rate=0.001,
        n_inversions=1, circular=True,
    )
    bs, _ = ref_build(arena, cfg)
    assert any(not b.is_gapless for b in bs.blocks)
    return bs, cfg


def test_bs_round_trips_both_ways(built):
    bs, _ = built
    port = port_blockset(bs)  # reference writer -> port reader
    assert blockset_hash(port) == ref_hash(bs)
    assert [b.name for b in port.blocks] == [b.name for b in bs.blocks]
    fh = io.StringIO()
    write_blockset(fh, port)  # port writer -> reference reader
    back = ref_read(io.StringIO(fh.getvalue()))
    assert ref_hash(back) == ref_hash(bs)
    want = io.StringIO()
    ref_write(want, bs)
    assert fh.getvalue() == want.getvalue()
    again = blockset_from_bs_text(port.arena, fh.getvalue())
    assert blockset_hash(again) == blockset_hash(port)


def test_fragment_rooms_and_column_classes_equal(built):
    bs, _ = built
    port = port_blockset(bs)
    for got, want in zip(
        FragmentIndex(port.arena, port.blocks).per_block_rooms(),
        RefFragmentIndex(bs.arena, bs.blocks).per_block_rooms(),
    ):
        assert len(got) == len(want) == len(bs.blocks)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for pb, rb in zip(port.blocks, bs.blocks):
        for g, w in zip(column_classes(pb.rows(port.arena)),
                        ref_column_classes(rb.rows(bs.arena))):
            np.testing.assert_array_equal(g, w)


def test_host_library_builds_in_the_ports_build_dir():
    native.load_library()
    path = native.library_path()
    assert path.exists()
    assert path.parent == ROOT / "build" / "npge_tpu_torch"
    assert path.name.startswith("libnpge_native_")
    assert (ROOT / "npge_tpu_torch" / "csrc" / "npge_native.cpp").exists()


def test_build_yields_only_the_ports_classes(built):
    bs, cfg = built
    got, _ = build_pangenome(port_arena(bs.arena), port_config(cfg), "cpu")
    assert type(got) is BlockSet and type(got.arena) is GenomeArena
    assert got.blocks and all(type(b) is Block for b in got.blocks)
    assert all(type(b.frags) is FragmentTable for b in got.blocks)
    got.canonicalize()
    ref = port_blockset(bs)
    ref.canonicalize()
    assert blockset_hash(got) == blockset_hash(ref)
