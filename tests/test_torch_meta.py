"""npge_tpu_torch.meta vs npge_tpu.meta: the same processor and pipe names,
and every one of them, run on one built blockset, gives the same blockset
(hash and block names) as the reference's stage."""

import copy

import pytest

from npge_tpu import meta as ref_meta
from npge_tpu.algo.pangenome import build_pangenome as ref_build
from npge_tpu.config import default_config
from npge_tpu.model.blocks import BlockSet
from npge_tpu.model.hashing import blockset_hash
from npge_tpu.util.synthetic import synthetic_arena
from npge_tpu_torch import meta
from npge_tpu_torch.model.hashing import blockset_hash as port_hash
from torch_carry import port_blockset, port_config


@pytest.fixture(scope="module")
def built():
    """A built blockset over circular genomes with gapped blocks."""
    arena = synthetic_arena(
        n_genomes=3, length=5000, seed=4, sub_rate=0.006, indel_rate=0.001,
        n_inversions=1, circular=True,
    )
    cfg = default_config().replace(
        ANCHOR_SIZE=17, MIN_LENGTH=60, MIN_END=3, GAPPED_FLANK=64, MAX_LOOPS=1
    )
    bs, _ = ref_build(arena, cfg)
    assert any(not b.is_gapless for b in bs.blocks)
    return bs, cfg


def _copy(bs: BlockSet) -> BlockSet:
    # stages edit blocks in place; the arena is immutable and shared
    return BlockSet(bs.arena, [copy.deepcopy(b) for b in bs.blocks])


def test_names_match_reference():
    assert meta.names() == ref_meta.names()
    assert "MakePangenome" in meta.names() and "Pangenome" in meta.names()


@pytest.mark.parametrize("name", ref_meta.names())
def test_stage_matches_reference(name, built, capsys):
    bs, cfg = built
    want = ref_meta.get(name)(_copy(bs), cfg)
    want_out = capsys.readouterr().out
    got = meta.get(name)(port_blockset(bs), port_config(cfg), "cpu")
    assert capsys.readouterr().out == want_out
    assert port_hash(got) == blockset_hash(want)
    assert [b.name for b in got.blocks] == [b.name for b in want.blocks]


def test_unknown_name_raises():
    with pytest.raises(KeyError):
        meta.get("NoSuchProcessor")


def test_run_script_rebinds_bs(built, tmp_path):
    bs, cfg = built
    script = tmp_path / "script.py"
    script.write_text(
        "assert device == 'cpu'\n"
        "bs = meta.get('RemoveNames')(bs, cfg, device)\n"
        "bs = type(bs)(bs.arena, bs.blocks[:3])\n"
    )
    out = meta.run_script(str(script), port_blockset(bs), port_config(cfg), "cpu")
    assert len(out.blocks) == 3
    assert all(b.name is None for b in out.blocks)
