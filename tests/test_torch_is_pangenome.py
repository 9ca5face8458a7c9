"""npge_tpu_torch check_is_pangenome vs the JAX reference: with the deep
probe on device="cpu", the whole report (ok, new_hits, messages and the
host checks' counts) equals the reference's, on a full build that passes
and on a build whose probe finds improving hits."""

import pytest
import torch

import npge_tpu_torch
from npge_tpu.algo.is_pangenome import check_is_pangenome as ref_check
from npge_tpu.algo.pangenome import build_pangenome as ref_build
from npge_tpu.config import default_config
from npge_tpu.util.synthetic import synthetic_arena
from npge_tpu_torch.algo.is_pangenome import check_is_pangenome
from npge_tpu_torch.algo.pangenome import StageTimings
from torch_carry import fields, port_blockset, port_config

WORLDS = {
    # a full build: the probe finds nothing, the check passes
    "full": lambda: (
        synthetic_arena(
            n_genomes=3, length=5000, seed=4, sub_rate=0.006,
            indel_rate=0.001, n_inversions=1, circular=True,
        ),
        default_config().replace(
            ANCHOR_SIZE=17, MIN_LENGTH=60, MIN_END=3, GAPPED_FLANK=64,
            MAX_LOOPS=2,
        ),
        (True, 0),
    ),
    # no re-seed round and coarse seeds: the probe finds improving hits
    "hits": lambda: (
        synthetic_arena(
            n_genomes=3, length=6000, seed=4, sub_rate=0.02,
            indel_rate=0.002, n_inversions=1,
        ),
        default_config().replace(
            ANCHOR_SIZE=31, MIN_LENGTH=60, MIN_END=3, GAPPED_EXTEND=False,
            MAX_LOOPS=0,
        ),
        (False, 80),
    ),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_deep_report_matches_reference(world):
    arena, cfg, (want_ok, want_hits) = WORLDS[world]()
    bs, _ = ref_build(arena, cfg)
    want = ref_check(bs, cfg, deep=True)
    tm = StageTimings()
    got = check_is_pangenome(
        port_blockset(bs), port_config(cfg), deep=True, device="cpu",
        timings=tm,
    )
    assert fields(got) == fields(want)
    assert (got.ok, got.new_hits) == (want_ok, want_hits)
    # the probe's stages are the top spans; their steps nest inside them
    assert {k for k, p in tm.parents.items() if "" in p} == {
        "deep.cons", "deep.scan", "deep.extend", "deep.deconseq",
        "deep.resolve",
    }
    assert tm.counters["deep.extend_cells"] > 0


def test_shallow_report_needs_no_device():
    arena, cfg, _ = WORLDS["full"]()
    bs, _ = ref_build(arena, cfg)
    got = check_is_pangenome(port_blockset(bs), port_config(cfg))
    assert fields(got) == fields(ref_check(bs, cfg))


def test_deep_needs_an_explicit_device(monkeypatch):
    arena, cfg, _ = WORLDS["hits"]()
    bs, cfg = port_blockset(ref_build(arena, cfg)[0]), port_config(cfg)
    with pytest.raises(ValueError):
        check_is_pangenome(bs, cfg, deep=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        check_is_pangenome(bs, cfg, deep=True, device="cuda")


def test_package_exports_the_ports_check():
    assert npge_tpu_torch.check_is_pangenome is check_is_pangenome
    assert npge_tpu_torch.check_is_pangenome is not ref_check
