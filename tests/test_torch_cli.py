"""npge_tpu_torch device resolution and CLI: explicit devices, no fallback,
and a make-pangenome run hash-equal to the reference CLI's."""

import pytest
import torch

from npge_tpu.cli import main as ref_main
from npge_tpu.io.checkpoint import load_stage, save_stage
from npge_tpu.model.blocks import BlockSet
from npge_tpu.model.hashing import blockset_hash
from npge_tpu.util.synthetic import synthetic_arena
from npge_tpu_torch.cli import main
from npge_tpu_torch.device import resolve_device, upload_arena

OPTS = ["-o", "ANCHOR_SIZE=17", "-o", "MIN_LENGTH=60", "-o", "MIN_END=3",
        "-o", "GAPPED_FLANK=64"]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_cpu_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_resolve_cuda_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_upload_arena_doubles_and_caches():
    arena = synthetic_arena(n_genomes=2, length=300, seed=1)
    codes, codes2 = upload_arena(arena, "cpu")
    T = arena.total_length
    assert codes2.dtype == torch.uint8 and codes2.shape == (2 * T,)
    assert torch.equal(codes2[:T], codes)
    comp = torch.where(codes < 4, 3 - codes, codes).flip(0)
    assert torch.equal(codes2[T:], comp)
    assert upload_arena(arena, "cpu")[1] is codes2


def test_make_pangenome_cuda_exits_without_gpu(tmp_path, no_gpu):
    arena = synthetic_arena(n_genomes=2, length=2000, seed=2)
    save_stage(str(tmp_path), "input", BlockSet(arena, []))
    with pytest.raises(SystemExit) as e:
        main(["make-pangenome", "-w", str(tmp_path)])  # default: cuda
    assert e.value.code not in (0, None)
    assert load_stage(str(tmp_path), "pangenome") is None


def test_make_pangenome_cpu_matches_reference_cli(tmp_path):
    arena = synthetic_arena(
        n_genomes=3, length=6000, seed=12, sub_rate=0.006, indel_rate=0.001
    )
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for d in (ref_dir, port_dir):
        save_stage(str(d), "input", BlockSet(arena, []))
    ref_main(["make-pangenome", "-w", str(ref_dir), "--platform", "cpu", *OPTS])
    main(["make-pangenome", "-w", str(port_dir), "--device", "cpu", *OPTS])
    ref = load_stage(str(ref_dir), "pangenome")
    got = load_stage(str(port_dir), "pangenome")
    assert len(got.blocks) > 3
    assert blockset_hash(got) == blockset_hash(ref)
