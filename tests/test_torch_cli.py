"""npge_tpu_torch device resolution and CLI: explicit devices, no fallback,
and every verb's output equal to the reference CLI's on the same work
dir."""

import json
import os
import shutil

import pytest
import torch

from npge_tpu.cli import main as ref_main
from npge_tpu.io.checkpoint import load_stage, save_stage
from npge_tpu.io.fasta import write_fasta
from npge_tpu.model.blocks import BlockSet
from npge_tpu.model.hashing import blockset_hash
from npge_tpu.util.synthetic import synthetic_arena
from npge_tpu_torch.cli import main
from npge_tpu_torch.device import resolve_device, upload_arena
from torch_carry import port_arena

OPTS = ["-o", "ANCHOR_SIZE=17", "-o", "MIN_LENGTH=60", "-o", "MIN_END=3",
        "-o", "GAPPED_FLANK=64"]
POST_FILES = (
    "blocks.tsv", "mutations.tsv", "distances.tsv", "bsa.tsv",
    "bsa_scaffold.tsv", "consensus_tree.nwk", "info.txt",
    "genomes_stats.tsv",
)


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
    arena = port_arena(arena)
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


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Work dirs prepared from the same FASTA files, built by the
    reference's CLI ("ref") and by the port's on the CPU ("port")."""
    root = tmp_path_factory.mktemp("cli")
    arena = synthetic_arena(
        n_genomes=3, length=5000, seed=33, sub_rate=0.01, indel_rate=0.0005,
        n_inversions=1,
    )
    paths = []
    for i in range(arena.n_seqs):
        p = root / f"g{i}.fa"
        with open(p, "w") as fh:
            write_fasta(fh, [(arena.names[i], arena.seq_codes(i))])
        paths.append(str(p))
    ref, port = str(root / "ref"), str(root / "port")
    ref_main(["prepare", "--fasta", *paths, "-w", ref])
    main(["prepare", "--fasta", *paths, "-w", port])
    ref_main(["make-pangenome", "-w", ref, "--platform", "cpu", *OPTS])
    main(["make-pangenome", "-w", port, "--device", "cpu", *OPTS])
    return ref, port


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _twins(src: str, tmp_path) -> tuple[str, str]:
    """Two copies of the work dir ``src``: one for each CLI to write in."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    return a, b


def _exit_code(fn, argv) -> int:
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return e.value.code


def test_prepare_and_build_match_reference(work):
    ref, port = work
    for name in ("input.bs", "pangenome.bs"):
        assert _read(os.path.join(port, name)) == _read(os.path.join(ref, name))
    memo = json.load(open(os.path.join(port, "pangenome.json")))["deep_probe"]
    want = json.load(open(os.path.join(ref, "pangenome.json")))["deep_probe"]
    assert memo == want and memo["ok"] is True


@pytest.mark.parametrize("verb", ["info", "hash", "examine", "processors"])
def test_host_verb_stdout_matches_reference(verb, work, capsys):
    port = work[1]
    ref_main([verb, "-w", port])
    want = capsys.readouterr().out
    main([verb, "-w", port])
    got = capsys.readouterr().out
    assert got and got == want


def test_hash_of_a_stage(work, capsys):
    port = work[1]
    main(["hash", "-w", port, "--stage", "input"])
    got = capsys.readouterr().out.strip()
    assert got == f"{blockset_hash(load_stage(port, 'input')):016x}"


def test_post_processing_and_report_match_reference(work, tmp_path, capsys):
    a, b = _twins(work[1], tmp_path)
    for fn, d in ((ref_main, a), (main, b)):
        fn(["post-processing", "-w", d])
        fn(["report", "-w", d])
    for name in (*POST_FILES, "report.html"):
        assert _read(os.path.join(b, name)) == _read(os.path.join(a, name)), name
    capsys.readouterr()
    ref_main(["post-processing", "-w", a, "--target", "info.txt=:stdout"])
    want = capsys.readouterr().out
    main(["post-processing", "-w", b, "--target", "info.txt=:stdout"])
    assert capsys.readouterr().out.replace(b, a) == want  # names its dir


def test_check_deep_memo_matches_reference(work, capsys):
    """As the reference's test_check_deep_reuses_buildtime_proof: the
    build-time proof is reused under the same config, and a changed
    config runs the probe."""
    port = work[1]
    changed = [*OPTS, "-o", "MAX_LOOPS=3"]  # the probe itself is unchanged
    for opts, reuse in ((OPTS, True), (changed, False)):
        capsys.readouterr()
        assert _exit_code(
            ref_main, ["check", "-w", port, "--deep", "--platform", "cpu", *opts]
        ) == 0
        want = capsys.readouterr()
        assert _exit_code(
            main, ["check", "-w", port, "--deep", "--device", "cpu", *opts]
        ) == 0
        got = capsys.readouterr()
        assert got.out == want.out
        assert ("reusing build-time proof" in got.err) is reuse
        assert ("reusing build-time proof" in want.err) is reuse


def test_check_deep_failure_matches_reference(tmp_path, capsys):
    arena = synthetic_arena(
        n_genomes=3, length=6000, seed=4, sub_rate=0.02, indel_rate=0.002,
        n_inversions=1,
    )
    w = str(tmp_path)
    save_stage(w, "input", BlockSet(arena, []))
    opts = ["-o", "ANCHOR_SIZE=31", "-o", "MIN_LENGTH=60", "-o", "MIN_END=3",
            "-o", "GAPPED_EXTEND=false", "-o", "MAX_LOOPS=0"]
    main(["make-pangenome", "-w", w, "--device", "cpu", *opts])
    assert _exit_code(main, ["check", "-w", w, "--device", "cpu", *opts]) == 0
    capsys.readouterr()
    assert _exit_code(
        ref_main, ["check", "-w", w, "--deep", "--platform", "cpu", *opts]
    ) == 1
    want = capsys.readouterr().out
    assert _exit_code(
        main, ["check", "-w", w, "--deep", "--device", "cpu", *opts]
    ) == 1
    got = capsys.readouterr().out
    assert got == want
    assert "re-seeding finds improving hits" in got


@pytest.mark.parametrize("name", ["Stem", "MakePangenome", "Pangenome"])
def test_run_matches_reference(name, work, tmp_path):
    a, b = _twins(work[1], tmp_path)
    ref_main(["run", name, "-w", a, "--platform", "cpu", "--stage-name", "s", *OPTS])
    main(["run", name, "-w", b, "--device", "cpu", "--stage-name", "s", *OPTS])
    got, want = load_stage(b, "s"), load_stage(a, "s")
    assert blockset_hash(got) == blockset_hash(want)
    if name == "MakePangenome":
        assert blockset_hash(got) == blockset_hash(load_stage(b, "pangenome"))


def test_shell_scope(work, monkeypatch):
    import code

    from npge_tpu_torch import meta

    seen = {}
    monkeypatch.setattr(
        code, "interact", lambda banner, local: seen.update(local)
    )
    main(["shell", "-w", work[1], "--device", "cpu"])
    assert seen["meta"] is meta and seen["device"] == torch.device("cpu")
    assert len(seen["bs"].blocks) > 3 and seen["cfg"].ANCHOR_SIZE == 21


def test_warmup_cpu(capsys):
    main(["warmup", "--size", "6000", "-n", "3", "--device", "cpu", *OPTS])
    out = capsys.readouterr().out
    assert out.startswith("warmup: 3x2000 bp built on cpu")
    assert "no kernel library on the CPU" in out


@pytest.mark.parametrize("verb", [
    ["make-pangenome"], ["check", "--deep"], ["run", "MakePangenome"],
    ["run", "Joiner"], ["warmup", "--size", "3000"], ["shell"],
])
def test_device_verbs_exit_without_gpu(verb, work, tmp_path, no_gpu):
    w = _twins(work[1], tmp_path)[0]
    before = sorted(os.listdir(w))
    code = _exit_code(main, [*verb, "-w", w, "--device", "cuda"])
    assert code not in (0, None)
    assert "torch.cuda.is_available() is False" in str(code)
    assert sorted(os.listdir(w)) == before


def test_host_check_needs_no_gpu(work, no_gpu):
    assert _exit_code(main, ["check", "-w", work[1], *OPTS]) == 0
