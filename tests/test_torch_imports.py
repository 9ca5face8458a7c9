"""npge_tpu_torch stands alone: no import of jax or of the JAX package
``npge_tpu`` in the port's sources or in ``chip_smoke.py``, and a build and
every CLI verb work with jax, jaxlib and npge_tpu blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "npge_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            assert node.level == 0, f"{path}: relative import"
            yield node.module
            for a in node.names:  # from npge_tpu import ops
                yield f"{node.module}.{a.name}"


def _forbidden(mod: str) -> bool:
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "npge_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"npge_tpu_torch/meta.py", "npge_tpu_torch/cli.py",
            "npge_tpu_torch/algo/is_pangenome.py"} <= names
    bad = [
        f"{p.relative_to(ROOT)}: {m}"
        for p in files for m in _imported_modules(p) if _forbidden(m)
    ]
    assert not bad, bad


def test_chip_smoke_imports_only_the_port():
    mods = set(_imported_modules(ROOT / "chip_smoke.py"))
    assert "npge_tpu_torch.cli" in mods
    bad = [m for m in mods if m.split(".")[0] == "npge_tpu"]
    assert not bad, bad


BLOCKED_RUN = r"""
import contextlib, importlib.abc, io, os, sys, tempfile

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "npge_tpu"):
            raise ImportError(f"blocked {name}")
        return None

sys.meta_path.insert(0, _Block())

from npge_tpu_torch import (
    blockset_hash, build_pangenome, check_is_pangenome, default_config,
    synthetic_arena,
)
from npge_tpu_torch.cli import main
from npge_tpu_torch.io.checkpoint import load_stage
from npge_tpu_torch.io.fasta import write_fasta

arena = synthetic_arena(
    n_genomes=3, length=5000, seed=4, sub_rate=0.006, indel_rate=0.001,
    n_inversions=1, circular=True,
)
cfg = default_config().replace(
    ANCHOR_SIZE=17, MIN_LENGTH=60, MIN_END=3, GAPPED_FLANK=64, MAX_LOOPS=2
)
bs, tm = build_pangenome(arena, cfg, "cpu")
assert tm.counters["gapext_pairs"] > 0, tm.counters
assert tm.counters.get("reseed.extend_cells", 0) > 0, tm.counters
work = tempfile.mkdtemp()
fasta = []
for i, name in enumerate(arena.names):
    fasta.append(os.path.join(work, f"g{i}.fa"))
    with open(fasta[-1], "w") as fh:
        write_fasta(fh, [(name, arena.seq_codes(i))])
opts = ["-o", "ANCHOR_SIZE=17", "-o", "MIN_LENGTH=60", "-o", "MIN_END=3",
        "-o", "GAPPED_FLANK=64", "-o", "MAX_LOOPS=2"]

def cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            main([*argv, "-w", work])
        except SystemExit as e:
            assert e.code in (0, None), (argv, e.code)
    return out.getvalue()

cli("prepare", "--fasta", *fasta)
assert load_stage(work, "input").arena.names == arena.names
assert cli("examine").strip()
cli("make-pangenome", "--device", "cpu", *opts)
assert blockset_hash(load_stage(work, "pangenome")) == blockset_hash(bs)
assert cli("hash").strip() == f"{blockset_hash(bs):016x}"
# the memo, then the probe itself (a changed config skips the memo)
for extra in ([], ["-o", "MAX_LOOPS=3"]):
    assert cli("check", "--deep", "--device", "cpu", *opts, *extra).startswith("OK")
cli("run", "MakePangenome", "--device", "cpu", "--stage-name", "again", *opts)
assert blockset_hash(load_stage(work, "again")) == blockset_hash(bs)
assert "MakePangenome" in cli("processors").split()
cli("post-processing")
cli("report")
assert cli("info").strip()
for f in ("blocks.tsv", "consensus_tree.nwk", "report.html", "again.bs"):
    assert os.path.exists(os.path.join(work, f)), f
rep = check_is_pangenome(bs, cfg, deep=True, device="cpu")
assert rep.ok, rep.messages
for mod in ("jax", "jaxlib", "npge_tpu"):
    assert mod not in sys.modules, mod
print("STANDALONE_OK", len(bs.blocks))
"""


def test_build_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "STANDALONE_OK" in res.stdout
