"""npge_tpu_torch never loads jax: no import of it (or of the reference's
jax modules) in the port's sources, and a build with jax blocked works."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = (
    "jax", "jaxlib", "npge_tpu.ops", "npge_tpu.parallel",
    "npge_tpu.algo.anchors", "npge_tpu.algo.extender",
    "npge_tpu.algo.pangenome", "npge_tpu.meta",
)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            for a in node.names:  # from npge_tpu import ops
                yield f"{node.module}.{a.name}"


def _forbidden(mod: str) -> bool:
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "npge_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [
        f"{p.relative_to(ROOT)}: {m}"
        for p in files for m in _imported_modules(p) if _forbidden(m)
    ]
    assert not bad, bad


BLOCKED_RUN = r"""
import importlib.abc, os, sys, tempfile

class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("blocked jax")
        return None

sys.meta_path.insert(0, _BlockJax())

from npge_tpu.config import default_config
from npge_tpu.io.checkpoint import load_stage, save_stage
from npge_tpu.model.blocks import BlockSet
from npge_tpu.model.hashing import blockset_hash
from npge_tpu.util.synthetic import synthetic_arena
from npge_tpu_torch.algo.pangenome import build_pangenome
from npge_tpu_torch.cli import main

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
save_stage(work, "input", BlockSet(arena, []))
main(["make-pangenome", "-w", work, "--device", "cpu",
      "-o", "ANCHOR_SIZE=17", "-o", "MIN_LENGTH=60", "-o", "MIN_END=3",
      "-o", "GAPPED_FLANK=64", "-o", "MAX_LOOPS=2"])
assert blockset_hash(load_stage(work, "pangenome")) == blockset_hash(bs)
assert "jax" not in sys.modules and "jaxlib" not in sys.modules
print("JAX_FREE_OK", len(bs.blocks))
"""


def test_build_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_FREE_OK" in res.stdout
