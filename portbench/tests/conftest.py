"""Tests of the benchmark harness. CPU tests drive a tiny cell through
everything but the card; tests marked ``card`` need an NVIDIA GPU and
skip without one (see portbench/README.md)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIG = {
    "name": "tiny", "source": "a tiny world for the harness's tests",
    "reduced": [], "assumed": [], "chips": 1, "mesh": 1,
    "n_genomes": 4, "genome_length": 6000, "circular": False, "pipeline": {},
}
# 4 genomes of two circular chromosomes, their origins turned
TINY_CIRCULAR = dict(TINY_CONFIG, chromosome_lengths=[4000, 2000], circular=True,
                     rotate_origins=True)
TINY_TRAFFIC = {"sub_rate": 0.01, "indel_rate": 0.002, "n_inversions": 1}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (CUDA); skips without one")


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout's worth of the benchmark in ``tmp_path``: BENCHMARK.json
    and portbench/, with a tiny configuration (``tiny``, ``tiny4`` on a
    4-shard mesh, and ``tinyc`` of circular genomes) and traffic mix
    (``tinymix``) added as files, and cells ``tiny.tinymix``,
    ``tiny4.tinymix`` and ``tinyc.tinymix`` that report every metric."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = []
    for name, base, mesh in (("tiny", TINY_CONFIG, 1), ("tiny4", TINY_CONFIG, 4),
                             ("tinyc", TINY_CIRCULAR, 1)):
        cfg = dict(base, name=name, mesh=mesh)
        (tmp_path / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "reduced": [],
                                 "file": f"portbench/configs/{name}.json", "why": "test"})
        bench["workloads"].append({"name": f"{name}.tinymix", "config": name,
                                   "traffic": "tinymix", "chips": 1, "why": "test"})
        cells.append(f"{name}.tinymix")
    (tmp_path / "portbench" / "traffic" / "tinymix.json").write_text(json.dumps(TINY_TRAFFIC))
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + cells
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += cells
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
