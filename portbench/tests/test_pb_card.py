"""The benchmark's cells on the card: each runs and is correct, and the
control fails the check at the cell's own size. Marked ``card``; each test
skips without enough NVIDIA GPUs (see portbench/README.md)."""

import json
import subprocess
import sys

import pytest

from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = BENCH["workloads"]


def _need_cards(n: int) -> None:
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} CUDA device(s), {have} visible")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS, ids=[c["name"] for c in CELLS])
def test_cell_runs_correct_on_the_card(cell):
    _need_cards(cell["chips"])
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell["name"],
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == cell["chips"]
    assert set(line["metrics"]) == {m["name"] for m in BENCH["end_to_end"]
                                    if cell["name"] in m.get("workloads", [cell["name"]])}
    assert all(v["value"] > 0 for v in line["metrics"].values()), line["metrics"]


@pytest.mark.card
def test_control_fails_on_the_card():
    _need_cards(1)
    res = subprocess.run(
        [sys.executable, "portbench/readings.py", "--workload",
         "brucella17.species-div", "--seeds", "2147484001", "--plant", "control"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["checks"]["candidates_differing"] > 0
