"""The harness on the CPU: a tiny cell driven through everything but the
card, found by name from files alone, held to the references, and failed
by the control and by every planted fault."""

import json
import os
import subprocess
import sys
import time

import pytest

from conftest import REPO

BANNED = {"jax", "jaxlib", "flax", "npge_tpu"}


def _run(root, cell, plant=None, trace=False, min_builds=1, seed=7):
    from portbench import harness
    from portbench import plant as plants

    return harness.run(cell, seed, 0.0, trace, t_start=time.perf_counter(),
                       root=root, device="cpu", log=lambda *a, **k: None,
                       plant=plants.PLANTS[plant] if plant else None,
                       min_builds=min_builds)


def test_run_without_a_card_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "brucella17.species-div", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "cuda" in res.stderr.lower()


def test_run_needs_the_program():
    """In a directory with only BENCHMARK.json and portbench/, a run fails."""
    res = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.remove(sys.argv[1]) if sys.argv[1] in sys.path else None; "
         "import runpy; sys.argv = ['run.py', '--workload', 'brucella17.species-div', '--seed', '1', "
         "'--seconds', '1', '--trace', '0']; runpy.run_path('portbench/run.py', run_name='__main__')", str(REPO)],
        cwd=REPO / "portbench" / "configs", capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "{" not in res.stdout


def test_files_added_are_found_by_name(tiny_root):
    """A configuration, a traffic mix and a metric reader added as files
    under a copy of the benchmark run without any edit of its code."""
    (tiny_root / "portbench" / "metrics" / "tiny_blocks.py").write_text(
        "def read(rec):\n    return float(rec['n_builds'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "tiny_blocks", "unit": "builds", "better": "higher",
        "source": "program_counter", "layer": "pipeline", "moves": "build_s",
        "workloads": ["tiny.tinymix"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "line = harness.run('tiny.tinymix', 5, 0.0, True, t_start=time.perf_counter(),"
        " root=Path(sys.argv[1]), device='cpu', log=lambda *a, **k: None)\n"
        "print(json.dumps(line))\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", code, str(tiny_root), str(REPO)],
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line, mods = (json.loads(x) for x in res.stdout.strip().splitlines()[-2:])
    assert line["correct"] is True
    assert line["metrics"]["tiny_blocks"] == {"value": 1.0, "unit": "builds"}
    for name in ("anchors_s", "extend_s", "resolve_s", "join_s",
                 "reseed_cons_s", "gapext_host_s", "sw_pairs"):
        assert name in line["metrics"], name
    assert list(line)[-1] == "checks"
    # what a run loads, compared by whole top-level names
    assert not BANNED & set(mods), mods
    assert "npge_tpu_torch" in mods


def test_references_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "import portbench.reference.anchors, portbench.reference.extend\n"
            "import portbench.reference.sw, portbench.reference.blockset\n"
            "import portbench.reference.joins, portbench.reference.consensus\n"
            "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert not (BANNED | {"npge_tpu_torch"}) & mods, mods


# each planted fault, with the number that must catch it; None is a clean
# run, which must pass
FAULTS = [
    (None, "tiny.tinymix", None),
    ("control", "tiny.tinymix", "candidates_differing"),
    ("unchanged", "tiny.tinymix", "candidates_differing"),
    ("half_batch", "tiny.tinymix", "sw_rows_differing"),
    ("no_exchange", "tiny4.tinymix", "anchor_groups_differing"),
    ("anchor", "tiny.tinymix", "anchor_groups_differing"),
    ("sw_row", "tiny.tinymix", "sw_rows_differing"),
    ("fragment", "tiny.tinymix", "partition_errors"),
    ("row_text", "tiny.tinymix", "bad_blocks"),
    ("one_build", "tiny.tinymix", "builds_differing"),
    ("no_join", "tiny.tinymix", "joinable_pairs"),
    ("fewer_rounds", "tiny.tinymix", "reseed_short_of_kmin"),
    ("cons_base", "tiny.tinymix", "consensus_differing"),
    ("no_deconseq", "tiny.tinymix", "mapped_missing"),
    ("no_halo", "tinyc.tinymix", "anchor_groups_differing"),
    ("no_origin_join", "tinyc.tinymix", "joinable_pairs"),
    ("fragment", "tinyc.tinymix", "partition_errors"),
]


@pytest.mark.parametrize("plant,cell,caught_by", FAULTS,
                         ids=[(f[0] or "clean") + ("-circular" if f[1] == "tinyc.tinymix" else "")
                              for f in FAULTS])
def test_check_fails_every_planted_fault(tiny_root, plant, cell, caught_by):
    line = _run(tiny_root, cell, plant=plant, min_builds=2)
    checks = {k: v["value"] for k, v in line["checks"].items()}
    if plant is None:
        assert line["correct"] is True and line["failed"] == 0, checks
        assert line["attempted"] == 2
    else:
        assert line["correct"] is False and line["failed"] >= 1, checks
        assert checks[caught_by] > 0, checks


def test_mesh_cell_matches_the_references(tiny_root):
    line = _run(tiny_root, "tiny4.tinymix", trace=True)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["count"] == 1 and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
