"""The mesh's books on the CPU: a build over ``DeviceMesh([cpu] * 4)``
books the sharded scan, its slices and merge, and each extension slice
under the right parents; the per-shard counters sum to their totals; the
tracer changes no blockset; a one-card build books no ``mesh.*`` name; the
benchmark's mesh readers read hand-made records; and the harness reads
them from a tiny four-shard cell, whose planted ``no_exchange`` fault still
fails the check."""

import json
import subprocess
import sys

import numpy as np
import pytest

from npge_tpu_torch import default_config, synthetic_arena
from npge_tpu_torch.algo.pangenome import build_pangenome
from npge_tpu_torch.model.hashing import blockset_hash
from npge_tpu_torch.parallel import distributed
from npge_tpu_torch.parallel.mesh import DeviceMesh
from test_torch_trace import REPO, _tiny_root

SHARDS = 4


def _world():
    return synthetic_arena(
        n_genomes=4, length=20_000, seed=5, sub_rate=0.004,
        indel_rate=0.0003, n_inversions=1,
    )


@pytest.fixture(scope="module")
def meshed():
    return build_pangenome(_world(), default_config(), "cpu",
                           mesh=DeviceMesh(["cpu"] * SHARDS))


@pytest.fixture(scope="module")
def single():
    return build_pangenome(_world(), default_config(), "cpu")


def _shard_counts(counters: dict, prefix: str) -> list[int]:
    return [counters[f"{prefix}.s{i}"] for i in range(SHARDS)]


def test_mesh_spans_nest_under_their_stages(meshed):
    _bs, t = meshed
    assert t.parents["mesh.scan"] == ["anchors"]
    assert t.parents["mesh.scan.slice"] == ["mesh.scan"]
    assert t.parents["mesh.scan.merge"] == ["mesh.scan"]
    assert t.parents["mesh.extend.slice"] == ["extend", "reseed.extend.ext"]
    assert t.seconds["mesh.scan"] >= t.seconds["mesh.scan.slice"] + t.seconds["mesh.scan.merge"]
    assert t.seconds["mesh.extend.slice"] <= (
        t.seconds["extend"] + t.seconds["reseed.extend.ext"])


def test_mesh_counters_sum_to_their_totals(meshed):
    _bs, t = meshed
    arena, cfg = _world(), default_config()
    # one slice over the whole arena is the single-device scan's rows
    _key, pos, _strand = distributed.scan_slice(
        arena, cfg, cfg.ANCHOR_SIZE, 0, arena.total_length, "cpu")
    rows = _shard_counts(t.counters, "mesh.scan.rows")
    assert sum(rows) == len(pos) and min(rows) > 0
    slots = _shard_counts(t.counters, "mesh.extend.slot_rounds")
    assert sum(slots) == (t.counters["extend.slot_rounds"]
                          + t.counters["reseed.extend.slot_rounds"])
    assert t.counters["reseed.extend.slot_rounds"] > 0 and min(slots) > 0


def test_tracer_changes_no_blockset(meshed, single, monkeypatch):
    monkeypatch.setattr(DeviceMesh, "traced", lambda self, timings: self)
    bare, t = build_pangenome(_world(), default_config(), "cpu",
                              mesh=DeviceMesh(["cpu"] * SHARDS))
    assert "mesh.scan" not in t.seconds  # its mesh carries no tracer
    assert blockset_hash(meshed[0]) == blockset_hash(single[0]) == blockset_hash(bare)


def test_one_card_build_books_no_mesh_name(single):
    _bs, t = single
    names = [*t.seconds, *t.counters]
    assert names and not [n for n in names if n.startswith("mesh.")]


def _record(chips=4, busy=(2.0, 1.0, 0.5, 0.0)):
    books = {"mesh.scan": 3.0, "mesh.scan.slice": 2.0, "mesh.scan.merge": 1.0,
             "mesh.extend.slice": 5.0, "anchors": 4.0}
    counters = {"mesh.extend.slot_rounds.s0": 300, "mesh.extend.slot_rounds.s1": 100,
                "mesh.extend.slot_rounds.s2": 100, "mesh.extend.slot_rounds.s3": 100,
                "extend.slot_rounds": 600}
    return {"n_builds": 2, "books": books, "counters": counters, "chips": chips,
            "window_s": 10.0, "busy_s": list(busy[:chips])}


@pytest.mark.parametrize("name,want", [
    ("mesh_scan_s", 1.5), ("mesh_merge_s", 0.5), ("mesh_extend_s", 2.5),
    ("mesh_balance", 200.0), ("mesh_cards_idle", 100 * (0.9 + 0.95 + 1.0) / 3),
])
def test_mesh_readers(name, want):
    from portbench import harness

    assert harness.metric_reader(REPO, name)(_record()) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "mesh_scan_s", "mesh_merge_s", "mesh_extend_s", "mesh_balance",
    "mesh_cards_idle",
])
def test_mesh_readers_without_a_mesh_return_nothing(name):
    """A one-card build, or a program whose mesh books nothing (an earlier
    commit), reads as nothing, not as 0."""
    from portbench import harness

    rec = _record(chips=1)
    rec["books"] = {"anchors": 4.0}
    rec["counters"] = {"extend.slot_rounds": 600}
    assert harness.metric_reader(REPO, name)(rec) is None
    if name == "mesh_cards_idle":  # the books alone do not make a second card
        assert harness.metric_reader(REPO, name)(_record(chips=1)) is None


@pytest.mark.parametrize("plant", [None, "no_exchange"])
def test_harness_reads_the_mesh_metrics_on_a_tiny_four_shard_cell(tmp_path, plant):
    """The benchmark's run of a four-shard CPU cell, in a process of its own
    (the harness refuses to run beside jax): traced, it is correct and four
    mesh metrics read a number (no second card on the CPU); with the
    exchange between shards left out (``plant.no_exchange``, which wraps
    ``parallel.sharded.scan_slice``), the check fails it."""
    root = _tiny_root(tmp_path, mesh=SHARDS)
    code = (
        "import json, sys, time; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from pathlib import Path\n"
        "from portbench import harness, plant\n"
        "name = sys.argv[3]\n"
        "line = harness.run('tiny.tinymix', 2**31 + 11, 0.0, name == 'None',"
        " t_start=time.perf_counter(), root=Path(sys.argv[1]), device='cpu',"
        " plant=plant.PLANTS.get(name), log=lambda *a, **k: None, warm=False)\n"
        "print(json.dumps(line))\n")
    res = subprocess.run(
        [sys.executable, "-c", code, str(root), str(REPO), str(plant)],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    checks = {k: v["value"] for k, v in line["checks"].items()}
    if plant is None:
        assert line["correct"] is True, checks
        got = {m: v["value"] for m, v in line["metrics"].items() if m.startswith("mesh_")}
        assert sorted(got) == ["mesh_balance", "mesh_extend_s", "mesh_merge_s", "mesh_scan_s"]
        assert 0 < got["mesh_merge_s"] < got["mesh_scan_s"]
        assert got["mesh_extend_s"] > 0 and 100 <= got["mesh_balance"] <= 100 * SHARDS
        assert np.isfinite(list(got.values())).all()
    else:
        assert line["correct"] is False, checks
        assert checks["anchor_groups_differing"] > 0, checks
