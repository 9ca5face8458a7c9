"""npge_tpu_torch's tracer (``npge_tpu_torch.trace.StageTimings``) on the
CPU: spans nest under the build with the right parents and book every
stage that the benchmark reads; under ``torch.profiler`` they appear as
``npge:`` events with their round tags and no device-side copy; without a
profiler no profiler record is opened; the extension's host-derived live
slot count equals a round-by-round recount; transfers are counted; the
``--timing`` table's TOTAL is the build span; and the benchmark's harness
reads the new metrics from a tiny CPU cell."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from npge_tpu_torch import default_config, synthetic_arena
from npge_tpu_torch import trace
from npge_tpu_torch.algo import extender
from npge_tpu_torch.algo.anchors import find_anchors
from npge_tpu_torch.algo.pangenome import StageTimings, build_pangenome
from npge_tpu_torch.device import to_device, to_host
from npge_tpu_torch.ops.extend import extend_chunk

REPO = Path(__file__).resolve().parents[1]

# the books that portbench/metrics/*.py read; a missing one reads as 0
READ_BOOKS = (
    "anchors", "reseed.scan", "extend", "reseed.extend.ext", "resolve",
    "reseed.resolve", "join", "reseed.join", "reseed.occ", "reseed.cons",
    "reseed.extend.deconseq", "gapext.assemble", "gapext.nw", "gapext.apply",
)


def _world():
    return synthetic_arena(
        n_genomes=4, length=20_000, seed=5, sub_rate=0.004,
        indel_rate=0.0003, n_inversions=1,
    )


@pytest.fixture(scope="module")
def built():
    return build_pangenome(_world(), default_config(), "cpu")


def test_spans_nest_under_the_build(built):
    _, t = built
    assert t.parents["build"] == [""]
    for book in READ_BOOKS:
        assert t.seconds.get(book, 0.0) > 0.0, book
    for child, parent in (
        ("anchors", "build"), ("reseed.extend.ext", "reseed.extend"),
        ("reseed.extend.deconseq", "reseed.extend"),
        ("deconseq.fast", "reseed.extend.deconseq"),
        ("gapext.nw", "gapext"), ("gapext.nw", "reseed.gapext"),
        ("reseed.occ.canon", "reseed.occ"), ("reseed.cons.upload", "reseed.cons"),
        ("resolve.native", "resolve"), ("resolve.native", "reseed.resolve"),
        ("blockset", "join"), ("sync.d2h", "extend"), ("sync.h2d", "upload"),
    ):
        assert parent in t.parents[child], (child, t.parents[child])
    # only the build is at the top, and the self times add up to it
    assert [k for k, p in t.parents.items() if "" in p] == ["build"]
    assert sum(t.self_seconds(k) for k in t.seconds) == pytest.approx(
        t.seconds["build"], rel=1e-9)
    # the books that hold sub-steps hold at least their seconds
    for outer, inner in (("reseed.extend", ("reseed.extend.ext", "reseed.extend.deconseq")),
                         ("reseed.occ", ("reseed.occ.rest", "reseed.occ.canon", "reseed.occ.hash"))):
        assert t.seconds[outer] >= sum(t.seconds[k] for k in inner)


def test_build_counts_its_work(built):
    c = built[1].counters
    for name in ("sync.d2h", "sync.d2h_bytes", "sync.h2d", "sync.h2d_bytes",
                 "extend.batches", "extend.rounds", "extend.slot_rounds",
                 "extend.useful_slot_rounds", "reseed.rounds", "reseed.mapped",
                 "resolve.native_cands", "deconseq.fast"):
        assert c.get(name, 0) > 0, name
    assert "deconseq.general" in c
    assert c["extend.useful_slot_rounds"] <= c["extend.slot_rounds"]
    assert c["reseed.reverted"] <= c["reseed.rounds"]


def test_report_total_is_the_build_span(built):
    _, t = built
    text = t.report()
    assert "Mcells" not in text
    total = [ln for ln in text.splitlines() if ln.startswith("TOTAL")]
    assert total and float(total[0].split()[-1]) == round(t.seconds["build"], 3)
    assert "extend_cells" in text and "sync.d2h" in text
    lines = text.splitlines()
    books = lines[1:lines.index(total[0])]
    assert len(books) == len(t.seconds)
    selfs = [float(ln.split()[-2]) for ln in books]
    assert sum(selfs) == pytest.approx(t.seconds["build"], abs=5e-4 * len(selfs))


def test_profiler_sees_spans_with_round_tags():
    cfg = default_config().replace(MAX_LOOPS=2)
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True
    ) as prof:
        build_pangenome(_world(), cfg, "cpu")
    names = {e.name for e in prof.events()}
    assert {"npge:build", "npge:extend", "npge:sync.d2h", "npge:reseed.scan"} <= names
    tags = [e.kwinputs for e in prof.events() if e.name == "npge:reseed.scan"]
    assert [(tg["round"], tg["k"]) for tg in tags] == [(0, 21), (1, 19)]
    # a function-scope record: the profiler makes no device-side copy of it
    kinds = {str(e.activity_type()) for e in prof.profiler.kineto_results.events()
             if e.name().startswith(trace.PREFIX)}
    assert kinds == {"cpu_op"}


def test_no_profiler_opens_no_record(monkeypatch):
    opened = []
    real = trace._record
    monkeypatch.setattr(trace, "_record", lambda name, tags: opened.append(name) or real(name, tags))
    cfg = default_config().replace(MAX_LOOPS=1)
    build_pangenome(_world(), cfg, "cpu")
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        build_pangenome(_world(), cfg, "cpu")
    assert opened[0] == "build" and "sync.d2h" in opened


def test_transfer_helpers_count_on_the_cpu():
    t = StageTimings()
    x = to_device(np.arange(10, dtype=np.int32), "cpu", t)
    y = to_host(torch.zeros(3, dtype=torch.int64), t)
    assert x.tolist() == list(range(10)) and y.tolist() == [0, 0, 0]
    assert t.counters == {"sync.h2d": 1, "sync.h2d_bytes": 40,
                          "sync.d2h": 1, "sync.d2h_bytes": 24}
    assert set(t.seconds) == {"sync.h2d", "sync.d2h"}
    to_host(torch.zeros(3))  # no tracer: nothing booked, nothing raised


def _recount_rounds(recount):
    """extend_rounds' loop, adding up the valid slots of the rows still
    extending as each round starts."""

    def run(codes2, base, fmask, cap, num, den, chunk, max_rounds, timings=None):
        z = torch.zeros(base.shape[0], dtype=torch.int32)
        cl, ci, total = z, z, z
        live = torch.ones(base.shape[0], dtype=torch.bool)
        rounds = 0
        while rounds < max_rounds:
            recount.append(int((live[:, None] & fmask).sum()))
            ext, cl, ci = extend_chunk(codes2, base, fmask, cap, cl, ci, num, den, chunk)
            rounds += 1
            total = total + ext
            live = ext == chunk
            if not bool(live.any()):
                break
            base = base + ext[:, None]
            cap = torch.where(live[:, None], (cap - ext[:, None]).clamp(min=0), 0)
        return total, rounds

    return run


@pytest.mark.parametrize("world,cfg_kw", [
    (dict(n_genomes=4, length=20_000, seed=5, sub_rate=0.004), {}),
    (dict(n_genomes=3, length=8_000, seed=9, sub_rate=0.001),
     dict(ANCHOR_SIZE=17, EXTEND_CHUNK=64)),
])
def test_useful_slot_rounds_equal_a_recount(monkeypatch, world, cfg_kw):
    arena = synthetic_arena(indel_rate=0.0003, **world)
    cfg = default_config().replace(**cfg_kw)
    groups = find_anchors(arena, cfg, "cpu")
    t = StageTimings()
    want = extender.extend_anchor_groups(arena, groups, cfg, "cpu", timings=t)
    recount = []
    monkeypatch.setattr(extender, "extend_rounds", _recount_rounds(recount))
    got = extender.extend_anchor_groups(arena, groups, cfg, "cpu")
    np.testing.assert_array_equal(got.length, want.length)
    c = t.counters
    assert c["extend.useful_slot_rounds"] == sum(recount) > 0
    assert c["extend.rounds"] == len(recount)
    assert c["extend.slot_rounds"] >= c["extend.useful_slot_rounds"]
    if cfg_kw:  # small chunks: some batch runs more than one round
        assert c["extend.rounds"] > c["extend.batches"]


def _tiny_root(tmp_path: Path, mesh: int = 1) -> Path:
    """A checkout's worth of the benchmark with one tiny CPU cell,
    ``tiny.tinymix``, that every metric lists; ``mesh`` shards on the CPU."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = {"name": "tiny", "source": "test", "reduced": [], "assumed": [],
           "chips": 1, "mesh": mesh, "n_genomes": 4, "genome_length": 6000,
           "circular": False, "pipeline": {}}
    (tmp_path / "portbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench" / "traffic" / "tinymix.json").write_text(
        json.dumps({"sub_rate": 0.01, "indel_rate": 0.002, "n_inversions": 1}))
    bench["configs"].append({"name": "tiny", "source": "test", "reduced": [],
                             "file": "portbench/configs/tiny.json", "why": "test"})
    bench["workloads"].append({"name": "tiny.tinymix", "config": "tiny",
                               "traffic": "tinymix", "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + ["tiny.tinymix"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_harness_reads_the_new_metrics_on_a_tiny_cell(tmp_path):
    """The benchmark's traced run on the CPU, in a process of its own (the
    harness refuses to run beside jax): the new per-layer metrics read a
    number, and the program's spans reach the trace."""
    root = _tiny_root(tmp_path)
    code = (
        "import json, sys, time; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from pathlib import Path\n"
        "from portbench import harness, profile_read, span_read\n"
        "kept = {}\n"
        "inner = profile_read.events_of\n"
        "def keep(prof):\n"
        "    kept['rows'] = span_read.events_of(prof)\n"
        "    return inner(prof)\n"
        "profile_read.events_of = keep\n"
        "line = harness.run('tiny.tinymix', 2**31 + 7, 0.0, True, t_start=time.perf_counter(),"
        " root=Path(sys.argv[1]), device='cpu', log=lambda *a, **k: None, warm=False)\n"
        "red = span_read.reduce_spans(kept['rows'])\n"
        "print(json.dumps({'line': line, 'spans': red}))\n")
    res = subprocess.run([sys.executable, "-c", code, str(root), str(REPO)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    line, red = out["line"], out["spans"]
    assert line["correct"] is True
    for name in ("sync_wait_s", "device_syncs", "extend_useful_share",
                 "deconseq_general_share", "resolve_python_share"):
        v = line["metrics"][name]["value"]
        assert isinstance(v, (int, float)) and v >= 0, name
    assert 0 < line["metrics"]["extend_useful_share"]["value"] <= 100
    # a one-card build books nothing that the mesh's readers read
    assert not [m for m in line["metrics"] if m.startswith("mesh_")]
    assert red["n_builds"] == 1 and red["build_self_s"] < 0.02 * red["build_s"]
    # on the CPU the whole window is idle: it is booked to the spans
    idle = sum(red["idle_by_span_s"].values())
    assert idle == pytest.approx(line["device"]["window_s"], rel=1e-3)
    assert red["idle_by_span_s"]["extend"] > 0


def test_reduce_events_unchanged_by_program_spans():
    """The harness's trace reduction gives the same numbers with the
    program's host-side spans among the events: they are not work and
    not step labels."""
    from portbench.profile_read import reduce_events

    base = [
        ("pb.window", False, -1, 0, 100), ("pb:find_anchors", False, -1, 10, 40),
        ("pb:join_blocks", False, -1, 50, 90), ("pb:find_anchors", True, 0, 10, 40),
        ("k1", True, 0, 20, 30), ("k1", True, 0, 25, 35), ("k2", True, 0, 60, 61),
        ("sw_xdrop_kernel", True, 0, 70, 72), ("k3", True, 1, 0, 50),
        ("k3", True, 1, 120, 130),
    ]
    spans = [
        ("npge:build", False, -1, 1, 99), ("npge:anchors", False, -1, 9, 41),
        ("npge:sync.d2h", False, -1, 30, 36), ("npge:join", False, -1, 49, 91),
        ("npge:sync.h2d", False, -1, 59, 60),
    ]
    want = reduce_events(base, 2)
    got = reduce_events(sorted(base + spans, key=lambda e: e[3]), 2)
    for key in ("window_s", "busy_s", "kernels_s", "idle_by_step_s", "launches_s"):
        assert got[key] == pytest.approx(want[key]), key


def test_span_reduction_books_idle_and_device_time():
    """Idle time goes to the innermost open span; device time to the span
    that launched it and to the span in which it ran."""
    from portbench.span_read import reduce_spans

    us = 1e-6
    events = [  # name, is_device, card, start, end, correlation
        ("pb.window", False, -1, 0, 100, 0),
        ("npge:build", False, -1, 0, 100, 0),
        ("npge:extend", False, -1, 10, 50, 0),
        ("npge:sync.d2h", False, -1, 40, 50, 0),
        ("npge:resolve", False, -1, 50, 90, 0),
        ("cudaLaunchKernel", False, -1, 12, 13, 7),
        ("aten::add", False, -1, 11, 14, 3),
        ("k", True, 0, 45, 55, 7),  # queued in extend, ran into resolve
        ("pb:join_blocks", True, 0, 50, 90, 0),  # a device-side label
        ("k_other_card", True, 1, 20, 30, 0),
    ]
    r = reduce_spans(events)
    assert r["n_builds"] == 1 and r["build_s"] == pytest.approx(100 * us)
    assert r["build_self_s"] == pytest.approx(20 * us)
    assert r["idle_by_span_s"] == pytest.approx(
        {"build": 20 * us, "extend": 30 * us, "sync.d2h": 5 * us, "resolve": 35 * us})
    assert r["device_by_launch_s"] == pytest.approx({"extend": 10 * us})
    assert r["device_by_run_s"] == pytest.approx({"sync.d2h": 10 * us})
