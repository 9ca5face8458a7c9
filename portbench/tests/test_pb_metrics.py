"""The per-layer readers and the SW yardstick, on hand-made records."""

import numpy as np
import pytest
import torch

from conftest import REPO
from portbench import harness, roofline
from portbench.reference import sw as ref_sw


def _record():
    from npge_tpu_torch.algo.pangenome import StageTimings

    books, counters = {}, {}
    for build in range(2):  # two builds' books, summed as the harness does
        t = StageTimings()
        for stage, s in (("anchors", 1.0), ("reseed.scan", 0.5), ("extend", 2.0),
                         ("reseed.extend.ext", 0.25), ("reseed.extend", 3.0),
                         ("resolve", 1.5), ("reseed.resolve", 2.5), ("join", 0.75),
                         ("reseed.join", 0.25), ("reseed.occ", 0.5),
                         ("reseed.cons", 1.0), ("reseed.extend.deconseq", 2.75),
                         ("gapext", 9.0), ("gapext.assemble", 0.1),
                         ("gapext.sw", 5.0), ("gapext.nw", 0.2), ("gapext.apply", 0.3)):
            t.add(stage, s * (build + 1))
        t.count("gapext_pairs", 10)
        for k, v in t.seconds.items():
            books[k] = books.get(k, 0.0) + v
        for k, v in t.counters.items():
            counters[k] = counters.get(k, 0) + v
    return {"n_builds": 2, "books": books, "counters": counters, "sw_pairs": 10,
            "sw_batches": [], "peak_bytes": [3 * 2**30, 0],
            "device_name": "NVIDIA H100 80GB HBM3", "window_s": 10.0,
            "busy_s": [1.0, 0.5], "kernels_s": {}}


@pytest.mark.parametrize("name,want", [
    ("anchors_s", 1.5 * 1.5), ("extend_s", 2.25 * 1.5), ("resolve_s", 4.0 * 1.5),
    ("join_s", 1.0 * 1.5), ("reseed_cons_s", 4.25 * 1.5), ("gapext_host_s", 0.6 * 1.5),
    ("sw_pairs", 10), ("device_idle", 90.0), ("peak_mem_gib", 3.0),
])
def test_reader_sums(name, want):
    assert harness.metric_reader(REPO, name)(_record()) == pytest.approx(want)


def test_a_role_twin_reads_as_its_base():
    rec = dict(_record(), walls=[4.0, 5.0])
    for name in ("anchors_s", "reseed_cons_s", "sw_pairs", "device_idle"):
        assert (harness.metric_reader(REPO, f"{name}.setup")(rec)
                == harness.metric_reader(REPO, name)(rec))
    assert harness.metric_reader(REPO, "build_s.setup")(rec) == pytest.approx(4.5)


def test_every_cell_reports_what_its_metrics_move():
    """Each cell reports setup_s, another end-to-end metric and a per-layer
    one; each per-layer metric has a reader and moves an end-to-end metric
    that every cell it lists reports."""
    import json

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for cell in cells:
        have = {n for n, wl in e2e.items() if cell in wl}
        assert "setup_s" in have and len(have) >= 2, (cell, have)
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"]), cell
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(REPO, m["name"])), m["name"]
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m["name"]


def test_readers_without_a_reading_return_nothing():
    rec = _record()
    assert harness.metric_reader(REPO, "sw_roofline")(rec) is None  # no kernel time
    rec.update(busy_s=[0.0], peak_bytes=[0])
    assert harness.metric_reader(REPO, "device_idle")(rec) is None
    assert harness.metric_reader(REPO, "peak_mem_gib")(rec) is None


def _naive_needed(q, t, L=512, W=128, match=1, mismatch=-2, gap=-3, xdrop=64):
    """The cell-by-cell recurrence on a dict, anti-diagonal by
    anti-diagonal, for the needed diagonal and the endpoint."""
    NEG = ref_sw.NEG
    H = {(0, 0): 0}
    best, bi, bj = 0, 0, 0
    if len(q) >= 1:
        H[(1, 0)] = gap
    if len(t) >= 1:
        H[(0, 1)] = gap
    prev_max = max([H.get((1, 0), NEG), H.get((0, 1), NEG)])
    for d in range(2, len(q) + len(t) + 1):
        ib = (d + 1) // 2 - W // 2
        col = NEG
        cells = []
        for r in range(W):
            i, j = ib + r, d - ib - r
            if not (0 <= i <= len(q) and 0 <= j <= len(t)):
                continue
            v = NEG
            if i >= 1 and j >= 1 and (i - 1, j - 1) in H:
                v = max(v, H[(i - 1, j - 1)] + (match if q[i - 1] == t[j - 1] else mismatch))
            if i >= 1 and (i - 1, j) in H:
                v = max(v, H[(i - 1, j)] + gap)
            if j >= 1 and (i, j - 1) in H:
                v = max(v, H[(i, j - 1)] + gap)
            if v < best - xdrop:
                continue
            H[(i, j)] = v
            cells.append((v, i, j))
        if cells:
            col = max(c[0] for c in cells)
        if col > best:
            best, bi, bj = col, *min((c[1], c[2]) for c in cells if c[0] == col)
        if col == NEG and prev_max == NEG:
            return d, (best, bi, bj)
        prev_max = col
    return max(len(q) + len(t), 1), (best, bi, bj)


def test_sw_needed_cells_match_a_hand_count():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, 300).astype(np.uint8)
    b = a.copy()
    b[150:] = rng.integers(0, 4, 150)  # a homologous start, then noise
    pairs = [(a[:40], a[:40]), (a[:0], a[:0]), (a[:300], b[:300]),
             (a[:64], (3 - a[:64]).astype(np.uint8)), (a[:5], a[:3])]
    codes = np.concatenate([np.concatenate([q, t]) for q, t in pairs])
    qb, tb, qc, tc, pos = [], [], [], [], 0
    for q, t in pairs:
        qb.append(pos)
        tb.append(pos + len(q))
        qc.append(len(q))
        tc.append(len(t))
        pos += len(q) + len(t)
    out, needed = ref_sw.sw_endpoints(torch.from_numpy(codes), qb, qc, tb, tc, 512)
    for p, (q, t) in enumerate(pairs):
        d, ends = _naive_needed(list(q), list(t))
        assert int(needed[p]) == d, p
        assert tuple(out[p].tolist()) == ends, p
    assert int(needed[0]) == 80 and int(needed[1]) == 1  # no early exit there
    cells = roofline.sw_needed_cells(needed)
    assert cells == 128 * sum(int(n) + 1 for n in needed)
    peak = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    # 132 SMs x 64 lanes x 2 halves x 1.98 GHz = 33.45 T packed op/s
    assert roofline.packed_ops_per_s(peak) == pytest.approx(3.345408e13)
    ops = 8 * cells / 3.345408e13
    assert roofline.sw_bound_s(cells, 0, peak) == pytest.approx(ops)
    assert roofline.sw_bound_s(cells, 0, peak, packed=False) == pytest.approx(2 * ops)


def test_reference_sw_equals_the_programs_plain_version():
    """On the CPU the program runs its plain torch SW; the yardstick, a
    separate statement of the recurrence, gives the same rows."""
    from npge_tpu_torch.ops.sw import sw_extend_windows

    rng = np.random.default_rng(11)
    anc = rng.integers(0, 4, 4000).astype(np.uint8)
    mut = anc.copy()
    flip = rng.random(4000) < 0.05
    mut[flip] = (mut[flip] + 1) % 4
    mut[rng.random(4000) < 0.01] = 4  # some N
    codes = torch.from_numpy(np.concatenate([anc, mut]))
    codes2 = ref_sw.doubled(codes)
    P = 300
    qb = rng.integers(0, 3400, P)
    tb = qb + 4000 + rng.integers(-3, 4, P)
    qc = rng.integers(0, 520, P)
    tc = rng.integers(0, 520, P)
    want = sw_extend_windows(codes2, qb, qc, tb, tc, 512)
    got, _ = ref_sw.sw_endpoints(codes2, qb, qc, tb, tc, 512)
    assert torch.equal(got, want)


def test_trace_reduction_books_idle_time_to_steps():
    """Busy time is the union of a card's events; idle time is split over
    the step spans it overlaps, the rest booked to "other"; the labels and
    their device-side mirrors are not work."""
    from portbench.profile_read import reduce_events

    us = 1e-6
    events = [
        ("pb.window", False, -1, 0, 100), ("pb:scan", False, -1, 10, 40),
        ("pb:join", False, -1, 50, 90), ("pb:scan", True, 0, 10, 40),
        ("k1", True, 0, 20, 30), ("k1", True, 0, 25, 35), ("k2", True, 0, 60, 61),
        ("k3", True, 1, 0, 50), ("k3", True, 1, 120, 130),
    ]
    r = reduce_events(events, 2)
    assert r["window_s"] == pytest.approx(100 * us)
    assert r["busy_s"] == pytest.approx([16 * us, 50 * us])
    assert r["kernels_s"] == pytest.approx({"k1": 20 * us, "k2": 1 * us, "k3": 50 * us})
    assert r["idle_by_step_s"] == pytest.approx(
        {"scan": 15 * us, "join": 39 * us, "other": 30 * us})
