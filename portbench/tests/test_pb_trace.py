"""The readers of the program's own spans and counters, on hand-made
records, and the span reduction of ``span_read.py`` on a fixed event
list."""

import pytest

from conftest import REPO
from portbench import harness


def _record():
    """Two builds' books and counters, summed as the harness sums them."""
    from npge_tpu_torch.trace import StageTimings

    books, counters = {}, {}
    for build in range(2):
        t = StageTimings()
        t.add("sync.d2h", 0.5 * (build + 1))
        t.add("sync.h2d", 0.25)
        for name, n in (("sync.d2h", 30), ("sync.h2d", 10),
                        ("extend.slot_rounds", 1000), ("extend.useful_slot_rounds", 250),
                        ("reseed.extend.slot_rounds", 600),
                        ("reseed.extend.useful_slot_rounds", 150),
                        ("deep.extend.slot_rounds", 10_000),
                        ("deconseq.fast", 90), ("deconseq.general", 10),
                        ("resolve.native_cands", 95), ("resolve.python_cands", 5)):
            t.count(name, n)
        for k, v in t.seconds.items():
            books[k] = books.get(k, 0.0) + v
        for k, v in t.counters.items():
            counters[k] = counters.get(k, 0) + v
    return {"n_builds": 2, "books": books, "counters": counters}


@pytest.mark.parametrize("name,want", [
    ("sync_wait_s", (0.5 + 1.0 + 0.5) / 2), ("device_syncs", 40.0),
    ("extend_useful_share", 25.0), ("deconseq_general_share", 10.0),
    ("resolve_python_share", 5.0),
])
def test_program_readers(name, want):
    assert harness.metric_reader(REPO, name)(_record()) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "sync_wait_s", "device_syncs", "extend_useful_share",
    "deconseq_general_share", "resolve_python_share",
])
def test_program_readers_without_the_books_return_nothing(name):
    """A program that books none of them (an earlier commit) reads as
    nothing, not as 0."""
    rec = {"n_builds": 2, "books": {"resolve": 1.0}, "counters": {"extend_cells": 5}}
    assert harness.metric_reader(REPO, name)(rec) is None


def test_span_reduction_books_idle_and_device_time():
    from portbench.span_read import innermost, reduce_spans

    assert innermost([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"), (6, 6, "d")]) == [
        (0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a")]
    us = 1e-6
    events = [
        ("pb.window", False, -1, 0, 100, 0), ("npge:build", False, -1, 0, 100, 0),
        ("npge:extend", False, -1, 10, 50, 0), ("npge:resolve", False, -1, 50, 90, 0),
        ("k", True, 0, 45, 55, 9),  # no runtime call queued it
    ]
    r = reduce_spans(events)
    assert r["device_by_launch_s"] == pytest.approx({"(none)": 10 * us})
    assert r["device_by_run_s"] == pytest.approx({"extend": 10 * us})
    assert r["idle_by_span_s"] == pytest.approx(
        {"build": 20 * us, "extend": 35 * us, "resolve": 35 * us})
