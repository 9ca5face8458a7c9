#!/usr/bin/env python3
"""The program's own spans on the clock of the device trace.

npge_tpu_torch books every step of a build in its tracer (``StageTimings``),
which, while a profiler records, also opens a host-side profiler event
``npge:<name>`` for each span: ``npge:build`` around the whole build, the
stages inside it, their sub-steps inside those, and each blocking transfer
(``npge:sync.d2h``, ``npge:sync.h2d``) innermost. Two reductions of a
traced window read them:

* ``idle_by_span_s``: card 0's idle time in the window, booked to the
  innermost program span open on the host at the time, as that span's
  self time ("build" is idle under the build but under none of its steps,
  "(none)" idle outside every span);
* ``device_by_launch_s`` and ``device_by_run_s``: card 0's device time,
  booked once to the innermost span open when the host queued each
  operation (the launch that the profiler correlates with it) and once to
  the innermost span open while the card ran it. Where they differ, device
  work queued by one step runs while the host is in a later one.

Device-side copies of host annotations (``pb:`` labels, ``pb.window``) are
labels, not work, and are dropped. Run

    python3 portbench/span_read.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout for one traced run of the cell, as
``run.py --trace 1`` makes it: the result line on standard output, and on
standard error both reductions, the share of each build's host time that
the build's steps cover, the spans a build opens, the program's counters
over the window's builds, and the ``--timing`` table of the last build.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from pathlib import Path

T_START = time.perf_counter()

PREFIX = "npge:"
WINDOW = "pb.window"
LABELS = ("pb:", PREFIX)
NONE = "(none)"


def events_of(prof) -> list:
    """(name, is_device, device_index, start_us, end_us, correlation) of a
    finished ``torch.profiler.profile``, from its Kineto events: a device
    operation has the correlation of the runtime call that queued it."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        a = e.start_ns() / 1e3
        rows.append((e.name(), dev, int(e.device_index()) if dev else -1, a,
                     a + e.duration_ns() / 1e3, int(e.correlation_id())))
    return rows


def innermost(spans) -> list:
    """(start, end, name) pieces of the timeline, each under the innermost
    of ``spans`` (properly nested (start, end, name) intervals) open there;
    time under none of them is left out."""
    bounds = sorted({t for a, b, _n in spans if b > a for t in (a, b)})
    opening = defaultdict(list)
    for a, b, name in spans:
        if b > a:
            opening[a].append((b, name))
    out, stack = [], []
    for t, t_next in zip(bounds, bounds[1:]):
        while stack and stack[-1][0] <= t:
            stack.pop()
        for b, name in sorted(opening.get(t, ()), reverse=True):
            stack.append((b, name))
        if stack:
            out.append((t, t_next, stack[-1][1]))
    return out


def _at(pieces, starts, t) -> str:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and pieces[i][0] <= t < pieces[i][1]:
        return pieces[i][2]
    return NONE


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_spans(events, card: int = 0) -> dict:
    """The reductions of the module docstring over the windows
    (``pb.window`` spans) of ``events`` (rows of :func:`events_of`), in
    seconds, with the host time of the ``build`` spans and of their own
    self time (under no step), and the number of builds."""
    windows = sorted((a, b) for n, d, _i, a, b, *_ in events if n == WINDOW and not d)
    spans = [(a, b, n[len(PREFIX):]) for n, d, _i, a, b, *_ in events
             if n.startswith(PREFIX) and not d]
    pieces = innermost(spans)
    starts = [a for a, _b, _n in pieces]
    # the CUDA runtime calls (cudaLaunchKernel, cudaMemcpyAsync, ...) that
    # queued each device operation, by correlation
    launch = {corr: a for n, d, _i, a, _b, corr in events
              if not d and corr and n.startswith("cu")}
    dev = [(a, b, corr) for n, d, i, a, b, corr in events
           if d and i == card and not n.startswith(LABELS) and n != WINDOW]
    by_launch, by_run = defaultdict(float), defaultdict(float)
    busy = []
    for a, b, corr in dev:
        for lo, hi in windows:
            a2, b2 = max(a, lo), min(b, hi)
            if b2 <= a2:
                continue
            busy.append((a2, b2))
            t_launch = launch.get(corr)
            queued = NONE if t_launch is None else _at(pieces, starts, t_launch)
            by_launch[queued] += (b2 - a2) / 1e6
            by_run[_at(pieces, starts, a2)] += (b2 - a2) / 1e6
    idle = defaultdict(float)
    for lo, hi in windows:
        t, gaps = lo, []
        for a, b in _union([iv for iv in busy if lo <= iv[0] < hi]):
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        for a, b in gaps:
            left = b - a
            i = max(0, bisect.bisect_right(starts, a) - 1)
            while i < len(pieces) and pieces[i][0] < b:
                pa, pb, name = pieces[i]
                part = min(b, pb) - max(a, pa)
                if part > 0:
                    idle[name] += part / 1e6
                    left -= part
                i += 1
            if left > 0:
                idle[NONE] += left / 1e6
    builds = [(a, b) for a, b, n in spans if n == "build"]
    build_self = sum(b - a for a, b, n in pieces if n == "build")
    return {
        "n_builds": len(builds),
        "build_s": sum(b - a for a, b in builds) / 1e6,
        "build_self_s": build_self / 1e6,
        "spans": len(spans),
        "idle_by_span_s": dict(idle),
        "device_by_launch_s": dict(by_launch),
        "device_by_run_s": dict(by_run),
    }


def log_reduction(red: dict, log=print) -> None:
    n = max(red["n_builds"], 1)
    cover = 1.0 - red["build_self_s"] / red["build_s"] if red["build_s"] else 0.0
    log(f"[spans] {red['n_builds']} builds, {red['build_s']:.6f} s under "
        f"npge:build, {red['build_self_s']:.6f} s of it under no step: the "
        f"steps cover {100 * cover:.3f} %; {red['spans'] / n:.1f} spans a build",
        file=sys.stderr)
    for key in ("idle_by_span_s", "device_by_launch_s", "device_by_run_s"):
        top = sorted(red[key].items(), key=lambda kv: -kv[1])
        log(f"[spans] {key} (s a build): "
            + ", ".join(f"{k} {v / n:.6f}" for k, v in top), file=sys.stderr)
    moved = {k: red["device_by_run_s"].get(k, 0.0) - red["device_by_launch_s"].get(k, 0.0)
             for k in set(red["device_by_run_s"]) | set(red["device_by_launch_s"])}
    top = sorted(moved.items(), key=lambda kv: -abs(kv[1]))[:12]
    log("[spans] device time run minus launched under each span (s a build): "
        + ", ".join(f"{k} {v / n:+.6f}" for k, v in top), file=sys.stderr)


def main(argv=None) -> int:
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "portbench" / sub)
    sys.path.insert(0, str(root))
    import npge_tpu_torch
    from portbench import harness, profile_read

    kept, books = {}, []
    inner, build = profile_read.events_of, npge_tpu_torch.build_pangenome

    def events_and_keep(prof):
        kept["rows"] = events_of(prof)
        return inner(prof)

    def build_and_keep(*a, **kw):
        bs, tm = build(*a, **kw)
        books.append(tm)
        return bs, tm

    profile_read.events_of = events_and_keep
    npge_tpu_torch.build_pangenome = build_and_keep
    try:
        line = harness.run(args.workload, args.seed, args.seconds, True,
                           t_start=T_START, root=root)
    except harness.RunError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    finally:
        profile_read.events_of = inner
        npge_tpu_torch.build_pangenome = build
    log_reduction(reduce_spans(kept["rows"]))
    window = books[1:]  # the first build is the warm-up
    counters = defaultdict(int)
    for tm in window:
        for k, v in tm.counters.items():
            counters[k] += v
    print("[spans] counters a build: " + ", ".join(
        f"{k} {v / len(window):.1f}" for k, v in sorted(counters.items())), file=sys.stderr)
    print(books[-1].report(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
