#!/usr/bin/env python3
"""Readings of the correctness check over many seeds in one process, for
setting and re-checking its limits (not part of a measured run):

    python3 portbench/readings.py --workload <cell> --seconds <s> \\
        --seeds 11 12 13 [--plant control no_join ...]

Each seed builds its own world and runs a window of ``--seconds`` (one
build at the least); with ``--plant`` each named entry of
``portbench.plant`` in turn replaces its part of the program first. One
JSON line a seed and plant: the seed, ``correct``, the builds, their
seconds each (the first build of a process pays its warm-up), the card's
peak memory and each compared number; the harness's own lines, the check's
seconds among them, go to standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--plant", nargs="*", default=[None])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness, plant

    for name in args.plant:
        for seed in args.seeds:
            _reading(harness, plant.PLANTS[name] if name else None, name, seed, args)
    return 0


def _reading(harness, fn, name, seed, args):
    t0 = time.perf_counter()
    line = harness.run(args.workload, seed, args.seconds, False,
                       t_start=t0, root=ROOT, plant=fn, warm=False)
    print(json.dumps({
        "workload": args.workload, "seed": seed, "plant": name,
        "correct": line["correct"], "builds": line["attempted"],
        "build_s": line["metrics"].get("build_s", {}).get("value"),
        "memory_peak_bytes": line["device"]["memory_peak_bytes"],
        "checks": {k: v["value"] for k, v in line["checks"].items()},
        "seconds": time.perf_counter() - t0,
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
