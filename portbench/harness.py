"""One run of one cell: set-up, the measured window of whole builds, the
correctness check, and the result line.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json`` names its configuration (``configs[].file``) and its
traffic mix (``portbench/traffic/<traffic>.json``), and each per-layer
metric is read by ``portbench/metrics/<name>.py``'s ``read(record)``.

The window calls ``npge_tpu_torch.build_pangenome(arena, cfg, "cuda")``
(over a ``DeviceMesh`` of the configuration's ``mesh`` cards where it has
one), the main path of ``make-pangenome``, back to back on a fresh
``GenomeArena`` of the same world each time, until ``seconds`` have passed;
the build running at the deadline is finished and counted. The window is
the builds' own time: each build is timed from its call to the cards'
synchronisation, and what the harness does between builds (keeping the
answer, collecting the build's garbage) is outside it. Set-up builds the
world once before it, so every shape and library the window uses is warm.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from portbench import capture, check, world

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BANNED = ("jax", "jaxlib", "flax", "npge_tpu")


class RunError(Exception):
    """A run that cannot give a result (exit code 2, nothing printed)."""


def load_cell(root: Path, name: str):
    """(BENCHMARK.json, the cell, its configuration, its traffic mix)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (root / PKG.name / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def metric_reader(root: Path, name: str):
    """``metrics/<name>.py``'s ``read``. A metric ``<base>.<role>`` without
    a file of its own reads as ``<base>`` does: the same quantity, in cells
    where it moves another end-to-end metric."""
    path = root / PKG.name / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        name = name.split(".", 1)[0]
        path = root / PKG.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED))


def _sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        root: Path = ROOT, device: str = "cuda", plant=None, log=print,
        min_builds: int = 1, warm: bool = True) -> dict:
    """The result of one run. ``device`` is "cuda" for a measured run; the
    tests pass "cpu" to drive everything but the card. ``plant``, when
    given, is called with a ``capture.Patches`` before set-up and may
    replace parts of the program (a control or a planted fault); the tests
    ask for ``min_builds`` builds in the window whatever the clock says, and
    readings of the check over many seeds skip the warm-up build
    (``warm=False``): their times mean nothing."""
    import torch

    bench, cell, config, traffic = load_cell(root, name)
    chips = int(cell["chips"])
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is False: a run needs the card")
        if torch.cuda.device_count() < chips:
            raise RunError(f"{name} needs {chips} cards, "
                           f"{torch.cuda.device_count()} visible")

    import npge_tpu_torch as P
    from npge_tpu_torch.parallel.mesh import DeviceMesh, make_mesh

    cfg = P.default_config().replace(**config.get("pipeline", {}))
    n_mesh = int(config.get("mesh", 1))
    if n_mesh > 1:
        mesh = make_mesh(n_mesh, "cuda") if device == "cuda" else DeviceMesh([device] * n_mesh)
        dev = mesh.devices[0]
        devices = list(dict.fromkeys(mesh.devices))
    else:
        mesh = None
        dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
        devices = [dev]
    names, seqs = world.make_world(config, traffic, seed)
    world_codes, world_offsets = world.concat(seqs)
    world_circular = np.array([n.endswith("&c") for n in names], bool)

    planted = capture.Patches()
    if plant is not None:
        plant(planted)
    rec = capture.Recorder(labels=trace)
    try:
        with capture.installed(rec):
            if warm:
                P.build_pangenome(P.GenomeArena(names, seqs), cfg, dev, mesh=mesh)
            _sync(devices)
            gc.collect()
            gc.freeze()
            setup_s = time.perf_counter() - t_start
            result = _window(P, rec, names, seqs, cfg, dev, mesh, devices,
                             seconds, trace, min_builds)
    finally:
        planted.undo()
    found = banned_modules()
    if found:
        raise RunError(f"modules loaded that the port must not load: {found}")

    # the program's state goes before the reference runs
    answers = [check.plain_blocks(blocks) for blocks in result.pop("answers")]
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    n = result["n_builds"]
    sampled = int(np.random.default_rng([seed, 1]).integers(0, min(n, 2)))

    t0 = time.perf_counter()
    checks, batches, spent = check.compare(
        rec.calls.get(sampled, []), answers, sampled, world_codes,
        world_offsets, cfg, seed, dev, world_circular)
    kinds = [c["kind"] for c in rec.calls.get(sampled, [])]
    log(f"[check] build {sampled} of {n} held to the reference in "
        f"{time.perf_counter() - t0:.3f} s: {kinds.count('scan')} scans, "
        f"{kinds.count('extend')} extensions, {kinds.count('sw')} SW batches "
        f"({[b['pairs'] for b in batches]} pairs); seconds by part "
        f"{ {k: round(v, 3) for k, v in spent.items()} }", file=sys.stderr)
    correct = all(v <= lim for _n, v, lim in checks)

    record = {
        "n_builds": n, "books": result["books"], "counters": result["counters"],
        "sw_pairs": rec.sw_pairs.get(sampled, 0), "sw_batches": batches,
        "peak_bytes": result["peak_bytes"], "device_name": _device_name(dev),
        "chips": chips, "walls": result["walls"],
    }
    if trace:
        record.update(result["trace"])
    out_metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            v = metric_reader(root, m["name"])(record)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"build_s": result["window_s"] / n, "setup_s": setup_s,
                  "device_peak_gib": max(result["peak_bytes"]) / 2**30}
        for m in bench["end_to_end"]:
            if name in m.get("workloads", [name]):
                out_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if device == "cuda" else device,
        "kind": record["device_name"], "count": chips,
        "memory_peak_bytes": max(result["peak_bytes"]),
    }
    line = {
        "correct": correct, "attempted": n,
        "failed": _failed_builds(checks),
        "metrics": out_metrics, "device": dev_info,
    }
    if trace:
        dev_info["busy_s"] = float(np.mean(record["busy_s"][:chips]))
        dev_info["window_s"] = record["window_s"]
        line["breakdown"] = record["breakdown"]
        log(f"[trace] busy_s per card {record['busy_s']}, window "
            f"{record['window_s']} s", file=sys.stderr)
        _log_sw_launches(record, log)
    line["checks"] = {nm: {"value": v, "limit": lim} for nm, v, lim in checks}
    log(f"[window] {n} builds in {result['window_s']} s (each {result['walls']}), "
        f"set-up {setup_s} s, "
        f"peak bytes per card {result['peak_bytes']}", file=sys.stderr)
    return line


def _failed_builds(checks) -> int:
    """Builds whose answer failed: the checked one when any of its numbers
    is over its limit, and each other build that differs from it."""
    over = any(v > lim for nm, v, lim in checks if nm != "builds_differing")
    return int(over) + {nm: v for nm, v, _lim in checks}["builds_differing"]


def _log_sw_launches(record, log) -> None:
    """Each SW batch of one build: pairs, needed cells, the kernel's device
    seconds, and its share of the packed and of the int32 bound (the
    window's builds launch the same batches in the same order)."""
    from portbench import roofline

    peak = roofline.PEAKS.get(record["device_name"])
    batches, launches = record["sw_batches"], record["launches_s"]
    nb = len(batches)
    if peak is None or nb == 0 or len(launches) != nb * record["n_builds"]:
        log(f"[sw] {len(launches)} launches for {nb} batches x "
            f"{record['n_builds']} builds: no per-batch shares", file=sys.stderr)
        return
    for i, b in enumerate(batches):
        spent = float(np.mean(launches[i::nb]))
        cells = roofline.sw_needed_cells(b["needed"])
        nbytes = roofline.sw_bytes(b["qcap"], b["tcap"])
        packed = roofline.sw_bound_s(cells, nbytes, peak)
        int32 = roofline.sw_bound_s(cells, nbytes, peak, packed=False)
        log(f"[sw] batch {i}: {b['pairs']} pairs, {cells} needed cells, "
            f"{spent * 1e3:.4f} ms, share {packed / spent:.4f} packed, "
            f"{int32 / spent:.4f} int32", file=sys.stderr)


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _window(P, rec, names, seqs, cfg, dev, mesh, devices, seconds, trace,
            min_builds) -> dict:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    books: dict[str, float] = {}
    counters: dict[str, int] = {}
    answers, walls = [], []
    while True:
        rec.build = len(walls)
        span = record_function("pb.window") if trace else contextlib.nullcontext()
        with span:
            tb = time.perf_counter()
            bs, tm = P.build_pangenome(P.GenomeArena(names, seqs), cfg, dev, mesh=mesh)
            _sync(devices)
            walls.append(time.perf_counter() - tb)
        rec.build = None
        # outside the timed span: keep the answer and the books, then clear
        # the build's garbage and freeze what stays, so that every build
        # starts from the same heap and no collection walks kept answers
        answers.append(bs.blocks)
        for k, v in tm.seconds.items():
            books[k] = books.get(k, 0.0) + v
        for k, v in tm.counters.items():
            counters[k] = counters.get(k, 0) + v
        del bs, tm
        gc.collect()
        gc.freeze()
        if sum(walls) >= seconds and len(walls) >= min_builds:
            break
    out = {"n_builds": len(walls), "window_s": sum(walls), "books": books,
           "counters": counters, "answers": answers, "walls": walls}
    if trace:
        prof.__exit__(None, None, None)
    out["peak_bytes"] = [
        torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0
        for d in devices
    ]
    if trace:
        from portbench import profile_read

        red = profile_read.reduce_events(profile_read.events_of(prof), len(devices))
        red["breakdown"] = {
            "device_ops": [[name[:160], s] for name, s in profile_read.top(red["kernels_s"])],
            "idle_gaps": profile_read.top(red["idle_by_step_s"]),
        }
        out["trace"] = red
    return out
