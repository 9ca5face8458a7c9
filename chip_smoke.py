#!/usr/bin/env python3
"""Smoke run of npge_tpu_torch on one NVIDIA GPU: the default builds, the
mesh and two-process builds, the deep IsPangenome probe, every CLI verb and
k = 32, end to end, through the hand-written CUDA kernel.

    python3 chip_smoke.py [--ab-parent OLD/sw_xdrop.cu]

Phases (each prints its lines; any failure exits non-zero):
  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit, whether jax is importable, the port's host library;
  2. build the SW kernel from the sources in the checkout (ptxas registers
     and spills);
  3. the kernel against its plain torch version on the card, exactly equal,
     at P = 8192, L = 512 and a ragged small shape, with its time, the
     cells these inputs need and the int32-operation bound on them;
  4. the 5 x 20 kb circular world with inversions: blockset hash, the
     IsPangenome check and kernel launches;
  5. the 17 x 1 Mbp world with the default config: stage table, wall,
     canonical blockset hash and the IsPangenome check; every call of the
     SW entry point is recorded;
  6. the deep IsPangenome probe on that blockset, called directly (no
     build-time memo): its verdict against the reference's, its wall and
     its scan and extension seconds;
  6a. mesh builds of the 5 x 20 kb and 17 x 1 Mbp worlds over 4 shards on
     card 0, and over the distinct cards where there are two or more:
     hashes, the IsPangenome check and SW launches;
  6b. the 17 x 1 Mbp build split over two spawned processes of one gloo
     group, each on cuda:(rank % card count): both hashes, each rank's SW
     launches and its share of the SW pairs; then the stage seconds of the
     single-device, mesh and per-rank builds side by side;
  6c. the deep probe on a 3 x 6 kb build without re-seeding, where it must
     find the reference's 80 hits;
  7. the 50 x 300 kb world with the default config, as phase 5;
  8. the CLI on the 5 x 20 kb world in a temporary work dir: make-pangenome,
     hash, make-pangenome --devices 2 (refused with fewer than two cards),
     run MakePangenome, check --deep (the probe; then the build-time
     memo and, with a changed config, the probe again after a build that
     records its proof), run Pangenome, processors, post-processing, report
     and info;
  9. a k = 32 build of a small linear world against the reference's hash,
     and 2-bit packing of the 17 x 1 Mbp codes on the card;
 10. every recorded SW batch of phases 5 and 7 replayed: the kernel against
     its plain version exactly, the kernel's time by CUDA events, the cells
     the batch needs and the bound on them.
With ``--ab-parent``, an earlier sw_xdrop.cu is built beside this one and
timed in turns with it (parent, new, new, parent) in phases 3 and 10.
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and the line before that lists each
kernel with its launches in phase 5 (and phases 6a, 6b per rank, 7-9) and
its times.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import importlib.util
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# 5 x 20 kb circular world (the JAX package's multi-device dry run world)
SMALL_HASH = 14129187163991902977
# 17 x 1 Mbp world (benchmarks/scale_17x1mb.py): arena digest and the
# canonical blockset hash of the reference build
BIG_WORLD = dict(n_genomes=17, length=1_000_000, seed=42, sub_rate=0.002,
                 indel_rate=0.0001, n_inversions=3)
BIG_CODES_SHA256 = "e71b5800b914d646423518ffeed8ba4428c170b869fedb5f01a46bb4b7a82208"
BIG_HASH = 0x3D5ECC8CF4FD2751
# 50 x 300 kb world (benchmarks/scale_50x300kb.py): arena digest and the
# canonical blockset hash of the reference build (6883 blocks)
W50_WORLD = dict(n_genomes=50, length=300_000, seed=50, sub_rate=0.001,
                 indel_rate=0.00005, n_inversions=1)
W50_CODES_SHA256 = "b31046dc4bc11270ea4195c3a638b4c5b0bc1ed148316ac444d779b0ec0fa3b2"
W50_HASH = 0x171AB5F47B993F3E
# the reference's deep IsPangenome report (ok, new_hits, messages) on the
# canonical 17 x 1 Mbp blockset, from the JAX package on the CPU
BIG_DEEP = (True, 0, [])
# 3 x 6 kb linear world built without re-seeding (phase 6): the reference's
# hash and its deep report, which finds improving hits
HITS_HASH = 0xE938397915E6DE11
HITS_DEEP = (False, 80, ["re-seeding finds improving hits (80 candidates)"])
# 3 x 5 kb linear world built at k = 32 (phase 8): the reference's hash
K32_HASH = 0x53EE0976D143B7A1
K32_BLOCKS = 16
# the 5 x 20 kb world's config, as overrides of the default config
SMALL_CFG = {
    "ANCHOR_SIZE": 17, "MINIMIZER_WINDOW": 8, "MIN_LENGTH": 60,
    "MIN_END": 3, "MAX_LOOPS": 2, "GAPPED_FLANK": 64,
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def phase_env() -> None:
    import torch

    from npge_tpu_torch import have_native, native
    from npge_tpu_torch.ops._build import _nvcc

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    nv = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True)
    print(f"[env] nvcc: {nv.stdout.strip().splitlines()[-1]}", flush=True)
    print(f"[env] gpu: {smi_line()}", flush=True)
    print(f"[env] jax importable: "
          f"{str(importlib.util.find_spec('jax') is not None).lower()}",
          flush=True)
    if not have_native():
        fail(f"the port's host library {native.library_path()} did not build")
    print(f"[env] host library: {native.library_path()}", flush=True)


def phase_build() -> None:
    from npge_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    dt = time.perf_counter() - t0
    print(f"[build] sw_xdrop built+loaded in {dt:.2f} s "
          f"({_build.library_path().name})", flush=True)
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)


def planted_windows(seed: int, P: int, L: int):
    """codes2 with N runs and P pairs of windows whose targets are mutated
    copies (substitutions, indels) of their queries; ragged caps include 0
    and values above L."""
    rng = np.random.default_rng(seed)
    n = P * 4 * L
    codes2 = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(max(1, P // 2)):
        a = int(rng.integers(0, n - 30))
        codes2[a : a + int(rng.integers(1, 30))] = 4
    qb = np.arange(P, dtype=np.int64) * 4 * L
    tb = qb + 2 * L
    for p in range(P):
        src = codes2[qb[p] : qb[p] + L + L // 2].copy()
        sub = rng.random(len(src)) < 0.03
        src[sub] = (src[sub] + 1) % 4
        for _ in range(int(rng.integers(0, 4))):
            x = int(rng.integers(0, len(src) - 5))
            if rng.random() < 0.5:
                src = np.delete(src, range(x, x + int(rng.integers(1, 4))))
            else:
                src = np.insert(src, x, rng.integers(0, 4, 2).astype(np.uint8))
        m = min(len(src), 2 * L)
        codes2[tb[p] : tb[p] + m] = src[:m]
    qcap = rng.integers(0, L + L // 2, P)
    tcap = rng.integers(0, L + L // 2, P)
    qcap[0], tcap[1] = 0, 0
    return codes2, qb, qcap, tb, tcap


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` runs after one
    warm-up, by CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, launches: int = 20) -> float:
    """Device milliseconds of one call of ``fn`` (a kernel launch): the
    median replay time of a CUDA graph of ``launches`` back-to-back calls,
    over the count, so the wrapper's host time between launches is not
    counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    return cuda_ms(g.replay) / launches


# int32 operations a cell of the SW recurrence needs (substitution compare
# and select, diagonal add, two add-max, x-drop compare and select, running
# max), and the card's int32 lanes: 64 per SM on Hopper
SW_OPS_PER_CELL = 8
INT32_LANES_PER_SM = 64


@functools.cache
def int32_ops_per_ms() -> float:
    """The card's peak int32 operations per millisecond: SMs x int32 lanes
    x the maximum SM clock that nvidia-smi reports."""
    import torch

    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi clocks query failed: {res.stderr.strip()}")
    mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e3


def sw_bound_ms(cells: int) -> float:
    return SW_OPS_PER_CELL * cells / int32_ops_per_ms()


def build_parent_kernel(src: str):
    """An earlier sw_xdrop.cu (no last-diagonal output) built with the same
    nvcc flags into build/npge_tpu_torch/ab/, for an A/B timing; returns a
    launcher with the signature of ``_sw_windows_cuda``'s kernel call."""
    import ctypes

    import torch

    from npge_tpu_torch.ops import _build

    out = _build._BUILD_DIR / "ab" / "libsw_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        fail(f"nvcc failed on {src}:\n{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ab] parent {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.npge_sw_xdrop.argtypes = [vp, ll, vp, vp, vp, vp, vp] + [i32] * 9 + [vp]
    lib.npge_sw_xdrop.restype = i32

    def launch(c2, qb, qc, tb, tc, L):
        out_t = torch.empty((qb.shape[0], 3), dtype=torch.int32, device=c2.device)
        rc = lib.npge_sw_xdrop(
            c2.data_ptr(), c2.shape[0], qb.data_ptr(), tb.data_ptr(),
            qc.data_ptr(), tc.data_ptr(), out_t.data_ptr(), qb.shape[0], L,
            128, 1, -2, -3, 64, 250, 251,
            torch.cuda.current_stream().cuda_stream,
        )
        if rc != 0:
            fail(f"parent kernel launch failed: CUDA error {rc}")
        return out_t

    return launch


def needed_cells(args) -> int:
    """Cells these inputs need: W * (last + 1) per pair, from the kernel's
    last-diagonal output."""
    import torch

    from npge_tpu_torch.ops.sw import _sw_windows_cuda

    last = torch.empty(args[1].shape[0], dtype=torch.int32, device=args[0].device)
    _sw_windows_cuda(*args, 250, 251, 128, 1, -2, -3, 64, last=last)
    return int(128 * (last.to(torch.int64) + 1).sum())


def phase_kernel(parent=None) -> dict:
    """Kernel vs plain version on the card; returns the main-shape
    numbers for the kernels line. With ``parent`` (a launcher from
    build_parent_kernel), also times that kernel in turns with this one
    (parent, new, new, parent) on the same inputs."""
    import torch

    from npge_tpu_torch.ops.sw import _sw_windows_cuda, sw_windows_plain

    W = 128
    result = {}
    for P, L in ((8192, 512), (37, 64)):
        codes2, qb, qcap, tb, tcap = planted_windows(P + L, P, L)
        dev = torch.device("cuda")
        c2 = torch.from_numpy(codes2).to(dev)
        qb_t = torch.from_numpy(qb).to(dev)
        tb_t = torch.from_numpy(tb).to(dev)
        qc_t = torch.from_numpy(np.minimum(qcap, L).astype(np.int32)).to(dev)
        tc_t = torch.from_numpy(np.minimum(tcap, L).astype(np.int32)).to(dev)
        args = (c2, qb_t, qc_t, tb_t, tc_t, L)
        got = _sw_windows_cuda(*args, 250, 251, W, 1, -2, -3, 64)
        want = sw_windows_plain(*args)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0:
            bad = int((got != want).any(dim=1).sum())
            fail(f"kernel != plain at P={P} L={L}: {bad} pairs differ")
        new = lambda: _sw_windows_cuda(*args, 250, 251, W, 1, -2, -3, 64)  # noqa: E731
        ms = graph_ms(new)
        call_ms = cuda_ms(new)
        plain_ms = cuda_ms(lambda: sw_windows_plain(*args))
        cells = P * W * (2 * L + 1)
        need = needed_cells(args)
        bound = sw_bound_ms(need)
        aligned = int((want[:, 0] > 20).sum())
        print(f"[kernel] P={P} L={L}: exact match ({aligned} pairs score > 20); "
              f"cuda {ms:.4f} ms on the device ({cells / ms / 1e6:.2f} "
              f"Gcells/s nominal; {call_ms:.4f} ms a call from the host), "
              f"plain torch {plain_ms:.3f} ms; cells nominal {cells}, "
              f"needed {need}; bound {bound:.4f} ms on needed cells "
              f"({sw_bound_ms(cells):.4f} ms nominal), share "
              f"{bound / ms:.3f} ({sw_bound_ms(cells) / ms:.3f} nominal)",
              flush=True)
        row = {"max_abs_err": err, "ms": ms, "call_ms": call_ms,
               "plain_ms": plain_ms,
               "bound_ms": bound, "bound_ms_nominal": sw_bound_ms(cells),
               "cells_nominal": cells, "needed_cells": need}
        if parent is not None:
            old = lambda: parent(*args)  # noqa: E731
            if not torch.equal(old(), want):
                fail(f"parent kernel != plain at P={P} L={L}")
            turns = [graph_ms(f) for f in (old, new, new, old)]
            print(f"[ab] P={P} L={L}: parent {turns[0]:.4f} ms, new "
                  f"{turns[1]:.4f} ms, new {turns[2]:.4f} ms, parent "
                  f"{turns[3]:.4f} ms", flush=True)
            row["ab_turns_ms"] = turns
        result[f"P{P}_L{L}"] = row
    return result


class BatchRecorder:
    """Wraps ``npge_tpu_torch.ops.sw.sw_extend_windows`` (the function
    gapext calls) inside this script and keeps each call's inputs, so the
    main path's real batches can be replayed under CUDA events. The package
    has no knob for this."""

    def __init__(self):
        from npge_tpu_torch.ops import sw

        self.sw = sw
        self.inner = sw.sw_extend_windows
        self.batches = []

    def __enter__(self):
        def record(codes2, qb, qcap, tb, tcap, L, **kw):
            self.batches.append((codes2, *(np.array(a, copy=True) for a in (
                qb, qcap, tb, tcap)), L, kw))
            return self.inner(codes2, qb, qcap, tb, tcap, L, **kw)

        self.sw.sw_extend_windows = record
        return self

    def __exit__(self, *exc):
        self.sw.sw_extend_windows = self.inner


def replay_batches(world: str, batches, parent=None) -> list:
    """Each recorded batch through the kernel and its plain version on the
    card, exactly equal; the kernel's time by CUDA events (and the parent
    kernel's, in turns, when given), the cells the batch needs and the
    bound on them."""
    import torch

    from npge_tpu_torch.ops.sw import _sw_windows_cuda, sw_windows_plain

    rows = []
    for n, (codes2, qb, qcap, tb, tcap, L, kw) in enumerate(batches):
        dev = codes2.device
        sw = (kw.get("match", 1), kw.get("mismatch", -2), kw.get("gap", -3),
              kw.get("xdrop", 64))
        if sw != (1, -2, -3, 64) or kw.get("W", 128) != 128:
            fail(f"{world} batch {n}: unexpected SW parameters {kw}")
        args = (
            codes2, torch.from_numpy(qb).to(dev, torch.int64),
            torch.from_numpy(np.minimum(qcap, L)).to(dev, torch.int32),
            torch.from_numpy(tb).to(dev, torch.int64),
            torch.from_numpy(np.minimum(tcap, L)).to(dev, torch.int32), L,
        )
        P = len(qb)
        got = _sw_windows_cuda(*args, 250, 251, 128, *sw)
        want = sw_windows_plain(*args)
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=1).sum())
            fail(f"{world} batch {n} (P={P}, L={L}): {bad} pairs differ "
                 "from the plain version")
        new = lambda: _sw_windows_cuda(*args, 250, 251, 128, *sw)  # noqa: E731
        need = needed_cells(args)
        row = {"world": world, "batch": n, "P": P, "L": L,
               "cells_nominal": P * 128 * (2 * L + 1), "needed_cells": need,
               "bound_ms": sw_bound_ms(need)}
        if parent is not None:
            old = lambda: parent(*args)  # noqa: E731
            if not torch.equal(old(), want):
                fail(f"{world} batch {n}: parent kernel != plain")
            row["ab_turns_ms"] = [graph_ms(f) for f in (old, new, new, old)]
            row["ms"] = statistics.median(row["ab_turns_ms"][1:3])
        else:
            row["ms"] = graph_ms(new)
        print(f"[replay] {world} batch {n}: P={P} L={L} exact; "
              f"{row['ms']:.4f} ms, needed cells {need} of "
              f"{row['cells_nominal']}, bound {row['bound_ms']:.4f} ms"
              + (f", turns parent/new/new/parent {row['ab_turns_ms']}"
                 if parent is not None else ""), flush=True)
        rows.append(row)
    return rows


def small_world():
    from npge_tpu_torch import synthetic_arena

    return synthetic_arena(
        n_genomes=5, length=20_000, seed=11, sub_rate=0.004,
        indel_rate=0.0008, n_inversions=2, circular=True,
    )


def phase_small_world() -> None:
    from npge_tpu_torch import (
        blockset_hash, build_pangenome, check_is_pangenome, default_config,
    )
    from npge_tpu_torch.ops import sw

    arena = small_world()
    cfg = default_config().replace(**SMALL_CFG)
    sw.SW_LAUNCHES = 0
    t0 = time.perf_counter()
    bs, _ = build_pangenome(arena, cfg, "cuda")
    wall = time.perf_counter() - t0
    h = blockset_hash(bs)
    rep = check_is_pangenome(bs, cfg)
    print(f"[small] 5x20kb circular: {len(bs.blocks)} blocks, hash {h}, "
          f"IsPangenome {rep.ok}, sw launches {sw.SW_LAUNCHES}, "
          f"wall {wall:.2f} s", flush=True)
    if h != SMALL_HASH:
        fail(f"small world hash {h} != {SMALL_HASH}")
    if not rep.ok:
        fail(f"small world IsPangenome: {rep.messages}")
    if sw.SW_LAUNCHES <= 0:
        fail("small world build launched no SW kernel")


def phase_world(tag: str, world: dict, codes_sha256: str, pinned: int):
    """The default build of a pinned world through the recorded SW entry
    point; returns its kernel launches, recorded batches, the canonical
    blockset, the config and the stage timings."""
    import torch

    from npge_tpu_torch import (
        blockset_hash, build_pangenome, check_is_pangenome, default_config,
        synthetic_arena,
    )
    from npge_tpu_torch.ops import sw

    arena = synthetic_arena(**world)
    digest = hashlib.sha256(arena.codes.tobytes()).hexdigest()
    print(f"[{tag}] arena: {arena.total_length} bp, codes sha256 "
          f"{digest} (pinned {codes_sha256})", flush=True)
    if digest != codes_sha256:
        fail(f"{tag} arena differs from the pinned world")
    cfg = default_config()
    with BatchRecorder() as rec:
        sw.SW_LAUNCHES = 0  # count the main path's launches only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bs, tm = build_pangenome(arena, cfg, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sw.SW_LAUNCHES
    print(tm.report(), flush=True)
    tm.add("wall", wall)
    print(f"[{tag}] wall {wall:.2f} s; sw pairs "
          f"{tm.counters.get('gapext_pairs', 0)}, sw launches {launches}, "
          f"batches {[len(b[1]) for b in rec.batches]}", flush=True)
    rep = check_is_pangenome(bs, cfg)
    bs.canonicalize()
    h = blockset_hash(bs)
    print(f"[{tag}] {len(bs.blocks)} blocks, canonical hash {h:#x}, "
          f"IsPangenome {rep.ok}", flush=True)
    if h != pinned:
        fail(f"{tag} hash {h:#x} != {pinned:#x}")
    if not rep.ok:
        fail(f"{tag} IsPangenome: {rep.messages}")
    if launches <= 0 or launches != len(rec.batches):
        fail(f"{tag} build: {launches} SW launches, {len(rec.batches)} batches")
    return launches, rec.batches, bs, cfg, tm


def phase_deep(bs, cfg) -> None:
    import torch

    from npge_tpu_torch import check_is_pangenome
    from npge_tpu_torch.algo.pangenome import StageTimings

    tm = StageTimings()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = check_is_pangenome(bs, cfg, deep=True, device="cuda", timings=tm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    books = ", ".join(f"{k} {v:.3f} s" for k, v in tm.seconds.items())
    print(f"[deep] 17x1Mbp deep probe at k={cfg.MIN_ANCHOR_SIZE}: ok {rep.ok}, "
          f"new_hits {rep.new_hits}, wall {wall:.3f} s ({books}; "
          f"extend cells {tm.counters.get('deep.extend_cells', 0)})",
          flush=True)
    got = (rep.ok, rep.new_hits, rep.messages)
    if got != BIG_DEEP:
        fail(f"deep probe {got} != the reference's {BIG_DEEP}")
    if tm.counters.get("deep.extend_cells", 0) <= 0:
        fail("17x1Mbp deep probe extended nothing")


def phase_deep_hits() -> None:
    """The deep probe on a build without re-seeding, where it must find the
    reference's improving hits on the card."""
    from npge_tpu_torch import (
        blockset_hash, build_pangenome, check_is_pangenome, default_config,
        synthetic_arena,
    )
    from npge_tpu_torch.algo.pangenome import StageTimings

    arena = synthetic_arena(
        n_genomes=3, length=6000, seed=4, sub_rate=0.02, indel_rate=0.002,
        n_inversions=1,
    )
    cfg = default_config().replace(
        ANCHOR_SIZE=31, MIN_LENGTH=60, MIN_END=3, GAPPED_EXTEND=False,
        MAX_LOOPS=0,
    )
    bs, _ = build_pangenome(arena, cfg, "cuda")
    h = blockset_hash(bs)
    tm = StageTimings()
    t0 = time.perf_counter()
    rep = check_is_pangenome(bs, cfg, deep=True, device="cuda", timings=tm)
    wall = time.perf_counter() - t0
    got = (rep.ok, rep.new_hits, rep.messages)
    print(f"[deep-hits] 3x6kb without re-seeding: hash {h:#x}, ok {rep.ok}, "
          f"new_hits {rep.new_hits}, wall {wall:.3f} s (extend cells "
          f"{tm.counters.get('deep.extend_cells', 0)})", flush=True)
    if h != HITS_HASH:
        fail(f"3x6kb build hash {h:#x} != the reference's {HITS_HASH:#x}")
    if got != HITS_DEEP:
        fail(f"3x6kb deep probe {got} != the reference's {HITS_DEEP}")


def phase_cli() -> int:
    """Every verb of the port's CLI on the 5 x 20 kb world; returns the SW
    kernel launches of the phase."""
    import torch

    from npge_tpu_torch import BlockSet, save_stage
    from npge_tpu_torch.cli import main as cli
    from npge_tpu_torch.ops import sw

    opts = [a for k, v in SMALL_CFG.items() for a in ("-o", f"{k}={v}")]
    work = tempfile.mkdtemp(prefix="npge_smoke_")

    def run(*argv, refused: bool = False) -> tuple[str, str]:
        """One verb; it must exit 0, or non-zero when ``refused``."""
        out, err = io.StringIO(), io.StringIO()
        code = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                cli([*argv, "-w", work])
            except SystemExit as e:
                code = e.code
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        label = " ".join(argv).replace(" ".join(opts), "<opts>")
        print(f"[cli] {label}: exit {code}, wall {wall:.3f} s", flush=True)
        if (code not in (0, None)) != refused:
            fail(f"cli {argv}: exit {code}\n{out.getvalue()[-2000:]}"
                 f"{err.getvalue()[-2000:]}")
        return out.getvalue(), err.getvalue()

    try:
        save_stage(work, "input", BlockSet(small_world(), []))
        sw.SW_LAUNCHES = 0
        out, _ = run("make-pangenome", "--device", "cuda", *opts)
        if '"is_pangenome": true' not in out:
            fail(f"cli make-pangenome: {out}")
        out, _ = run("hash")
        if out.strip() != f"{SMALL_HASH:016x}":
            fail(f"cli hash {out.strip()} != {SMALL_HASH:016x}")
        # --devices 2: a real error with fewer than 2 cards, else the
        # single-device hash over the first two cards
        few = torch.cuda.device_count() < 2
        run("make-pangenome", "--device", "cuda", "--devices", "2", *opts,
            refused=few)
        out, _ = run("hash")
        if out.strip() != f"{SMALL_HASH:016x}":
            fail(f"cli hash after --devices 2: {out.strip()} != {SMALL_HASH:016x}")
        run("run", "MakePangenome", "--device", "cuda", "--stage-name",
            "again", *opts)
        out, _ = run("hash", "--stage", "again")
        if out.strip() != f"{SMALL_HASH:016x}":
            fail(f"cli run MakePangenome hash {out.strip()} != {SMALL_HASH:016x}")
        # this build ends at MAX_LOOPS before its k reaches MIN_ANCHOR_SIZE,
        # so it records no proof and the deep check runs the probe
        out, err = run("check", "--deep", "--device", "cuda", *opts)
        if not out.startswith("OK") or "reusing" in err:
            fail(f"cli check --deep: {out}{err}")
        # a build that reaches k = MIN_ANCHOR_SIZE records its proof: the
        # deep check reuses it, and with a changed config runs the probe
        loops4 = [*opts, "-o", "MAX_LOOPS=4"]
        run("make-pangenome", "--device", "cuda", *loops4)
        out, err = run("check", "--deep", "--device", "cuda", *loops4)
        if not out.startswith("OK") or "reusing build-time proof" not in err:
            fail(f"cli check --deep did not reuse the build's proof: {out}{err}")
        out, err = run("check", "--deep", "--device", "cuda", *loops4,
                       "-o", "MAX_LOOPS=5")
        if not out.startswith("OK") or "reusing" in err:
            fail(f"cli check --deep with a changed config: {out}{err}")
        out, _ = run("run", "Pangenome", "--device", "cuda", *opts)
        print(f"[cli] {out.strip()}", flush=True)
        out, _ = run("processors")
        if "MakePangenome" not in out.split() or len(out.split()) != 21:
            fail(f"cli processors: {out.split()}")
        run("post-processing")
        run("report")
        out, _ = run("info")
        missing = [f for f in ("blocks.tsv", "consensus_tree.nwk",
                               "report.html", "stage.bs")
                   if not os.path.exists(os.path.join(work, f))]
        if missing or not out.strip():
            fail(f"cli outputs missing: {missing}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = sw.SW_LAUNCHES
    print(f"[cli] every verb ran; sw launches {launches}", flush=True)
    if launches <= 0:
        fail("the CLI phase launched no SW kernel")
    return launches


def phase_k32() -> int:
    """Returns the SW kernel launches of the k = 32 build."""
    from npge_tpu_torch import (
        blockset_hash, build_pangenome, default_config, synthetic_arena,
    )
    from npge_tpu_torch.ops import sw

    arena = synthetic_arena(
        n_genomes=3, length=5000, seed=4, sub_rate=0.006, indel_rate=0.001,
        n_inversions=1,
    )
    cfg = default_config().replace(
        ANCHOR_SIZE=32, MIN_LENGTH=60, MIN_END=3, GAPPED_FLANK=64,
        MAX_LOOPS=2,
    )
    sw.SW_LAUNCHES = 0
    t0 = time.perf_counter()
    bs, _ = build_pangenome(arena, cfg, "cuda")
    wall = time.perf_counter() - t0
    h = blockset_hash(bs)
    print(f"[k32] 3x5kb linear at k=32: {len(bs.blocks)} blocks, hash "
          f"{h:#x}, sw launches {sw.SW_LAUNCHES}, wall {wall:.3f} s",
          flush=True)
    if (h, len(bs.blocks)) != (K32_HASH, K32_BLOCKS):
        fail(f"k=32 build {h:#x} ({len(bs.blocks)} blocks) != "
             f"{K32_HASH:#x} ({K32_BLOCKS} blocks)")
    return sw.SW_LAUNCHES


def mesh_build(tag: str, arena, cfg, mesh, pinned: int):
    """One build over ``mesh`` (device = its first device): hash, the
    IsPangenome check and SW launches; returns (launches, timings)."""
    import torch

    from npge_tpu_torch import blockset_hash, build_pangenome, check_is_pangenome
    from npge_tpu_torch.ops import sw

    sw.SW_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs, tm = build_pangenome(arena, cfg, mesh.devices[0], mesh=mesh)
    for d in dict.fromkeys(mesh.devices):
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    launches = sw.SW_LAUNCHES
    rep = check_is_pangenome(bs, cfg)
    bs.canonicalize()
    h = blockset_hash(bs)
    print(f"[mesh] {tag} over {mesh}: {len(bs.blocks)} blocks, canonical "
          f"hash {h:#x}, IsPangenome {rep.ok}, sw launches {launches}, wall "
          f"{wall:.2f} s", flush=True)
    if h != pinned:
        fail(f"{tag} mesh build hash {h:#x} != {pinned:#x}")
    if not rep.ok:
        fail(f"{tag} mesh build IsPangenome: {rep.messages}")
    if launches <= 0:
        fail(f"{tag} mesh build launched no SW kernel")
    tm.add("wall", wall)
    return launches, tm


def phase_mesh():
    """Mesh builds of the 5 x 20 kb and 17 x 1 Mbp worlds over 4 shards on
    card 0 (written out: a mesh that repeats a card is never made on its
    own), and over the distinct cards where there are two or more. Returns
    (mesh, SW launches, stage timings) of each 17 x 1 Mbp build, the
    4-shard one first."""
    import torch

    from npge_tpu_torch import default_config, synthetic_arena
    from npge_tpu_torch.parallel.mesh import DeviceMesh, make_mesh

    small_cfg = default_config().replace(**SMALL_CFG)
    meshes = [DeviceMesh([torch.device("cuda", 0)] * 4)]
    count = torch.cuda.device_count()
    if count >= 2:
        meshes.append(make_mesh(count, "cuda"))
    else:
        print(f"[mesh] {count} card visible: no mesh over distinct cards",
              flush=True)
    big = synthetic_arena(**BIG_WORLD)
    out = []
    for mesh in meshes:
        mesh_build("5x20kb circular", small_world(), small_cfg, mesh, SMALL_HASH)
        out.append((mesh, *mesh_build("17x1Mbp", big, default_config(), mesh,
                                      BIG_HASH)))
    return out


def mp_rank(rank: int, size: int, init: str, queue) -> None:
    """One rank of the multi-process 17 x 1 Mbp build (a spawned process):
    a gloo group, the build on cuda:(rank % card count); puts its result
    dict on ``queue``."""
    import datetime
    import traceback

    try:
        import torch
        import torch.distributed as dist

        from npge_tpu_torch import (
            blockset_hash, build_pangenome, check_is_pangenome,
            default_config, synthetic_arena,
        )
        from npge_tpu_torch.ops import sw

        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        dist.init_process_group(
            "gloo", init_method=init, world_size=size, rank=rank,
            timeout=datetime.timedelta(seconds=300),
        )
        arena = synthetic_arena(**BIG_WORLD)
        cfg = default_config()
        sw.SW_LAUNCHES = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        bs, tm = build_pangenome(arena, cfg, dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = sw.SW_LAUNCHES
        dist.destroy_process_group()
        rep = check_is_pangenome(bs, cfg)
        bs.canonicalize()
        tm.add("wall", wall)
        queue.put({
            "rank": rank, "device": str(dev), "hash": blockset_hash(bs),
            "blocks": len(bs.blocks), "ok": rep.ok, "launches": launches,
            "seconds": tm.seconds, "counters": tm.counters,
            "jax": [m for m in ("jax", "npge_tpu") if m in sys.modules],
        })
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def phase_mp(size: int = 2) -> list:
    """The 17 x 1 Mbp build split over ``size`` spawned processes of one
    gloo group, each on cuda:(rank % card count): every rank must give the
    pinned hash, launch the SW kernel on its own share of the pairs, and
    the shares must sum to the total. Returns the ranks' result dicts."""
    import multiprocessing
    import queue as queue_mod
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [
        ctx.Process(target=mp_rank, args=(r, size, f"tcp://localhost:{port}", q))
        for r in range(size)
    ]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in range(size):
            try:
                results.append(q.get(timeout=600))
            except queue_mod.Empty:
                fail(f"{size}-process build: a rank gave no result in 600 s")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results.sort(key=lambda r: r["rank"])
    for r in results:
        if "error" in r:
            fail(f"rank {r['rank']} failed:\n{r['error']}")
    for p in procs:
        if p.exitcode != 0:
            fail(f"a rank exited with {p.exitcode}")
    total = results[0]["counters"].get("gapext_pairs", 0)
    for r in results:
        c = r["counters"]
        print(f"[mp] rank {r['rank']}/{size} on {r['device']}: {r['blocks']} "
              f"blocks, canonical hash {r['hash']:#x}, IsPangenome {r['ok']}, "
              f"sw launches {r['launches']}, sw pairs owned "
              f"{c.get('mp.gapext_pairs_owned', 0)} of "
              f"{c.get('gapext_pairs', 0)}, extension groups owned "
              f"{c.get('mp.extend_groups_owned', 0)} of "
              f"{c.get('mp.extend_groups_total', 0)} (re-seed "
              f"{c.get('mp.reseed.extend_groups_owned', 0)} of "
              f"{c.get('mp.reseed.extend_groups_total', 0)}), wall "
              f"{r['seconds']['wall']:.2f} s, gathers "
              f"{r['seconds'].get('mp.gather', 0.0):.4f} s", flush=True)
        if r["jax"]:
            fail(f"rank {r['rank']} imported {r['jax']}")
        if r["hash"] != BIG_HASH or not r["ok"]:
            fail(f"rank {r['rank']}: hash {r['hash']:#x} (want {BIG_HASH:#x}), "
                 f"IsPangenome {r['ok']}")
        if r["launches"] <= 0:
            fail(f"rank {r['rank']} launched no SW kernel")
        if not 0 < c.get("mp.gapext_pairs_owned", 0) < total:
            fail(f"rank {r['rank']} owns no real share of the SW pairs: {c}")
        if c.get("gapext_pairs") != total:
            fail("the ranks disagree on the SW pair total")
    owned = sum(r["counters"]["mp.gapext_pairs_owned"] for r in results)
    if owned != total:
        fail(f"SW pairs owned by the ranks sum to {owned}, not {total}")
    return results


def print_stage_table(cols: dict) -> None:
    """Stage seconds of several builds side by side (one column each)."""
    names = list(dict.fromkeys(k for tm in cols.values() for k in tm))
    print("[stages] " + " | ".join(["stage (s)", *cols]), flush=True)
    for k in names:
        print("[stages] " + " | ".join(
            [k, *(f"{tm.get(k, 0.0):.3f}" for tm in cols.values())]
        ), flush=True)


def phase_pack() -> None:
    """2-bit packing of the 17 x 1 Mbp codes on the card: equal to the CPU
    result and round-tripping."""
    import torch

    from npge_tpu_torch import synthetic_arena
    from npge_tpu_torch.ops.pack import pack2, unpack2

    codes = torch.from_numpy(synthetic_arena(**BIG_WORLD).codes).clone()
    codes[::4099] = 4  # N codes too
    packed, mask = pack2(codes.cuda())
    want, want_mask = pack2(codes)
    back = unpack2(packed, mask).cpu()
    ok = (torch.equal(packed.cpu(), want) and torch.equal(mask.cpu(), want_mask)
          and torch.equal(back, codes))
    print(f"[pack] {codes.shape[0]} codes -> {packed.shape[0]} uint32 words "
          f"on {packed.device}: equal to the CPU and round-trips: {ok}",
          flush=True)
    if not ok:
        fail("pack2 / unpack2 on the card disagree with the CPU")


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--ab-parent", metavar="SW_XDROP_CU",
        help="an earlier sw_xdrop.cu (without the last-diagonal output) to "
             "build and time in turns with this one on every shape and batch",
    )
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    phase_env()
    phase_build()
    parent = build_parent_kernel(opts.ab_parent) if opts.ab_parent else None
    kern = phase_kernel(parent)
    phase_small_world()
    launches, batches, bs, cfg, tm_single = phase_world(
        "17x1Mbp", BIG_WORLD, BIG_CODES_SHA256, BIG_HASH
    )
    phase_deep(bs, cfg)
    del bs
    meshes = phase_mesh()
    launches_mesh = meshes[0][1]
    ranks = phase_mp()
    print_stage_table({
        "17x1Mbp single device": tm_single.seconds,
        **{f"mesh {m}": tm.seconds for m, _, tm in meshes},
        **{f"rank {r['rank']} of 2": r["seconds"] for r in ranks},
    })
    phase_deep_hits()
    launches_50, batches_50, _, _, _ = phase_world(
        "50x300kb", W50_WORLD, W50_CODES_SHA256, W50_HASH
    )
    launches_cli = phase_cli()
    launches_k32 = phase_k32()
    phase_pack()
    rows = replay_batches("17x1Mbp", batches, parent)
    rows += replay_batches("50x300kb", batches_50, parent)
    for mod in ("jax", "npge_tpu"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    main_shape = kern["P8192_L512"]
    kernels = [{
        "name": "sw_xdrop",
        "route": "cuda",
        "source": "npge_tpu_torch/csrc/sw_xdrop.cu",
        "replaces": "npge_tpu/ops/sw.py:74",
        "launches": launches,
        "launches_50x300kb": launches_50,
        "launches_cli": launches_cli,
        "launches_k32": launches_k32,
        "launches_mesh": launches_mesh,
        "launches_mp": [r["launches"] for r in ranks],
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
        "bound_ms_nominal": main_shape["bound_ms_nominal"],
        "needed_cells": main_shape["needed_cells"],
        "cells_nominal": main_shape["cells_nominal"],
        "shapes": kern,
        "batches": rows,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
