#!/usr/bin/env python3
"""Smoke run of npge_tpu_torch on one NVIDIA GPU: the default build, end to
end, through the hand-written CUDA kernel.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit, whether jax is importable, the host library check;
  2. build the SW kernel from the sources in the checkout;
  3. the kernel against its plain torch version on the card, exactly equal,
     at the main path's shape (P = 8192, L = 512) and a ragged small one;
  4. the 5 x 20 kb circular world with inversions: blockset hash, the
     IsPangenome check and kernel launches;
  5. the 17 x 1 Mbp world with the default config: stage table, wall,
     canonical blockset hash and the IsPangenome check.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches in phase 5 and its times.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# 5 x 20 kb circular world (the JAX package's multi-device dry run world)
SMALL_HASH = 14129187163991902977
# 17 x 1 Mbp world (benchmarks/scale_17x1mb.py): arena digest and the
# canonical blockset hash of the reference build
BIG_CODES_SHA256 = "e71b5800b914d646423518ffeed8ba4428c170b869fedb5f01a46bb4b7a82208"
BIG_HASH = 0x3D5ECC8CF4FD2751


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

    from npge_tpu_torch import have_native
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
        fail("host library native/libnpge_native.so did not build")
    print("[env] native host library: ok", flush=True)


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


def phase_kernel() -> dict:
    """Kernel vs plain version on the card; returns the main-shape
    numbers for the kernels line."""
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
        ms = cuda_ms(lambda: _sw_windows_cuda(*args, 250, 251, W, 1, -2, -3, 64))
        plain_ms = cuda_ms(lambda: sw_windows_plain(*args))
        cells = P * W * (2 * L + 1)
        aligned = int((want[:, 0] > 20).sum())
        print(f"[kernel] P={P} L={L}: exact match ({aligned} pairs score > 20); "
              f"cuda {ms:.3f} ms ({cells / ms / 1e6:.2f} Gcells/s), "
              f"plain torch {plain_ms:.3f} ms "
              f"({cells / plain_ms / 1e6:.2f} Gcells/s)", flush=True)
        if P == 8192:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return result


def phase_small_world() -> None:
    from npge_tpu_torch import (
        blockset_hash, build_pangenome, check_is_pangenome, default_config,
        synthetic_arena,
    )
    from npge_tpu_torch.ops import sw

    arena = synthetic_arena(
        n_genomes=5, length=20_000, seed=11, sub_rate=0.004,
        indel_rate=0.0008, n_inversions=2, circular=True,
    )
    cfg = default_config().replace(
        ANCHOR_SIZE=17, MINIMIZER_WINDOW=8, MIN_LENGTH=60, MIN_END=3,
        MAX_LOOPS=2, GAPPED_FLANK=64,
    )
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


def phase_big_world() -> int:
    """Returns the SW kernel launches of this build."""
    import torch

    from npge_tpu_torch import (
        blockset_hash, build_pangenome, check_is_pangenome, default_config,
        synthetic_arena,
    )
    from npge_tpu_torch.ops import sw

    arena = synthetic_arena(
        n_genomes=17, length=1_000_000, seed=42, sub_rate=0.002,
        indel_rate=0.0001, n_inversions=3,
    )
    digest = hashlib.sha256(arena.codes.tobytes()).hexdigest()
    print(f"[big] 17x1Mbp arena: {arena.total_length} bp, codes sha256 "
          f"{digest} (pinned {BIG_CODES_SHA256})", flush=True)
    if digest != BIG_CODES_SHA256:
        fail("17x1Mbp arena differs from the pinned world")
    cfg = default_config()
    sw.SW_LAUNCHES = 0  # count the main path's launches only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs, tm = build_pangenome(arena, cfg, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sw.SW_LAUNCHES
    print(tm.report(), flush=True)
    print(f"[big] wall {wall:.2f} s; sw pairs "
          f"{tm.counters.get('gapext_pairs', 0)}, sw launches {launches}",
          flush=True)
    rep = check_is_pangenome(bs, cfg)
    bs.canonicalize()
    h = blockset_hash(bs)
    print(f"[big] {len(bs.blocks)} blocks, canonical hash {h:#x}, "
          f"IsPangenome {rep.ok}", flush=True)
    if h != BIG_HASH:
        fail(f"17x1Mbp hash {h:#x} != {BIG_HASH:#x}")
    if not rep.ok:
        fail(f"17x1Mbp IsPangenome: {rep.messages}")
    if launches <= 0:
        fail("17x1Mbp build launched no SW kernel")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    phase_env()
    phase_build()
    kern = phase_kernel()
    phase_small_world()
    launches = phase_big_world()
    if "jax" in sys.modules:
        fail("jax was imported")
    kernels = [{
        "name": "sw_xdrop",
        "route": "cuda",
        "source": "npge_tpu_torch/csrc/sw_xdrop.cu",
        "replaces": "npge_tpu/ops/sw.py:74",
        "launches": launches,
        **kern,
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
