# mirrors npge_tpu/parallel/distributed.py
"""Multi-process builds over ``torch.distributed``: the process group, the
contiguous partition of work between processes, the position-sliced anchor
scan and the host gathers that merge the slices.

Every process holds the whole arena and runs the host stages (resolve,
join, surgery, rest) identically, as the reference does; the device stages
split their work: each process scans a slice of the arena's positions,
extends a slice of every F-bucket's anchor groups and runs SW on a slice of
the gapped-extension pairs. The partial results are gathered in rank order
and merged by rules that do not depend on the split (a (key, position)
sort, per-group sums, concatenation), so every process ends with the
single-process blockset.

The collective backend is gloo, on host tensors, on the card too.
Everything the reference gathers is a host numpy array (occurrence rows,
per-group extension lengths, SW endpoint rows), and the merges run on the
host, so the port gathers the same arrays as CPU tensors, padded to a
common length as the reference pads them. NCCL gathers device tensors and
needs a distinct GPU for each rank, so it could not run two ranks on one
card; it would pay off only once a gather sits on the critical path.

The multi-process branches switch on only inside an initialised process
group of more than one rank (:func:`multiprocess`).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from npge_tpu_torch.algo.anchors import AnchorGroups, find_anchors, form_groups
from npge_tpu_torch.config import Config
from npge_tpu_torch.device import upload_arena
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.ops.kmers import _sid_from_offsets, select_occurrences


def init_distributed() -> tuple[int, int]:
    """Initialise the default process group (gloo, ``env://``) when a
    launcher such as ``torchrun`` has set ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR``; returns :func:`process_index_count`."""
    if not dist.is_initialized() and all(
        v in os.environ for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR")
    ):
        dist.init_process_group("gloo")
    return process_index_count()


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) when none
    is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def multiprocess() -> bool:
    """True inside an initialised process group of more than one rank: the
    one switch of every multi-process branch."""
    return (
        dist.is_available() and dist.is_initialized()
        and dist.get_world_size() > 1
    )


# mirrors npge_tpu/parallel/distributed.py:host_slice
def host_slice(total: int, pi: int, pc: int) -> tuple[int, int]:
    """Deterministic contiguous partition of [0, total) across processes."""
    per = -(-total // pc)
    lo = min(pi * per, total)
    hi = min(lo + per, total)
    return lo, hi


def allgather(x: np.ndarray, timings=None) -> np.ndarray:
    """[world size, *x.shape]: ``x`` of every process in rank order (every
    process passes the same shape and dtype). A gloo all_gather of CPU
    tensors; ``timings`` books its wall time as ``mp.gather``."""
    t0 = time.perf_counter()
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    g = torch.stack(out).numpy()
    if timings is not None:
        timings.add("mp.gather", time.perf_counter() - t0)
    return g


# mirrors npge_tpu/parallel/distributed.py:scan_slice
def scan_slice(
    arena: GenomeArena, cfg: Config, k: int, lo: int, hi: int, device
):
    """Scan position slice [lo, hi) on ``device`` with a halo of
    k - 1 + 2w on both sides; returns the slice's own occurrences
    (key int64, pos int64, strand int8) as host arrays in position order.
    The union over a partition of [0, T) is the single-device scan."""
    T = arena.total_length
    halo = k - 1 + 2 * cfg.MINIMIZER_WINDOW
    a = max(0, lo - halo)
    b = min(T, hi + halo)
    codes = upload_arena(arena, device)[0][a:b]
    sid = _sid_from_offsets(arena.offsets, b - a, codes.device, start=a)
    key, idx, strand = select_occurrences(codes, sid, k, cfg.MINIMIZER_WINDOW)
    own = (idx >= lo - a) & (idx < hi - a)
    return (
        key[own].cpu().numpy(), (idx[own] + a).cpu().numpy(),
        strand[own].cpu().numpy(),
    )


def merge_occurrences(key, pos, strand, arena, cfg, k) -> AnchorGroups:
    """Anchor groups of occurrence rows in any order: the (key, position)
    sort of the single-device scan, then group formation."""
    order = np.lexsort((pos, key))
    return form_groups(key[order], pos[order], strand[order], arena, cfg, k)


# mirrors npge_tpu/parallel/distributed.py:multihost_find_anchors
def multihost_find_anchors(
    arena: GenomeArena, cfg: Config, device, k: int | None = None,
    timings=None,
) -> AnchorGroups:
    """Anchor scan partitioned across processes by arena position, merged
    deterministically; with one process this is ``find_anchors``.

    Circular arenas take the cyclic-halo scan of ``find_anchors`` on every
    process (deterministic, so all processes agree); only the linear scan is
    partitioned."""
    k = k or cfg.ANCHOR_SIZE
    if any(
        arena.circular(i) and arena.seq_len(i) >= k
        for i in range(arena.n_seqs)
    ):
        return find_anchors(arena, cfg, device, k=k)
    pi, pc = process_index_count()
    lo, hi = host_slice(arena.total_length, pi, pc)
    key, pos, strand = scan_slice(arena, cfg, k, lo, hi, device)
    if pc > 1:
        # padded all_gather of every process's rows; strand travels as
        # int64 beside the key and position
        counts = allgather(np.array([len(pos)], np.int64), timings)[:, 0]
        rows = np.zeros((3, int(counts.max())), np.int64)
        rows[:, : len(pos)] = (key, pos, strand)
        g = allgather(rows, timings)
        key, pos, strand = (
            np.concatenate([g[r, i, : counts[r]] for r in range(pc)])
            for i in range(3)
        )
        strand = strand.astype(np.int8)
    return merge_occurrences(key, pos, strand, arena, cfg, k)
