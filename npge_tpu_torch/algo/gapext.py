"""Gapped flank extension — grow admitted blocks through indels.

Copy of ``npge_tpu/algo/gapext.py:gapped_extend_blocks`` whose SW pass
(flank endpoints of every (block, side, fragment) pair) runs the port's
``sw_extend_windows`` on the arena's device copy of codes2: the CUDA kernel
on a GPU, its plain torch version on the CPU. Single process. Path
recovery, the center-star merge, trimming and splicing come from the
reference by import.
"""

from __future__ import annotations

import time

import numpy as np

from npge_tpu.algo.gapext import (
    _apply_side,
    _merge_center_star,
    _nw_fixed_query_batch,
    _side_bases,
    _trim_good,
    host_codes2,
)
from npge_tpu.config import Config
from npge_tpu.model.blocks import BlockSet
from npge_tpu.model.fragindex import FragmentIndex
from npge_tpu.model.stats import column_classes
from npge_tpu_torch.device import upload_arena
from npge_tpu_torch.ops import sw as sw_ops


# mirrors npge_tpu/algo/gapext.py:gapped_extend_blocks
def gapped_extend_blocks(
    bs: BlockSet, cfg: Config, device, timings=None,
    probe_cache: dict | None = None,
) -> int:
    """Extend every multi-fragment block through its free flank room on
    both sides (gapped), with the SW endpoint pass on ``device``. Mutates
    ``bs.blocks`` in place; returns the number of side-extensions applied.

    ``probe_cache`` memoizes no-extension probes across calls, keyed by
    (block object, side, per-fragment caps); entries pin their block."""

    def _book(phase, t0):
        if timings is not None:
            timings.add(f"gapext.{phase}", time.perf_counter() - t0)
        return time.perf_counter()

    _t = time.perf_counter()
    arena = bs.arena
    blocks = bs.blocks
    multi = [i for i, b in enumerate(blocks) if b.n_frags >= 2]
    if not multi:
        return 0
    idx = FragmentIndex(arena, blocks)
    rr, rf = idx.per_block_rooms()
    codes2 = host_codes2(arena)
    FL = cfg.GAPPED_FLANK
    min_room = cfg.MIN_GAPPED_ROOM
    sw = dict(
        match=cfg.SW_MATCH, mismatch=cfg.SW_MISMATCH, gap=cfg.SW_GAP,
        xdrop=cfg.SW_XDROP,
    )

    # ---- assemble jobs: one per (block, side) with every fragment roomy ----
    # Each job captures its cache key now (pinning the original block).
    jobs = []  # (bi, side, caps[F] int64, bases[F] int64, block, key)
    for bi in multi:
        b = blocks[bi]
        base_l, base_r = _side_bases(b.frags, arena)
        ori = b.frags.ori.astype(np.int64)
        room_rev = rr[bi]
        room_fwd = rf[bi]
        cap_r = np.where(ori == 1, room_fwd, room_rev)
        cap_l = np.where(ori == 1, room_rev, room_fwd)
        side_jobs = []
        for side, base, cap in (("L", base_l, cap_l), ("R", base_r, cap_r)):
            cap = np.minimum(cap, FL)
            if cap.min() >= min_room:
                key = (id(b), side, cap.tobytes())
                side_jobs.append((side, cap, base, key))
        # a cached no-ext outcome is a pure replay only if every roomy side
        # of the block is a hit (a fresh sibling side could change it)
        hits = [
            probe_cache is not None and sj[3] in probe_cache
            for sj in side_jobs
        ]
        if side_jobs and all(hits):
            if timings is not None:
                timings.count("cache.gapext_probe_skip", len(side_jobs))
            continue  # proven unextendable under these exact caps
        for side, cap, base, key in side_jobs:
            jobs.append((bi, side, cap, base, b, key))
    if timings is not None:
        timings.count("cache.gapext_probe_run", len(jobs))
    if not jobs:
        return 0
    _t = _book("assemble", _t)

    # ---- one batched device pass for all flank-pair endpoints ----
    def flank(base, cap):
        return codes2[base : base + cap]

    n_pairs = np.array([len(c) - 1 for (_b, _s, c, *_r) in jobs], np.int64)
    owner = np.repeat(np.arange(len(jobs)), n_pairs)
    qb = np.concatenate(
        [np.full(len(cap) - 1, base[0]) for (_b, _s, cap, base, *_r) in jobs]
    )
    qcap = np.concatenate(
        [np.full(len(cap) - 1, cap[0]) for (_b, _s, cap, *_r) in jobs]
    )
    tb = np.concatenate([base[1:] for (_b, _s, _c, base, *_r) in jobs])
    tcap = np.concatenate([cap[1:] for (_b, _s, cap, *_r) in jobs])
    adv = np.full(len(jobs), np.int64(1) << 40)
    launches = sw_ops.SW_LAUNCHES
    ends = sw_ops.sw_extend_windows(
        upload_arena(arena, device)[1], qb, qcap, tb, tcap, L=FL, **sw
    ).cpu().numpy()
    np.minimum.at(adv, owner, ends[:, 1].astype(np.int64))
    if timings is not None:
        timings.count("gapext_pairs", len(qb))
        timings.count("gapext.sw_launches", sw_ops.SW_LAUNCHES - launches)
    _t = _book("sw", _t)

    # ---- per-job path recovery, merge, trim, splice ----
    stats_cache: dict[int, tuple[int, int]] = {}

    def block_stats(bi: int) -> tuple[int, int]:
        st = stats_cache.get(bi)
        if st is None:
            ident, gapless = column_classes(blocks[bi].rows(arena))
            st = (int((ident & gapless).sum()), blocks[bi].n_cols)
            stats_cache[bi] = st
        return st

    # ---- batched path recovery across all (job, fragment) pairs ----
    nw_pairs = []  # (q, t) in job order
    pair_job = []
    job_q: dict[int, np.ndarray] = {}
    for j, (bi, side, cap, base, _b0, _key) in enumerate(jobs):
        A = int(adv[j])
        if A <= 0:
            continue
        q = flank(int(base[0]), A)
        job_q[j] = q
        for fi in range(1, len(cap)):
            # target window: lockstep advance plus bounded indel slack
            tcap_f = int(min(cap[fi], A + cfg.SW_XDROP))
            nw_pairs.append((q, flank(int(base[fi]), max(tcap_f, 0))))
            pair_job.append(j)
    nw_out = _nw_fixed_query_batch(
        nw_pairs, cfg.SW_MATCH, cfg.SW_MISMATCH, cfg.SW_GAP
    )
    _t = _book("nw", _t)
    job_results: dict[int, list] = {j: [] for j in job_q}
    for r, j in zip(nw_out, pair_job):
        job_results[j].append(r)

    applied = 0
    for j, (bi, side, cap, base, _b0, _key) in enumerate(jobs):
        # no-ext results are cached only while blocks[bi] is still the
        # block the key captured
        cacheable = probe_cache is not None and blocks[bi] is _b0
        if j not in job_q:
            if cacheable:  # adv <= 0: nothing to extend
                probe_cache[_key] = _b0
            continue
        q = job_q[j]
        cols = _merge_center_star(q, job_results[j])
        good0, total0 = block_stats(bi)
        c = _trim_good(cols, good0, total0, cfg)
        if c == 0:
            if cacheable:
                probe_cache[_key] = _b0
            continue
        cols = cols[:, :c]
        ident, gapless = column_classes(cols)
        blocks[bi] = _apply_side(blocks[bi], arena, cols, side)
        stats_cache[bi] = (
            good0 + int((ident & gapless).sum()), total0 + c
        )
        applied += 1
    _book("apply", _t)
    return applied
