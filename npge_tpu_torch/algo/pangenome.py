"""Pangenome construction pipeline — the main orchestration loop.

Counterpart of ``npge_tpu/algo/pangenome.py:build_pangenome`` on one
device and one process: anchors and gapless extension on the device, greedy
overlap resolution, Joiner, gapped flank extension (SW on the device), then
the consensus re-seed fixed-point loop, Rest and names. Same stage books,
k schedule, revert rule, cache sweep and ``deep.proven_at_kmin`` exits as
the reference, so the blockset hash is the reference's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from npge_tpu_torch.algo.anchors import find_anchors
from npge_tpu_torch.algo.conseq import consensus_arena, deconseq
from npge_tpu_torch.algo.extender import extend_anchor_groups
from npge_tpu_torch.algo.gapext import gapped_extend_blocks
from npge_tpu_torch.algo.joiner import _StatCache, join_blocks
from npge_tpu_torch.algo.overlaps import occupancy, resolve_overlaps
from npge_tpu_torch.algo.rest import rest_blocks
from npge_tpu_torch.algo.surgery import quality_metric
from npge_tpu_torch.config import Config
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import BlockSet
from npge_tpu_torch.model.hashing import blockset_hash
from npge_tpu_torch.model.naming import assign_names
from npge_tpu_torch.device import resolve_device, upload_arena


# mirrors npge_tpu/algo/pangenome.py:StageTimings
@dataclass
class StageTimings:
    seconds: dict[str, float] = field(default_factory=dict)
    counters: dict[str, int] = field(default_factory=dict)

    def add(self, stage: str, dt: float) -> None:
        self.seconds[stage] = self.seconds.get(stage, 0.0) + dt

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def report(self) -> str:
        total = sum(self.seconds.values())
        lines = [f"{'stage':<18}{'seconds':>10}"]
        for k, v in self.seconds.items():
            lines.append(f"{k:<18}{v:>10.3f}")
        lines.append(f"{'TOTAL':<18}{total:>10.3f}")
        for k, v in self.counters.items():
            rate = ""
            base = k.split("_cells")[0]
            if k.endswith("_cells") and self.seconds.get(base):
                rate = f"  ({v / self.seconds[base] / 1e6:.1f} Mcells/s)"
            lines.append(f"{k:<18}{v:>12}{rate}")
        return "\n".join(lines)


# mirrors npge_tpu/algo/pangenome.py:build_pangenome
def build_pangenome(
    arena: GenomeArena, cfg: Config, device, verbose: bool = False
) -> tuple[BlockSet, StageTimings]:
    """Pangenome construction on ``device`` ("cuda" or "cpu"). Stage wall
    times are host clocks; device work is synchronized by each stage's
    readback."""
    dev = resolve_device(device)
    t = StageTimings()

    def log(msg: str) -> None:
        if verbose:
            print(msg, flush=True)

    t0 = time.perf_counter()
    upload_arena(arena, dev)  # cached on the arena for the stages below
    t.add("upload", time.perf_counter() - t0)

    t0 = time.perf_counter()
    groups = find_anchors(arena, cfg, dev)
    t.add("anchors", time.perf_counter() - t0)
    log(f"anchors: {groups.n_groups} groups, {len(groups.pos)} occurrences")

    t0 = time.perf_counter()
    cand = extend_anchor_groups(arena, groups, cfg, dev, timings=t)
    t.add("extend", time.perf_counter() - t0)
    log(f"extend: {len(cand)} candidate blocks")

    t0 = time.perf_counter()
    accepted = resolve_overlaps(cand, arena, cfg)
    t.add("resolve", time.perf_counter() - t0)
    log(f"resolve: {len(accepted)} admitted blocks")

    t0 = time.perf_counter()
    bs = BlockSet(arena, accepted)
    # join probe caches persist across the whole build (resolve keeps Block
    # object identity for unchanged blocks)
    join_cache = _StatCache(bs, cfg.MIN_END, stats=t.counters)
    join_rejected: set = set()
    gapext_cache: dict = {}  # no-ext probe memo, see gapped_extend_blocks
    n_joins = join_blocks(bs, cfg, join_cache, join_rejected)
    t.add("join", time.perf_counter() - t0)
    log(f"join: {n_joins} merges -> {len(bs.blocks)} blocks")

    if cfg.GAPPED_EXTEND:
        t0 = time.perf_counter()
        n_ext = gapped_extend_blocks(
            bs, cfg, dev, timings=t, probe_cache=gapext_cache
        )
        if n_ext:
            join_blocks(bs, cfg, join_cache, join_rejected)
        t.add("gapext", time.perf_counter() - t0)
        log(f"gapext: {n_ext} side-extensions -> {len(bs.blocks)} blocks")

    # ---- consensus re-seed fixed-point loop ----
    k = cfg.ANCHOR_SIZE
    prev_hash = None
    best_metric = quality_metric(bs)
    snapshot = list(bs.blocks)
    cons_cache: dict = {}  # id -> (block, cons, cmap), see consensus_arena
    rest_cache: dict = {}  # (seq, start, len) -> Block, see rest_blocks
    canon_memo: dict = {}  # id -> (block, canonical block), see canonicalize
    hash_memo: dict = {}  # id -> (block, hash), see blockset_hash
    slice_memo: dict = {}  # (id, c0, c1, ori) -> (block, piece), deconseq

    def sweep_caches() -> None:
        """Evict cache entries for blocks no longer reachable from the
        current blockset, the revert snapshot or the rest fillers (the
        caches pin their blocks)."""
        live = {id(b) for b in bs.blocks}
        live.update(id(b) for b in snapshot)
        live.update(id(b) for b in rest_cache.values())
        for key in [key for key in canon_memo if key not in live]:
            del canon_memo[key]
        canon_live = live | {id(v[1]) for v in canon_memo.values()}
        for key in [key for key in cons_cache if key not in canon_live]:
            del cons_cache[key]
        for key in [key for key in hash_memo if key not in canon_live]:
            del hash_memo[key]
        for key in [key for key in slice_memo if key[0] not in canon_live]:
            del slice_memo[key]
        for key in [key for key in join_cache.d if key not in live]:
            del join_cache.d[key]
        for pair in [
            pair for pair in join_rejected
            if id(pair[0]) not in live or id(pair[1]) not in live
        ]:
            join_rejected.discard(pair)
        for key in [key for key in gapext_cache if key[0] not in live]:
            del gapext_cache[key]

    for round_no in range(cfg.MAX_LOOPS):
        sweep_caches()
        # seed phase books: occ = rest fill + canonical hash, cons =
        # consensus arena build + upload, scan = anchor scan, extend =
        # extension + deconseq mapping
        t0 = time.perf_counter()
        occ = occupancy(arena, bs.blocks)
        full = BlockSet(
            arena,
            list(bs.blocks) + rest_blocks(
                arena, occ, rest_cache, stats=t.counters
            ),
        )
        full.canonicalize(canon_memo, stats=t.counters)
        h = blockset_hash(full, hash_memo)
        if h == prev_hash and k <= cfg.MIN_ANCHOR_SIZE:
            # unchanged blockset and no finer seed size left: the deep
            # IsPangenome probe at k=MIN is proven non-improving
            t.count("deep.proven_at_kmin", 1)
            t.add("reseed.occ", time.perf_counter() - t0)
            break
        prev_hash = h
        k = max(cfg.MIN_ANCHOR_SIZE, k - (cfg.RESEED_SHRINK if round_no else 0))
        t.add("reseed.occ", time.perf_counter() - t0)
        t0 = time.perf_counter()
        cons, src = consensus_arena(full, cons_cache, stats=t.counters)
        upload_arena(cons, dev)
        t.add("reseed.cons", time.perf_counter() - t0)
        t0 = time.perf_counter()
        groups = find_anchors(cons, cfg, dev, k=k)
        t.add("reseed.scan", time.perf_counter() - t0)
        t0 = time.perf_counter()
        cand_cons = extend_anchor_groups(
            cons, groups, cfg, dev, timings=t,
            counter_prefix="reseed.extend",
        )
        t.add("reseed.extend.ext", time.perf_counter() - t0)
        t0d = time.perf_counter()
        mapped = deconseq(cand_cons, src, full, slice_memo)
        t.add("reseed.extend.deconseq", time.perf_counter() - t0d)
        t.add("reseed.extend", time.perf_counter() - t0)
        log(
            f"reseed {round_no}: k={k} {groups.n_groups} cons-groups -> "
            f"{len(mapped)} mapped candidates"
        )
        if not mapped:
            if k <= cfg.MIN_ANCHOR_SIZE:
                t.count("deep.proven_at_kmin", 1)  # probe at k=MIN is empty
                break
            # finer seeds may still find hits: exhaust the k schedule
            continue
        t0 = time.perf_counter()
        accepted = resolve_overlaps(
            [b for b in bs.blocks if b.n_frags >= 2] + mapped, arena, cfg
        )
        bs = BlockSet(arena, accepted)
        t.add("reseed.resolve", time.perf_counter() - t0)
        t0 = time.perf_counter()
        join_blocks(bs, cfg, join_cache, join_rejected)
        t.add("reseed.join", time.perf_counter() - t0)
        if cfg.GAPPED_EXTEND:
            t0 = time.perf_counter()
            if gapped_extend_blocks(
                bs, cfg, dev, timings=t, probe_cache=gapext_cache
            ):
                join_blocks(bs, cfg, join_cache, join_rejected)
            t.add("reseed.gapext", time.perf_counter() - t0)
        metric = quality_metric(bs)
        log(
            f"reseed {round_no}: -> {len(bs.blocks)} blocks after "
            f"resolve+join, metric={metric}"
        )
        # a round that fails to improve the quality metric is reverted; the
        # loop then continues with a finer k
        if metric <= best_metric:
            bs = BlockSet(arena, snapshot)
            log(f"reseed {round_no}: no improvement at k={k}, reverting")
            if k <= cfg.MIN_ANCHOR_SIZE:
                t.count("deep.proven_at_kmin", 1)
                break
            continue
        best_metric = metric
        snapshot = list(bs.blocks)

    t0 = time.perf_counter()
    occ = occupancy(arena, bs.blocks)
    bs.blocks.extend(rest_blocks(arena, occ))
    t.add("rest", time.perf_counter() - t0)

    t0 = time.perf_counter()
    assign_names(bs)
    t.add("names", time.perf_counter() - t0)
    log(f"total blocks: {len(bs.blocks)}")
    return bs, t
