"""IsPangenome — the correctness oracle, with the deep probe on a device.

Counterpart of ``npge_tpu/algo/is_pangenome.py``. Checks 1-3b are host
code, copied from the reference:

  1. partition: every genome position belongs to exactly one block;
  2. every multi-fragment block is good;
  3. no two neighbouring blocks are joinable (Joiner dry run empty);
  3b. no snappable boundaries (Stick dry run empty).

The deep probe, one consensus re-seed round at k = MIN_ANCHOR_SIZE, runs
the port's scan, extension, deconseq and resolve on the named device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from npge_tpu_torch.algo.anchors import find_anchors
from npge_tpu_torch.algo.conseq import consensus_arena, deconseq
from npge_tpu_torch.algo.extender import extend_anchor_groups
from npge_tpu_torch.algo.joiner import _StatCache, joinable_pairs
from npge_tpu_torch.algo.overlaps import resolve_overlaps
from npge_tpu_torch.algo.stick import snappable_pairs
from npge_tpu_torch.algo.surgery import quality_metric
from npge_tpu_torch.config import Config
from npge_tpu_torch.device import resolve_device, upload_arena
from npge_tpu_torch.model.blocks import BlockSet
from npge_tpu_torch.model.stats import is_good_block
from npge_tpu_torch.trace import span


# mirrors npge_tpu/algo/is_pangenome.py:PangenomeReport
@dataclass
class PangenomeReport:
    ok: bool
    uncovered_positions: int = 0
    overcovered_positions: int = 0
    bad_blocks: list[str] = field(default_factory=list)
    joinable: int = 0
    snappable: int = 0
    new_hits: int = 0
    messages: list[str] = field(default_factory=list)


# mirrors npge_tpu/algo/is_pangenome.py:check_is_pangenome (checks 1-3b)
def _host_checks(bs: BlockSet, cfg: Config) -> PangenomeReport:
    rep = PangenomeReport(ok=True)

    # 1. partition invariant
    cov = bs.coverage_per_seq()
    for seq_id, c in enumerate(cov):
        un = int((c == 0).sum())
        ov = int((c > 1).sum())
        rep.uncovered_positions += un
        rep.overcovered_positions += ov
        if un or ov:
            rep.ok = False
            rep.messages.append(
                f"seq {bs.arena.names[seq_id]}: {un} uncovered, {ov} overcovered"
            )

    # 2. good blocks
    for i, b in enumerate(bs.blocks):
        if not is_good_block(b, bs.arena, cfg):
            rep.ok = False
            rep.bad_blocks.append(b.name or f"#{i}")
    if rep.bad_blocks:
        rep.messages.append(f"{len(rep.bad_blocks)} bad blocks")

    # 3. no joinable neighbors (incl. bounded-gap joins that would stay good)
    rep.joinable = len(joinable_pairs(bs, cfg, _StatCache(bs, cfg.MIN_END)))
    if rep.joinable:
        rep.ok = False
        rep.messages.append(f"{rep.joinable} joinable block pairs")

    # 3b. no snappable boundaries (Stick dry run)
    rep.snappable = len(snappable_pairs(bs, cfg))
    if rep.snappable:
        rep.ok = False
        rep.messages.append(
            f"{rep.snappable} snappable block pairs (run Stick)"
        )
    return rep


# mirrors npge_tpu/algo/is_pangenome.py:check_is_pangenome
def check_is_pangenome(
    bs: BlockSet, cfg: Config, deep: bool = False, device=None,
    timings=None,
) -> PangenomeReport:
    """Checks 1-3b, then with ``deep`` the re-seed probe on
    ``device`` ("cuda" or "cpu"; required with ``deep``, never guessed).
    ``timings`` (StageTimings) receives the probe's stages as spans
    ``deep.cons``, ``deep.scan``, ``deep.extend``, ``deep.deconseq`` and
    ``deep.resolve`` (each with the spans of its own steps inside), the
    transfers, and the ``deep.extend`` counters."""
    if deep and device is None:
        raise ValueError("the deep probe needs an explicit device")
    rep = _host_checks(bs, cfg)
    if not deep:
        return rep
    dev = resolve_device(device)

    # re-seeding on block consensuses yields no admissible good hit: a
    # "new hit" is a mapped candidate that would be admitted against the
    # current partition and raise the quality metric
    with span(timings, "deep.cons"):
        full = BlockSet(bs.arena, list(bs.blocks))
        full.canonicalize()
        cons, src = consensus_arena(full)
        upload_arena(cons, dev, timings)
    with span(timings, "deep.scan"):
        # probe at the finest seed size the construction loop ever uses
        groups = find_anchors(cons, cfg, dev, k=cfg.MIN_ANCHOR_SIZE, timings=timings)
    with span(timings, "deep.extend"):
        cand = extend_anchor_groups(
            cons, groups, cfg, dev, timings=timings, counter_prefix="deep.extend"
        )
    with span(timings, "deep.deconseq"):
        mapped = deconseq(cand, src, full, timings=timings)
    with span(timings, "deep.resolve"):
        if mapped:
            multi = [b for b in full.blocks if b.n_frags >= 2]
            base = quality_metric(BlockSet(bs.arena, multi))
            trial = resolve_overlaps(multi + mapped, bs.arena, cfg, timings=timings)
            if quality_metric(BlockSet(bs.arena, trial)) > base:
                rep.new_hits = len(mapped)
                rep.ok = False
                rep.messages.append(
                    f"re-seeding finds improving hits ({len(mapped)} candidates)"
                )
    return rep
