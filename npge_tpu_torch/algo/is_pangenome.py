"""IsPangenome — the correctness oracle, with the deep probe on a device.

Counterpart of ``npge_tpu/algo/is_pangenome.py``. Checks 1-3b (partition,
good blocks, no joinable or snappable pairs) are host code and run through
the reference's own function. The deep probe, one consensus re-seed round
at k = MIN_ANCHOR_SIZE, runs the port's scan, extension, deconseq and
resolve on the named device.
"""

from __future__ import annotations

import time

from npge_tpu.algo.conseq import consensus_arena
from npge_tpu.algo.is_pangenome import PangenomeReport
from npge_tpu.algo.is_pangenome import check_is_pangenome as _host_checks
from npge_tpu.algo.surgery import quality_metric
from npge_tpu.config import Config
from npge_tpu.model.blocks import BlockSet
from npge_tpu_torch.algo.anchors import find_anchors
from npge_tpu_torch.algo.conseq import deconseq
from npge_tpu_torch.algo.extender import extend_anchor_groups
from npge_tpu_torch.algo.overlaps import resolve_overlaps
from npge_tpu_torch.device import resolve_device, upload_arena


# mirrors npge_tpu/algo/is_pangenome.py:check_is_pangenome
def check_is_pangenome(
    bs: BlockSet, cfg: Config, deep: bool = False, device=None,
    timings=None,
) -> PangenomeReport:
    """The reference's checks 1-3b, then with ``deep`` the re-seed probe on
    ``device`` ("cuda" or "cpu"; required with ``deep``, never guessed).
    ``timings`` (StageTimings) receives the probe's stage seconds under
    ``deep.cons``, ``deep.scan``, ``deep.extend``, ``deep.deconseq`` and
    ``deep.resolve``, and the ``deep.extend_cells`` counter."""
    if deep and device is None:
        raise ValueError("the deep probe needs an explicit device")
    rep = _host_checks(bs, cfg, deep=False)
    if not deep:
        return rep
    dev = resolve_device(device)

    def book(stage: str, t0: float) -> float:
        t1 = time.perf_counter()
        if timings is not None:
            timings.add(stage, t1 - t0)
        return t1

    # re-seeding on block consensuses yields no admissible good hit: a
    # "new hit" is a mapped candidate that would be admitted against the
    # current partition and raise the quality metric
    t0 = time.perf_counter()
    full = BlockSet(bs.arena, list(bs.blocks))
    full.canonicalize()
    cons, src = consensus_arena(full)
    upload_arena(cons, dev)
    t0 = book("deep.cons", t0)
    # probe at the finest seed size the construction loop ever uses
    groups = find_anchors(cons, cfg, dev, k=cfg.MIN_ANCHOR_SIZE)
    t0 = book("deep.scan", t0)
    cand = extend_anchor_groups(
        cons, groups, cfg, dev, timings=timings, counter_prefix="deep.extend"
    )
    t0 = book("deep.extend", t0)
    mapped = deconseq(cand, src, full)
    t0 = book("deep.deconseq", t0)
    if mapped:
        multi = [b for b in full.blocks if b.n_frags >= 2]
        base = quality_metric(BlockSet(bs.arena, multi))
        trial = resolve_overlaps(multi + mapped, bs.arena, cfg)
        if quality_metric(BlockSet(bs.arena, trial)) > base:
            rep.new_hits = len(mapped)
            rep.ok = False
            rep.messages.append(
                f"re-seeding finds improving hits ({len(mapped)} candidates)"
            )
    book("deep.resolve", t0)
    return rep
