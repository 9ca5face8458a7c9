# mirrors npge_tpu/parallel/sharded.py
"""Mesh-sharded anchor scan with the single-device merge.

Each shard scans its contiguous slice of arena positions on its own device
(with the halo of ``distributed.scan_slice``); the occurrence rows meet on
the host in the (key, position) order of the single-device scan, so the
anchor groups are the single-device groups for any shard count.
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.algo.anchors import AnchorGroups
from npge_tpu_torch.config import Config
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.parallel.distributed import merge_occurrences, scan_slice
from npge_tpu_torch.parallel.mesh import DeviceMesh


# mirrors npge_tpu/parallel/sharded.py:sharded_find_anchors
def sharded_find_anchors(
    arena: GenomeArena, cfg: Config, mesh: DeviceMesh, k: int | None = None
) -> AnchorGroups:
    """Position-sharded AnchorFinder over ``mesh``.

    Like the reference's mesh path, this scans linearly even when the arena
    has circular sequences (no cyclic halo, unlike ``find_anchors``)."""
    k = k or cfg.ANCHOR_SIZE
    parts = [
        scan_slice(arena, cfg, k, lo, hi, dev)
        for dev, lo, hi in mesh.slices(arena.total_length)
    ]
    key, pos, strand = (np.concatenate(col) for col in zip(*parts))
    return merge_occurrences(key, pos, strand, arena, cfg, k)
