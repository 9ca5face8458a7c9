# mirrors npge_tpu/parallel/sharded.py
"""Mesh-sharded anchor scan with the single-device merge.

Each shard scans its contiguous slice of arena positions on its own device
(with the halo of ``distributed.scan_slice``); the occurrence rows meet on
the host in the (key, position) order of the single-device scan, so the
anchor groups are the single-device groups for any shard count.

Over a mesh bound to a build's tracer (``DeviceMesh.traced``) the scan
books the span ``mesh.scan``, inside it one ``mesh.scan.slice`` a shard
(tag ``card``: the shard's index; its scan and readback) and
``mesh.scan.merge`` (the host sort and group formation), and counts each
shard's occurrence rows as ``mesh.scan.rows.s<i>``. The slices' transfers
are not booked: ``scan_slice`` is called as ``(arena, cfg, k, lo, hi,
device)``, the signature that the benchmark's planted faults wrap.
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.algo.anchors import AnchorGroups
from npge_tpu_torch.config import Config
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.parallel.distributed import merge_occurrences, scan_slice
from npge_tpu_torch.parallel.mesh import DeviceMesh
from npge_tpu_torch.trace import span


# mirrors npge_tpu/parallel/sharded.py:sharded_find_anchors
def sharded_find_anchors(
    arena: GenomeArena, cfg: Config, mesh: DeviceMesh, k: int | None = None
) -> AnchorGroups:
    """Position-sharded AnchorFinder over ``mesh``.

    Like the reference's mesh path, this scans linearly even when the arena
    has circular sequences (no cyclic halo, unlike ``find_anchors``)."""
    k = k or cfg.ANCHOR_SIZE
    t = mesh.timings
    with span(t, "mesh.scan"):
        parts = []
        for i, (dev, lo, hi) in enumerate(mesh.slices(arena.total_length)):
            with span(t, "mesh.scan.slice", card=i):
                parts.append(scan_slice(arena, cfg, k, lo, hi, dev))
            if t is not None:
                t.count(f"mesh.scan.rows.s{i}", len(parts[-1][1]))
        with span(t, "mesh.scan.merge"):
            key, pos, strand = (np.concatenate(col) for col in zip(*parts))
            return merge_occurrences(key, pos, strand, arena, cfg, k)
