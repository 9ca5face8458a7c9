# mirrors npge_tpu/parallel/mesh.py
"""A 1-D device mesh: an explicit list of torch devices, one shard each.

The reference's mesh is a ``jax.sharding.Mesh`` whose sharded arrays XLA
splits over the devices. Here a stage splits its work itself: the k-mer
scan by arena position (``parallel.sharded``), the extension batches by
row (``algo.extender``), each slice on its own device, merged on the host.

Devices are always named by the caller. :func:`make_mesh` takes the first
n distinct visible devices of a kind and raises when fewer exist; a mesh
that repeats a device (n shards on one card, or on the CPU, which torch
sees as one device) is built only by writing the list out.

A mesh may carry a build's tracer (:meth:`DeviceMesh.traced`): the stages
that take the mesh book each shard's slice there, so the tracer reaches
them without a new argument (``sharded_find_anchors`` keeps the signature
``(arena, cfg, mesh, k=None)`` that the benchmark's recorder wraps).
"""

from __future__ import annotations

import torch

from npge_tpu_torch.device import resolve_device
from npge_tpu_torch.parallel.distributed import host_slice


class DeviceMesh:
    """An explicit list of devices, one shard each; a device may repeat.
    ``timings``: the ``StageTimings`` of the build that runs over the mesh,
    or None (nothing booked)."""

    def __init__(self, devices, timings=None):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a DeviceMesh needs at least one device")
        self.timings = timings

    def traced(self, timings) -> "DeviceMesh":
        """A mesh over the same devices that books into ``timings``."""
        return DeviceMesh(self.devices, timings)

    @property
    def size(self) -> int:
        return len(self.devices)

    def slices(self, total: int) -> list[tuple[torch.device, int, int]]:
        """[0, total) split into one contiguous (device, lo, hi) slice per
        shard, in shard order; trailing slices may be empty."""
        return [
            (d, *host_slice(total, i, self.size))
            for i, d in enumerate(self.devices)
        ]

    def __repr__(self) -> str:
        cards = list(dict.fromkeys(str(d) for d in self.devices))
        return f"{self.size} shards on {len(cards)} device(s): {', '.join(cards)}"


def make_mesh(n: int, kind: str = "cuda") -> DeviceMesh:
    """A mesh over the first ``n`` distinct visible devices of ``kind``
    ("cuda" or "cpu"); raises ValueError when fewer exist."""
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(have)]
    elif kind == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported device kind {kind!r}: use 'cuda' or 'cpu'")
    if n < 1 or len(devs) < n:
        raise ValueError(f"need {n} {kind} devices, have {len(devs)}")
    return DeviceMesh(devs[:n])
