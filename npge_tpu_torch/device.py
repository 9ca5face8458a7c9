"""Device resolution and the device copy of an arena.

The device is always named by the caller: ``"cuda"`` requires a GPU and
raises without one, ``"cpu"`` runs the plain torch versions of every op. No
path switches from one to the other on its own.
"""

from __future__ import annotations

import torch

from npge_tpu.model.arena import GenomeArena
from npge_tpu_torch.ops.extend import make_codes2

# attribute under which upload_arena caches device copies on an arena
_ARENA_ATTR = "_npge_tpu_torch_dev"


def resolve_device(name) -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu", or a
    ``torch.device``). Raises RuntimeError for CUDA without a usable GPU
    and ValueError for any other device type."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is "
                "False (no GPU, or a CPU-only torch build)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev


def upload_arena(arena: GenomeArena, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes, codes2) uint8 tensors of ``arena`` on ``device``, where
    ``codes2 = codes ++ revcomp(codes)``. Cached on the arena object per
    device (arenas are immutable)."""
    dev = resolve_device(device)
    cache = arena.__dict__.setdefault(_ARENA_ATTR, {})
    hit = cache.get(str(dev))
    if hit is None:
        codes = torch.from_numpy(arena.codes).to(dev)
        hit = (codes, make_codes2(codes))
        cache[str(dev)] = hit
    return hit
