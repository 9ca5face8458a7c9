"""Device resolution, the blocking host-device transfers, and the device
copy of an arena.

The device is always named by the caller: ``"cuda"`` requires a GPU and
raises without one, ``"cpu"`` runs the plain torch versions of every op. No
path switches from one to the other on its own.

Every blocking transfer of a build goes through :func:`to_host` or
:func:`to_device`, which book it in the build's tracer (``timings``, a
``trace.StageTimings``) as a span and two counters. They count on the CPU
too, where the copy is free, so that a CPU build counts the transfers that
the same build makes on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.trace import span

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


def _book(timings, kind: str, nbytes: int) -> None:
    if timings is not None:
        timings.count(kind, 1)
        timings.count(kind + "_bytes", nbytes)


def to_host(x: torch.Tensor, timings=None) -> torch.Tensor:
    """``x`` on the host: for a device tensor a copy that waits for the
    work queued before it. Booked as span and counter ``sync.d2h``, with
    ``sync.d2h_bytes``."""
    with span(timings, "sync.d2h"):
        out = x.cpu()
    _book(timings, "sync.d2h", x.numel() * x.element_size())
    return out


def to_device(x, device, timings=None) -> torch.Tensor:
    """Host data (a numpy array or a CPU tensor) as a tensor on ``device``,
    copied from pageable memory. Booked as span and counter ``sync.h2d``,
    with ``sync.h2d_bytes``."""
    with span(timings, "sync.h2d"):
        out = torch.as_tensor(x, device=device)
    nbytes = x.nbytes if isinstance(x, np.ndarray) else x.numel() * x.element_size()
    _book(timings, "sync.h2d", nbytes)
    return out


def upload_arena(
    arena: GenomeArena, device, timings=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes, codes2) uint8 tensors of ``arena`` on ``device``, where
    ``codes2 = codes ++ revcomp(codes)``. Cached on the arena object per
    device (arenas are immutable)."""
    from npge_tpu_torch.ops.extend import make_codes2  # ops.extend imports this module

    dev = resolve_device(device)
    cache = arena.__dict__.setdefault(_ARENA_ATTR, {})
    hit = cache.get(str(dev))
    if hit is None:
        codes = to_device(arena.codes, dev, timings)
        hit = (codes, make_codes2(codes))
        cache[str(dev)] = hit
    return hit
