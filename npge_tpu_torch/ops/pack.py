# mirrors npge_tpu/ops/pack.py
"""2-bit packed genome arrays: 16 bases a uint32 word plus an N mask.

Plain torch ops on the caller's device (elementwise shifts and a sum; the
reference's versions are jnp, not Pallas). The uint8 code arena remains the
working representation; packing is for storage and transfer. The words are
computed in int64, because torch has no shifts on uint32.
"""

from __future__ import annotations

import torch


def _shifts(device) -> torch.Tensor:
    return 2 * torch.arange(16, dtype=torch.int64, device=device)


def pack2(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8[n] codes -> (uint32[ceil(n/16)] packed, bool[n] n_mask).
    N (and anything >= 4) packs as base 0 with the mask bit set; base i
    of a word sits at bits 2i, 2i+1."""
    n = codes.shape[0]
    c = torch.zeros(-(-n // 16) * 16, dtype=torch.int64, device=codes.device)
    c[:n] = codes
    n_mask = codes >= 4
    vals = torch.where(c < 4, c, 0).reshape(-1, 16)
    words = (vals << _shifts(codes.device)).sum(dim=1)
    return words.to(torch.uint32), n_mask


def unpack2(packed: torch.Tensor, n_mask: torch.Tensor) -> torch.Tensor:
    """Inverse of pack2; result length = len(n_mask)."""
    n = n_mask.shape[0]
    words = packed.to(torch.int64)[:, None]
    vals = ((words >> _shifts(packed.device)) & 3).reshape(-1)[:n]
    return torch.where(n_mask, 4, vals).to(torch.uint8)
