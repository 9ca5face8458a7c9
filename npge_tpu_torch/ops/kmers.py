"""Canonical k-mer scan + minimizer sampling + anchor grouping in torch.

Counterpart of ``npge_tpu/ops/kmers.py`` (semantics of its CPU branch).
The 2-bit k-mer value itself is the key, held as ONE non-negative int64
(k <= 31), so comparing keys compares the reference's (hi, lo) uint32
pairs. The strand-canonical key is min(forward, reverse complement);
windows that leave their sequence or hold an N are invalid. (w,k)-minimizer
sampling keeps every tying position (window-max of window-min equals the
key). Selected positions compact in ascending order, and a stable sort on
the key then gives the reference's lexsort((pos, key)) order.
"""

from __future__ import annotations

import numpy as np
import torch

_KEY_FILL = torch.iinfo(torch.int64).max  # above every valid key (< 4^31)


# mirrors npge_tpu/ops/kmers.py:kmer_scan
def kmer_scan(codes: torch.Tensor, seq_id_of: torch.Tensor, k: int):
    """Per-position canonical k-mer keys.

    codes: uint8[T] base codes (0..4); seq_id_of: int32[T]; 1 <= k <= 31.
    Returns (key int64[T] canonical key, valid positions only; strand
    int8[T] +1 forward canonical / -1 revcomp / 0 palindrome; valid
    bool[T] window fits in one sequence and holds no N)."""
    if k == 32:
        raise ValueError("k = 32 needs unsigned 64-bit keys; the port takes k <= 31")
    if not (1 <= k <= 31):
        raise ValueError("k must be in [1, 31]")
    T = codes.shape[0]
    dev = codes.device
    c = torch.cat(
        [codes.to(torch.int64), torch.full((k,), 4, dtype=torch.int64, device=dev)]
    )
    sid_ext = torch.cat(
        [seq_id_of.to(torch.int32), torch.full((k,), -1, dtype=torch.int32, device=dev)]
    )
    f = torch.zeros(T, dtype=torch.int64, device=dev)
    r = torch.zeros(T, dtype=torch.int64, device=dev)
    has_n = torch.zeros(T, dtype=torch.bool, device=dev)
    # rolling (Horner) update: base i enters the forward key at weight
    # 4^(k-1-i) and its complement enters the revcomp key at weight 4^i
    for i in range(k):
        ci = c[i : i + T]
        has_n |= ci >= 4
        b = ci & 3  # N windows are masked by has_n
        f = (f << 2) | b
        r = r | ((3 - b) << (2 * i))
    valid = (sid_ext[k - 1 : k - 1 + T] == seq_id_of) & ~has_n
    fwd_min = f < r
    key = torch.where(fwd_min, f, r)
    strand = torch.where(
        f == r, 0, torch.where(fwd_min, 1, -1)
    ).to(torch.int8)
    return key, strand, valid


# mirrors npge_tpu/ops/kmers.py:minimizer_mask
def minimizer_mask(key: torch.Tensor, valid: torch.Tensor, w: int) -> torch.Tensor:
    """bool[T]: position is a (w,k)-minimizer occurrence — its key equals
    the minimum of at least one window of w consecutive keys containing it
    (all ties selected). w = 1 selects every valid position."""
    if w <= 1:
        return valid
    h = torch.where(valid, key, _KEY_FILL)
    fill = torch.full((w - 1,), _KEY_FILL, dtype=torch.int64, device=key.device)
    wmin = torch.cat([h, fill]).unfold(0, w, 1).amin(dim=1)  # min over [s, s+w)
    zero = torch.zeros(w - 1, dtype=torch.int64, device=key.device)
    mh = torch.cat([zero, wmin]).unfold(0, w, 1).amax(dim=1)  # max over [p-w+1, p]
    return valid & (mh == h)


# mirrors npge_tpu/ops/kmers.py:_sid_from_offsets
def _sid_from_offsets(offsets: np.ndarray, T: int, device) -> torch.Tensor:
    """int32 sequence id per position from the offsets table; positions at
    or past offsets[-1] get -1."""
    pos = torch.arange(T, dtype=torch.int64, device=device)
    off = torch.as_tensor(np.asarray(offsets, np.int64), device=device)
    sid = torch.searchsorted(off, pos, right=True) - 1
    return torch.where(pos >= off[-1], -1, sid).to(torch.int32)


# mirrors npge_tpu/ops/kmers.py:find_anchor_occurrences (its CPU branch)
def find_anchor_occurrences(
    codes, seq_id_of, k: int, w: int, device,
    offsets: np.ndarray | None = None, want_gid: bool = False,
):
    """Scan -> minimizer sample -> compact -> sort by (key, position).

    ``codes`` is a uint8 tensor or numpy array (moved to ``device``); pass
    ``offsets`` instead of ``seq_id_of`` to build the sequence ids on the
    device. Returns host numpy arrays (key int64, pos int64, strand int8),
    one row per sampled valid non-palindromic occurrence, or with
    ``want_gid`` (gid int64, pos, strand) where gid numbers the same-key
    runs densely."""
    T = int(codes.shape[0])
    Tp = 1 << max(0, T - 1).bit_length()
    if Tp >= 1 << 31:  # the reference's int32-position guard
        raise ValueError("arena too large for int32 positions")
    if T == 0:
        e = np.zeros(0, np.int64)
        return e, e.copy(), np.zeros(0, np.int8)
    codes = torch.as_tensor(codes, device=device)
    if seq_id_of is None:
        seq_id_of = _sid_from_offsets(offsets, T, codes.device)
    else:
        seq_id_of = torch.as_tensor(seq_id_of, device=codes.device)
    key, strand, valid = kmer_scan(codes, seq_id_of, k)
    sel = minimizer_mask(key, valid, w) & (strand != 0)
    idx = torch.nonzero(sel)[:, 0]  # ascending positions
    key, order = torch.sort(key[idx], stable=True)
    idx = idx[order]
    strand = strand[idx]
    key, idx, strand = key.cpu().numpy(), idx.cpu().numpy(), strand.cpu().numpy()
    if want_gid:
        new = np.ones(len(key), bool)
        new[1:] = key[1:] != key[:-1]
        return np.cumsum(new).astype(np.int64) - 1, idx, strand
    return key, idx, strand
