"""Canonical k-mer scan + minimizer sampling + anchor grouping in torch.

Counterpart of ``npge_tpu/ops/kmers.py`` (semantics of its CPU branch).
The 2-bit k-mer value itself is the key, held as ONE int64 whose order is
the reference's (hi, lo) uint32 pair order. For k <= 31 the key is the
value itself (below 4^31, non-negative). For k = 32 the value needs all 64
bits, so the key is the value minus 2^63 (the top bit flipped), which keeps
the unsigned order in the signed type. The strand-canonical key is
min(forward, reverse complement); windows that leave their sequence or
hold an N are invalid. (w,k)-minimizer sampling keeps every tying position
(window-max of window-min equals the key). Selected positions compact in
ascending order, and a stable sort on the key then gives the reference's
lexsort((pos, key)) order.
"""

from __future__ import annotations

import numpy as np
import torch

from npge_tpu_torch.device import to_device, to_host

# Window-min fill, at or above every valid key. For k <= 31 keys are below
# 4^31. For k = 32 int64 max is the all-T 32-mer, which is never canonical:
# its reverse complement, all-A, is smaller.
_KEY_FILL = torch.iinfo(torch.int64).max
# Window-max fill, at or below every valid key (all-A at k = 32).
_KEY_FLOOR = torch.iinfo(torch.int64).min


def _horner(c: torch.Tensor, T: int, a: int, b: int) -> torch.Tensor:
    """Value of bases a..b-1 of each window, base a most significant
    (b - a <= 31, so no shift overflows)."""
    v = torch.zeros(T, dtype=torch.int64, device=c.device)
    for i in range(a, b):
        v = (v << 2) | (c[i : i + T] & 3)  # N windows are masked by has_n
    return v


def _rev_horner(c: torch.Tensor, T: int, a: int, b: int) -> torch.Tensor:
    """Value of the complements of bases a..b-1 of each window, base i at
    weight 4^(i-a) (b - a <= 31)."""
    v = torch.zeros(T, dtype=torch.int64, device=c.device)
    for i in range(a, b):
        v = v | ((3 - (c[i : i + T] & 3)) << (2 * (i - a)))
    return v


def _u64_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key (hi * 2^32 + lo) - 2^63 of two 32-bit halves, computed
    without a signed overflow."""
    return (hi - (1 << 31)) * (1 << 32) + lo


# mirrors npge_tpu/ops/kmers.py:kmer_scan
def kmer_scan(codes: torch.Tensor, seq_id_of: torch.Tensor, k: int):
    """Per-position canonical k-mer keys.

    codes: uint8[T] base codes (0..4); seq_id_of: int32[T]; 1 <= k <= 32.
    Returns (key int64[T] canonical key, valid positions only; strand
    int8[T] +1 forward canonical / -1 revcomp / 0 palindrome; valid
    bool[T] window fits in one sequence and holds no N)."""
    if not (1 <= k <= 32):
        raise ValueError("k must be in [1, 32]")
    T = codes.shape[0]
    dev = codes.device
    c = torch.cat(
        [codes.to(torch.int64), torch.full((k,), 4, dtype=torch.int64, device=dev)]
    )
    sid_ext = torch.cat(
        [seq_id_of.to(torch.int32), torch.full((k,), -1, dtype=torch.int32, device=dev)]
    )
    has_n = torch.zeros(T, dtype=torch.bool, device=dev)
    if k <= 31:
        f = torch.zeros(T, dtype=torch.int64, device=dev)
        r = torch.zeros(T, dtype=torch.int64, device=dev)
        # rolling (Horner) update: base i enters the forward key at weight
        # 4^(k-1-i) and its complement enters the revcomp key at weight 4^i
        for i in range(k):
            ci = c[i : i + T]
            has_n |= ci >= 4
            b = ci & 3  # N windows are masked by has_n
            f = (f << 2) | b
            r = r | ((3 - b) << (2 * i))
    else:  # 16-base halves; the revcomp's high half is the window's tail
        for i in range(k):
            has_n |= c[i : i + T] >= 4
        f = _u64_key(_horner(c, T, 0, 16), _horner(c, T, 16, 32))
        r = _u64_key(_rev_horner(c, T, 16, 32), _rev_horner(c, T, 0, 16))
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
    floor = torch.full((w - 1,), _KEY_FLOOR, dtype=torch.int64, device=key.device)
    mh = torch.cat([floor, wmin]).unfold(0, w, 1).amax(dim=1)  # max over [p-w+1, p]
    return valid & (mh == h)


# mirrors npge_tpu/ops/kmers.py:_sid_from_offsets
def _sid_from_offsets(
    offsets: np.ndarray, T: int, device, start: int = 0, timings=None
) -> torch.Tensor:
    """int32 sequence id of positions start .. start+T-1 from the offsets
    table; positions at or past offsets[-1] get -1."""
    pos = torch.arange(start, start + T, dtype=torch.int64, device=device)
    off = to_device(np.asarray(offsets, np.int64), device, timings)
    sid = torch.searchsorted(off, pos, right=True) - 1
    return torch.where(pos >= off[-1], -1, sid).to(torch.int32)


def select_occurrences(codes: torch.Tensor, seq_id_of: torch.Tensor, k: int, w: int):
    """Scan -> minimizer sample: (key int64, idx int64, strand int8)
    tensors of the sampled valid non-palindromic occurrences, in ascending
    position order (idx indexes ``codes``)."""
    key, strand, valid = kmer_scan(codes, seq_id_of, k)
    idx = torch.nonzero(minimizer_mask(key, valid, w) & (strand != 0))[:, 0]
    return key[idx], idx, strand[idx]


# mirrors npge_tpu/ops/kmers.py:find_anchor_occurrences (its CPU branch)
def find_anchor_occurrences(
    codes, seq_id_of, k: int, w: int, device,
    offsets: np.ndarray | None = None, want_gid: bool = False, timings=None,
):
    """Scan -> minimizer sample -> compact -> sort by (key, position).

    ``codes`` is a uint8 tensor or numpy array (moved to ``device``); pass
    ``offsets`` instead of ``seq_id_of`` to build the sequence ids on the
    device. Returns host numpy arrays (key int64, pos int64, strand int8),
    one row per sampled valid non-palindromic occurrence, or with
    ``want_gid`` (gid int64, pos, strand) where gid numbers the same-key
    runs densely. Host arrays moved to the device and the readback are
    booked in ``timings``."""
    T = int(codes.shape[0])
    Tp = 1 << max(0, T - 1).bit_length()
    if Tp >= 1 << 31:  # the reference's int32-position guard
        raise ValueError("arena too large for int32 positions")
    if T == 0:
        e = np.zeros(0, np.int64)
        return e, e.copy(), np.zeros(0, np.int8)
    if isinstance(codes, torch.Tensor):
        codes = torch.as_tensor(codes, device=device)
    else:
        codes = to_device(codes, device, timings)
    if seq_id_of is None:
        seq_id_of = _sid_from_offsets(offsets, T, codes.device, timings=timings)
    elif isinstance(seq_id_of, torch.Tensor):
        seq_id_of = torch.as_tensor(seq_id_of, device=codes.device)
    else:
        seq_id_of = to_device(seq_id_of, codes.device, timings)
    key, idx, strand = select_occurrences(codes, seq_id_of, k, w)
    key, order = torch.sort(key, stable=True)
    idx, strand = idx[order], strand[order]
    key, idx, strand = (to_host(x, timings).numpy() for x in (key, idx, strand))
    if want_gid:
        new = np.ones(len(key), bool)
        new[1:] = key[1:] != key[:-1]
        return np.cumsum(new).astype(np.int64) - 1, idx, strand
    return key, idx, strand
