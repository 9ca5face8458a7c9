"""AnchorFinder — exact k-mer anchor groups across genomes and strands.

Host copies of ``npge_tpu/algo/anchors.py`` (which imports the reference's
device scan) calling the port's scan (``npge_tpu_torch.ops.kmers``). Keys
are one int64 per occurrence instead of the reference's (hi, lo) pair;
their order and equality are the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from npge_tpu.config import Config
from npge_tpu.model.arena import GenomeArena
from npge_tpu_torch.device import upload_arena
from npge_tpu_torch.ops.kmers import find_anchor_occurrences


# mirrors npge_tpu/algo/anchors.py:AnchorGroups
@dataclass
class AnchorGroups:
    """Ragged groups of anchor occurrences (CSR layout).

    Occurrence m of group g (offsets[g] <= m < offsets[g+1]):
      pos[m]     arena-global start of the k-mer window
      seq_id[m]  owning sequence
      strand[m]  +1 if forward text equals the canonical form, else -1
    """

    k: int
    offsets: np.ndarray  # int64 [G+1]
    pos: np.ndarray      # int64 [M]
    seq_id: np.ndarray   # int32 [M]
    strand: np.ndarray   # int8  [M]

    @property
    def n_groups(self) -> int:
        return len(self.offsets) - 1

    def group(self, g: int):
        a, b = self.offsets[g], self.offsets[g + 1]
        return self.pos[a:b], self.seq_id[a:b], self.strand[a:b]

    def sizes(self) -> np.ndarray:
        return np.diff(self.offsets)


# mirrors npge_tpu/algo/anchors.py:_splitmix64
def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mixer (splitmix64 finalizer), vectorized."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


# mirrors npge_tpu/algo/anchors.py:_dedupe_keep_mask
def _dedupe_keep_mask(groups: AnchorGroups, window: int) -> np.ndarray:
    """Keep mask: the per-group key (seqs, strands, position deltas) is a
    128-bit order-sensitive rolling hash; greedy window suppression runs
    per hash bucket."""
    G = groups.n_groups
    sizes = groups.sizes()
    first = groups.offsets[:-1]
    gid = np.repeat(np.arange(G, dtype=np.int64), sizes)
    M = len(groups.pos)
    delta = np.zeros(M, np.int64)
    if M > 1:
        delta[1:] = groups.pos[1:] - groups.pos[:-1]
    delta[first] = 0  # first position is NOT part of the key
    row = (
        (groups.seq_id.astype(np.uint64) << np.uint64(34))
        ^ ((groups.strand.astype(np.int64) & 0x3).astype(np.uint64)
           << np.uint64(32))
        ^ delta.astype(np.uint64)
    )

    # order-sensitive segment hash: sum_i mix(row_i) * P^(i - first_g),
    # with P^(i - first) = P^i * inv(P)^first (P odd, Newton inverse)
    def _seg_pows(P: int) -> np.ndarray:
        Pu = np.uint64(P)
        inv = Pu  # Newton: x *= 2 - P*x doubles correct bits; 6 steps
        with np.errstate(over="ignore"):
            for _ in range(6):
                inv = inv * (np.uint64(2) - Pu * inv)
            cp = np.multiply.accumulate(
                np.concatenate([[np.uint64(1)], np.full(M - 1, Pu)])
            )  # cp[i] = P^i
            icp = np.multiply.accumulate(
                np.concatenate([[np.uint64(1)], np.full(M - 1, inv)])
            )  # icp[i] = P^-i
            return cp * icp[first[gid]]

    with np.errstate(over="ignore"):
        pw1 = _seg_pows(0x100000001B3)
        pw2 = _seg_pows(0x9E3779B97F4A7C15 | 1)
        t1 = _splitmix64(row) * pw1
        t2 = _splitmix64(row ^ np.uint64(0xA5A5A5A5A5A5A5A5)) * pw2
    # segments are contiguous in occurrence order -> reduceat segment sums
    # (hash equality replaces exact key comparison, as in the reference)
    h1 = np.add.reduceat(t1, first).astype(np.uint64)
    h2 = np.add.reduceat(t2, first).astype(np.uint64)
    p0 = groups.pos[first]
    order = np.lexsort((p0, sizes, h2, h1))
    h1s, h2s, ss = h1[order], h2[order], sizes[order]
    new_bucket = np.ones(G, dtype=bool)
    new_bucket[1:] = (
        (h1s[1:] != h1s[:-1]) | (h2s[1:] != h2s[:-1]) | (ss[1:] != ss[:-1])
    )
    keep = np.ones(G, dtype=bool)
    starts = np.flatnonzero(new_bucket)
    ends = np.append(starts[1:], G)
    p0s = p0[order]
    for a, b in zip(starts, ends):
        if b - a == 1:
            continue
        last = p0s[a]
        for i in range(a + 1, b):
            if p0s[i] - last <= window:
                keep[order[i]] = False
            else:
                last = p0s[i]
    return keep


# mirrors npge_tpu/algo/anchors.py:dedupe_parallel_groups
def dedupe_parallel_groups(
    groups: AnchorGroups, window: int
) -> AnchorGroups:
    """Drop groups that are shifted copies of a nearby kept group: same
    sequences, strands and position deltas, first position within
    ``window`` of the previously kept group of that key."""
    if groups.n_groups == 0:
        return groups
    keep = _dedupe_keep_mask(groups, window)
    if keep.all():
        return groups
    sizes = groups.sizes()[keep]
    keep_m = np.repeat(keep, groups.sizes())
    offsets = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return AnchorGroups(
        groups.k,
        offsets,
        groups.pos[keep_m],
        groups.seq_id[keep_m],
        groups.strand[keep_m],
    )


# mirrors npge_tpu/algo/anchors.py:_cyclic_scan
def _cyclic_scan(arena: GenomeArena, k: int, w: int, device):
    """Anchor occurrences with a cyclic halo on circular sequences: each
    circular sequence of length >= k gets its first k+w-2 bases appended,
    occurrences map back to original coordinates, halo duplicates are
    deduped and origin-wrapping windows dropped. Returns (key, pos,
    strand) sorted by (key, pos)."""
    halos = np.array(
        [
            min(k + w - 2, arena.seq_len(i))
            if (arena.circular(i) and arena.seq_len(i) >= k)
            else 0
            for i in range(arena.n_seqs)
        ],
        np.int64,
    )
    parts = []
    eoff = np.zeros(arena.n_seqs + 1, np.int64)
    for i in range(arena.n_seqs):
        s = arena.seq_codes(i)
        seg = np.concatenate([s, s[: halos[i]]]) if halos[i] else s
        parts.append(seg)
        eoff[i + 1] = eoff[i] + len(seg)
    codes_ext = np.concatenate(parts)
    key, pos, strand = find_anchor_occurrences(
        codes_ext, None, k, w, device, offsets=eoff
    )
    seq = np.searchsorted(eoff, pos, side="right") - 1
    lens = (arena.offsets[seq + 1] - arena.offsets[seq]).astype(np.int64)
    local = pos - eoff[seq]
    local = np.where(local >= lens, local - lens, local)
    keep = local + k <= lens  # drop origin-wrapping windows
    seq, local = seq[keep], local[keep]
    key, strand = key[keep], strand[keep]
    pos = arena.offsets[seq] + local
    order = np.lexsort((pos, key))
    key, pos, strand = key[order], pos[order], strand[order]
    if len(key):  # dedupe halo copies of the same (key, position)
        uniq = np.ones(len(key), bool)
        uniq[1:] = (key[1:] != key[:-1]) | (pos[1:] != pos[:-1])
        key, pos, strand = key[uniq], pos[uniq], strand[uniq]
    return key, pos, strand


# mirrors npge_tpu/algo/anchors.py:find_anchors
def find_anchors(
    arena: GenomeArena,
    cfg: Config,
    device,
    k: int | None = None,
) -> AnchorGroups:
    """Find anchor groups over the whole arena on ``device`` (scanning the
    arena's cached device copy, see ``device.upload_arena``). Arenas with
    circular sequences take the cyclic-halo scan."""
    k = k or cfg.ANCHOR_SIZE
    w = cfg.MINIMIZER_WINDOW
    if any(
        arena.circular(i) and arena.seq_len(i) >= k
        for i in range(arena.n_seqs)
    ):
        key, pos, strand = _cyclic_scan(arena, k, w, device)
        return form_groups(key, pos, strand, arena, cfg, k)
    gid, pos, strand = find_anchor_occurrences(
        upload_arena(arena, device)[0], None, k, w, device,
        offsets=arena.offsets, want_gid=True,
    )
    return form_groups_gid(gid, pos, strand, arena, cfg, k)


# mirrors npge_tpu/algo/anchors.py:form_groups (one int64 key per row)
def form_groups(
    key, pos, strand, arena: GenomeArena, cfg: Config, k: int
) -> AnchorGroups:
    """Group key-sorted occurrences, apply size bounds and parallel-group
    dedupe."""
    if len(key) == 0:
        return AnchorGroups(
            k,
            np.zeros(1, np.int64),
            np.asarray(pos, np.int64),
            np.zeros(0, np.int32),
            np.asarray(strand, np.int8),
        )
    new = np.ones(len(key), dtype=bool)
    new[1:] = key[1:] != key[:-1]
    gid = np.cumsum(new) - 1
    return form_groups_gid(gid, pos, strand, arena, cfg, k)


# mirrors npge_tpu/algo/anchors.py:form_groups_gid
def form_groups_gid(
    gid, pos, strand, arena: GenomeArena, cfg: Config, k: int
) -> AnchorGroups:
    """Group formation from group ids of key-sorted occurrences (same-key
    runs, ids dense ascending)."""
    if len(gid) == 0:
        return AnchorGroups(
            k,
            np.zeros(1, np.int64),
            np.asarray(pos, np.int64),
            np.zeros(0, np.int32),
            np.asarray(strand, np.int8),
        )
    sizes = np.bincount(gid)
    keep_g = (sizes >= 2) & (sizes <= cfg.MAX_ANCHOR_FRAGMENTS)
    keep_m = keep_g[gid]
    pos, strand, gid = pos[keep_m], strand[keep_m], gid[keep_m]
    # re-number kept groups compactly, preserving sorted-key order
    kept_sizes = sizes[keep_g]
    offsets = np.zeros(len(kept_sizes) + 1, np.int64)
    np.cumsum(kept_sizes, out=offsets[1:])
    seq_id = (
        np.searchsorted(arena.offsets, pos, side="right").astype(np.int32) - 1
    )
    groups = AnchorGroups(
        k, offsets, pos.astype(np.int64), seq_id, strand.astype(np.int8)
    )
    if cfg.ANCHOR_DEDUPE_WINDOW > 0:
        groups = dedupe_parallel_groups(groups, cfg.ANCHOR_DEDUPE_WINDOW)
    return groups
