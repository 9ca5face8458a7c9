"""Extender — grow anchor groups into candidate gapless blocks.

Host batching of ``npge_tpu/algo/extender.py`` calling the port's
extension op (``npge_tpu_torch.ops.extend``): per-occurrence caps, ragged
groups bucketed by fragment count into padded (B, F) batches, both sides
stacked into one batch, and the columnar :class:`CandidateBatch` output.
The freeze rule makes each group's result independent of its batch, so one
plain loop over F-buckets gives the reference's answer without its
single-bucket and split-tail dispatch schemes.
"""

from __future__ import annotations

import numpy as np
import torch

from npge_tpu_torch.algo.anchors import AnchorGroups
from npge_tpu_torch.config import Config
from npge_tpu_torch.device import resolve_device, upload_arena
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import Block
from npge_tpu_torch.model.fragments import FragmentTable
from npge_tpu_torch.ops.extend import bases_for_groups, extend_rounds
from npge_tpu_torch.parallel.distributed import (
    allgather, host_slice, multiprocess, process_index_count,
)
from npge_tpu_torch.util.csr import csr_gather

# target element budget per (B, F, S) window gather of one side; both sides
# ride one batch, so a batch gathers twice this
_ELEM_BUDGET = 1 << 27


# mirrors npge_tpu/algo/extender.py:CandidateBatch
class CandidateBatch:
    """Columnar gapless candidate set — one group per candidate, SoA.

    A sequence of Blocks for API compatibility (iteration, len, indexing);
    `resolve_overlaps` and `deconseq` consume the arrays directly."""

    __slots__ = ("offsets", "seq", "start", "length", "ori")

    def __init__(self, offsets, seq, start, length, ori):
        self.offsets = offsets
        self.seq = seq
        self.start = start
        self.length = length
        self.ori = ori

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        a, e = int(self.offsets[i]), int(self.offsets[i + 1])
        return Block(
            FragmentTable(
                self.seq[a:e], self.start[a:e],
                self.length[a:e], self.ori[a:e],
            )
        )

    def to_blocks(self) -> list[Block]:
        return list(self)

    @classmethod
    def empty(cls) -> "CandidateBatch":
        z = np.zeros(0, np.int64)
        zi = np.zeros(0, np.int32)
        return cls(np.zeros(1, np.int64), z, zi, zi, zi)

    def select(self, ids: np.ndarray) -> "CandidateBatch":
        """Sub-batch of the given candidate indices (CSR gather)."""
        idx, offs = csr_gather(self.offsets, ids)
        return CandidateBatch(
            offs, self.seq[idx], self.start[idx],
            self.length[idx], self.ori[idx],
        )


# mirrors npge_tpu/algo/extender.py:_compute_caps
def _compute_caps(groups: AnchorGroups, arena: GenomeArena):
    """Per-occurrence (cap_left, cap_right) in column space, int64, and the
    per-group flag of groups whose anchor windows overlap each other."""
    k = groups.k
    pos = groups.pos
    seq_id = groups.seq_id
    strand = groups.strand.astype(np.int64)
    seq_lo = arena.offsets[seq_id]
    seq_hi = arena.offsets[seq_id + 1]
    end = pos + k
    # sequence-bound caps in *sequence* direction
    room_fwd = seq_hi - end      # room toward larger positions
    room_rev = pos - seq_lo      # room toward smaller positions
    # same-group neighbor gaps (sort by pos within each group)
    gid = np.repeat(
        np.arange(groups.n_groups, dtype=np.int64), groups.sizes()
    )
    order = np.lexsort((pos, gid))
    p_s, g_s, sid_s = pos[order], gid[order], seq_id[order]
    end_s = p_s + k
    gap_after = np.full(len(pos), np.int64(1) << 40)
    gap_before = np.full(len(pos), np.int64(1) << 40)
    bad_group = np.zeros(groups.n_groups, dtype=bool)
    if len(pos) > 1:
        same = (g_s[1:] == g_s[:-1]) & (sid_s[1:] == sid_s[:-1])
        ga = np.where(same, p_s[1:] - end_s[:-1], np.int64(1) << 40)
        gap_after[order[:-1]] = ga
        gap_before[order[1:]] = ga
        # tandem repeats with period < k: the block would overlap itself
        overlapping = same & (ga < 0)
        if overlapping.any():
            bad_group[np.unique(g_s[:-1][overlapping])] = True
    # both neighbors extend into a shared gap: split it deterministically
    room_fwd = np.minimum(room_fwd, gap_after // 2 + gap_after % 2)
    room_rev = np.minimum(room_rev, gap_before // 2)
    # column space: right = sequence-forward for ori=+1, backward for -1
    cap_right = np.where(strand == 1, room_fwd, room_rev)
    cap_left = np.where(strand == 1, room_rev, room_fwd)
    return np.maximum(cap_left, 0), np.maximum(cap_right, 0), bad_group


# mirrors npge_tpu/algo/extender.py:_bucket_f
def _bucket_f(f: int) -> int:
    b = 2
    while b < f:
        b *= 2
    return b


# mirrors npge_tpu/algo/extender.py:extend_anchor_groups
def extend_anchor_groups(
    arena: GenomeArena,
    groups: AnchorGroups,
    cfg: Config,
    device,
    timings=None,
    counter_prefix: str = "extend",
    mesh=None,
) -> CandidateBatch:
    """Extend all groups on ``device`` (over the arena's cached doubled
    codes, see ``device.upload_arena``); return the columnar CandidateBatch
    of gapless candidates (one per group) in group order. ``timings``
    (StageTimings) receives the ``<counter_prefix>_cells`` counter.

    With ``mesh`` (a ``parallel.mesh.DeviceMesh``) every stacked batch is
    split into contiguous row slices, one per mesh device, each extended
    over that device's copy of the arena; the cells counter takes the most
    rounds of any slice, which is what the whole batch runs. In a process
    group of more than one rank (and no mesh) each process extends a
    contiguous slice of every F-bucket's groups, books
    ``mp.<counter_prefix>_groups_total`` and ``_owned``, and the per-group
    lengths are summed over the processes. Both give the single-device
    result: the freeze rule makes each group's result independent of its
    batch."""
    if groups.n_groups == 0:
        return CandidateBatch.empty()
    shards = (
        mesh.slices if mesh is not None
        else lambda n: [(resolve_device(device), 0, n)]
    )
    proc_shard = mesh is None and multiprocess()
    pi, pc = process_index_count()
    T = arena.total_length
    k = groups.k
    cap_l, cap_r, bad_group = _compute_caps(groups, arena)
    sizes = groups.sizes()
    gids = np.arange(groups.n_groups)
    results_l = np.zeros(groups.n_groups, np.int32)
    results_r = np.zeros(groups.n_groups, np.int32)

    num, den = cfg.MIN_IDENTITY.num, cfg.MIN_IDENTITY.den
    chunk = min(cfg.EXTEND_CHUNK, cfg.MAX_EXTEND)
    max_rounds = max(1, -(-cfg.MAX_EXTEND // chunk))

    for fb in sorted({_bucket_f(int(s)) for s in sizes}):
        sel = gids[
            (sizes <= fb) & (sizes > (fb // 2 if fb > 2 else 1)) & ~bad_group
        ]
        if proc_shard:
            a0, a1 = host_slice(len(sel), pi, pc)
            if timings is not None:
                timings.count(f"mp.{counter_prefix}_groups_total", len(sel))
                timings.count(f"mp.{counter_prefix}_groups_owned", a1 - a0)
            sel = sel[a0:a1]
        b_cap = max(256, _ELEM_BUDGET // (fb * chunk))
        for i0 in range(0, len(sel), b_cap):
            batch = sel[i0 : i0 + b_cap]
            # ragged -> padded gather (slot j of group g reads occurrence
            # offsets[g]+j, masked by group size)
            occ0 = groups.offsets[batch]
            nocc = groups.offsets[batch + 1] - occ0
            slot = np.arange(fb)
            oidx = occ0[:, None] + slot[None, :]
            valid = slot[None, :] < nocc[:, None]
            oidx = np.where(valid, oidx, 0)
            lo = np.where(valid, groups.pos[oidx], 0)
            ori = np.where(valid, groups.strand[oidx], 1)
            cl = np.where(valid, np.minimum(cap_l[oidx], cfg.MAX_EXTEND), 0)
            cr = np.where(valid, np.minimum(cap_r[oidx], cfg.MAX_EXTEND), 0)
            base_l, base_r = bases_for_groups(lo, lo + k, ori, T)
            # left/right are independent problems: one stacked batch
            B = len(batch)
            base2 = torch.from_numpy(np.concatenate([base_l, base_r]))
            cap2 = torch.from_numpy(np.concatenate([cl, cr]).astype(np.int32))
            fm2 = torch.from_numpy(np.concatenate([valid, valid]))
            total = np.zeros(2 * B, np.int32)
            rounds = 0
            for dev, r0, r1 in shards(2 * B):
                if r0 == r1:
                    continue
                tot, r = extend_rounds(
                    upload_arena(arena, dev)[1], base2[r0:r1].to(dev),
                    fm2[r0:r1].to(dev), cap2[r0:r1].to(dev),
                    num, den, chunk, max_rounds,
                )
                total[r0:r1] = tot.cpu().numpy()
                rounds = max(rounds, r)
            results_l[batch] = total[:B]
            results_r[batch] = total[B:]
            if timings is not None:
                # both sides scan up to rounds*chunk columns per fragment
                timings.count(
                    f"{counter_prefix}_cells",
                    2 * int(valid.sum()) * rounds * chunk,
                )
    if proc_shard:
        # owned entries are exclusive per process, the rest zero: sum merge
        g = allgather(np.stack([results_l, results_r]), timings)
        results_l = g[:, 0].sum(axis=0).astype(np.int32)
        results_r = g[:, 1].sum(axis=0).astype(np.int32)

    # build the columnar candidate batch in one vectorized pass
    kept = np.flatnonzero(~bad_group)
    oidx_all, offs = csr_gather(groups.offsets, kept)
    cnt = np.diff(offs)
    gl = np.repeat(results_l[kept].astype(np.int64), cnt)
    gr = np.repeat(results_r[kept].astype(np.int64), cnt)
    p = groups.pos[oidx_all]
    s = groups.strand[oidx_all].astype(np.int64)
    sid = groups.seq_id[oidx_all]
    new_global = np.where(s == 1, p - gl, p - gr)
    local = new_global - arena.offsets[sid]
    length = (k + gl + gr).astype(np.int32)
    return CandidateBatch(
        offs, sid, local.astype(np.int32), length, s.astype(np.int32)
    )
