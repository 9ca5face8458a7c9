"""OverlapsResolver — make candidate blocks non-overlapping.

Copies of the two functions of ``npge_tpu/algo/overlaps.py`` that reach
the reference's ``CandidateBatch`` (a jax module); here they test against
the port's own class. Admission order and the per-candidate admission
come from the reference by import.
"""

from __future__ import annotations

import numpy as np

from npge_tpu.algo.overlaps import _admission_order_and_wraps, _admit_python
from npge_tpu.config import Config
from npge_tpu.model.arena import GenomeArena
from npge_tpu.model.blocks import Block
from npge_tpu.model.fragments import FragmentTable
from npge_tpu.util.csr import csr_gather
from npge_tpu_torch.algo.extender import CandidateBatch


# mirrors npge_tpu/algo/overlaps.py:_FlatCandidates
class _FlatCandidates:
    """Uniform columnar view over a candidate collection: a
    CandidateBatch's arrays directly (zero copies), or one concatenation
    pass over a list of Blocks."""

    def __init__(self, cand, arena: GenomeArena):
        self.cand = cand
        self.is_batch = isinstance(cand, CandidateBatch)
        G = len(cand)
        if self.is_batch:
            self.offs = np.asarray(cand.offsets, np.int64)
            self.seq = np.asarray(cand.seq, np.int64)
            self.start = np.asarray(cand.start, np.int64)
            self.length = np.asarray(cand.length, np.int64)
            self.ori = np.asarray(cand.ori, np.int64)
            self.nfr = np.diff(self.offs)
            self.ncols = np.zeros(G, np.int64)
            ne = self.nfr > 0
            self.ncols[ne] = self.length[self.offs[:-1][ne]]
            self.gapless = np.ones(G, bool)
        else:
            self.nfr = np.fromiter(
                (b.n_frags for b in cand), np.int64, G
            ) if G else np.zeros(0, np.int64)
            self.ncols = np.fromiter(
                (b.n_cols for b in cand), np.int64, G
            ) if G else np.zeros(0, np.int64)
            self.offs = np.zeros(G + 1, np.int64)
            np.cumsum(self.nfr, out=self.offs[1:])
            if G:
                self.seq = np.concatenate(
                    [b.frags.seq_id for b in cand]
                ).astype(np.int64)
                self.start = np.concatenate(
                    [b.frags.start for b in cand]
                ).astype(np.int64)
                self.length = np.concatenate(
                    [b.frags.length for b in cand]
                ).astype(np.int64)
                self.ori = np.concatenate(
                    [b.frags.ori for b in cand]
                ).astype(np.int64)
            else:
                self.seq = self.start = self.length = self.ori = np.zeros(
                    0, np.int64
                )
            self.gapless = np.fromiter(
                (b.is_gapless for b in cand), bool, G
            ) if G else np.zeros(0, bool)

    def block(self, i: int) -> Block:
        return self.cand[i]

    def frag_rows(self, sel: np.ndarray):
        """CSR gather of the fragment rows of candidates ``sel`` (in sel
        order): (cand_offsets, seq, start, length, ori)."""
        idx, offs = csr_gather(self.offs, sel)
        return (
            offs, self.seq[idx], self.start[idx],
            self.length[idx], self.ori[idx],
        )


# mirrors npge_tpu/algo/overlaps.py:resolve_overlaps
def resolve_overlaps(
    cand, arena: GenomeArena, cfg: Config, use_native: bool = True
) -> list[Block]:
    """Greedy admission of candidate blocks (a list of Blocks or a
    CandidateBatch) into an overlap-free, all-good set. Gapless non-wrap
    candidates run through the C++ fast path, the rest through the Python
    path, in one global greedy order over one occupancy bitmap."""
    from npge_tpu import native

    occ_concat = np.zeros(arena.total_length, np.uint8)
    occ = [
        occ_concat[arena.offsets[i] : arena.offsets[i + 1]]
        for i in range(arena.n_seqs)
    ]
    fc = _FlatCandidates(cand, arena)
    order, wraps = _admission_order_and_wraps(fc, arena)
    eligible = (fc.nfr >= 2) & (fc.ncols >= cfg.MIN_LENGTH)
    accepted: list[Block] = []
    native_ok = use_native and native.have_native()
    nat = native_ok & fc.gapless & ~wraps
    i = 0
    while i < len(order):
        ci = int(order[i])
        if not eligible[ci]:
            i += 1
            continue
        if not nat[ci]:
            _admit_python(fc.block(ci), arena, cfg, occ, accepted)
            i += 1
            continue
        # maximal run of consecutive gapless non-wrap candidates -> one
        # C++ call (the native path assumes start+length <= seq_len)
        j = i
        while j < len(order) and nat[order[j]]:
            j += 1
        seg_ids = order[i:j]
        seg_ids = seg_ids[eligible[seg_ids]]
        offs, f_seq, f_start, f_len, f_ori = fc.frag_rows(seg_ids)
        res = native.resolve_gapless(
            arena.codes, arena.offsets, occ_concat,
            offs, f_seq.astype(np.int32), f_start.astype(np.int32),
            f_len.astype(np.int32), f_ori.astype(np.int32),
            np.arange(len(seg_ids), dtype=np.int64),
            cfg.MIN_LENGTH, cfg.MIN_END,
            cfg.MIN_IDENTITY.num, cfg.MIN_IDENTITY.den,
        )
        out_off, o_seq, o_start, o_len, o_ori, o_src = res
        for k in range(len(out_off) - 1):
            a, e = int(out_off[k]), int(out_off[k + 1])
            src_ci = int(seg_ids[int(o_src[k])])
            sa, se = int(fc.offs[src_ci]), int(fc.offs[src_ci + 1])
            # candidate admitted whole -> for list candidates reuse the
            # input Block OBJECT (downstream caches key by identity)
            if (
                not fc.is_batch
                and e - a == se - sa
                and int(o_len[a]) == int(fc.ncols[src_ci])
                and np.array_equal(
                    o_start[a:e].astype(np.int64), fc.start[sa:se]
                )
            ):
                accepted.append(fc.block(src_ci))
                continue
            accepted.append(
                Block(
                    FragmentTable(
                        o_seq[a:e], o_start[a:e], o_len[a:e], o_ori[a:e]
                    )
                )
            )
        i = j
    return accepted
