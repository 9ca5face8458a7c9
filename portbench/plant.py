"""The control and the planted faults: ways to break the timed path from
outside the program, for showing that the check fails them. The
benchmark's own runs plant nothing.

Each entry takes a ``capture.Patches`` and replaces one part of the
program for the run:

control       the gapless extension's identity threshold held in bfloat16
              (9/10 becomes 115/128), as a device test of the ratio in a
              narrow float would hold it: it breaks the configuration's
              guarantee that MIN_IDENTITY is tested exactly.
unchanged     a step that returns its state unchanged: every extension
              returns its anchors as they came.
half_batch    half of each SW batch left out: only the first half of the
              pairs is computed, the rest read zero.
no_exchange   the exchange between cards left out: the sharded scan keeps
              the first shard's occurrences only (mesh cells).
anchor        an answer altered where it is produced: one anchor position
              of each scan moved by one.
sw_row        one SW endpoint of each batch altered.
fragment      the final answer with its first block left out.
row_text      the final answer with one base of a block's rows altered.
one_build     every build after the first answers without its last block.
no_join       the joiner skipped: every join pass merges nothing.
fewer_rounds  the consensus re-seed cut to two rounds (MAX_LOOPS 2), so it
              never searches at the least seed size.
cons_base     one base of each re-seed round's consensus arena altered.
no_deconseq   the re-seed's hits never mapped back to the genomes: every
              round finds nothing to add.
no_halo       the scan of a circular arena (each build's first) run as the
              linear scan, with no reading round the origins (circular
              worlds).
no_origin_join the joiner's links across the origin of a circular sequence
              dropped (circular worlds).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from portbench.capture import PIPELINE, SW_ENTRY, SW_MODULE
from portbench.reference import extend as ref_extend


def control(p):
    mod = "npge_tpu_torch.ops.extend"
    inner = p.get(mod, "_extend_core")

    def _extend_core(ch, within, fmask, carry_len, carry_ident, num, den):
        import torch

        held = Fraction(torch.tensor(num / den, dtype=torch.bfloat16).item())
        return inner(ch, within, fmask, carry_len, carry_ident,
                     held.numerator, held.denominator)

    p.set(mod, "_extend_core", _extend_core)


def unchanged(p):
    inner = p.get(PIPELINE, "extend_anchor_groups")

    def extend_anchor_groups(arena, groups, cfg, device, **kw):
        cand = inner(arena, groups, cfg, device, **kw)
        offs = np.asarray(groups.offsets)
        kept = np.flatnonzero(~ref_extend.bad_groups(offs, groups.pos, groups.seq_id, groups.k))
        sizes = np.diff(offs)[kept]
        idx = np.concatenate([np.arange(offs[g], offs[g + 1]) for g in kept]) \
            if len(kept) else np.zeros(0, np.int64)
        new_offs = np.zeros(len(kept) + 1, np.int64)
        np.cumsum(sizes, out=new_offs[1:])
        sid = groups.seq_id[idx]
        start = (groups.pos[idx] - arena.offsets[sid]).astype(np.int32)
        length = np.full(len(idx), groups.k, np.int32)
        return type(cand)(new_offs, sid, start, length, groups.strand[idx].astype(np.int32))

    p.set(PIPELINE, "extend_anchor_groups", extend_anchor_groups)


def half_batch(p):
    inner = p.get(SW_MODULE, SW_ENTRY)

    def sw_extend_windows(codes2, qb, qcap, tb, tcap, L, **kw):
        out = inner(codes2, qb, qcap, tb, tcap, L, **kw)
        out[len(qb) // 2 :] = 0
        return out

    p.set(SW_MODULE, SW_ENTRY, sw_extend_windows)


def no_exchange(p):
    mod = "npge_tpu_torch.parallel.sharded"
    inner = p.get(mod, "scan_slice")

    def scan_slice(arena, cfg, k, lo, hi, device):
        key, pos, strand = inner(arena, cfg, k, lo, hi, device)
        if lo > 0:
            return key[:0], pos[:0], strand[:0]
        return key, pos, strand

    p.set(mod, "scan_slice", scan_slice)


def anchor(p):
    inner = p.get(PIPELINE, "find_anchors")

    def find_anchors(arena, cfg, device, k=None):
        groups = inner(arena, cfg, device, k=k)
        if len(groups.pos):
            groups.pos[0] += 1
        return groups

    p.set(PIPELINE, "find_anchors", find_anchors)


def sw_row(p):
    inner = p.get(SW_MODULE, SW_ENTRY)

    def sw_extend_windows(codes2, qb, qcap, tb, tcap, L, **kw):
        out = inner(codes2, qb, qcap, tb, tcap, L, **kw)
        if len(out):
            out[0, 1] += 1
        return out

    p.set(SW_MODULE, SW_ENTRY, sw_extend_windows)


def _final(p, alter):
    """Alter the final answer just before the pipeline names its blocks."""
    inner = p.get(PIPELINE, "assign_names")
    count = [0]

    def assign_names(bs):
        alter(bs, count[0])
        count[0] += 1
        return inner(bs)

    p.set(PIPELINE, "assign_names", assign_names)


def fragment(p):
    _final(p, lambda bs, _n: bs.blocks.pop(0))


def row_text(p):
    def alter(bs, _n):
        for b in bs.blocks:
            if b.n_frags >= 2:
                rows = b.rows(bs.arena).copy()
                rows[0, rows.shape[1] // 2] = (rows[0, rows.shape[1] // 2] + 1) % 4
                b.alignment = rows
                return

    _final(p, alter)


def one_build(p):
    def drop(bs, n):
        if n >= 2:  # the warm-up build is call 0, the window's first call 1
            bs.blocks.pop()

    _final(p, drop)


def no_join(p):
    p.set(PIPELINE, "join_blocks", lambda *args, **kw: 0)


def fewer_rounds(p):
    inner = p.get("npge_tpu_torch", "build_pangenome")

    def build_pangenome(arena, cfg, device, **kw):
        return inner(arena, cfg.replace(MAX_LOOPS=2), device, **kw)

    p.set("npge_tpu_torch", "build_pangenome", build_pangenome)


def cons_base(p):
    inner = p.get(PIPELINE, "consensus_arena")

    def consensus_arena(bs, *args, **kw):
        cons, src = inner(bs, *args, **kw)
        if len(cons.codes):
            cons.codes[0] = (cons.codes[0] + 1) % 4
        return cons, src

    p.set(PIPELINE, "consensus_arena", consensus_arena)


def no_deconseq(p):
    p.set(PIPELINE, "deconseq", lambda *args, **kw: [])


def no_halo(p):
    inner = p.get(PIPELINE, "find_anchors")

    def find_anchors(arena, cfg, device, k=None):
        from npge_tpu_torch.model.arena import GenomeArena

        if any(arena.circular(i) for i in range(arena.n_seqs)):
            arena = GenomeArena.from_flat(arena.names, arena.codes, arena.offsets,
                                          np.zeros(arena.n_seqs, bool))
        return inner(arena, cfg, device, k=k)

    p.set(PIPELINE, "find_anchors", find_anchors)


def no_origin_join(p):
    mod = "npge_tpu_torch.algo.joiner"
    inner = p.get(mod, "_adjacency_links")

    def _adjacency_links(bs, max_gap):
        links = inner(bs, max_gap)
        keep = ~links[-1]
        return tuple(x[keep] for x in links)

    p.set(mod, "_adjacency_links", _adjacency_links)


PLANTS = {f.__name__: f for f in (
    control, unchanged, half_batch, no_exchange, anchor, sw_row, fragment,
    row_text, one_build, no_join, fewer_rounds, cons_base, no_deconseq,
    no_halo, no_origin_join)}
