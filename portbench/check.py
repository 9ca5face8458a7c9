"""The comparison that decides ``correct``.

Once the window has closed, one of the recorded builds, drawn from the
seed, is held against the plain references of ``portbench.reference``
layer by layer, and every build's answer against that build's:

  anchor_groups_differing  every anchor scan of the build: the groups the
                           reference finds on the same arena
  candidates_differing     every extension of the build: the candidate
                           count, and the candidate blocks of a sample of
                           groups drawn from the seed, with the largest
                           groups and the longest candidates in it
  sw_rows_differing        every SW batch of the build: all output rows
  consensus_differing      every re-seed round of the build: the consensus
                           sequences made from the blockset it started from
  mapped_missing           every re-seed round of the build: candidates on
                           the consensus arena, over gapless blocks, that
                           are not mapped back to the genomes as the
                           reference maps them
  reseed_short_of_kmin     1 when the re-seed never searched at the least
                           seed size MIN_ANCHOR_SIZE, where every round
                           schedule of the pipeline ends (fewer rounds)
  partition_errors         the answer: bases in no fragment or in several
  bad_blocks               the answer: blocks whose rows are not their
                           fragments' texts, or that are not good
  joinable_pairs           every join pass of the build, and the answer:
                           neighbouring blocks that the joiner should
                           have merged (IsPangenome check 3, as far as it
                           is decided without aligning a gap; check 3b,
                           no fragments overlapping by a few bases, is in
                           partition_errors)
  builds_differing         every other build's answer against this one's

Circular worlds are held as linear ones are, by the references' cyclic
rules: the scan of a circular arena by the cyclic plain scan, fragments
that cross an origin read round it, and the origin's pairs among the pairs
left to join.

The first scan reads the world the harness made; the later scans and their
extensions read the consensus arenas the program made from its own blocks
(each held to the reference's consensus of those blocks), and the SW
batches the program's window coordinates: there the reference follows the
program's state and judges each step on it. Every number is an
exact count, with the limit 0.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.reference import anchors as ref_anchors
from portbench.reference import blockset as ref_blockset
from portbench.reference import consensus as ref_consensus
from portbench.reference import extend as ref_extend
from portbench.reference import joins as ref_joins
from portbench.reference import sw as ref_sw

LIMITS = {
    "anchor_groups_differing": 0,
    "candidates_differing": 0,
    "sw_rows_differing": 0,
    "consensus_differing": 0,
    "mapped_missing": 0,
    "reseed_short_of_kmin": 0,
    "partition_errors": 0,
    "bad_blocks": 0,
    "joinable_pairs": 0,
    "builds_differing": 0,
}
SAMPLE_GROUPS = 600  # groups drawn per extension, besides the extremes
EXTREMES = 32  # the largest groups and the longest candidates, each
SW_BLOCK = 1 << 16  # pairs per block of the SW reference


def plain_blocks(blocks) -> list:
    """The answer as plain arrays: ((seq, start, length, ori), rows)."""
    out = []
    for b in blocks:
        f = b.frags
        frags = tuple(np.asarray(a, np.int64) for a in (f.seq_id, f.start, f.length, f.ori))
        out.append((frags, None if b.alignment is None else np.asarray(b.alignment)))
    return out


def _groups(g):
    return (np.asarray(g.offsets), np.asarray(g.pos), np.asarray(g.seq_id),
            np.asarray(g.strand))


def check_scans(calls, world_codes, world_offsets, world_circular=None):
    """anchor_groups_differing, and each scan's reference groups by the
    id of the program's groups object."""
    bad, ref_of = 0, {}
    first = True
    for c in (c for c in calls if c["kind"] == "scan"):
        if first:
            codes, offsets, circular = world_codes, world_offsets, world_circular
        else:
            codes, offsets, circular = c["codes"], c["offsets"], c["circular"]
        first = False
        want = ref_anchors.anchor_groups(
            codes, offsets, c["k"], c["w"], c["max_fragments"], c["dedupe"], circular)
        bad += ref_anchors.groups_differing(want, _groups(c["out"]))
        ref_of[id(c["out"])] = (want, c["k"], codes, offsets)
    return bad, ref_of


def check_extensions(calls, ref_of, rng):
    bad = 0
    for c in (c for c in calls if c["kind"] == "extend"):
        if id(c["groups"]) not in ref_of:
            raise ValueError("an extension took groups of no recorded scan")
        (offs, pos, sid, st), k, codes, offsets = ref_of[id(c["groups"])]
        c_offs, c_seq, c_start, c_len, c_ori = c["out"]
        G = len(offs) - 1
        badg = ref_extend.bad_groups(offs, pos, sid, k)
        kept = np.flatnonzero(~badg)
        bad += abs(len(kept) - (len(c_offs) - 1))
        if len(kept) != len(c_offs) - 1 or G == 0:
            continue
        sizes = np.diff(offs)[kept]
        cand_len = np.asarray(c_len)[np.asarray(c_offs)[:-1]]
        pick = set(rng.choice(len(kept), min(SAMPLE_GROUPS, len(kept)), replace=False).tolist())
        pick.update(np.argsort(-sizes, kind="stable")[:EXTREMES].tolist())
        pick.update(np.argsort(-cand_len, kind="stable")[:EXTREMES].tolist())
        for ci in sorted(pick):
            g = kept[ci]
            a, b = offs[g], offs[g + 1]
            got = ref_extend.extend_group(
                codes, offsets, pos[a:b], sid[a:b], st[a:b], k,
                c["num"], c["den"], c["chunk"], c["max_extend"])
            x, y = c_offs[ci], c_offs[ci + 1]
            same = got is not None and (
                np.array_equal(c_seq[x:y], sid[a:b])
                and np.array_equal(c_start[x:y], got[0])
                and np.array_equal(c_len[x:y], got[1])
                and np.array_equal(c_ori[x:y], got[2]))
            bad += not same
    return bad


class _PerBlock:
    """A block's plain arrays and consensus, worked out once a check: the
    re-seed rounds hand on most blocks unchanged, as the same objects,
    which the records keep alive."""

    def __init__(self, codes, offsets, circular=None):
        self.codes, self.offsets, self.circular = codes, offsets, circular
        self._plain, self._cons = {}, {}

    def plain(self, blocks):
        out = []
        for b in blocks:
            hit = self._plain.get(id(b))
            if hit is None:
                hit = self._plain[id(b)] = plain_blocks([b])[0]
            out.append(hit)
        return out

    def consensus(self, blocks):
        out = []
        for b, (frags, rows) in zip(blocks, self.plain(blocks)):
            hit = self._cons.get(id(b))
            if hit is None:
                hit = self._cons[id(b)] = ref_consensus.block_consensus(
                    self.codes, self.offsets, frags, rows, self.circular)
            out.append(hit)
        return out


def check_consensus(calls, per_block):
    bad = 0
    for c in (c for c in calls if c["kind"] == "cons"):
        want = ref_consensus.consensus_arena(per_block.consensus(c["blocks"]))
        bad += ref_consensus.sequences_differing(
            want, np.asarray(c["codes"]), np.asarray(c["offsets"]), c["src"])
    return bad


def check_mapping(calls, per_block):
    bad = 0
    for c in (c for c in calls if c["kind"] == "deconseq"):
        want = ref_consensus.mapped_back(c["cand"], c["src"], per_block.plain(c["blocks"]),
                                         per_block.offsets, per_block.circular)
        out = plain_blocks(c["out"])
        g_off = np.zeros(len(out) + 1, np.int64)
        np.cumsum([len(fr[0]) for fr, _rows in out], out=g_off[1:])
        got = ref_consensus.block_keys(g_off, [
            np.concatenate([fr[k] for fr, _rows in out]) if out else np.zeros(0, np.int64)
            for k in range(4)])
        bad += ref_consensus.mapped_missing(want, got)
    return bad


def reseed_short(calls, min_k: int) -> int:
    """1 unless a scan after the first searched at ``min_k``."""
    ks = [c["k"] for c in calls if c["kind"] == "scan"][1:]
    return int(min_k not in ks)


def check_sw(calls, world_codes, device):
    """(sw_rows_differing, per-batch (pairs, needed cells, qcap, tcap))."""
    import torch

    codes2 = None
    bad, batches = 0, []
    for c in (c for c in calls if c["kind"] == "sw"):
        if codes2 is None:
            codes2 = ref_sw.doubled(torch.as_tensor(world_codes).to(device))
        P = len(c["qb"])
        got = c["out"].cpu().numpy()
        if c["n2"] != codes2.shape[0] or got.shape != (P, 3):
            bad += P
            continue
        kw = {key: c["kw"][key] for key in
              ("W", "match", "mismatch", "gap", "xdrop") if key in c["kw"]}
        if "q_n_code" in c["kw"]:
            kw["q_n"] = c["kw"]["q_n_code"]
        if "t_n_code" in c["kw"]:
            kw["t_n"] = c["kw"]["t_n_code"]
        needed = []
        for a in range(0, P, SW_BLOCK):
            sl = slice(a, a + SW_BLOCK)
            want, need = ref_sw.sw_endpoints(
                codes2, c["qb"][sl], c["qcap"][sl], c["tb"][sl], c["tcap"][sl],
                c["L"], **kw)
            bad += int((want.cpu().numpy() != got[sl]).any(axis=1).sum())
            needed.append(need.cpu().numpy())
        L = c["L"]
        batches.append({
            "pairs": P, "needed": np.concatenate(needed) if needed else np.zeros(0),
            "qcap": np.minimum(c["qcap"], L), "tcap": np.minimum(c["tcap"], L),
        })
    return bad, batches


def compare(calls, answers, sampled: int, world_codes, world_offsets, cfg,
            seed: int, device, world_circular=None):
    """(checks [(name, value, limit)], SW batches of the sampled build,
    seconds spent on each part).
    ``calls``: the sampled build's records; ``answers``: every build's
    final blocks as ``plain_blocks``, in build order; ``world_circular``:
    a flag per sequence of the world (None: linear sequences only)."""
    rng = np.random.default_rng([seed, 0x5EED])
    values, spent = {}, {}
    t = time.perf_counter()
    values["anchor_groups_differing"], ref_of = check_scans(
        calls, world_codes, world_offsets, world_circular)
    spent["scans"], t = time.perf_counter() - t, time.perf_counter()
    values["candidates_differing"] = check_extensions(calls, ref_of, rng)
    spent["extensions"], t = time.perf_counter() - t, time.perf_counter()
    values["sw_rows_differing"], batches = check_sw(calls, world_codes, device)
    spent["sw"], t = time.perf_counter() - t, time.perf_counter()
    per_block = _PerBlock(world_codes, world_offsets, world_circular)
    values["consensus_differing"] = check_consensus(calls, per_block)
    values["mapped_missing"] = check_mapping(calls, per_block)
    values["reseed_short_of_kmin"] = reseed_short(calls, cfg.MIN_ANCHOR_SIZE)
    spent["consensus"], t = time.perf_counter() - t, time.perf_counter()
    mine = answers[sampled]
    values["partition_errors"] = ref_blockset.partition_errors(
        world_offsets, mine, world_circular)
    values["bad_blocks"], _faults = ref_blockset.bad_blocks(
        world_codes, world_offsets, mine, cfg.MIN_LENGTH, cfg.MIN_END,
        cfg.MIN_IDENTITY.num, cfg.MIN_IDENTITY.den, world_circular)
    rules = (cfg.MIN_LENGTH, cfg.MIN_END, cfg.MIN_IDENTITY.num,
             cfg.MIN_IDENTITY.den, cfg.MAX_JOIN_GAP, world_circular)
    values["joinable_pairs"] = ref_joins.joinable_pairs(
        world_codes, world_offsets, mine, *rules) + sum(
        ref_joins.joinable_pairs(world_codes, world_offsets,
                                 per_block.plain(c["blocks"]), *rules)
        for c in calls if c["kind"] == "join")
    d0 = ref_blockset.digest(mine)
    values["builds_differing"] = sum(
        ref_blockset.digest(a) != d0
        for i, a in enumerate(answers) if i != sampled)
    spent["answers"] = time.perf_counter() - t
    checks = [(name, int(values[name]), LIMITS[name]) for name in LIMITS]
    return checks, batches, spent
