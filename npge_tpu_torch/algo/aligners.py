# mirrors npge_tpu/algo/aligners.py
"""The aligner stack: MetaAligner -> (External | Similar | Dummy).

Equivalent of the reference's alignment stack (SURVEY.md §2.3 ⚠[B]):

  - ``MetaAligner`` tries a configured list of aligners in order until one
    succeeds (reference order: external mafft -> muscle -> internal similar
    -> dummy [B]; here the internal SimilarAligner is the default since
    external tools are usually absent from TPU images).
  - ``SimilarAligner`` (full version; the short-segment core lives in
    algo/similar.py): anchor on k-mers unique-and-shared across all rows,
    chain them monotonically, align the short stretches between anchors with
    the progressive NW MSA — the reference's exact strategy for highly
    similar sequences [B].
  - ``ExternalAligner`` shells out to mafft/muscle when present on PATH
    (temp FASTA in/out, like the reference's fork/exec wrappers [B]).
  - ``DummyAligner`` right-pads with gaps (last-resort fallback [B]).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np

from npge_tpu_torch.config import Config
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import Block
from npge_tpu_torch.algo.similar import msa_short
from npge_tpu_torch.util import codes as C


def dummy_align(texts: list[np.ndarray]) -> np.ndarray:
    width = max((len(t) for t in texts), default=0)
    out = np.full((len(texts), width), C.GAP, np.uint8)
    for i, t in enumerate(texts):
        out[i, : len(t)] = t
    return out


def _anchor_chain(texts: list[np.ndarray], k: int) -> list[list[int]]:
    """Positions of k-mers occurring exactly once in every row, chained so
    positions increase in all rows simultaneously. Returns a list of
    per-row position lists (same length = number of chained anchors)."""
    maps = []
    for t in texts:
        seen: dict[bytes, int] = {}
        dup = set()
        tb = t.tobytes()
        for p in range(len(t) - k + 1):
            w = tb[p : p + k]
            if w in seen:
                dup.add(w)
            else:
                seen[w] = p
        maps.append({w: p for w, p in seen.items() if w not in dup})
    common = set(maps[0])
    for m in maps[1:]:
        common &= set(m)
    if not common:
        return [[] for _ in texts]
    # order candidates by position in row 0; greedily keep those strictly
    # increasing in every row (deterministic LIS-approximation)
    cands = sorted(common, key=lambda w: maps[0][w])
    chain: list[bytes] = []
    last = [-1] * len(texts)
    for w in cands:
        pos = [m[w] for m in maps]
        if all(p > l for p, l in zip(pos, last)):
            # avoid overlapping anchors
            if chain and any(p < l + k for p, l in zip(pos, last)):
                continue
            chain.append(w)
            last = pos
    return [[m[w] for w in chain] for m in maps]


def similar_align(
    texts: list[np.ndarray], k: int = 16, max_segment: int = 2000,
    match: int = 1, mismatch: int = -2, gap: int = -3,
) -> np.ndarray | None:
    """Anchored progressive MSA for highly similar rows. Between-anchor
    stretches longer than max_segment are aligned with the banded NW
    (band sized to the length spread), so this aligner always succeeds."""
    if not texts:
        return np.zeros((0, 0), np.uint8)
    if len(texts) == 1:
        return texts[0][None, :].copy()
    chains = _anchor_chain(texts, k)
    n_anchors = len(chains[0])
    cuts = [[0] for _ in texts]
    for a in range(n_anchors):
        for r in range(len(texts)):
            cuts[r].append(chains[r][a])
            cuts[r].append(chains[r][a] + k)
    for r, t in enumerate(texts):
        cuts[r].append(len(t))
    parts: list[np.ndarray] = []
    n_segs = len(cuts[0]) - 1
    for s in range(n_segs):
        segs = [texts[r][cuts[r][s] : cuts[r][s + 1]] for r in range(len(texts))]
        if s % 2 == 1:  # anchor segment: identical in all rows
            parts.append(np.stack(segs))
            continue
        if all(len(x) == len(segs[0]) for x in segs) and all(
            np.array_equal(x, segs[0]) for x in segs[1:]
        ):
            if len(segs[0]):
                parts.append(np.stack(segs))
            continue
        aligner = None
        if max(len(x) for x in segs) > max_segment:
            # long un-anchored stretch: banded progressive alignment
            from npge_tpu_torch.algo.similar import banded_nw_align

            spread = max(len(x) for x in segs) - min(len(x) for x in segs)
            band = max(64, spread + 32)

            def aligner(a, b, match=match, mismatch=mismatch, gap=gap,
                        _band=band):
                return banded_nw_align(a, b, _band, match, mismatch, gap)
        m = msa_short(segs, match=match, mismatch=mismatch, gap=gap,
                      aligner=aligner)
        if m.shape[1]:
            parts.append(m)
    if not parts:
        return np.zeros((len(texts), 0), np.uint8)
    return np.concatenate(parts, axis=1)


def external_align(
    texts: list[np.ndarray], tool: str = "mafft"
) -> np.ndarray | None:
    """Run an external MSA tool if present on PATH (reference
    ExternalAligner parity); None if unavailable or it fails."""
    exe = shutil.which(tool)
    if exe is None or not texts:
        return None
    with tempfile.TemporaryDirectory() as td:
        inp = os.path.join(td, "in.fa")
        with open(inp, "w") as fh:
            for i, t in enumerate(texts):
                fh.write(f">r{i}\n{C.decode(t)}\n")
        try:
            if tool == "mafft":
                cmd = [exe, "--quiet", "--retree", "1", inp]
            else:  # muscle-style
                cmd = [exe, "-align", inp, "-output", "-"]
            res = subprocess.run(
                cmd, capture_output=True, timeout=600, check=True
            )
        except Exception:
            return None
        rows: dict[int, list[str]] = {}
        cur = None
        for line in res.stdout.decode().splitlines():
            if line.startswith(">"):
                cur = int(line[2:].split()[0])
                rows[cur] = []
            elif cur is not None:
                rows[cur].append(line.strip())
        if len(rows) != len(texts):
            return None
        mat = [C.encode("".join(rows[i])) for i in range(len(texts))]
        width = len(mat[0])
        if any(len(r) != width for r in mat):
            return None
        return np.stack(mat)


def meta_align(texts: list[np.ndarray], cfg: Config) -> np.ndarray:
    """Try aligners in order: external (if configured binaries exist) ->
    SimilarAligner -> DummyAligner. Always succeeds."""
    for tool in ("mafft", "muscle"):
        if shutil.which(tool):
            m = external_align(texts, tool)
            if m is not None:
                return m
    m = similar_align(
        texts, match=cfg.SW_MATCH, mismatch=cfg.SW_MISMATCH, gap=cfg.SW_GAP
    )
    if m is not None:
        return m
    return dummy_align(texts)


def align_block(block: Block, arena: GenomeArena, cfg: Config) -> Block:
    """(Re)align a block's fragments; returns a block with an explicit,
    consistent alignment (gapless stays implicit)."""
    if block.n_frags < 2:
        return block
    texts = [
        arena.fragment_codes(*block.frags.row(i)) for i in range(block.n_frags)
    ]
    if all(len(t) == len(texts[0]) for t in texts) and block.is_gapless:
        return block
    aln = meta_align(texts, cfg)
    gapless = not (aln == C.GAP).any()
    return Block(block.frags, None if gapless else aln, block.name)
