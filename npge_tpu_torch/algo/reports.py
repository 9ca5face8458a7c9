# mirrors npge_tpu/algo/reports.py
"""Reporting processors: Info / Stats / BlockInfo / Hash.

Equivalent of the reference's summary processors (``src/algo/Info.cpp``,
``Stats.cpp``, ``BlockInfo.cpp``, ``Hash.cpp`` ⚠[B], SURVEY.md §2.3) plus
the structured JSON-lines observability channel of SURVEY §5.5.
"""

from __future__ import annotations

import json

import numpy as np

from npge_tpu_torch.config import Config
from npge_tpu_torch.model.blocks import BlockSet
from npge_tpu_torch.model.hashing import blockset_hash
from npge_tpu_torch.model.naming import block_type
from npge_tpu_torch.model.stats import make_stat


def blockset_summary(bs: BlockSet, cfg: Config | None = None) -> dict:
    arena = bs.arena
    genome_of_seq = arena.genome_id_of_seq()
    n_genomes = len(arena.genomes())
    total = arena.total_length
    by_type: dict[str, dict] = {}
    ident_num = ident_den = 0
    for b in bs.blocks:
        t = block_type(b, genome_of_seq, n_genomes)
        d = by_type.setdefault(
            t, {"blocks": 0, "fragments": 0, "positions": 0, "cols": 0}
        )
        d["blocks"] += 1
        d["fragments"] += b.n_frags
        d["positions"] += int(b.frags.length.sum())
        d["cols"] += b.n_cols
        if b.n_frags >= 2:
            st = make_stat(b, arena)
            ident_num += st.ident_nogap
            ident_den += st.total
    shared = sum(
        d["positions"] for t, d in by_type.items() if t != "u"
    )
    # identity histogram over multi-fragment blocks (SURVEY §5.5)
    hist = [0] * 10
    for b in bs.blocks:
        if b.n_frags < 2:
            continue
        st = make_stat(b, arena)
        frac = st.ident_nogap / max(st.total, 1)
        hist[min(9, int(frac * 10))] += 1
    return {
        "genomes": n_genomes,
        "sequences": arena.n_seqs,
        "total_length": total,
        "blocks": len(bs.blocks),
        "by_type": by_type,
        "shared_positions": shared,
        "shared_fraction": round(shared / total, 6) if total else 0.0,
        "mean_block_identity": (
            round(ident_num / ident_den, 6) if ident_den else None
        ),
        "identity_histogram_deciles": hist,
        "blockset_hash": f"{blockset_hash(bs):016x}",
    }


def per_genome_table(bs: BlockSet) -> str:
    """Per-genome coverage table (Stats parity): length, positions in
    shared (multi-fragment) blocks, fraction."""
    arena = bs.arena
    genomes = arena.genomes()
    gmap = arena.genome_id_of_seq()
    length = np.zeros(len(genomes), np.int64)
    for s in range(arena.n_seqs):
        length[gmap[s]] += arena.seq_len(s)
    shared = np.zeros(len(genomes), np.int64)
    for b in bs.blocks:
        if b.n_frags < 2:
            continue
        for fi in range(b.n_frags):
            s, _, ln, _ = b.frags.row(fi)
            shared[gmap[s]] += ln
    rows = ["genome\tlength\tshared_positions\tshared_fraction"]
    for i, g in enumerate(genomes):
        frac = shared[i] / length[i] if length[i] else 0.0
        rows.append(f"{g}\t{length[i]}\t{shared[i]}\t{frac:.4f}")
    return "\n".join(rows) + "\n"


def info_text(bs: BlockSet, cfg: Config | None = None) -> str:
    s = blockset_summary(bs, cfg)
    lines = [
        f"genomes: {s['genomes']}  sequences: {s['sequences']}  "
        f"total length: {s['total_length']}",
        f"blocks: {s['blocks']}  hash: {s['blockset_hash']}",
        f"shared (non-unique) positions: {s['shared_positions']} "
        f"({100 * s['shared_fraction']:.2f}%)",
    ]
    for t in sorted(s["by_type"]):
        d = s["by_type"][t]
        lines.append(
            f"  type {t}: {d['blocks']} blocks, {d['fragments']} fragments, "
            f"{d['positions']} positions"
        )
    if s["mean_block_identity"] is not None:
        lines.append(f"mean block identity: {s['mean_block_identity']:.4f}")
    return "\n".join(lines)


def block_info_tsv(bs: BlockSet) -> str:
    """Per-block table: name, fragments, columns, identity, GC."""
    rows = ["block\tn_fragments\tn_cols\tidentity\tgc"]
    for b in bs.blocks:
        st = make_stat(b, bs.arena)
        gc, at = st.gc_at
        denom = gc + at
        rows.append(
            "\t".join(
                [
                    b.name or "?",
                    str(b.n_frags),
                    str(b.n_cols),
                    f"{st.ident_nogap / max(st.total, 1):.4f}",
                    f"{gc / denom:.4f}" if denom else "nan",
                ]
            )
        )
    return "\n".join(rows) + "\n"


def json_line(stage: str, bs: BlockSet, **extra) -> str:
    payload = {"stage": stage, **blockset_summary(bs), **extra}
    return json.dumps(payload)
