# mirrors npge_tpu/algo/genes.py
"""Gene annotation mapping: AddGenes / FindGeneGroups / PrintGeneGroups /
PrintPartition.

Equivalent of the reference's gene processors (``src/algo/AddGenes.cpp``,
``FindGeneGroups.cpp``, ``PrintGeneGroups.cpp``, ``PrintPartition.cpp``
⚠[B], SURVEY.md §2.3): import gene annotations, map gene intervals onto the
block partition, and group genes that share a block (ortholog groups).

Supported annotation inputs (the reference reads EBI/GenBank feature tables
[B]; here local files only):
  - GFF3 (seqid  source  type  start  end  score  strand  phase  attrs),
    rows with type in {gene, CDS}; ID/locus_tag/Name attribute as the id
  - simple TSV: seq_name  start  end  strand(+|-)  gene_id  [product]
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from npge_tpu_torch.model.blocks import BlockSet
from npge_tpu_torch.util import codes as C


@dataclass(frozen=True)
class Gene:
    seq_id: int
    start: int      # 0-based inclusive
    end: int        # exclusive
    strand: int     # +1 / -1
    gene_id: str
    product: str = ""


def _attr(attrs: str, *keys: str) -> str | None:
    fields = dict(
        kv.split("=", 1) for kv in attrs.strip().split(";") if "=" in kv
    )
    for k in keys:
        if k in fields:
            return fields[k]
    return None


def read_gff3(path: str, bs: BlockSet) -> list[Gene]:
    genes = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9 or parts[2] not in ("gene", "CDS"):
                continue
            seq_name = parts[0]
            try:
                seq_id = bs.arena.seq_id(seq_name)
            except KeyError:
                continue
            gid = _attr(parts[8], "ID", "locus_tag", "Name") or f"{seq_name}:{parts[3]}"
            genes.append(
                Gene(
                    seq_id,
                    int(parts[3]) - 1,
                    int(parts[4]),
                    1 if parts[6] != "-" else -1,
                    gid,
                    _attr(parts[8], "product") or "",
                )
            )
    return genes


def read_genes_tsv(path: str, bs: BlockSet) -> list[Gene]:
    genes = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 5:
                parts = line.split()
            seq_id = bs.arena.seq_id(parts[0])
            genes.append(
                Gene(
                    seq_id,
                    int(parts[1]),
                    int(parts[2]),
                    1 if parts[3] != "-" else -1,
                    parts[4],
                    parts[5] if len(parts) > 5 else "",
                )
            )
    return genes


@dataclass
class GenePartition:
    gene: Gene
    pieces: list[tuple[str, int, int]]  # (block_name, col0, col1) covering


def partition_genes(genes: list[Gene], bs: BlockSet) -> list[GenePartition]:
    """Map every gene interval through the block partition: which blocks
    (and which alignment columns) cover it (PrintPartition parity).

    Fragment lookup rides the shared :class:`FragmentIndex` sorted rows
    (VERDICT r2 item 6) instead of an ad-hoc per-seq dict."""
    from npge_tpu_torch.model.fragindex import FragmentIndex

    idx = FragmentIndex(bs.arena, bs.blocks)
    out = []
    for gene in genes:
        pieces = []
        lo_r = int(idx.u_seq_off[gene.seq_id])
        hi_r = int(idx.u_seq_off[gene.seq_id + 1])
        i = int(
            np.searchsorted(
                idx.u_start[lo_r:hi_r], gene.start, side="right"
            )
        ) - 1
        i = max(i, 0) + lo_r
        for r in range(i, hi_r):
            st, en = int(idx.u_start[r]), int(idx.u_end[r])
            bi, fi = int(idx.u_block[r]), int(idx.u_frag[r])
            if st >= gene.end:
                break
            lo, hi = max(st, gene.start), min(en, gene.end)
            if lo >= hi:
                continue
            b = bs.blocks[bi]
            s, fst, fln, fo = b.frags.row(fi)
            # fragment text offsets of the overlap
            if fo == 1:
                t0, t1 = lo - fst, hi - fst
            else:
                t0, t1 = fst + fln - hi, fst + fln - lo
            # columns: for gapless blocks text offset == column
            if b.alignment is None:
                c0, c1 = t0, t1
            else:
                nz = np.flatnonzero(b.alignment[fi] != C.GAP)
                c0, c1 = int(nz[t0]), int(nz[t1 - 1]) + 1
            pieces.append((b.name or f"#{bi}", c0, c1))
        out.append(GenePartition(gene, pieces))
    return out


def gene_groups(genes: list[Gene], bs: BlockSet) -> dict[str, list[Gene]]:
    """Group genes by the block covering the majority of their length
    (FindGeneGroups parity: genes sharing a block form candidate ortholog
    groups)."""
    parts = partition_genes(genes, bs)
    groups: dict[str, list[Gene]] = {}
    for gp in parts:
        if not gp.pieces:
            continue
        best = {}
        for name, c0, c1 in gp.pieces:
            best[name] = best.get(name, 0) + (c1 - c0)
        name = max(sorted(best), key=lambda n: best[n])
        groups.setdefault(name, []).append(gp.gene)
    return groups


def gene_groups_tsv(genes: list[Gene], bs: BlockSet) -> str:
    groups = gene_groups(genes, bs)
    out = ["block\tn_genes\tgenes"]
    for name in sorted(groups):
        gs = groups[name]
        out.append(
            f"{name}\t{len(gs)}\t" + ",".join(g.gene_id for g in gs)
        )
    return "\n".join(out) + "\n"


def partition_tsv(genes: list[Gene], bs: BlockSet) -> str:
    out = ["gene\tseq\tstart\tend\tblocks"]
    for gp in partition_genes(genes, bs):
        blocks = ";".join(f"{n}:{c0}-{c1}" for n, c0, c1 in gp.pieces)
        out.append(
            f"{gp.gene.gene_id}\t{bs.arena.names[gp.gene.seq_id]}\t"
            f"{gp.gene.start}\t{gp.gene.end}\t{blocks}"
        )
    return "\n".join(out) + "\n"
