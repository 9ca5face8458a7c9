# mirrors npge_tpu/algo/bsa.py
"""Blockset alignment (BSA) — global order of blocks along genomes.

Equivalent of the reference's BSA family (``FindBSA`` / ``ChrBSA`` /
``PrintBSA`` / ``ExactStemBSA`` ⚠[B], SURVEY.md §2.3): align the *order* of
blocks along chromosomes across genomes, exposing the global structure and
rearrangements. Implemented here in the ExactStemBSA flavor: rows are
sequences, the column scaffold is the block order of the first sequence,
built over blocks with exactly one fragment in every genome (stem blocks);
blocks absent from the scaffold (rearranged relative to row 1) are appended
as extra columns. Entries are signed block names (minus = inverse
orientation relative to the fragment's sequence).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from npge_tpu_torch.model.blocks import BlockSet
from npge_tpu_torch.model.naming import block_type


@dataclass
class BSA:
    seq_names: list[str]
    columns: list[str]               # block names, scaffold order
    table: list[list[str]]           # [seq][column] signed block name or "."

    def tsv(self) -> str:
        out = ["sequence\t" + "\t".join(self.columns)]
        for name, row in zip(self.seq_names, self.table):
            out.append(name + "\t" + "\t".join(row))
        return "\n".join(out) + "\n"


def stem_order(bs: BlockSet) -> dict[int, list[tuple[str, int, int]]]:
    """Per-sequence ordered [(block_name, ori, start)] over stem blocks."""
    genome_of_seq = bs.arena.genome_id_of_seq()
    n_genomes = len(bs.arena.genomes())
    per_seq: dict[int, list[tuple[int, str, int]]] = {
        i: [] for i in range(bs.arena.n_seqs)
    }
    for b in bs.blocks:
        if block_type(b, genome_of_seq, n_genomes) != "s":
            continue
        for fi in range(b.n_frags):
            s, st, ln, o = b.frags.row(fi)
            per_seq[s].append((st, b.name or "?", o))
    return {
        s: [(name, o, st) for st, name, o in sorted(items)]
        for s, items in per_seq.items()
    }


def order_align(a_ids: list[str], b_ids: list[str],
                match: int = 2, mismatch: int = -3, gap: int = -1):
    """Global NW alignment of two block-order strings.

    Returns a list of (i | None, j | None) pairs. A block that moved
    (transposition) cannot match in both places, so it surfaces as a
    deletion + insertion — the displaced-column rearrangement view the
    reference's bsa_algo produces (``src/model/bsa_algo.cpp`` ⚠[B]).
    Deterministic tie-break: diag > up (gap in b) > left."""
    n, m = len(a_ids), len(b_ids)
    H = np.zeros((n + 1, m + 1), np.int64)
    H[0] = gap * np.arange(m + 1)
    H[:, 0] = gap * np.arange(n + 1)
    for i in range(1, n + 1):
        sub = np.where(np.array(b_ids) == a_ids[i - 1], match, mismatch)
        tmp = np.maximum(H[i - 1, :-1] + sub, H[i - 1, 1:] + gap)
        y = np.concatenate([[H[i, 0]], tmp]) - gap * np.arange(m + 1)
        H[i] = np.maximum.accumulate(y) + gap * np.arange(m + 1)
    out = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + (
            match if a_ids[i - 1] == b_ids[j - 1] else mismatch
        ):
            out.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif i > 0 and H[i, j] == H[i - 1, j] + gap:
            out.append((i - 1, None))
            i -= 1
        else:
            out.append((None, j - 1))
            j -= 1
    return out[::-1]


def find_bsa(bs: BlockSet, seq_ids: list[int] | None = None) -> BSA:
    """General blockset alignment: progressively align the *order* of stem
    blocks along every sequence (NW over block-id strings, sequence 0's
    order as the initial profile). Unlike :func:`exact_stem_bsa` (scaffold
    + appended extras), rearrangements appear as displaced columns: a
    transposed block occupies two columns, each with "." in the genomes
    where it sits elsewhere. Reference: FindBSA/ChrBSA ⚠[B] (SURVEY §2.3)."""
    orders = stem_order(bs)
    if seq_ids is None:
        seq_ids = list(range(bs.arena.n_seqs))
    if not seq_ids:
        return BSA([], [], [])
    # profile: per column, id + per-seq signed entry
    first = seq_ids[0]
    prof_ids: list[str] = [name for name, _o, _st in orders.get(first, [])]
    cells: list[dict[int, int]] = [
        {first: o} for _name, o, _st in orders.get(first, [])
    ]
    for s in seq_ids[1:]:
        row = orders.get(s, [])
        row_ids = [name for name, _o, _st in row]
        pairs = order_align(prof_ids, row_ids)
        new_ids: list[str] = []
        new_cells: list[dict[int, int]] = []
        for pi, ri in pairs:
            if pi is not None and ri is not None and prof_ids[pi] == row_ids[ri]:
                new_ids.append(prof_ids[pi])
                d = cells[pi]
                d[s] = row[ri][1]
                new_cells.append(d)
            elif pi is not None and ri is not None:
                # mismatch column: keep both, profile first (deterministic)
                new_ids.append(prof_ids[pi])
                new_cells.append(cells[pi])
                new_ids.append(row_ids[ri])
                new_cells.append({s: row[ri][1]})
            elif pi is not None:
                new_ids.append(prof_ids[pi])
                new_cells.append(cells[pi])
            else:
                new_ids.append(row_ids[ri])
                new_cells.append({s: row[ri][1]})
        prof_ids, cells = new_ids, new_cells
    table = []
    for s in seq_ids:
        table.append(
            [
                ("." if s not in d else (n if d[s] == 1 else "-" + n))
                for n, d in zip(prof_ids, cells)
            ]
        )
    return BSA([bs.arena.names[s] for s in seq_ids], list(prof_ids), table)


def chr_bsa(bs: BlockSet) -> dict[str, BSA]:
    """One BSA per chromosome name (the reference's ChrBSA ⚠[B]): sequences
    sharing a chromosome label align together."""
    by_chr: dict[str, list[int]] = {}
    for i, p in enumerate(bs.arena.parsed):
        by_chr.setdefault(p.chromosome, []).append(i)
    return {ch: find_bsa(bs, ids) for ch, ids in sorted(by_chr.items())}


def exact_stem_bsa(bs: BlockSet) -> BSA:
    orders = stem_order(bs)
    seq_ids = list(range(bs.arena.n_seqs))
    if not seq_ids:
        return BSA([], [], [])
    scaffold = [name for name, _o, _st in orders.get(0, [])]
    scaffold_set = set(scaffold)
    extras: list[str] = []
    for s in seq_ids[1:]:
        for name, _o, _st in orders[s]:
            if name not in scaffold_set and name not in extras:
                extras.append(name)
    columns = scaffold + extras
    col_of = {name: i for i, name in enumerate(columns)}
    table = []
    for s in seq_ids:
        row = ["."] * len(columns)
        for name, o, _st in orders[s]:
            row[col_of[name]] = name if o == 1 else "-" + name
        table.append(row)
    return BSA([bs.arena.names[s] for s in seq_ids], columns, table)
