"""npge_tpu_torch.algo.genes against the reference on the cases of
``tests/test_meta_genes.py``: gene partition, gene groups, their TSVs and
the GFF3 / TSV readers, each equal to the reference's."""

import dataclasses

import numpy as np
import pytest

from npge_tpu.algo import genes as ref_genes
from npge_tpu.model.arena import GenomeArena
from npge_tpu.model.blocks import Block, BlockSet
from npge_tpu.model.fragments import FragmentTable
from npge_tpu_torch.algo import genes
from torch_carry import port_blockset

GENES = [
    (0, 1, 7, 1, "geneA1"),
    (1, 2, 6, 1, "geneB1"),
    (0, 6, 11, 1, "geneA2"),  # spans a block boundary
    (1, 0, 12, -1, "geneB2", "whole"),
]


def two_genome_bs():
    arena = GenomeArena.from_strings(
        {"A&c&l": "ACGTACGTACGT", "B&c&l": "ACGTACGTACGT"}
    )
    return BlockSet(
        arena,
        [
            Block(FragmentTable.from_rows([(0, 0, 8, 1), (1, 0, 8, 1)]), name="s2x8"),
            Block(FragmentTable.from_rows([(0, 8, 4, 1)]), name="uA"),
            Block(FragmentTable.from_rows([(1, 8, 4, 1)]), name="uB"),
        ],
    )


def gapped_bs():
    """A gapped block, so pieces map text offsets through the alignment."""
    from npge_tpu.util import codes as C

    arena = GenomeArena.from_strings(
        {"A&c&l": "ACGTTGCAACGTAC", "B&c&l": "ACGTGCAACGTAC"}
    )
    aln = np.stack([C.encode("ACGTTGCAACGTAC"), C.encode("ACGTTGCAACGTAC")])
    aln[1, 4] = C.GAP
    frags = FragmentTable.from_rows([(0, 0, 14, 1), (1, 0, 13, 1)])
    return BlockSet(arena, [Block(frags, alignment=aln, name="g")])


def both(fn, bs, gene_rows):
    """fn applied by the reference and by the port to the same genes."""
    want = fn(ref_genes)([ref_genes.Gene(*g) for g in gene_rows], bs)
    got = fn(genes)([genes.Gene(*g) for g in gene_rows], port_blockset(bs))
    return got, want


@pytest.mark.parametrize("make", [two_genome_bs, gapped_bs])
def test_partition_and_groups_match_reference(make):
    bs = make()
    rows = GENES if make is two_genome_bs else [(0, 2, 12, 1, "gA"), (1, 1, 9, -1, "gB")]
    got, want = both(lambda m: m.partition_genes, bs, rows)
    assert [p.pieces for p in got] == [p.pieces for p in want]
    assert all(p.pieces for p in got)
    got, want = both(lambda m: m.gene_groups, bs, rows)
    assert {k: [dataclasses.astuple(g) for g in v] for k, v in got.items()} == {
        k: [dataclasses.astuple(g) for g in v] for k, v in want.items()
    }
    for name in ("gene_groups_tsv", "partition_tsv"):
        got, want = both(lambda m: getattr(m, name), bs, rows)
        assert got == want
    assert got.count("\n") == len(rows) + 1  # partition_tsv: a row a gene


def test_partition_pieces_as_in_reference_test():
    bs = port_blockset(two_genome_bs())
    parts = genes.partition_genes([genes.Gene(*g) for g in GENES[:3]], bs)
    assert parts[0].pieces == [("s2x8", 1, 7)]
    assert parts[1].pieces == [("s2x8", 2, 6)]
    assert [p[0] for p in parts[2].pieces] == ["s2x8", "uA"]


def test_readers_match_reference(tmp_path):
    bs = two_genome_bs()
    gff = tmp_path / "x.gff3"
    gff.write_text(
        "##gff-version 3\n"
        "A&c&l\tsrc\tgene\t2\t7\t.\t+\t.\tID=g1;product=thing\n"
        "A&c&l\tsrc\tregion\t1\t12\t.\t+\t.\tID=skip\n"
        "B&c&l\tsrc\tCDS\t3\t9\t.\t-\t.\tlocus_tag=t7\n"
        "unknown\tsrc\tgene\t1\t4\t.\t-\t.\tID=g2\n"
    )
    tsv = tmp_path / "g.tsv"
    tsv.write_text("B&c&l\t0\t4\t-\tg3\tstuff\n# note\nA&c&l 2 5 + g4\n")
    for reader in ("read_gff3", "read_genes_tsv"):
        path = str(gff if reader == "read_gff3" else tsv)
        want = getattr(ref_genes, reader)(path, bs)
        got = getattr(genes, reader)(path, port_blockset(bs))
        assert [dataclasses.astuple(g) for g in got] == [
            dataclasses.astuple(g) for g in want
        ]
        assert len(got) == 2
