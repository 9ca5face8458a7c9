# mirrors npge_tpu/io/bs.py
"""Blockset ``.bs`` file format: FASTA whose headers encode fragments+blocks.

Equivalent of the reference's ``BlockSetFastaReader`` / writers ⚠[A]/[B]
(SURVEY.md §2.1): a blockset file is FASTA where each record is one fragment's
*aligned* text (gaps as ``-``) and the header encodes coordinates and block
membership. Our canonical header (documented here; reference's exact header
grammar is tier [C] and will be reconciled when the mount is restored):

    >SEQNAME_<a>_<b> block=<name>

where for ori=+1: a=start, b=start+length-1; for ori=-1: a=start+length-1,
b=start (i.e. a>b marks the minus strand, matching the reference's
first>last convention [B]). A full dump also stores the input sequences as
``>SEQNAME`` records in a companion section so a blockset file is
self-contained.
"""

from __future__ import annotations

import numpy as np

from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.model.blocks import Block, BlockSet
from npge_tpu_torch.model.fragments import FragmentTable
from npge_tpu_torch.io.fasta import read_fasta, write_fasta
from npge_tpu_torch.util import codes as C


def fragment_id(arena: GenomeArena, seq_id: int, start: int, length: int, ori: int) -> str:
    if ori == 1:
        a, b = start, start + length - 1
    else:
        a, b = start + length - 1, start
    return f"{arena.names[seq_id]}_{a}_{b}"


def parse_fragment_id(frag_id: str, arena: GenomeArena) -> tuple[int, int, int, int]:
    name, a_s, b_s = frag_id.rsplit("_", 2)
    a, b = int(a_s), int(b_s)
    seq_id = arena.seq_id(name)
    if a <= b:
        return (seq_id, a, b - a + 1, 1)
    return (seq_id, b, a - b + 1, -1)


def write_blockset(fh, bs: BlockSet, with_sequences: bool = True) -> None:
    """Write a blockset to an open text handle OR a filesystem path
    (symmetric with :func:`read_blockset`'s handle-or-path contract —
    the reference's ``name_to_stream`` convenience, SURVEY §2.4)."""
    if isinstance(fh, (str, bytes)):
        with open(fh, "w") as real:
            write_blockset(real, bs, with_sequences)
        return
    if with_sequences:
        fh.write("# npge_tpu blockset v1\n")
        fh.write("# section: sequences\n")
        write_fasta(
            fh,
            (
                (bs.arena.names[i], bs.arena.seq_codes(i))
                for i in range(bs.arena.n_seqs)
            ),
        )
        fh.write("# section: blocks\n")
    for b in bs.blocks:
        rows = b.rows(bs.arena)
        name = b.name or "?"
        for i in range(b.n_frags):
            fid = fragment_id(bs.arena, *b.frags.row(i))
            fh.write(f">{fid} block={name}\n")
            text = C.decode(rows[i])
            for j in range(0, len(text), 60):
                fh.write(text[j : j + 60] + "\n")


def write_blocks_dir(bs: BlockSet, directory: str) -> int:
    """One FASTA file per block (the reference's per-block output helpers /
    OutputPipe ⚠[B]). Returns the number of files written."""
    import os

    os.makedirs(directory, exist_ok=True)
    n = 0
    for b in bs.blocks:
        name = b.name or f"block{n}"
        rows = b.rows(bs.arena)
        with open(os.path.join(directory, f"{name}.fasta"), "w") as fh:
            for i in range(b.n_frags):
                fid = fragment_id(bs.arena, *b.frags.row(i))
                fh.write(f">{fid} block={name}\n")
                text = C.decode(rows[i])
                for j in range(0, len(text), 60):
                    fh.write(text[j : j + 60] + "\n")
        n += 1
    return n


def read_blockset(fh_or_path, arena: GenomeArena | None = None) -> BlockSet:
    """Read a .bs file. If `arena` is None the file must contain the
    sequences section."""
    seq_records: dict[str, np.ndarray] = {}
    frag_records: list[tuple[str, str, np.ndarray]] = []
    # single-pass parse: '#' comment lines skipped, '>' headers carry
    # key=value attributes (block=NAME marks fragment records)
    if isinstance(fh_or_path, str):
        data = open(fh_or_path, "rb").read()
    else:
        fh_or_path.seek(0)
        data = fh_or_path.read()
        if isinstance(data, str):
            data = data.encode()
    name, attrs, chunks = None, {}, []

    def flush():
        if name is None:
            return
        codes_arr = C.encode(b"".join(chunks))
        if "block" in attrs:
            frag_records.append((name, attrs["block"], codes_arr))
        else:
            seq_records[name] = codes_arr

    for line in data.splitlines():
        line = line.strip()
        if not line or line.startswith(b"#"):
            continue
        if line.startswith(b">"):
            flush()
            parts = line[1:].split()
            name = parts[0].decode()
            attrs = {}
            for p in parts[1:]:
                if b"=" in p:
                    k, v = p.split(b"=", 1)
                    attrs[k.decode()] = v.decode()
            chunks = []
        else:
            chunks.append(line)
    flush()

    if arena is None:
        if not seq_records:
            raise ValueError(".bs file has no sequences section and no arena given")
        arena = GenomeArena(list(seq_records), list(seq_records.values()))

    by_block: dict[str, list[tuple[tuple[int, int, int, int], np.ndarray]]] = {}
    order: list[str] = []
    for fid, bname, codes_arr in frag_records:
        if bname not in by_block:
            order.append(bname)
        by_block.setdefault(bname, []).append(
            (parse_fragment_id(fid, arena), codes_arr)
        )
    bs = BlockSet(arena)
    for bname in order:
        items = by_block[bname]
        frows = [it[0] for it in items]
        texts = [it[1] for it in items]
        width = max(len(t) for t in texts)
        if any(len(t) != width for t in texts):
            raise ValueError(f"ragged alignment rows in block {bname}")
        aln = np.stack(texts)
        # A block alignment is implicit (dropped) only when provably so:
        # no gap characters AND every row's text length equals its
        # fragment's length — then the dense rows are exactly what
        # Block.rows() would reconstruct.
        gapless = not (aln == C.GAP).any()
        lengths_match = all(len(t) == r[2] for t, r in zip(texts, frows))
        if gapless and not lengths_match:
            raise ValueError(
                f"block {bname}: gapless row text length differs from "
                "fragment length"
            )
        block = Block(
            FragmentTable.from_rows(frows),
            None if gapless else aln,
            name=bname,
        )
        bs.add(block)
    return bs
