# mirrors npge_tpu/io/fasta.py
"""FASTA + genomes.tsv ingestion.

Host-side I/O layer (the reference reads FASTA via its Sequence readers and a
``genomes.tsv`` table ``<accession> <genome>&<chr>&<c|l>`` [B], SURVEY.md
§2.5). FASTA text is parsed and encoded in one pass by the C++ host
library (``native.fasta_encode``).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from npge_tpu_torch import native
from npge_tpu_torch.model.arena import GenomeArena
from npge_tpu_torch.util import codes as C


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path_or_file) -> list[tuple[str, np.ndarray]]:
    """Read FASTA -> [(header_first_word, codes uint8)], parsed by the C++
    host library in one pass."""
    close = False
    if isinstance(path_or_file, (str, os.PathLike)):
        fh = _open(str(path_or_file))
        close = True
    else:
        fh = path_or_file
    try:
        data = fh.read()
        if isinstance(data, str):
            data = data.encode()
    finally:
        if close:
            fh.close()
    headers, codes, offsets = native.fasta_encode(data)
    return [
        (headers[i], codes[offsets[i] : offsets[i + 1]])
        for i in range(len(headers))
    ]


def write_fasta(fh, records, width: int = 60) -> None:
    """records: iterable of (header, codes or str)."""
    for header, seq in records:
        fh.write(f">{header}\n")
        if not isinstance(seq, str):
            seq = C.decode(seq)
        for i in range(0, len(seq), width):
            fh.write(seq[i : i + width] + "\n")


def read_genomes_tsv(path: str) -> list[tuple[str, str]]:
    """Parse the reference's genomes table: ``<accession> <GENOME&CHR&c|l>``
    per line, ``#`` comments allowed [B]."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(f"bad genomes.tsv line: {line!r}")
            rows.append((parts[0], parts[1]))
    return rows


def arena_from_fasta_files(
    paths: list[str], rename: dict[str, str] | None = None
) -> GenomeArena:
    names, seqs = [], []
    for p in paths:
        for header, codes_arr in read_fasta(p):
            names.append((rename or {}).get(header, header))
            seqs.append(codes_arr)
    return GenomeArena(names, seqs)
