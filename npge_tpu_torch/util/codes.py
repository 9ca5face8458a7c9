# mirrors npge_tpu/util/codes.py
"""Base-code tables: A,C,G,T,N <-> small integer codes, complement, strings.

TPU-native equivalent of the reference's ``src/util/char_to_size.hpp`` /
``complement.hpp`` (SURVEY.md §2.4 ⚠[B]): everything downstream works on
uint8 code arrays (device-friendly), never on Python strings.

Code layout (chosen so complement is the arithmetic ``3 - c`` on real bases):
    A=0, C=1, G=2, T=3, N=4 (any non-ACGT input normalizes to N,
    mirroring the reference's ``to_atgcn`` normalization [B]), GAP=5
    (gap code appears only inside alignment matrices, never in genomes).
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N, GAP = 0, 1, 2, 3, 4, 5
N_REAL_BASES = 4  # codes < N_REAL_BASES are concrete nucleotides

_CODE_TO_CHAR = np.frombuffer(b"ACGTN-", dtype=np.uint8)

# char -> code lookup over all 256 byte values; unknown chars -> N.
_CHAR_TO_CODE = np.full(256, N, dtype=np.uint8)
for _ch, _code in [("A", A), ("C", C), ("G", G), ("T", T)]:
    _CHAR_TO_CODE[ord(_ch)] = _code
    _CHAR_TO_CODE[ord(_ch.lower())] = _code
_CHAR_TO_CODE[ord("-")] = GAP

# complement table over codes (N and GAP map to themselves)
COMPLEMENT = np.array([3, 2, 1, 0, N, GAP], dtype=np.uint8)


def encode(s: str | bytes) -> np.ndarray:
    """String/bytes -> uint8 code array. Non-ACGT letters become N."""
    if isinstance(s, str):
        s = s.encode("ascii")
    return _CHAR_TO_CODE[np.frombuffer(s, dtype=np.uint8)].copy()


def decode(codes: np.ndarray) -> str:
    """uint8 code array -> string (A/C/G/T/N/-)."""
    return _CODE_TO_CHAR[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def complement(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[np.asarray(codes, dtype=np.uint8)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis."""
    return complement(codes)[..., ::-1]
