# mirrors npge_tpu/native.py
"""ctypes bindings for the C++ host-runtime kernels (csrc/npge_native.cpp).

The port's own copy of the reference's host library, which the port
requires. It is built with g++ (or ``CXX``) at first use into
``build/npge_tpu_torch/`` at the root of the checkout through
``util.shlib``, named by a hash of the source and flags, so the two packages
never share a build product; a failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from npge_tpu_torch.util import shlib

_SRC = Path(__file__).resolve().parent / "csrc" / "npge_native.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib = None


def library_path() -> Path:
    return shlib.library_path("libnpge_native", CXX_FLAGS, [_SRC.read_bytes()])


def load_library() -> ctypes.CDLL:
    """The host library, built on first call if missing."""
    global _lib
    if _lib is not None:
        return _lib
    lib, _ = shlib.load(
        library_path(), lambda: os.environ.get("CXX", "g++"), CXX_FLAGS, [_SRC]
    )
    c_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    c_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.npge_fasta_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, c_u8p, c_i64p, c_i64p, c_i64p,
        ctypes.c_int64,
    ]
    lib.npge_fasta_encode.restype = ctypes.c_int64
    lib.npge_mark_intervals.argtypes = [
        c_u8p, ctypes.c_int64, c_i32p, c_i32p, ctypes.c_int64,
    ]
    lib.npge_uncovered_runs.argtypes = [
        c_u8p, ctypes.c_int64, c_i32p, c_i32p, ctypes.c_int64,
    ]
    lib.npge_uncovered_runs.restype = ctypes.c_int64
    lib.npge_resolve_overlaps.argtypes = [
        c_u8p, c_i64p, c_u8p,
        c_i64p, c_i64p, c_i64p, c_i64p, c_i64p, c_i64p,
        c_u64p, c_i64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        c_i64p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p,
        c_i64p, c_i64p, c_i64p, c_u8p,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.npge_resolve_overlaps.restype = ctypes.c_int64
    lib.npge_nw_align.argtypes = [
        c_u8p, ctypes.c_int64, c_u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint8,
        c_u8p, c_u8p,
    ]
    lib.npge_nw_align.restype = ctypes.c_int64
    _lib = lib
    return _lib


def fasta_encode(data: bytes):
    """Parse FASTA bytes in one pass. Returns (headers, codes, offsets)."""
    lib = load_library()
    n = len(data)
    max_seqs = max(16, data.count(b">") + 1)
    codes = np.empty(n, np.uint8)
    offsets = np.zeros(max_seqs + 1, np.int64)
    hs = np.zeros(max_seqs, np.int64)
    he = np.zeros(max_seqs, np.int64)
    nseq = lib.npge_fasta_encode(data, n, codes, offsets, hs, he, max_seqs)
    if nseq < 0:  # max_seqs counts every '>': cannot happen
        raise RuntimeError("npge_fasta_encode: more records than '>' bytes")
    headers = [
        data[hs[i] : he[i]].decode("ascii", "replace") for i in range(nseq)
    ]
    return headers, codes[: offsets[nseq]].copy(), offsets[: nseq + 1].copy()


def mark_intervals(occ: np.ndarray, start: np.ndarray, length: np.ndarray):
    """Set ``occ[start[k] : start[k] + length[k]]`` for every k."""
    load_library().npge_mark_intervals(
        occ, len(occ),
        np.ascontiguousarray(start, np.int32),
        np.ascontiguousarray(length, np.int32),
        len(start),
    )


def nw_align(a: np.ndarray, b: np.ndarray, match: int, mismatch: int,
             gap: int, gap_code: int):
    """C++ global NW (linear gaps) with the reference's NumPy
    ``algo.similar.nw_align`` values and traceback tie-breaks. Returns
    (row_a, row_b) uint8 arrays."""
    lib = load_library()
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    n, m = len(a), len(b)
    out_a = np.empty(n + m, np.uint8)
    out_b = np.empty(n + m, np.uint8)
    L = lib.npge_nw_align(a, n, b, m, match, mismatch, gap, gap_code,
                          out_a, out_b)
    return out_a[n + m - L :], out_b[n + m - L :]


def resolve_overlaps(
    codes: np.ndarray,
    seq_offsets: np.ndarray,
    occ_concat: np.ndarray,
    cand_offsets: np.ndarray,
    f_seq: np.ndarray,
    f_start: np.ndarray,
    f_len: np.ndarray,
    f_ori: np.ndarray,
    n_cols: np.ndarray,
    aln_ptrs: np.ndarray,
    order: np.ndarray,
    min_length: int,
    min_end: int,
    ident_num: int,
    ident_den: int,
    max_blocks: int,
    max_frags: int,
):
    """C++ greedy admission of candidates ``order``, gapless or gapped,
    wrapping or not, in one pass. Candidate ci has the fragment rows
    ``cand_offsets[ci]:cand_offsets[ci+1]`` (int64 columns), ``n_cols[ci]``
    columns, and ``aln_ptrs[ci]``, the address of its C-contiguous uint8
    alignment, or 0 where it is gapless; the caller keeps those arrays
    alive. Mutates occ_concat. The outputs hold ``max_blocks`` pieces and
    ``max_frags`` fragment rows, which the caller proves enough. Returns
    (out_offsets, o_seq, o_start, o_len, o_ori, o_row, o_src, o_c0, o_c1,
    o_whole): the pieces'
    fragment rows in CSR, each with its row in the source candidate, and
    for piece k its source candidate o_src[k], its columns
    [o_c0[k], o_c1[k]) and o_whole[k], set where the candidate was
    admitted as it is."""
    lib = load_library()

    def i64(a):
        return np.ascontiguousarray(a, np.int64)

    out_off = np.zeros(max_blocks + 1, np.int64)
    o_src, o_c0, o_c1 = (np.empty(max_blocks, np.int64) for _ in range(3))
    o_whole = np.empty(max_blocks, np.uint8)
    o_seq, o_start, o_len, o_ori, o_row = (
        np.empty(max_frags, np.int32) for _ in range(5)
    )
    nb = lib.npge_resolve_overlaps(
        np.ascontiguousarray(codes, np.uint8), i64(seq_offsets), occ_concat,
        i64(cand_offsets), i64(f_seq), i64(f_start), i64(f_len), i64(f_ori),
        i64(n_cols), np.ascontiguousarray(aln_ptrs, np.uint64), i64(order),
        len(order), min_length, min_end, ident_num, ident_den,
        out_off, o_seq, o_start, o_len, o_ori, o_row,
        o_src, o_c0, o_c1, o_whole, max_blocks, max_frags,
    )
    if nb < 0:
        raise RuntimeError("npge_resolve_overlaps: output bound exceeded")
    nf = int(out_off[nb])
    return (
        out_off[: nb + 1].copy(),
        *(a[:nf].copy() for a in (o_seq, o_start, o_len, o_ori, o_row)),
        *(a[:nb].copy() for a in (o_src, o_c0, o_c1, o_whole)),
    )


def uncovered_runs(occ: np.ndarray):
    """(starts, ends) int32 arrays of maximal zero-runs."""
    lib = load_library()
    cap = 1024
    while True:
        starts = np.empty(cap, np.int32)
        ends = np.empty(cap, np.int32)
        cnt = lib.npge_uncovered_runs(occ, len(occ), starts, ends, cap)
        if cnt >= 0:
            return starts[:cnt].copy(), ends[:cnt].copy()
        cap *= 4
