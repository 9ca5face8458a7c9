"""npge_tpu_torch's C++ host library and its builder.

The port's C++ global alignment against the JAX package's NumPy one (the
reference's own library switched off), the port's FASTA reader against the
reference's as the reference runs it (with its C++ library), the library
names, and a failing build through ``util.shlib``."""

import hashlib
import io
import os

import numpy as np
import pytest

import npge_tpu.native
from npge_tpu.algo.similar import nw_align as ref_nw_align
from npge_tpu.io.fasta import read_fasta as ref_read_fasta
from npge_tpu_torch import native
from npge_tpu_torch.algo.similar import nw_align
from npge_tpu_torch.io.fasta import read_fasta
from npge_tpu_torch.ops import _build
from npge_tpu_torch.util import shlib


def _codes(text: str) -> np.ndarray:
    return np.array(["ACGTN".index(c) for c in text], np.uint8)


NW_CASES = {
    "equal": ("ACGTACGT", "ACGTACGT", (1, -2, -3)),
    "one_deletion": ("ACGTTACGA", "ACGTACGA", (1, -2, -3)),
    "empty_side": ("", "ACGT", (1, -2, -3)),
    "both_empty": ("", "", (1, -2, -3)),
    # the deleted A could be any of three: the traceback's diag > up >
    # left order picks one
    "traceback_ties": ("GAAAC", "GAAC", (1, -2, -3)),
    # a mismatch costs as much as two gaps
    "ties_mismatch_or_gaps": ("ACGT", "AGGT", (1, -2, -1)),
    "with_n": ("ACNNGT", "ACNGTT", (2, -1, -2)),
}


@pytest.mark.parametrize("case", sorted(NW_CASES))
def test_nw_align_matches_reference_numpy(case, monkeypatch):
    a, b, (match, mismatch, gap) = NW_CASES[case]
    a, b = _codes(a), _codes(b)
    monkeypatch.setattr(npge_tpu.native, "_lib", False)
    want = ref_nw_align(a, b, match, mismatch, gap)
    got = nw_align(a, b, match, mismatch, gap)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_nw_align_matches_reference_numpy_on_random_pairs(monkeypatch):
    rng = np.random.default_rng(15)
    monkeypatch.setattr(npge_tpu.native, "_lib", False)
    for _ in range(60):
        a = rng.integers(0, 4, int(rng.integers(0, 40))).astype(np.uint8)
        b = a.copy()
        for _ in range(int(rng.integers(0, 4))):
            if len(b) and rng.random() < 0.5:
                b = np.delete(b, int(rng.integers(0, len(b))))
            else:
                b = np.insert(b, int(rng.integers(0, len(b) + 1)),
                              rng.integers(0, 4))
        want = ref_nw_align(a, b)
        got = nw_align(a, b)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


FASTA_TEXTS = {
    "crlf_interior_space": b">x\r\nAC GT\r\n",
    "text_before_header": b"ACGT\n>a\nC\n",
    "header_description": (
        b">chr1 Brucella suis 1330 chromosome I\nACGTN\nacgtn\n"
        b">chr2\tplasmid\nGGCC\n"
    ),
    "empty_record_and_no_final_newline": b">a\n>b desc\nAC\nGT",
}


@pytest.mark.parametrize("name", sorted(FASTA_TEXTS))
def test_read_fasta_matches_reference(name):
    assert npge_tpu.native._load()  # the reference's C++ parser
    text = FASTA_TEXTS[name]
    want = ref_read_fasta(io.BytesIO(text))
    got = read_fasta(io.BytesIO(text))
    assert [h for h, _ in got] == [h for h, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lib", ["host", "kernels"])
def test_library_names_hash_flags_and_sources(lib):
    """The file names under build/npge_tpu_torch/: the flags joined by
    spaces, then the source (the host library) or each source's name and
    text (the kernels)."""
    if lib == "host":
        h = hashlib.sha256(" ".join(native.CXX_FLAGS).encode())
        h.update(native._SRC.read_bytes())
        want = f"libnpge_native_{h.hexdigest()[:16]}.so"
        got = native.library_path()
    else:
        h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
        for name in _build.SOURCES:
            h.update(name.encode())
            h.update((_build._SRC_DIR / name).read_bytes())
        want = f"libnpge_tpu_torch_{h.hexdigest()[:16]}.so"
        got = _build.library_path()
    assert got == shlib.BUILD_DIR / want


def test_failed_build_raises_with_command_and_stderr(tmp_path):
    """A compiler that writes part of its output and fails: RuntimeError
    with the command and the compiler's stderr, and no file left."""
    out = tmp_path / "libbroken.so"
    # sh -c SCRIPT sh -o TMP SOURCE: $2 is the temporary output
    script = 'echo partial > "$2"; echo "broken source" >&2; exit 3'
    with pytest.raises(RuntimeError) as err:
        shlib.build("sh", ("-c", script, "sh"), [tmp_path / "x.cpp"], out)
    cmd = f"sh -c {script} sh -o {out}.{os.getpid()}.tmp {tmp_path / 'x.cpp'}"
    assert str(err.value) == f"sh failed (3): {cmd}\nbroken source\n"
    assert list(tmp_path.iterdir()) == []
