"""Build and load the port's CUDA kernels at first use.

The sources under ``npge_tpu_torch/csrc`` are compiled by ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes`` through
``util.shlib``, which names it by a hash of the sources and flags and raises
with nvcc's output when the build fails.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

from npge_tpu_torch.util import shlib

_SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("sw_xdrop.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
# nvcc's output for the library this process built (ptxas registers and
# spills per kernel); empty when an existing library was loaded
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH")


def library_path() -> Path:
    parts = []
    for name in SOURCES:
        parts += [name.encode(), (_SRC_DIR / name).read_bytes()]
    return shlib.library_path("libnpge_tpu_torch", NVCC_FLAGS, parts)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call if missing."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = shlib.load(
        library_path(), _nvcc, NVCC_FLAGS, [_SRC_DIR / n for n in SOURCES]
    )
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.npge_sw_xdrop.argtypes = [vp, ll, vp, vp, vp, vp, vp, vp] + [i32] * 9 + [vp]
    lib.npge_sw_xdrop.restype = i32
    lib.npge_cuda_error_string.argtypes = [i32]
    lib.npge_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
