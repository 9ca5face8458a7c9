"""Build and load the port's CUDA kernels at first use.

The sources under ``npge_tpu_torch/csrc`` are compiled by ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``. The library
lands in ``build/npge_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and flags, so a changed source rebuilds and an unchanged
one loads the existing file. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "npge_tpu_torch"
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_SRC_DIR / name).read_bytes())
    return _BUILD_DIR / f"libnpge_tpu_torch_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(_SRC_DIR / name) for name in SOURCES]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return res.stdout + res.stderr


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call if missing."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not path.exists():
        BUILD_LOG = _compile(path)
    lib = ctypes.CDLL(str(path))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.npge_sw_xdrop.argtypes = [vp, ll, vp, vp, vp, vp, vp, vp] + [i32] * 9 + [vp]
    lib.npge_sw_xdrop.restype = i32
    lib.npge_cuda_error_string.argtypes = [i32]
    lib.npge_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
