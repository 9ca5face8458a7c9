"""Build and load the port's shared libraries at first use.

Both of the port's native libraries come through here: the C++ host
library (``native``, g++) and the CUDA kernels (``ops._build``, nvcc). A
library is named by a hash of its flags and sources under
``build/npge_tpu_torch/`` at the root of the checkout, so a changed source
rebuilds and an unchanged one loads the existing file. It is compiled into a
temporary file named by the process and moved into place, so a concurrent
process never loads a half-written library. A failed build raises
``RuntimeError`` with the command and the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Iterable, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "npge_tpu_torch"


def library_path(stem: str, flags: Sequence[str], parts: Iterable[bytes]) -> Path:
    """``BUILD_DIR/<stem>_<hash>.so``, hashing the flags joined by spaces
    and then each of ``parts`` in turn."""
    h = hashlib.sha256(" ".join(flags).encode())
    for part in parts:
        h.update(part)
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build(compiler: str, flags: Sequence[str], sources: Sequence[Path],
          out: Path) -> str:
    """Compile ``sources`` into ``out`` as ``compiler *flags -o TMP
    *sources``; returns the compiler's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, sources)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{compiler} failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stderr}"
        )
    os.replace(tmp, out)
    return res.stdout + res.stderr


def load(path: Path, compiler: Callable[[], str], flags: Sequence[str],
         sources: Sequence[Path]) -> tuple[ctypes.CDLL, str]:
    """The library at ``path``, built first if it is missing (``compiler``
    is asked only then), and the compiler's output, empty when the file was
    there."""
    log = "" if path.exists() else build(compiler(), flags, sources, path)
    return ctypes.CDLL(str(path)), log
