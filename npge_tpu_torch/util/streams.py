# mirrors npge_tpu/util/streams.py
"""Named stream resolution (reference ``util/name_to_stream.hpp`` ⚠[C],
SURVEY.md §2.4).

Maps stream *names* to file-like objects so processors can be pointed at
stdout/stderr, real files, or named in-memory buffers interchangeably —
the reference uses this to test report processors against in-memory
streams; we keep the same contract:

  ":stdout" / ":stderr"   process streams (never closed by helpers here)
  ":null"                 a sink that discards writes / yields EOF
  ":<name>"               named in-memory StringIO, created on first use,
                          shared per process (test hook; reference [C])
  anything else           a filesystem path

``write_text`` / ``read_text`` are the convenience wrappers the CLI uses:
they open, write/read, and close only when the target is a real file.
"""

from __future__ import annotations

import io
import os
import sys

_MEMORY: dict[str, io.StringIO] = {}


def memory_stream(name: str) -> io.StringIO:
    """The named in-memory stream (create on first use)."""
    if name not in _MEMORY:
        _MEMORY[name] = io.StringIO()
    return _MEMORY[name]


def reset_memory_streams() -> None:
    _MEMORY.clear()


def name_to_ostream(name: str):
    """Resolve a name to a writable text stream.

    Returns (stream, should_close): only real files need closing.
    """
    if name == ":stdout":
        return sys.stdout, False
    if name == ":stderr":
        return sys.stderr, False
    if name == ":null":
        return open(os.devnull, "w"), True
    if name.startswith(":"):
        return memory_stream(name[1:]), False
    return open(name, "w"), True


def name_to_istream(name: str):
    """Resolve a name to a readable text stream.

    Returns (stream, should_close). ``:stdin`` is the process stream; a
    named memory stream is rewound to the start (reads see everything
    written so far).
    """
    if name == ":stdin":
        return sys.stdin, False
    if name == ":null":
        return open(os.devnull, "r"), True
    if name.startswith(":"):
        s = memory_stream(name[1:])
        s.seek(0)
        return s, False
    return open(name, "r"), True


def write_text(name: str, text: str) -> None:
    stream, close = name_to_ostream(name)
    try:
        stream.write(text)
    finally:
        if close:
            stream.close()


def read_text(name: str) -> str:
    stream, close = name_to_istream(name)
    try:
        return stream.read()
    finally:
        if close:
            stream.close()
