"""Memory-mapped file ingest split into logical lines.

reference: include/plssvm/detail/io/file_reader.hpp:17-206 — mmap-based file
reading (UNIX mmap / Windows MapViewOfFile, ifstream fallback), splitting the
content into lines while dropping empty lines and lines starting with a
comment character.
"""

from __future__ import annotations

import mmap
import os
from typing import List

from ..exceptions import FileNotFoundError_


def read_lines(filename: str, comment: str = "#") -> List[str]:
    """Read ``filename`` and return its non-empty, non-comment lines.

    A line is dropped when, after stripping leading whitespace, it is empty or
    starts with ``comment`` (reference: file_reader.hpp:124-129).
    """
    if not os.path.isfile(filename):
        raise FileNotFoundError_(f"Couldn't find file: '{filename}'!")
    try:
        with open(filename, "rb") as fh:
            try:
                with mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
                    content = mm.read().decode("utf-8", errors="replace")
            except ValueError:
                # zero-length files cannot be mmapped
                content = fh.read().decode("utf-8", errors="replace")
    except OSError as exc:
        raise FileNotFoundError_(f"Couldn't open file: '{filename}'! ({exc})") from exc

    lines: List[str] = []
    for raw in content.splitlines():
        line = raw.strip()
        if not line or (comment and line.startswith(comment)):
            continue
        lines.append(line)
    return lines


def stream_header_lines(
    filename: str,
    *,
    comment: str,
    is_terminator,
    max_lines: int = 0,
    max_bytes: int = 1 << 22,
):
    """Stream a file's header: non-comment lines up to and including the
    first line for which ``is_terminator(stripped_line)`` is true.

    Returns ``(lines, offset)`` with ``offset`` the byte position just past
    the terminator line — a native data-section parser can start there
    without the Python side ever touching the (possibly multi-GB) payload.
    Returns ``None`` when no terminator appears within the byte/line budget
    (callers fall back to their full-file Python path, which raises the
    exact reference error).  Shared by the ARFF (`@DATA`) and model-file
    (`SV`) fast paths.
    """
    lines: List[str] = []
    pos = 0
    try:
        with open(filename, "rb") as fh:
            buf = b""
            while True:
                chunk = fh.read(65536)
                if not chunk:
                    return None
                buf += chunk
                start = 0
                while True:
                    nl = buf.find(b"\n", start)
                    if nl < 0:
                        break
                    raw = buf[start:nl]
                    pos += nl - start + 1
                    start = nl + 1
                    s = raw.decode("utf-8", errors="replace").strip()
                    if s and not s.startswith(comment):
                        lines.append(s)
                        if is_terminator(s):
                            return lines, pos
                buf = buf[start:]
                # budget the BUFFERED bytes too: a newline-less (e.g.
                # binary) prefix would otherwise accumulate without bound
                # before the first complete line ever advances pos
                if (
                    pos + len(buf) > max_bytes
                    or (max_lines and len(lines) > max_lines)
                ):
                    return None
    except OSError:
        return None
