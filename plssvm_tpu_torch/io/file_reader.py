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
