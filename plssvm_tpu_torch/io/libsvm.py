"""LIBSVM sparse data file parsing and writing.

reference: include/plssvm/detail/io/libsvm_parsing.hpp —
``label idx:val idx:val ...`` rows with **one-based, strictly increasing**
feature indices; label presence must be all-or-nothing across rows; the
writer omits zero-valued features and formats values as ``{:.10e}``.

The parser is NumPy-backed: tokenization happens once per file, value
CONVERSION runs as one vectorized ``np.asarray(..., dtype)`` batch, and
the dense (n, d) matrix is scattered in one fancy-indexing store.  Value
VALIDATION is per token during the line loop — the error-order contract
with the native parser (first bad line wins, like std::from_chars)
requires it; the batch conversion then re-parses validated tokens.
(The reference parallelizes the same work with OpenMP threads,
libsvm_parsing.hpp:117-221.)
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..exceptions import InvalidFileFormatError


def _has_label(line: str) -> bool:
    """Reproduce the reference's label detection (libsvm_parsing.hpp:150-156):

    the row has a label iff the first ``:`` does not come before the first
    whitespace.
    """
    pos_space = line.find(" ")
    pos_colon = line.find(":")
    if pos_colon == -1:
        return True  # no features at all -> whole line is a label
    if pos_space == -1:
        return False  # single 'idx:val' token without label
    return pos_colon > pos_space


def parse_libsvm_lines(
    lines: List[str], dtype: np.dtype = np.float64
) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Parse LIBSVM content lines into a dense (n, d) matrix + raw label strings.

    Labels are returned as strings (or ``None`` when the file has no labels);
    typed conversion is the caller's concern, mirroring the reference's
    label_type template parameter.

    Raises :class:`InvalidFileFormatError` exactly where the reference does
    (libsvm_parsing.hpp:117-221): zero-based indices, non-strictly-increasing
    indices, unconvertible tokens, inconsistent labelling, empty files.
    """
    if not lines:
        raise InvalidFileFormatError("Can't parse file: no data points are given!")

    n = len(lines)
    labels: List[str] = [""] * n
    has_label = False
    has_no_label = False

    # token split per row; collect flattened index/value token lists
    all_idx_tokens: List[str] = []
    all_val_tokens: List[str] = []
    row_ids: List[int] = []

    for i, line in enumerate(lines):
        tokens = line.split()
        if not tokens:
            # an all-zero unlabeled row (the model-file SV fallback feeds
            # feature-only lines here, and an SV with no nonzero features
            # is legal — the writer omits zeros).  Blank lines in actual
            # training files never reach this parser (read_lines drops
            # them), so file semantics are unchanged.
            continue
        start = 0
        if _has_label(line):
            has_label = True
            labels[i] = tokens[0]
            start = 1
        else:
            has_no_label = True

        last_index = 0
        for tok in tokens[start:]:
            colon = tok.find(":")
            if colon == -1:
                raise InvalidFileFormatError(
                    f"Can't convert '{tok}' to a LIBSVM index:value pair!"
                )
            idx_str = tok[:colon]
            val_str = tok[colon + 1 :]
            # optional leading '+' then digits — EXACTLY what the native
            # parser accepts (parse_index strips one '+' for Python
            # compatibility, then std::from_chars on an unsigned type):
            # Python's bare int() would also take '-5' and '1_5', an
            # accept/reject divergence between the two paths
            idx_digits = (
                idx_str[1:] if idx_str.startswith("+") else idx_str
            )
            # isascii() too: str.isdigit() accepts Unicode digits ('²'
            # passes but int() raises; Arabic-Indic '٥' even converts),
            # which std::from_chars never would
            if not (idx_digits.isascii() and idx_digits.isdigit()):
                raise InvalidFileFormatError(
                    f"Can't convert '{idx_str}' to a value of type "
                    "unsigned long!"
                )
            index = int(idx_str)
            if index == 0:
                raise InvalidFileFormatError(
                    "LIBSVM assumes a 1-based feature indexing scheme, but 0 was given!"
                )
            if last_index >= index:
                raise InvalidFileFormatError(
                    f"The features indices must be strictly increasing, but {index} "
                    f"is smaller or equal than {last_index}!"
                )
            last_index = index
            # validate the value NOW (not in the end-of-parse batch):
            # the native parser raises at the first bad line, and the two
            # paths promise interchangeable errors.  Python's float() also
            # accepts underscored literals ('1_5') that std::from_chars
            # rejects — an accept/reject divergence, not just a message
            # difference — so reject them explicitly.
            if not val_str or "_" in val_str:
                raise InvalidFileFormatError(
                    f"Can't convert '{val_str}' to a value of type "
                    "real_type!"
                )
            try:
                float(val_str)
            except ValueError:
                raise InvalidFileFormatError(
                    f"Can't convert '{val_str}' to a value of type "
                    "real_type!"
                ) from None
            all_idx_tokens.append(idx_str)
            all_val_tokens.append(val_str)
            row_ids.append(i)

    if has_label and has_no_label:
        raise InvalidFileFormatError(
            "Inconsistent label specification found "
            "(some data points are labeled, others are not)!"
        )

    if not all_idx_tokens:
        raise InvalidFileFormatError("Can't parse file: no data points are given!")

    try:
        indices = np.asarray(all_idx_tokens, dtype=np.int64)
    except OverflowError:
        # an index past int64 passed Python's unbounded int() above; the
        # native parser reports it as an unconvertible index
        for tok in all_idx_tokens:
            if int(tok) > np.iinfo(np.int64).max:
                raise InvalidFileFormatError(
                    f"Can't convert '{tok}' to a value of type unsigned "
                    "long!"
                ) from None
        raise
    values = np.asarray(all_val_tokens, dtype=dtype)
    rows = np.asarray(row_ids, dtype=np.int64)

    num_features = int(indices.max())
    data = np.zeros((n, num_features), dtype=dtype)
    data[rows, indices - 1] = values

    return data, (labels if has_label else None)


def parse_libsvm_file(
    filename: str, dtype: np.dtype = np.float64
) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Parse a LIBSVM file with the NumPy parser.

    The JAX package's native C++ mmap parser (plssvm_tpu/native/) is not
    ported yet (ROADMAP Queue 1, item 1); the NumPy parser raises the same
    exceptions with the same messages.
    """
    from .file_reader import read_lines

    return parse_libsvm_lines(read_lines(filename, comment="#"), dtype=dtype)


def write_libsvm_lines(
    data: np.ndarray, labels: Optional[np.ndarray] = None
) -> List[str]:
    """Format a dense matrix (+ labels) as sparse LIBSVM rows.

    Zero-valued features are omitted; values use ``{:.10e}``; each entry is
    followed by a space, matching the reference writer
    (libsvm_parsing.hpp:243-300, format ``{}:{:.10e} ``).
    """
    data = np.asarray(data)
    n, _ = data.shape
    lines: List[str] = []
    nonzero_mask = data != 0.0
    for i in range(n):
        parts: List[str] = []
        if labels is not None:
            parts.append(f"{labels[i]} ")
        cols = np.nonzero(nonzero_mask[i])[0]
        row = data[i]
        parts.extend(f"{j + 1}:{row[j]:.10e} " for j in cols)
        lines.append("".join(parts))
    return lines


def write_libsvm_file(
    filename: str, data: np.ndarray, labels: Optional[np.ndarray] = None
) -> None:
    with open(filename, "w", encoding="utf-8") as fh:
        for line in write_libsvm_lines(data, labels):
            fh.write(line)
            fh.write("\n")
