"""ARFF data file parsing and writing.

reference: include/plssvm/detail/io/arff_parsing.hpp —
``@RELATION`` / ``@ATTRIBUTE <name> NUMERIC`` / ``@ATTRIBUTE CLASS {a,b}`` /
``@DATA`` header followed by dense ``v0,v1,...,label`` or sparse
``{idx val, idx val}`` rows (zero-based indices; the CLASS attribute occupies
one index slot at its header position).  Comment lines start with ``%``.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from ..exceptions import InvalidFileFormatError

ARFF_COMMENT = "%"


def _check_name(line: str, prefix: int, suffix: int) -> str:
    """Validate the name part of a header field (arff_parsing.hpp:65-83)."""
    sv = line[prefix:]
    if suffix:
        sv = sv[:-suffix]
    sv = sv.strip()
    if not sv:
        raise InvalidFileFormatError(f'The "{line}" field must contain a name!')
    if " " in sv and not (sv.startswith('"') and sv.endswith('"')):
        raise InvalidFileFormatError(
            f'A "{line}" name that contains a whitespace must be quoted!'
        )
    return sv


def parse_arff_header(lines: List[str]) -> Tuple[int, int, List[str], int]:
    """Parse the ARFF header.

    Returns ``(num_features, num_header_lines, unique_labels, label_idx)``
    following reference arff_parsing.hpp:60-196.  ``unique_labels`` is empty
    when no CLASS attribute exists; labels are returned as (sorted) strings.
    """
    num_features = 0
    label_idx = 0
    has_label = False
    labels: List[str] = []

    header_line = 0
    for header_line, line in enumerate(lines):
        upper = line.upper()
        if upper.startswith("@RELATION"):
            if header_line != 0:
                raise InvalidFileFormatError(
                    "The @RELATION attribute must be set before any other @ATTRIBUTE!"
                )
            _check_name(line, len("@RELATION"), 0)
            continue
        if upper.startswith("@ATTRIBUTE"):
            if "NUMERIC" in upper:
                name = _check_name(line, len("@ATTRIBUTE"), len("NUMERIC"))
                if name.upper() == "CLASS":
                    raise InvalidFileFormatError(
                        'May not use the combination of the reserved name "class" '
                        "and attribute type NUMERIC!"
                    )
                num_features += 1
                if not has_label:
                    label_idx += 1
                continue
            rest = line[len("@ATTRIBUTE"):].lstrip()
            if rest.upper().startswith("CLASS"):
                if has_label:
                    raise InvalidFileFormatError(
                        "A nominal attribute with the name CLASS may only be provided once!"
                    )
                rest = rest[len("CLASS"):].strip()
                if not rest:
                    raise InvalidFileFormatError(
                        f'The "{line}" field must contain class labels!'
                    )
                if not (rest.startswith("{") and rest.endswith("}")):
                    raise InvalidFileFormatError(
                        f'The "{line}" nominal attribute must be enclosed with {{}}!'
                    )
                parts = [p.strip() for p in rest[1:-1].split(",")]
                if len(parts) == 1:
                    raise InvalidFileFormatError("Only a single label has been provided!")
                unique = sorted(set(parts))
                if len(unique) != len(parts):
                    raise InvalidFileFormatError(
                        f"Provided {len(parts)} labels but only {len(unique)} "
                        "of them was/where unique!"
                    )
                for lab in parts:
                    if " " in lab:
                        raise InvalidFileFormatError(
                            "String labels may not contain whitespaces, "
                            f'but "{lab}" has at least one!'
                        )
                labels = unique
                has_label = True
                continue
        if upper.startswith("@DATA"):
            break
        # any other line in the header — @-prefixed or not — is invalid
        # (reference: arff_parsing.hpp:181)
        raise InvalidFileFormatError(f'Read an invalid header entry: "{line}"!')
    else:
        header_line = len(lines)

    if num_features == 0:
        raise InvalidFileFormatError("Can't parse file: no feature ATTRIBUTES are defined!")
    if header_line + 1 >= len(lines):
        raise InvalidFileFormatError("Can't parse file: @DATA is missing!")

    return num_features, header_line + 1, labels, (label_idx if has_label else 0)


def parse_arff_lines(
    lines: List[str], dtype: np.dtype = np.float64
) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Parse ARFF content lines into dense (n, d) matrix + raw label strings.

    reference: arff_parsing.hpp:236-376 (parse_arff_data).
    """
    num_features, num_header_lines, unique_labels, label_idx = parse_arff_header(lines)
    has_label = bool(unique_labels)
    num_attributes = num_features + (1 if has_label else 0)
    data_lines = lines[num_header_lines:]
    n = len(data_lines)

    data = np.zeros((n, num_features), dtype=dtype)
    labels: List[str] = [""] * n

    for i, line in enumerate(data_lines):
        if line.startswith("@"):
            raise InvalidFileFormatError(f'Read @ inside data section!: "{line}"!')
        if line.startswith("{"):
            if not line.endswith("}"):
                raise InvalidFileFormatError(
                    f"Missing closing '}}' for sparse data point \"{line}\" description!"
                )
            is_class_set = False
            body = line[1:-1].strip()
            if body:
                for entry in body.split(","):
                    entry = entry.strip()
                    m = re.match(r"^(\S+)\s+(.+)$", entry)
                    if m is None:
                        raise InvalidFileFormatError(
                            f"Can't parse the sparse entry '{entry}'!"
                        )
                    idx_str, val_str = m.group(1), m.group(2).strip()
                    try:
                        index = int(idx_str)
                    except ValueError:
                        raise InvalidFileFormatError(
                            f"Can't convert '{idx_str}' to a value of type unsigned long!"
                        ) from None
                    if index >= num_attributes or index < 0:
                        raise InvalidFileFormatError(
                            f"Trying to add feature/label at index {index} but the "
                            f"maximum index is {num_attributes - 1}!"
                        )
                    if has_label and index == label_idx:
                        is_class_set = True
                        labels[i] = val_str
                    else:
                        if has_label and index > label_idx:
                            index -= 1
                        try:
                            data[i, index] = dtype(val_str) if callable(dtype) else float(val_str)
                        except ValueError:
                            raise InvalidFileFormatError(
                                f"Can't convert '{val_str}' to a value of type real_type!"
                            ) from None
            if has_label and not is_class_set:
                raise InvalidFileFormatError(f'Missing label for data point "{line}"!')
        else:
            if line.endswith("}"):
                raise InvalidFileFormatError(
                    f"Missing opening '{{' for sparse data point \"{line}\" description!"
                )
            parts = line.split(",")
            if len(parts) != num_attributes:
                raise InvalidFileFormatError(
                    f"Invalid number of features and labels! Found {len(parts)} "
                    f"but should be {num_attributes}!"
                )
            feat_j = 0
            for j, tok in enumerate(parts):
                tok = tok.strip()
                if has_label and j == label_idx:
                    labels[i] = tok
                else:
                    try:
                        data[i, feat_j] = float(tok)
                    except ValueError:
                        raise InvalidFileFormatError(
                            f"Can't convert '{tok}' to a value of type real_type!"
                        ) from None
                    feat_j += 1
        if has_label and labels[i] not in unique_labels:
            raise InvalidFileFormatError(
                f'Found the label "{labels[i]}" which was not specified in the header '
                f"({{{','.join(unique_labels)}}})!"
            )

    return data, (labels if has_label else None)


def _read_arff_header_and_offset(filename: str):
    """Stream the ARFF header: lines up to and including ``@DATA``.

    Returns ``(header_lines, offset)`` with ``offset`` the byte position
    just past the @DATA line, or ``None`` when no @DATA marker appears
    within a sane header budget (the caller falls back to the full-file
    Python path, which raises the exact reference error)."""
    from .file_reader import stream_header_lines

    return stream_header_lines(
        filename,
        comment=ARFF_COMMENT,
        is_terminator=lambda s: s.upper().startswith("@DATA"),
        max_bytes=1 << 22,
    )


def parse_arff_file(
    filename: str, dtype: np.dtype = np.float64
) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Parse a full ARFF file, preferring the native C++ data-section parser.

    The header is streamed in Python (it is metadata-scale) and the data
    section goes through the native mmap + std::thread parser
    (native/libsvm_parser.cpp::plssvm_parse_arff_data) — the analog of the
    reference's OpenMP-parallel ARFF parse (arff_parsing.hpp:236-376).  Any
    content anomaly falls back to the Python path, which raises the exact
    reference error messages.
    """
    from .file_reader import read_lines

    streamed = _read_arff_header_and_offset(filename)
    if streamed is not None:
        header_lines, data_offset = streamed
        try:
            # the placeholder row only satisfies the header parser's
            # "rows exist after @DATA" check; it is never parsed
            num_features, _, unique_labels, label_idx = parse_arff_header(
                header_lines + ["<data-row>"]
            )
        except InvalidFileFormatError:
            num_features = 0
        if num_features:
            from ..native import parse_arff_data_native

            native = parse_arff_data_native(
                filename, data_offset, num_features, label_idx,
                bool(unique_labels), dtype,
            )
            if native is not None:
                data, labels = native
                if not unique_labels:
                    return data, None
                # label-set membership is validated here (the native parser
                # does not know the header's label set); ANY violation
                # reruns the Python path so the reference error message —
                # and its position in the error order — is exact
                if np.isin(
                    np.asarray(labels), np.asarray(unique_labels)
                ).all():
                    return data, labels

    lines = read_lines(filename, comment=ARFF_COMMENT)
    return parse_arff_lines(lines, dtype=dtype)


def parse_arff_file_window(
    filename: str, row_begin: int, row_end: int, dtype: np.dtype = np.float64
) -> Optional[Tuple[np.ndarray, Optional[List[str]], int, int]]:
    """Windowed ARFF read: the features of rows [row_begin, row_end) only.

    Counterpart of plssvm_tpu/io/arff.py::parse_arff_file_window, the
    per-process reader of a multi-process fit (parallel/multihost.py):
    O(window * d) data memory at any file size.  The header streams in
    Python; the data section goes through the native windowed parser
    (``parse_arff_window_native``), which still validates every row and
    returns the whole label column (global metadata: every process maps
    the labels alike).  Returns ``(X_window, labels_all_or_None, n_total,
    num_features)``, or None where the native library is missing or bails
    (the caller then parses the whole file, which raises the reference's
    messages).  ``row_begin = row_end = 0`` is the metadata scan.
    """
    streamed = _read_arff_header_and_offset(filename)
    if streamed is None:
        return None
    header_lines, data_offset = streamed
    try:
        num_features, _, unique_labels, label_idx = parse_arff_header(
            header_lines + ["<data-row>"]
        )
    except InvalidFileFormatError:
        return None
    if not num_features:
        return None
    from ..native import parse_arff_window_native

    native = parse_arff_window_native(
        filename, data_offset, num_features, label_idx,
        bool(unique_labels), row_begin, row_end, dtype,
    )
    if native is None:
        return None
    data, labels, n_total = native
    if unique_labels and not np.isin(np.asarray(labels), np.asarray(unique_labels)).all():
        # a label outside the header: the whole-file parse raises its message
        return None
    return data, (labels if unique_labels else None), n_total, num_features


def write_arff_file(
    filename: str, data: np.ndarray, labels: Optional[np.ndarray] = None
) -> None:
    """Write dense ARFF output (zeros included), reference arff_parsing.hpp:407-459.

    The row payload is formatted by the native multithreaded writer when
    available (byte-identical "{:.10e}" output); Python is the fallback."""
    data = np.asarray(data)
    n, d = data.shape
    header = [f"% {n}x{d}", "@RELATION data_set"]
    header.extend(f"@ATTRIBUTE feature_{i} NUMERIC" for i in range(d))
    if labels is not None:
        unique = sorted({str(lab) for lab in labels})
        header.append(f"@ATTRIBUTE class {{{','.join(unique)}}}")
    header.append("@DATA")
    header_str = "\n".join(header) + "\n"

    from ..native import write_arff_native

    if write_arff_native(filename, header_str, data, labels):
        return

    with open(filename, "w", encoding="utf-8") as fh:
        fh.write(header_str)
        for i in range(n):
            row = ",".join(f"{v:.10e}" for v in data[i])
            if labels is not None:
                fh.write(f"{row},{labels[i]}\n")
            else:
                fh.write(f"{row}\n")
