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


def parse_arff_file(
    filename: str, dtype: np.dtype = np.float64
) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Parse a full ARFF file with the Python parser.

    The JAX package's native C++ data-section parser (plssvm_tpu/native/)
    is not ported yet (ROADMAP Queue 1, item 1); the Python path raises the
    exact reference error messages.
    """
    from .file_reader import read_lines

    lines = read_lines(filename, comment=ARFF_COMMENT)
    return parse_arff_lines(lines, dtype=dtype)


def write_arff_file(
    filename: str, data: np.ndarray, labels: Optional[np.ndarray] = None
) -> None:
    """Write dense ARFF output (zeros included), reference arff_parsing.hpp:407-459."""
    data = np.asarray(data)
    n, d = data.shape
    header = [f"% {n}x{d}", "@RELATION data_set"]
    header.extend(f"@ATTRIBUTE feature_{i} NUMERIC" for i in range(d))
    if labels is not None:
        unique = sorted({str(lab) for lab in labels})
        header.append(f"@ATTRIBUTE class {{{','.join(unique)}}}")
    header.append("@DATA")
    header_str = "\n".join(header) + "\n"

    with open(filename, "w", encoding="utf-8") as fh:
        fh.write(header_str)
        for i in range(n):
            row = ",".join(f"{v:.10e}" for v in data[i])
            if labels is not None:
                fh.write(f"{row},{labels[i]}\n")
            else:
                fh.write(f"{row}\n")
