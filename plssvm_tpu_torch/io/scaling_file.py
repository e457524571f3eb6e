"""Scaling-factors file IO (LIBSVM ``svm-scale`` compatible).

reference: include/plssvm/detail/io/scaling_factors_parsing.hpp:35-150 —
format: a line containing only ``x``, the interval line ``lower upper``, then
one ``idx min max`` line per scaled feature with ONE-based feature indices.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..exceptions import InvalidFileFormatError
from .file_reader import read_lines


def parse_scaling_factors(
    filename: str,
) -> Tuple[Tuple[float, float], np.ndarray]:
    """Read a scaling-factors file.

    Returns ``((lower, upper), factors)`` where ``factors`` is an (m, 3) array
    of ``(zero_based_feature_index, min, max)`` rows.
    """
    lines = read_lines(filename, comment="#")
    if len(lines) < 2:
        raise InvalidFileFormatError(
            f"At least two lines must be present, but only {len(lines)} were given!"
        )
    if lines[0].strip() != "x":
        raise InvalidFileFormatError(
            f'The first line must only contain an \'x\', but is "{lines[0]}"!'
        )
    interval_tokens = lines[1].split()
    if len(interval_tokens) != 2:
        raise InvalidFileFormatError(
            "The interval to which the data points should be scaled must exactly "
            f"have two values, but {len(interval_tokens)} were given!"
        )
    try:
        lower, upper = float(interval_tokens[0]), float(interval_tokens[1])
    except ValueError:
        raise InvalidFileFormatError(
            f"Can't convert the scaling interval '{lines[1]}' to floating point values!"
        ) from None
    if lower >= upper:
        raise InvalidFileFormatError(
            f"Inconsistent scaling interval specification: lower ({lower:g}) must be "
            f"less than upper ({upper:g})!"
        )

    rows: List[Tuple[float, float, float]] = []
    for line in lines[2:]:
        tokens = line.split()
        if len(tokens) != 3:
            raise InvalidFileFormatError(
                f"Each line must contain exactly three values, but {len(tokens)} were given!"
            )
        try:
            feature = int(tokens[0])
            f_min, f_max = float(tokens[1]), float(tokens[2])
        except ValueError:
            # int() (not int(float())): a fractional index like '2.7'
            # must be rejected, not silently truncated to 2
            raise InvalidFileFormatError(
                f"Can't convert the scaling factors line '{line}'!"
            ) from None
        if feature == 0:
            raise InvalidFileFormatError(
                "The scaling factors must be provided one-based, but are zero-based!"
            )
        if feature < 0:
            # a negative entry would store a negative zero-based index
            # that escapes the consumer's ascending max-check and silently
            # rescales the wrong column via numpy negative indexing
            raise InvalidFileFormatError(
                f"The scaling factors must be provided one-based, but "
                f"{feature} was given!"
            )
        rows.append((feature - 1, f_min, f_max))

    factors = np.asarray(rows, dtype=np.float64).reshape(-1, 3)
    return (lower, upper), factors


def write_scaling_factors(
    filename: str,
    interval: Tuple[float, float],
    factors: np.ndarray,
) -> None:
    """Write the scaling-factors file with one-based feature indices.

    reference: scaling_factors_parsing.hpp (write_scaling_factors).
    """
    lower, upper = interval
    with open(filename, "w", encoding="utf-8") as fh:
        fh.write("x\n")
        fh.write(f"{lower:g} {upper:g}\n")
        for feature, f_min, f_max in np.asarray(factors).reshape(-1, 3):
            fh.write(f"{int(feature) + 1} {f_min:.16g} {f_max:.16g}\n")
