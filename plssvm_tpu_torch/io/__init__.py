"""File IO: LIBSVM/ARFF data files, LIBSVM model files, scaling-factor files.

reference: include/plssvm/detail/io/ — the parsers here reproduce the
reference's formats and error taxonomy with NumPy-vectorized implementations.
"""

from .file_reader import read_lines
from .libsvm import parse_libsvm_lines, write_libsvm_file
from .arff import parse_arff_lines, write_arff_file
from .model_file import parse_model_file, write_model_file
from .scaling_file import parse_scaling_factors, write_scaling_factors

__all__ = [
    "read_lines",
    "parse_libsvm_lines",
    "write_libsvm_file",
    "parse_arff_lines",
    "write_arff_file",
    "parse_model_file",
    "write_model_file",
    "parse_scaling_factors",
    "write_scaling_factors",
]
