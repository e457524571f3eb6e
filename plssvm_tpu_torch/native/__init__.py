"""Native (C++) components: the mmap-based LIBSVM / ARFF / model-file
parser and writer.

Counterpart of plssvm_tpu/native.  Compiled on demand with g++ into
``plssvm_tpu_torch/_build/native/`` and loaded via ctypes; every entry
point has a NumPy fallback, so the package works (slower) without a
toolchain.  Equivalent of the reference's native IO layer
(include/plssvm/detail/io/{file_reader,libsvm_parsing}.hpp).
"""

from .loader import (
    native_available,
    parse_arff_data_native,
    parse_arff_window_native,
    parse_libsvm_native,
    parse_model_svs_native,
    write_arff_native,
    write_libsvm_native,
    write_model_native,
)

__all__ = [
    "native_available",
    "parse_arff_data_native",
    "parse_arff_window_native",
    "parse_libsvm_native",
    "parse_model_svs_native",
    "write_arff_native",
    "write_libsvm_native",
    "write_model_native",
]
