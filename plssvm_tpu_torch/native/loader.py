"""ctypes loader for the native LIBSVM / ARFF / model-file parser, with
on-demand compilation.

Counterpart of plssvm_tpu/native/loader.py.  The shared library is built
from ``libsvm_parser.cpp`` on first use with ``g++ -O3 -std=c++17 -shared
-fPIC -pthread`` into this package's own build directory,
``plssvm_tpu_torch/_build/native/`` (``PLSSVM_TPU_TORCH_NATIVE_CACHE_DIR``
overrides it), keyed by a hash of the source, mirroring how the reference
JIT-compiles and sha256-caches its OpenCL kernels (src/plssvm/backends/
OpenCL/detail/utility.cpp:233-327).  Concurrent builders each compile to a
file of their own and ``os.replace`` it into place.

``PLSSVM_TPU_TORCH_NO_NATIVE=1`` forces the NumPy fallback.  This package
never reads plssvm_tpu's variables (``PLSSVM_TPU_NO_NATIVE``,
``PLSSVM_TPU_NATIVE_CACHE_DIR``) or its cache, and plssvm_tpu never reads
these.  Every entry point returns None / False when the library is
unavailable, and the I/O modules then take their NumPy paths.

The fallback is for users without a toolchain; a run that must prove it
parsed natively reads the counters: every parse and every write that the
library carried out adds one to :data:`native_parses` /
:data:`native_writes` (:func:`reset_counts` sets both to 0), as the kernel
wrappers of ``ops/`` count their launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..exceptions import FileNotFoundError_, InvalidFileFormatError

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "libsvm_parser.cpp")
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build", "native"
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False

#: files the library parsed (LIBSVM data, ARFF data sections, model SV blocks)
native_parses = 0
#: files the library wrote (LIBSVM data, ARFF data, model files)
native_writes = 0


def reset_counts() -> None:
    """Set the native parse and write counters to 0."""
    global native_parses, native_writes
    native_parses = 0
    native_writes = 0


def _count(parses: int = 0, writes: int = 0) -> None:
    global native_parses, native_writes
    native_parses += parses
    native_writes += writes


class _ParseResult(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_double)),
        ("n_total", ctypes.c_int64),
        # void* (not c_char_p: ctypes would eagerly convert to bytes,
        # truncating at the first NUL of the concatenated label buffer)
        ("labels", ctypes.c_void_p),
        ("labels_bytes", ctypes.c_int64),
        ("n", ctypes.c_int64),
        ("d", ctypes.c_int64),
        ("has_labels", ctypes.c_int32),
        ("error", ctypes.c_char * 512),
        ("coeffs", ctypes.POINTER(ctypes.c_double)),
        ("n_lead", ctypes.c_int64),
    ]


def _cache_dir() -> str:
    return os.environ.get("PLSSVM_TPU_TORCH_NATIVE_CACHE_DIR", _DEFAULT_CACHE)


def _build_library() -> Optional[str]:
    """Compile the shared library if not cached; return its path or None."""
    try:
        with open(_SOURCE, "rb") as fh:
            source = fh.read()
    except OSError:
        return None
    key = hashlib.sha256(source).hexdigest()[:16]
    cache = _cache_dir()
    so_path = os.path.join(cache, f"libsvm_parser_{key}.so")
    if os.path.exists(so_path):
        return so_path
    try:
        os.makedirs(cache, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             _SOURCE, "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.SubprocessError):
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("PLSSVM_TPU_TORCH_NO_NATIVE"):
            _lib_failed = True
            return None
        so_path = _build_library()
        if so_path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(so_path)
            lib.plssvm_parse_libsvm.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(_ParseResult)
            ]
            lib.plssvm_parse_libsvm.restype = ctypes.c_int
            lib.plssvm_parse_libsvm_window.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(_ParseResult),
            ]
            lib.plssvm_parse_libsvm_window.restype = ctypes.c_int
            lib.plssvm_free_result.argtypes = [ctypes.POINTER(_ParseResult)]
            lib.plssvm_free_result.restype = None
            lib.plssvm_write_libsvm.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_char_p,
            ]
            lib.plssvm_write_libsvm.restype = ctypes.c_int
            lib.plssvm_parse_model_svs.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(_ParseResult),
            ]
            lib.plssvm_parse_model_svs.restype = ctypes.c_int
            lib.plssvm_parse_arff_data.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(_ParseResult),
            ]
            lib.plssvm_parse_arff_data.restype = ctypes.c_int
            lib.plssvm_parse_arff_window.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(_ParseResult),
            ]
            lib.plssvm_parse_arff_window.restype = ctypes.c_int
            lib.plssvm_write_arff.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_char_p,
            ]
            lib.plssvm_write_arff.restype = ctypes.c_int
            lib.plssvm_write_model.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            lib.plssvm_write_model.restype = ctypes.c_int
            lib.plssvm_libsvm_line_spans.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.plssvm_libsvm_line_spans.restype = ctypes.c_int
            lib.plssvm_free_spans.argtypes = [
                ctypes.POINTER(ctypes.c_int64)
            ]
            lib.plssvm_free_spans.restype = None
            lib.plssvm_parse_libsvm_rows.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(_ParseResult),
            ]
            lib.plssvm_parse_libsvm_rows.restype = ctypes.c_int
            _lib = lib
        except OSError:
            _lib_failed = True
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def parse_libsvm_native(
    filename: str, dtype=np.float64
) -> Optional[Tuple[np.ndarray, Optional[List[str]]]]:
    """Parse with the native library; None means 'fall back to Python'.

    Raises the same exceptions as the NumPy parser for invalid content.
    """
    lib = _get_lib()
    if lib is None:
        return None
    if not os.path.isfile(filename):
        raise FileNotFoundError_(f"Couldn't find file: '{filename}'!")

    res = _ParseResult()
    rc = lib.plssvm_parse_libsvm(filename.encode(), ctypes.byref(res))
    if rc == 2:
        return None  # IO-level problem: let the Python path report it
    if rc == 1:
        raise InvalidFileFormatError(res.error.decode(errors="replace"))
    try:
        n, d = int(res.n), int(res.d)
        data = np.ctypeslib.as_array(res.data, shape=(n, d)).astype(dtype, copy=True)
        labels: Optional[List[str]] = None
        if res.has_labels:
            raw = ctypes.string_at(res.labels, int(res.labels_bytes))
            labels = raw.decode(errors="replace").split("\x00")[:n]
        _count(parses=1)
        return data, labels
    finally:
        lib.plssvm_free_result(ctypes.byref(res))


def parse_libsvm_native_window(
    filename: str, row_begin: int, row_end: int, dtype=np.float64
) -> Optional[Tuple[np.ndarray, Optional[List[str]], int, int]]:
    """Parse only rows [row_begin, row_end) — O(window * d) data memory.

    The whole file is still validated (d and label consistency are global
    properties) and labels are returned for the FULL file (they are
    metadata-scale; the global label set is needed for a consistent {-1,+1}
    mapping across hosts).  Returns ``(X_window, labels_all, n_total, d)``;
    ``None`` means the native library is unavailable.
    """
    lib = _get_lib()
    if lib is None:
        return None
    if not os.path.isfile(filename):
        raise FileNotFoundError_(f"Couldn't find file: '{filename}'!")

    res = _ParseResult()
    rc = lib.plssvm_parse_libsvm_window(
        filename.encode(), int(row_begin), int(row_end), ctypes.byref(res)
    )
    if rc == 2:
        return None
    if rc == 1:
        raise InvalidFileFormatError(res.error.decode(errors="replace"))
    try:
        n, n_total, d = int(res.n), int(res.n_total), int(res.d)
        if n == 0:
            data = np.zeros((0, d), dtype=dtype)
        else:
            data = np.ctypeslib.as_array(res.data, shape=(n, d)).astype(
                dtype, copy=True
            )
        labels: Optional[List[str]] = None
        if res.has_labels:
            raw = ctypes.string_at(res.labels, int(res.labels_bytes))
            labels = raw.decode(errors="replace").split("\x00")[:n_total]
        _count(parses=1)
        return data, labels, n_total, d
    finally:
        lib.plssvm_free_result(ctypes.byref(res))


def libsvm_line_spans(filename: str) -> Optional[np.ndarray]:
    """Byte spans of every data line as an (n, 2) int64 array, or None.

    One cheap memchr sweep over the mmap'd file — built ONCE by streaming
    consumers so every :func:`parse_libsvm_native_rows` call afterwards is
    O(selected rows), not O(file).
    """
    lib = _get_lib()
    if lib is None:
        return None
    if not os.path.isfile(filename):
        raise FileNotFoundError_(f"Couldn't find file: '{filename}'!")
    spans_ptr = ctypes.POINTER(ctypes.c_int64)()
    n = ctypes.c_int64()
    rc = lib.plssvm_libsvm_line_spans(
        filename.encode(), ctypes.byref(spans_ptr), ctypes.byref(n)
    )
    if rc != 0:
        return None
    try:
        if n.value == 0:
            return np.zeros((0, 2), dtype=np.int64)
        return np.ctypeslib.as_array(
            spans_ptr, shape=(int(n.value), 2)
        ).copy()
    finally:
        lib.plssvm_free_spans(spans_ptr)


def check_line_spans(spans: np.ndarray, n_expected: int) -> None:
    """Validate a span index against a prior parse's row count — the ONE
    consistency rule for streaming consumers (raises
    InvalidFileFormatError when the file changed between the validating
    parse and the memchr sweep)."""
    if spans.shape[0] != n_expected:
        raise InvalidFileFormatError(
            f"line index ({spans.shape[0]} rows) disagrees with the parse "
            f"({n_expected} rows) — file changed mid-read?"
        )


def parse_libsvm_native_rows(
    filename: str, spans: np.ndarray, d: int, dtype=np.float64
) -> Optional[np.ndarray]:
    """Parse the data lines at the given (k, 2) byte spans into (k, d).

    No whole-file revalidation: the caller must have validated the file via
    a prior metadata parse (``parse_libsvm_native_window(path, 0, 0)``) and
    pass its global feature count ``d``.  None = native unavailable.
    """
    lib = _get_lib()
    if lib is None:
        return None
    spans = np.ascontiguousarray(spans, dtype=np.int64)
    k = spans.shape[0]
    res = _ParseResult()
    rc = lib.plssvm_parse_libsvm_rows(
        filename.encode(),
        spans.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(k), int(d), ctypes.byref(res),
    )
    if rc == 2:
        return None
    if rc == 1:
        raise InvalidFileFormatError(res.error.decode(errors="replace"))
    try:
        _count(parses=1)
        if k == 0:
            return np.zeros((0, d), dtype=dtype)
        return np.ctypeslib.as_array(res.data, shape=(k, d)).astype(
            dtype, copy=True
        )
    finally:
        lib.plssvm_free_result(ctypes.byref(res))


def parse_model_svs_native(
    filename: str, offset: int, n_lead: int, dtype=np.float64
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parse a model file's SV block starting at byte ``offset``.

    Each row holds ``n_lead`` alpha columns then sparse features.  Returns
    ``(coeffs (n, n_lead), data (n, d))`` or ``None`` meaning 'fall back to
    the Python parser' — the native path bails out on ANY content anomaly so
    the Python path can raise the exact reference error message.
    """
    lib = _get_lib()
    if lib is None:
        return None
    res = _ParseResult()
    rc = lib.plssvm_parse_model_svs(
        filename.encode(), int(offset), int(n_lead), ctypes.byref(res)
    )
    if rc != 0:
        return None
    try:
        n, d = int(res.n), int(res.d)
        data = np.ctypeslib.as_array(res.data, shape=(n, d)).astype(dtype, copy=True)
        coeffs = np.ctypeslib.as_array(
            res.coeffs, shape=(n, int(res.n_lead))
        ).astype(dtype, copy=True)
        _count(parses=1)
        return coeffs, data
    finally:
        lib.plssvm_free_result(ctypes.byref(res))


def parse_arff_data_native(
    filename: str, offset: int, num_features: int, label_idx: int,
    has_label: bool, dtype=np.float64,
) -> Optional[Tuple[np.ndarray, Optional[List[str]]]]:
    """Parse a full ARFF data section starting at byte ``offset``.

    Returns ``(data, labels_or_None)`` or ``None`` meaning 'fall back to the
    Python parser' (native bails out on any content anomaly so the Python
    path can raise the exact reference error message).
    """
    win = parse_arff_window_native(
        filename, offset, num_features, label_idx, has_label, 0, -1, dtype
    )
    if win is None:
        return None
    data, labels, _n_total = win
    return data, labels


def parse_arff_window_native(
    filename: str, offset: int, num_features: int, label_idx: int,
    has_label: bool, row_begin: int, row_end: int, dtype=np.float64,
) -> Optional[Tuple[np.ndarray, Optional[List[str]], int]]:
    """Windowed ARFF data-section parse — features ONLY for rows
    [row_begin, row_end) (``row_end < 0`` = all rows), labels for the
    WHOLE section (global metadata, like ``parse_libsvm_native_window``).

    Returns ``(X_window, labels_all_or_None, n_total)`` or ``None``
    meaning 'fall back to the Python parser'.
    """
    lib = _get_lib()
    if lib is None:
        return None
    res = _ParseResult()
    rc = lib.plssvm_parse_arff_window(
        filename.encode(), int(offset), int(num_features), int(label_idx),
        1 if has_label else 0, int(row_begin), int(row_end),
        ctypes.byref(res),
    )
    if rc != 0:
        return None
    try:
        n, d = int(res.n), int(res.d)
        n_total = int(res.n_total)
        data = np.ctypeslib.as_array(res.data, shape=(n, d)).astype(dtype, copy=True)
        labels: Optional[List[str]] = None
        if res.has_labels:
            raw = ctypes.string_at(res.labels, int(res.labels_bytes))
            labels = raw.decode(errors="replace").split("\x00")[:n_total]
        _count(parses=1)
        return data, labels, n_total
    finally:
        lib.plssvm_free_result(ctypes.byref(res))


def write_model_native(
    filename: str, header: str, support_vectors: np.ndarray,
    coeffs: np.ndarray, order: np.ndarray,
) -> bool:
    """Write a model file natively; False means 'fall back to Python'.

    ``header`` is written verbatim (must end with "SV\\n"); rows follow in
    ``order`` permutation with ``coeffs.shape[1]`` alpha columns each,
    byte-identical to io/model_file.py's Python writer.
    """
    lib = _get_lib()
    if lib is None:
        return False
    sv = np.ascontiguousarray(support_vectors, dtype=np.float64)
    co = np.ascontiguousarray(coeffs, dtype=np.float64)
    od = np.ascontiguousarray(order, dtype=np.int64)
    n, d = sv.shape
    rc = lib.plssvm_write_model(
        filename.encode(),
        header.encode(),
        sv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        co.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        od.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, d, co.shape[1],
    )
    _count(writes=int(rc == 0))
    return rc == 0


def write_arff_native(
    filename: str, header: str, data: np.ndarray, labels=None
) -> bool:
    """Write an ARFF data file natively; False = fall back to Python."""
    lib = _get_lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(data, dtype=np.float64)
    n, d = arr.shape
    labels_buf = None
    if labels is not None:
        labels_buf = b"\x00".join(str(lab).encode() for lab in labels) + b"\x00"
    rc = lib.plssvm_write_arff(
        filename.encode(),
        header.encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        d,
        labels_buf,
    )
    _count(writes=int(rc == 0))
    return rc == 0


def write_libsvm_native(
    filename: str, data: np.ndarray, labels=None
) -> bool:
    """Write with the native library; False means 'fall back to Python'."""
    lib = _get_lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(data, dtype=np.float64)
    n, d = arr.shape
    labels_buf = None
    if labels is not None:
        labels_buf = b"\x00".join(str(lab).encode() for lab in labels) + b"\x00"
    rc = lib.plssvm_write_libsvm(
        filename.encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        d,
        labels_buf,
    )
    _count(writes=int(rc == 0))
    return rc == 0
