"""Data container: file loading, label mapping, min-max feature scaling.

reference: include/plssvm/data_set.hpp — data_set<T,U> loads LIBSVM/ARFF
files (format autodetected by the ``.arff`` extension, data_set.hpp:494-498),
maps arbitrary labels to {-1, +1} (the smaller label by the label type's
ordering maps to -1, data_set.hpp:438-446), and optionally min-max scales
features to an interval (data_set.hpp:669-735).

The matrix is a dense, C-contiguous NumPy array (the SoA/AoS layout
machinery of reference detail/layout.hpp is unnecessary — CSVM copies it to
its device as a dense row-major tensor); scaling is vectorized NumPy.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .exceptions import DataSetError
from .io import arff as arff_io
from .io import libsvm as libsvm_io
from .io.scaling_file import parse_scaling_factors, write_scaling_factors
from .parameter import FileFormatType
from .utils.logger import VerbosityLevel, log
from .utils.tracker import add_tracking_entry

#: default floating point type; the reference defaults to float64
#: (``--use_float_as_real_type`` opts into f32, parser_train.cpp:67).
#: Fit-time arrays are cast per the CSVM's dtype.
DEFAULT_DTYPE = np.float64

LabelsLike = Union[np.ndarray, Sequence]


def _infer_label_array(raw_labels: List[str], label_type) -> np.ndarray:
    """Convert parsed label strings to a typed array.

    ``label_type=None`` infers: int if every label parses as int, else float,
    else string — mirroring the reference's compile-time label_type choice
    (int by default, string via --use_strings_as_labels).
    """
    if label_type is None:
        for candidate in (int, float):
            try:
                return np.asarray([candidate(s) for s in raw_labels])
            except ValueError:
                continue
        return np.asarray(raw_labels, dtype=object)
    if label_type is bool:
        def to_bool(s: str) -> bool:
            sl = s.strip().lower()
            if sl in ("true", "1"):
                return True
            if sl in ("false", "0"):
                return False
            raise DataSetError(f"Can't convert '{s}' to a bool label!")
        return np.asarray([to_bool(s) for s in raw_labels])
    if label_type is str:
        return np.asarray(raw_labels, dtype=object)
    return np.asarray([label_type(s) for s in raw_labels])


class LabelMapper:
    """Maps the original labels to solver targets and back.

    Binary (2 labels): the smaller label (by the label type's natural
    ordering) maps to -1, the larger to +1 (reference: data_set.hpp:438-446 —
    std::set iteration order).

    Multiclass (> 2 labels — an EXTENSION; the reference rejects this,
    data_set.hpp:443): labels map to class indices 0..C-1 in sorted order,
    and :meth:`oaa_targets` builds the one-vs-all {-1, +1} target matrix the
    block-CG solver consumes (one column per class).
    """

    def __init__(self, labels: np.ndarray):
        unique = sorted(set(labels.tolist()))
        if len(unique) < 2:
            raise DataSetError(
                "At least two different labels are needed for classification, "
                f"but only {len(unique)} different label was given!"
            )
        self._classes = unique
        self._neg, self._pos = unique[0], unique[-1]

    def mapped_value(self, label) -> float:
        if self.num_mappings == 2:
            if label == self._neg:
                return -1.0
            if label == self._pos:
                return +1.0
            raise DataSetError(f'Label "{label}" unknown in this label mapping!')
        try:
            return float(self._classes.index(label))
        except ValueError:
            raise DataSetError(
                f'Label "{label}" unknown in this label mapping!'
            ) from None

    def label_by_mapped_value(self, value: float):
        if self.num_mappings == 2:
            if value == -1.0:
                return self._neg
            if value == +1.0:
                return self._pos
            raise DataSetError(
                f'Mapped value "{value}" unknown in this label mapping!'
            )
        idx = int(value)
        if idx != value or not 0 <= idx < len(self._classes):
            raise DataSetError(
                f'Mapped value "{value}" unknown in this label mapping!'
            )
        return self._classes[idx]

    def _class_indices(self, labels: np.ndarray) -> np.ndarray:
        """Vectorized label -> class-index mapping with unknown-label check."""
        labels = np.asarray(labels)
        idx = np.full(labels.shape, -1, dtype=np.int64)
        for c, lab in enumerate(self._classes):
            idx[labels == lab] = c
        if (idx < 0).any():
            bad = labels[(idx < 0).nonzero()[0][0]]
            raise DataSetError(f'Label "{bad}" unknown in this label mapping!')
        return idx

    def map_labels(self, labels: np.ndarray, dtype=np.float64) -> np.ndarray:
        """Vectorized solver-target mapping (O(n C) NumPy, no Python loop).

        Binary: {-1, +1}; multiclass: class indices 0..C-1.
        """
        idx = self._class_indices(labels)
        if self.num_mappings == 2:
            return np.where(idx == 1, 1.0, -1.0).astype(dtype)
        return idx.astype(dtype)

    def oaa_targets(self, labels: np.ndarray, dtype=np.float64) -> np.ndarray:
        """(n, C) one-vs-all target matrix: +1 for the row's class, else -1."""
        idx = self._class_indices(labels)
        C = len(self._classes)
        return np.where(
            idx[:, None] == np.arange(C)[None, :], 1.0, -1.0
        ).astype(dtype)

    def labels(self) -> list:
        """The different original labels, in mapped (sorted) order."""
        return list(self._classes)

    @property
    def num_mappings(self) -> int:
        return len(self._classes)


class Scaling:
    """Min-max scaling parameters: target interval + per-feature factors.

    reference: data_set.hpp:297-383 (scaling nested class) — construct from
    an interval (factors computed on first use) or restore from a file.
    """

    def __init__(
        self,
        lower: Optional[float] = None,
        upper: Optional[float] = None,
        *,
        restore_filename: Optional[str] = None,
    ):
        if restore_filename is not None:
            (self.lower, self.upper), self.factors = parse_scaling_factors(
                restore_filename
            )
        else:
            if lower is None or upper is None:
                raise DataSetError("A scaling interval needs both lower and upper!")
            if lower >= upper:
                raise DataSetError(
                    f"Inconsistent scaling interval specification: lower ({lower}) "
                    f"must be less than upper ({upper})!"
                )
            self.lower = float(lower)
            self.upper = float(upper)
            #: (m, 3) array of (zero-based feature index, min, max); empty until computed
            self.factors: np.ndarray = np.empty((0, 3), dtype=np.float64)

    @property
    def scaling_interval(self) -> Tuple[float, float]:
        return (self.lower, self.upper)

    def save(self, filename: str) -> None:
        """Write the factors file (reference: data_set.hpp:360-383)."""
        write_scaling_factors(filename, (self.lower, self.upper), self.factors)


class DataSet:
    """The training/prediction data container.

    reference: include/plssvm/data_set.hpp:100-169 (constructors).
    """

    def __init__(
        self,
        source: Union[str, np.ndarray, Sequence[Sequence[float]]],
        labels: Optional[LabelsLike] = None,
        *,
        file_format: Optional[Union[str, FileFormatType]] = None,
        scaling: Optional[Union[Scaling, Tuple[float, float]]] = None,
        label_type=None,
        dtype=None,
        regression: bool = False,
    ):
        """``regression=True`` treats the label column as CONTINUOUS
        regression targets (LS-SVR, an EXTENSION — neither the reference
        nor upstream supports regression): no label mapping happens and
        the solver consumes the raw float targets."""
        self._regression = bool(regression)
        self._scaling: Optional[Scaling] = None
        # the explicit solver's kernel matrix, (key, K), memoised by
        # CSVM._build_explicit_k; the key holds everything K depends on
        # but the data, which a DataSet never changes after construction
        self._k_cache = None
        if isinstance(scaling, tuple):
            scaling = Scaling(*scaling)

        if isinstance(source, (str, os.PathLike)):
            if labels is not None:
                raise DataSetError(
                    "Labels are read from the data file; they cannot also be passed explicitly!"
                )
            self._read_file(str(source), file_format, label_type, dtype or DEFAULT_DTYPE)
        else:
            # always copy: the DataSet owns its matrix (scaling mutates it
            # in place) and must never alias the caller's array — matching
            # the reference's owning-container semantics (data_set.hpp:100-169)
            try:
                X = np.array(
                    source, dtype=dtype or DEFAULT_DTYPE, order="C", copy=True
                )
            except ValueError as exc:
                if "inhomogeneous" in str(exc):
                    # ragged nested sequences (reference wording:
                    # generic_csvm_tests.hpp:285)
                    raise DataSetError(
                        "All data points must have the same number of features!"
                    ) from exc
                raise
            if X.ndim != 2:
                raise DataSetError("The data must be a 2-D array of shape (n, d)!")
            if X.shape[0] == 0:
                raise DataSetError("The data must not be empty!")
            if X.shape[1] == 0:
                raise DataSetError("The data points must contain at least one feature!")
            self._X = X
            if labels is not None:
                lab = np.asarray(labels)
                if lab.shape[0] != X.shape[0]:
                    raise DataSetError(
                        f"Number of labels ({lab.shape[0]}) must match number of "
                        f"data points ({X.shape[0]})!"
                    )
                self._labels: Optional[np.ndarray] = lab
            else:
                self._labels = None

        self._mapper: Optional[LabelMapper] = None
        self._y: Optional[np.ndarray] = None
        if self._labels is not None:
            if self._regression:
                # continuous targets go to the solver verbatim
                self._labels = np.asarray(self._labels, dtype=np.float64)
                self._y = self._labels.astype(self._X.dtype)
            else:
                self._mapper = LabelMapper(self._labels)
                self._y = self._mapper.map_labels(
                    self._labels, dtype=self._X.dtype
                )

        if scaling is not None:
            self._scaling = scaling
            self._scale()

    # -- file IO ----------------------------------------------------------
    def _read_file(self, filename, file_format, label_type, dtype) -> None:
        start = time.perf_counter()
        if file_format is None:
            fmt = (
                FileFormatType.ARFF
                if filename.lower().endswith(".arff")
                else FileFormatType.LIBSVM
            )
        else:
            fmt = FileFormatType.from_string(file_format)
        if fmt == FileFormatType.ARFF:
            # native mmap + multithreaded fast path with Python fallback
            X, raw_labels = arff_io.parse_arff_file(filename, dtype=dtype)
        else:
            # native mmap + multithreaded fast path with NumPy fallback
            X, raw_labels = libsvm_io.parse_libsvm_file(filename, dtype=dtype)
        self._X = np.ascontiguousarray(X)
        self._labels = (
            _infer_label_array(raw_labels, label_type) if raw_labels is not None else None
        )
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        log(
            VerbosityLevel.FULL | VerbosityLevel.TIMING,
            "Read {} data points with {} features in {:.2f}ms using {} parsing from file '{}'.\n",
            self._X.shape[0], self._X.shape[1], elapsed_ms, fmt, filename,
        )
        add_tracking_entry("data_set_read", "filename", filename)
        add_tracking_entry("data_set_read", "num_data_points", int(self._X.shape[0]))
        add_tracking_entry("data_set_read", "num_features", int(self._X.shape[1]))
        add_tracking_entry("data_set_read", "time", elapsed_ms)

    def save(self, filename: str, file_format: Optional[Union[str, FileFormatType]] = None) -> None:
        """Write the data set (reference: data_set.hpp:566-612)."""
        start = time.perf_counter()
        if file_format is None:
            fmt = (
                FileFormatType.ARFF
                if filename.lower().endswith(".arff")
                else FileFormatType.LIBSVM
            )
        else:
            fmt = FileFormatType.from_string(file_format)
        if fmt == FileFormatType.ARFF:
            arff_io.write_arff_file(filename, self._X, self._labels)
        else:
            libsvm_io.write_libsvm_file(filename, self._X, self._labels)
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        log(
            VerbosityLevel.FULL | VerbosityLevel.TIMING,
            "Write {} data points with {} features in {:.2f}ms to the {} file '{}'.\n",
            self.num_data_points, self.num_features, elapsed_ms, fmt, filename,
        )
        add_tracking_entry("data_set_write", "filename", filename)
        add_tracking_entry("data_set_write", "time", elapsed_ms)

    # -- scaling ----------------------------------------------------------
    def _scale(self) -> None:
        """Scale features to [lower, upper] (reference: data_set.hpp:669-735)."""
        assert self._scaling is not None
        start = time.perf_counter()
        lower, upper = self._scaling.scaling_interval
        X = self._X
        n, d = X.shape

        if self._scaling.factors.size == 0:
            mins = X.min(axis=0)
            maxs = X.max(axis=0)
            # a factor is recorded unless min == max == 0 (data_set.hpp:692-695)
            keep = ~((mins == 0.0) & (maxs == 0.0))
            idx = np.nonzero(keep)[0]
            self._scaling.factors = np.column_stack(
                [idx.astype(np.float64), mins[idx], maxs[idx]]
            )
        else:
            factors = self._scaling.factors
            if factors.shape[0] > d:
                raise DataSetError(
                    "Need at most as much scaling factors as features in the data "
                    f"set are present ({d}), but {factors.shape[0]} were given!"
                )
            order = np.argsort(factors[:, 0], kind="stable")
            factors = factors[order]
            if factors.shape[0] > 0 and int(factors[-1, 0]) >= d:
                raise DataSetError(
                    f"The maximum scaling feature index most not be greater than "
                    f"{d - 1}, but is {int(factors[-1, 0])}!"
                )
            feature_ids = factors[:, 0].astype(np.int64)
            dup = np.nonzero(np.diff(feature_ids) == 0)[0]
            if dup.size > 0:
                raise DataSetError(
                    "Found more than one scaling factor for the feature index "
                    f"{int(feature_ids[dup[0]])}!"
                )
            self._scaling.factors = factors

        factors = self._scaling.factors
        if factors.shape[0] > 0:
            cols = factors[:, 0].astype(np.int64)
            f_min = factors[:, 1].astype(X.dtype)
            f_max = factors[:, 2].astype(X.dtype)
            constant = np.flatnonzero(f_max == f_min)
            if constant.size > 0:
                # reference-compatible behavior (data_set.hpp:692-695 only
                # skips min==max==0): (x - c)/(c - c) fills the column
                # with NaN, which would make CG exit instantly "converged"
                # on a garbage model — at least say so loudly
                import warnings

                warnings.warn(
                    f"min-max scaling: feature(s) "
                    f"{[int(cols[i]) for i in constant[:5]]} are constant "
                    "and nonzero (min == max != 0) — scaling divides by "
                    "zero and fills the column with NaN (the reference "
                    "does the same); drop the constant feature or skip "
                    "its scaling factor.",
                    stacklevel=3,
                )
            X[:, cols] = lower + (upper - lower) * (X[:, cols] - f_min) / (f_max - f_min)

        elapsed_ms = (time.perf_counter() - start) * 1000.0
        log(
            VerbosityLevel.FULL | VerbosityLevel.TIMING,
            "Scaled the data set to the range [{}, {}] in {:.2f}ms.\n",
            lower, upper, elapsed_ms,
        )
        add_tracking_entry("data_set_scale", "lower", lower)
        add_tracking_entry("data_set_scale", "upper", upper)
        add_tracking_entry("data_set_scale", "time", elapsed_ms)

    # -- accessors ---------------------------------------------------------
    @property
    def data(self) -> np.ndarray:
        """The (n, d) feature matrix."""
        return self._X

    @property
    def labels(self) -> Optional[np.ndarray]:
        return self._labels

    @property
    def y(self) -> Optional[np.ndarray]:
        """Solver targets: {-1.0, +1.0} for binary data, class indices
        0..C-1 for multiclass data (see LabelMapper)."""
        return self._y

    def has_labels(self) -> bool:
        return self._labels is not None

    @property
    def num_data_points(self) -> int:
        return int(self._X.shape[0])

    @property
    def num_features(self) -> int:
        return int(self._X.shape[1])

    @property
    def is_regression(self) -> bool:
        """Whether the label column holds continuous regression targets."""
        return self._regression

    @property
    def different_labels(self) -> Optional[list]:
        return self._mapper.labels() if self._mapper is not None else None

    @property
    def num_different_labels(self) -> int:
        return self._mapper.num_mappings if self._mapper is not None else 0

    @property
    def mapper(self) -> Optional[LabelMapper]:
        return self._mapper

    def is_scaled(self) -> bool:
        return self._scaling is not None

    @property
    def scaling_factors(self) -> Optional[Scaling]:
        return self._scaling

    @property
    def dtype(self) -> np.dtype:
        return self._X.dtype
