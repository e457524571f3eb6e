"""The learned model: support vectors, alpha weights, rho, cached w.

reference: include/plssvm/model.hpp — in LS-SVM *all* training points are
support vectors; the model stores the training data_set, the weight vector
``alpha`` (one weight per point), the bias term ``rho``, and lazily caches the
``w`` vector for the linear-kernel prediction fast path (model.hpp:162-166).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from .data_set import DataSet
from .io.model_file import parse_model_file, write_model_file
from .parameter import ClassificationType, Parameter
from .utils.assertions import plssvm_assert
from .utils.logger import VerbosityLevel, log
from .utils.tracker import add_tracking_entry


class Model:
    """Fit result; loadable/savable as a LIBSVM model file.

    reference: model.hpp:49 (class model), file ctor 169-201, save 207-222.
    """

    def __init__(
        self,
        params: Parameter,
        data: DataSet,
        alpha: Optional[np.ndarray] = None,
        rho=0.0,
    ):
        self.params = params
        self.data = data
        if alpha is not None:
            # reference: gpu_csvm.hpp predict preconditions
            # (generic_csvm_tests.hpp:337)
            plssvm_assert(
                np.shape(alpha)[0] == data.num_data_points,
                "The number of support vectors ({}) and number of weights "
                "({}) must be the same!",
                data.num_data_points, np.shape(alpha)[0],
            )
        #: (n_sv,) weights for binary models; (n_sv, C) one-vs-all columns
        #: or (n_sv, C-1) LIBSVM-layout one-vs-one sv_coef for multiclass
        #: models (extension — the reference is binary-only)
        self.alpha = alpha
        #: scalar -bias for binary models; (C,) array for one-vs-all,
        #: (C(C-1)/2,) for one-vs-one multiclass
        self.rho = (
            np.asarray(rho, dtype=np.float64)
            if np.ndim(rho) > 0
            else float(rho)
        )
        #: cached w vector for the linear prediction fast path (model.hpp:162-166)
        self.w: Optional[np.ndarray] = None
        #: CG iterations of the producing fit (None for file-loaded models)
        self.n_iter: Optional[int] = None
        #: Platt-sigmoid calibration (plssvm_tpu.probability) — one (A, B)
        #: pair per sigmoid: 1 for binary, C for one-vs-all, C(C-1)/2 for
        #: one-vs-one models; None when the model is uncalibrated.
        #: Persisted as the LIBSVM probA/probB model-file header lines.
        self.prob_a: Optional[np.ndarray] = None
        self.prob_b: Optional[np.ndarray] = None
        #: multiclass decomposition of this model: OAA (one-vs-all block CG,
        #: the default) or OAO (one-vs-one, LIBSVM model layout).  Binary
        #: models are the same machine either way and keep the default.
        self.classification = ClassificationType.OAA
        #: True for LS-SVR regression models (continuous targets; stored
        #: in LIBSVM's epsilon_svr file layout) — an EXTENSION, neither the
        #: reference nor upstream supports regression
        self.is_regression = bool(getattr(data, "is_regression", False))
        #: True for one-class (novelty-detection) models: prediction is
        #: sign(f) as +1 inlier / -1 outlier, LIBSVM's one_class file
        #: layout (EXTENSION — plssvm_tpu.one_class)
        self.is_one_class = False
        #: the class order DEFINING the multiclass column/machine layout —
        #: alpha columns, rho entries and (for OAO) the pair enumeration all
        #: follow it.  None = the LabelMapper's sorted order (models trained
        #: here).  Model files loaded from LIBSVM may carry an UNSORTED
        #: ``label`` header (order of first appearance); Model.load records
        #: it so machine/rho/sv_coef association survives the round trip.
        self.label_order = None

    # -- file IO ----------------------------------------------------------
    @classmethod
    def load(cls, filename: str, label_type=None, dtype=np.float64) -> "Model":
        """Read a LIBSVM model file (reference: model.hpp:169-201)."""
        start = time.perf_counter()
        (params, rho, support_vectors, alpha, raw_labels, prob,
         svm_type) = parse_model_file(filename, dtype=dtype)
        from .data_set import _infer_label_array

        if raw_labels is None:
            # epsilon_svr layout: a regression model (no label header; the
            # continuous targets are not stored in LIBSVM model files)
            data = DataSet(support_vectors, dtype=dtype)
        else:
            labels = _infer_label_array(raw_labels, label_type)
            data = DataSet(support_vectors, labels, dtype=dtype)
        # rho arrives as a 1-element array for binary models, (C,) for
        # one-vs-all multiclass (io/model_file.py extension format)
        rho_val = float(rho[0]) if np.asarray(rho).size == 1 else rho
        model = cls(params, data, alpha=alpha, rho=rho_val)
        if raw_labels is None:
            # no-label layouts: LIBSVM's one_class vs the SVR types
            if svm_type == "one_class":
                model.is_regression = False
                model.is_one_class = True
            else:
                model.is_regression = True
        # multiclass format detection: C-1 coefficient columns = the standard
        # LIBSVM one-vs-one layout; C columns = the one-vs-all extension
        C = data.num_different_labels
        if C >= 2:
            # the file's label-header order (first appearance in the
            # class-grouped SV section) defines the column/machine layout —
            # LIBSVM writes it in training-file appearance order, which is
            # NOT necessarily sorted.  For BINARY files the order carries
            # the decision-sign association: libsvm predicts label[0] when
            # f > 0 (svm.cpp svm_predict), so ignoring it silently flips
            # every prediction of a file whose first-seen class sorts low
            seen = dict.fromkeys(labels.tolist())
            model.label_order = list(seen)
        if C > 2 and np.ndim(alpha) == 2 and alpha.shape[1] == C - 1:
            model.classification = ClassificationType.OAO
        if prob is not None:
            model.prob_a, model.prob_b = prob
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        log(
            VerbosityLevel.FULL | VerbosityLevel.TIMING,
            "Read {} support vectors with {} features in {:.2f}ms using the libsvm model parser from file '{}'.\n",
            data.num_data_points, data.num_features, elapsed_ms, filename,
        )
        add_tracking_entry("model_read", "filename", filename)
        add_tracking_entry("model_read", "num_support_vectors", data.num_data_points)
        add_tracking_entry("model_read", "num_features", data.num_features)
        add_tracking_entry("model_read", "time", elapsed_ms)
        return model

    def save(self, filename: str) -> None:
        """Write the LIBSVM model file (reference: model.hpp:207-222)."""
        if self.alpha is None:
            raise ValueError("Cannot save a model that has not been fit!")
        start = time.perf_counter()
        no_labels = self.is_regression or self.is_one_class
        write_model_file(
            filename,
            self.params,
            self.rho,
            np.asarray(self.alpha),
            self.data.data,
            None if no_labels else self.data.labels,
            # class grouping follows the model's layout order so rho /
            # alpha-column association survives re-saving a loaded model
            # whose label header was not sorted
            None if no_labels
            else [str(lab) for lab in self._file_class_order()],
            prob_a=self.prob_a,
            prob_b=self.prob_b,
            regression=self.is_regression,
            one_class=self.is_one_class,
        )
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        log(
            VerbosityLevel.FULL | VerbosityLevel.TIMING,
            "Write {} support vectors with {} features in {:.2f}ms to the libsvm model file '{}'.\n",
            self.num_support_vectors, self.num_features, elapsed_ms, filename,
        )
        add_tracking_entry("model_write", "filename", filename)
        add_tracking_entry("model_write", "time", elapsed_ms)

    # -- accessors ---------------------------------------------------------
    def _file_class_order(self) -> List:
        """Class order for the MODEL FILE header.

        Loaded models keep their file's order (sign/column association
        must survive re-saving).  Binary models trained here write the
        +1-mapped class FIRST: libsvm's svm_predict rule is
        ``f > 0 -> label[0]`` and our decision function is positive for
        the mapper's larger label — the reference writes the same order
        (its bundled fixtures read "label 1 -1",
        libsvm_model_parsing.hpp:294-500).
        """
        order = self.class_order()
        if self.label_order is None and len(order) == 2:
            return [order[1], order[0]]
        return order

    def class_order(self) -> List:
        """The class order defining this model's column/machine layout.

        ``label_order`` when set (file-loaded multiclass models keep the
        file's header order), else the LabelMapper's sorted order.
        """
        if self.label_order is not None:
            return list(self.label_order)
        return list(self.data.different_labels)

    @property
    def num_classes(self) -> int:
        """2 for binary models, C for one-vs-all multiclass models."""
        return self.data.num_different_labels

    @property
    def num_support_vectors(self) -> int:
        return self.data.num_data_points

    @property
    def num_features(self) -> int:
        return self.data.num_features

    @property
    def support_vectors(self) -> np.ndarray:
        return self.data.data

    @property
    def different_labels(self) -> Optional[List]:
        return self.data.different_labels

    def __repr__(self) -> str:
        return (
            f"Model(params={self.params!r}, rho={self.rho!r}, "
            f"num_support_vectors={self.num_support_vectors}, "
            f"num_features={self.num_features})"
        )


def model_from_numpy(
    params,
    support_vectors,
    alpha,
    rho,
    labels,
    *,
    label_order=None,
    classification=None,
    dtype=np.float64,
) -> Model:
    """Build a Model from the numpy fields of a plssvm_tpu model.

    ``params`` is a :class:`Parameter` of either package (their fields
    match); user-set values stay user-set, so the saved file is the same.
    ``support_vectors`` (n_sv, d) and ``labels`` (n_sv,) are the model's
    arrays; ``alpha`` is (n_sv,) with a scalar ``rho`` for a binary model,
    (n_sv, C) with ``rho`` (C,) for a one-vs-all model, (n_sv, C-1) with
    ``rho`` (C(C-1)/2,) for a one-vs-one model.  ``label_order`` is the
    label-header order of a file-loaded model (None for a trained one);
    ``classification`` the model's ``classification`` of either package
    (None: one-vs-all, the default).
    """
    port_params = Parameter()
    for name in Parameter.__slots__:
        field = getattr(params, name)
        if not field.is_default():
            value = field.value
            if name == "kernel_type":
                value = int(value)
            port_params.update(**{name: value})
    data = DataSet(np.asarray(support_vectors), np.asarray(labels), dtype=dtype)
    model = Model(
        port_params, data, alpha=np.asarray(alpha, dtype=dtype), rho=rho
    )
    model.label_order = None if label_order is None else list(label_order)
    if classification is not None:
        model.classification = ClassificationType.from_string(str(classification))
    return model
