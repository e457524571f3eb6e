"""sklearn-compatible facades over CSVM / DataSet / Model: ``SVC``,
``SVR`` and ``OneClassSVM``.

Counterpart of plssvm_tpu/sklearn.py (reference:
bindings/Python/sklearn.cpp:34-110 for the accepted constructor keywords and
the AttributeError on unimplemented sklearn parameters, 143-420 for the
methods and fitted attributes), with its parameter lists, ``get_params`` /
``set_params``, fitted attributes and error messages.  Every fit and predict
goes through the port's CSVM (its kernels on the card), the compact fits
through sparse.py and the calibration through probability.py.  The data
type defaults to float64, as plssvm_tpu's does (``dtype=`` at construction,
not an estimator parameter), so on the card the facade runs the FP64
tensor-core tiles.

The one parameter plssvm_tpu's facades lack is ``device``: the port's
entry points take an explicit device, and ``CSVM``'s ``automatic`` takes
the CUDA device or raises, never the CPU.  ``device=None`` (the default)
is that automatic choice; ``device="cpu"`` runs on the CPU's plain
versions.  It is in ``get_params``, so ``clone`` keeps it.

sklearn itself is imported only inside ``__sklearn_tags__``, which only
sklearn's own model-selection machinery calls: the facades import, fit
and predict without it.

Beyond the reference (as plssvm_tpu): ``decision_function``,
``intercept_``, ``dual_coef_`` and ``n_iter_``; ``probability=True`` with
``predict_proba`` / ``predict_log_proba`` / ``probA_`` / ``probB_`` (Platt
scaling on stratified 5-fold CV decision values); ``class_weight`` and
``sample_weight`` (Suykens' weighted LS-SVM); ``gamma="scale"``; the compact
fits ``max_sv`` / ``n_landmarks``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .csvm import CSVM
from .data_set import DataSet
from .model import Model
from .utils.logger import VerbosityLevel, set_verbosity

#: sklearn.svm.SVC constructor parameters the reference accepts but does not
#: implement — passing one raises AttributeError (sklearn.cpp:74-110).
#: ``probability`` and ``random_state`` ARE implemented here (capability
#: exceeded): Platt scaling on stratified-5-fold CV decision values
#: (probability.py), seeded by ``random_state``.
_UNSUPPORTED_PARAMS = (
    "shrinking",
    "cache_size",
    "break_ties",
)

_KNOWN_PARAMS = (
    "C", "kernel", "degree", "gamma", "coef0", "tol", "verbose", "max_iter",
    "probability", "random_state", "decision_function_shape",
    "classification", "class_weight", "max_sv", "n_landmarks", "device",
) + _UNSUPPORTED_PARAMS


def _rebuild_on_device(estimator, kwargs: dict) -> None:
    """``estimator._svm`` on ``kwargs["device"]`` where that differs from
    its device (the CSVM takes its device at construction), with its
    hyperparameters and data type."""
    if "device" not in kwargs or kwargs["device"] == estimator._device:
        return
    estimator._device = kwargs["device"]
    estimator._svm = CSVM(dtype=estimator._svm.dtype, device=estimator._device,
                          params=estimator._svm.params)


class SVC:
    """LS-SVM classifier with the sklearn.svm.SVC interface.

    reference: bindings/Python/sklearn.cpp (class svc + init_sklearn).
    Multiclass data trains a one-vs-all block-CG model (extension — the
    reference is binary-only); ``decision_function`` then returns the
    (n, C) OvR decision matrix and ``predict`` the argmax class.

    NOTE — gamma default deviates from sklearn.svm.SVC: when ``gamma`` is not
    given, this class (like the PLSSVM reference) uses ``1 / n_features``
    (sklearn's ``'auto'``), NOT sklearn's default ``'scale'``
    (``1 / (n_features * X.var())``).  Pass ``gamma='scale'`` explicitly for
    sklearn-default behavior; it is fully implemented here (the reference
    raises for it, sklearn.cpp:67).
    """

    def __init__(self, **kwargs):
        self._device = kwargs.get("device")
        self._svm = CSVM(dtype=kwargs.pop("dtype", np.float64), device=self._device)
        self._epsilon: Optional[float] = None
        self._max_iter: Optional[int] = None
        self._data: Optional[DataSet] = None
        self._model: Optional[Model] = None
        self._gamma_scale = False
        self._probability = False
        self._random_state: Optional[int] = None
        #: multiclass decomposition: "oaa" (default) or "oao" (sklearn's SVC
        #: itself always trains ovo; here the block-CG OvA is the default
        #: because it shares the Gram work across classes)
        self._classification = "oaa"
        #: decision_function output for OAO models: "ovr" (sklearn default,
        #: vote-based transform) or "ovo" (raw pair columns)
        self._decision_function_shape = "ovr"
        #: per-class regularization multipliers (Suykens' weighted LS-SVM;
        #: LIBSVM's -wi): None, 'balanced', or {label: weight}
        self._class_weight = None
        #: the effective per-sample weights of the last fit (None if
        #: unweighted) — reused by the probability calibration CV
        self._fit_weights = None
        #: compact-model fits (EXTENSION, sparse.py): ``max_sv``
        #: trains via Suykens pruning to at most N support vectors;
        #: ``n_landmarks`` via the fixed-size (Nystroem) primal ridge with
        #: M landmark SVs.  Mutually exclusive; GridSearchCV can sweep them
        #: like any other constructor parameter.
        self._max_sv: Optional[int] = None
        self._n_landmarks: Optional[int] = None
        #: row indices of the SVs in the training data (compact fits only;
        #: None = every training point is an SV, the exact-LS-SVM case)
        self._support_indices: Optional[np.ndarray] = None
        #: kept-row mapping after zero-weight exclusion (None = no rows
        #: dropped) and the fit-call X shape — support_/shape_fit_ report
        #: CALLER-X indexing
        self._kept_rows: Optional[np.ndarray] = None
        self._shape_fit: Optional[tuple] = None
        #: raw user-provided parameters, returned VERBATIM by get_params —
        #: sklearn's clone() contract compares them by identity
        self._user_params: dict = {}
        self._parse_params(kwargs)

    # -- parameter plumbing ------------------------------------------------
    def _parse_params(self, kwargs: dict) -> None:
        """Map sklearn names onto CSVM parameters (sklearn.cpp:51-110)."""
        for key in kwargs:
            if key not in _KNOWN_PARAMS:
                raise AttributeError(
                    f"Invalid parameter '{key}' for the 'SVC' constructor!"
                )
        for key in _UNSUPPORTED_PARAMS:
            if key in kwargs:
                raise AttributeError(
                    f"The '{key}' parameter for a call to the 'SVC' "
                    "constructor is not implemented yet!"
                )
        self._user_params.update(kwargs)
        _rebuild_on_device(self, kwargs)
        if "C" in kwargs:
            self._svm.set_params(cost=float(kwargs["C"]))
        if "kernel" in kwargs:
            self._svm.set_params(kernel_type=kwargs["kernel"])
        if "degree" in kwargs:
            self._svm.set_params(degree=int(kwargs["degree"]))
        if "gamma" in kwargs:
            gamma = kwargs["gamma"]
            # sklearn's "auto" is 1/n_features — our fit-time default.
            # "scale" (1 / (n_features * X.var())) is resolved at fit time —
            # implemented here; the reference leaves it as a TODO and raises
            # (sklearn.cpp:67).
            if gamma == "auto":
                self._gamma_scale = False
                # clear any previously-set numeric (or fit-resolved
                # 'scale') value so the 1/n_features default applies —
                # set_params would otherwise silently keep the old gamma
                # while get_params reports 'auto'
                self._svm.params.gamma.reset()
            elif gamma == "scale":
                self._gamma_scale = True
                self._svm.params.gamma.reset()
            else:
                self._gamma_scale = False
                self._svm.set_params(gamma=float(gamma))
        if "coef0" in kwargs:
            self._svm.set_params(coef0=float(kwargs["coef0"]))
        if "tol" in kwargs:
            self._epsilon = float(kwargs["tol"])
        if "verbose" in kwargs:
            set_verbosity(
                VerbosityLevel.FULL if kwargs["verbose"] else VerbosityLevel.QUIET
            )
        if "max_iter" in kwargs:
            mi = int(kwargs["max_iter"])
            self._max_iter = None if mi == -1 else mi
        if "probability" in kwargs:
            self._probability = bool(kwargs["probability"])
        if "random_state" in kwargs:
            rs = kwargs["random_state"]
            self._random_state = None if rs is None else int(rs)
        if "classification" in kwargs:
            from .parameter import ClassificationType

            self._classification = str(
                ClassificationType.from_string(kwargs["classification"])
            )
        if "decision_function_shape" in kwargs:
            shape = kwargs["decision_function_shape"]
            if shape not in ("ovr", "ovo"):
                raise AttributeError(
                    "decision_function_shape must be either 'ovr' or 'ovo', "
                    f"got {shape!r}."
                )
            self._decision_function_shape = shape
        if "class_weight" in kwargs:
            cw = kwargs["class_weight"]
            if cw is not None and cw != "balanced" and not isinstance(cw, dict):
                raise AttributeError(
                    "class_weight must be None, 'balanced', or a dict "
                    f"mapping labels to weights, got {cw!r}."
                )
            self._class_weight = cw
        if "max_sv" in kwargs:
            v = kwargs["max_sv"]
            self._max_sv = None if v is None else int(v)
        if "n_landmarks" in kwargs:
            v = kwargs["n_landmarks"]
            self._n_landmarks = None if v is None else int(v)

    def __sklearn_tags__(self):
        """Estimator tags for sklearn >= 1.6 model-selection machinery.

        Imported lazily so sklearn stays an optional dependency — the method
        is only ever called by sklearn itself (GridSearchCV, cross_val_*).
        """
        from sklearn.base import BaseEstimator, ClassifierMixin

        class _TagDonor(ClassifierMixin, BaseEstimator):
            pass

        return _TagDonor().__sklearn_tags__()

    #: get_params defaults for parameters the user did not provide
    _PARAM_DEFAULTS = {
        "C": 1.0,
        "kernel": "linear",
        "degree": 3,
        "gamma": "auto",
        "coef0": 0.0,
        "tol": 1e-3,
        "verbose": False,
        "max_iter": -1,
        "probability": False,
        "random_state": None,
        "decision_function_shape": "ovr",
        "classification": "oaa",
        "class_weight": None,
        "max_sv": None,
        "n_landmarks": None,
        "device": None,
    }

    def get_params(self, deep: bool = True) -> dict:
        """Estimator parameters as a dict (sklearn.cpp:196-219).

        User-provided values are returned VERBATIM (sklearn's clone()
        compares them by identity); unset ones report their defaults.
        The gamma resolved at fit time from 'auto'/'scale' is on the
        underlying CSVM (``clf._svm.get_params().gamma``), as in sklearn.
        """
        out = dict(self._PARAM_DEFAULTS)
        out.update(self._user_params)
        return out

    def set_params(self, **kwargs) -> "SVC":
        self._parse_params(kwargs)
        return self

    # -- estimator API -----------------------------------------------------
    def _per_class_weight_map(self, y) -> dict:
        """{str(label): weight} from the class_weight parameter — the ONE
        implementation behind fit-time weighting and ``class_weight_``."""
        y = np.asarray(y)
        classes, counts = np.unique(y.astype(str), return_counts=True)
        if self._class_weight == "balanced":
            return {
                c: len(y) / (len(classes) * n)
                for c, n in zip(classes, counts)
            }
        return {str(k): float(v) for k, v in self._class_weight.items()}

    def _effective_sample_weight(self, y, sample_weight):
        """Combined per-sample weights from class_weight and sample_weight.

        sklearn semantics: effective_i = class_weight[y_i] * sample_weight_i;
        'balanced' uses n / (C * count_c).  Returns None when neither is set.
        """
        y = np.asarray(y)
        weights = None
        if self._class_weight is not None:
            per_class = self._per_class_weight_map(y)
            weights = np.asarray(
                [per_class.get(str(lab), 1.0) for lab in y], dtype=np.float64
            )
        if sample_weight is not None:
            sw = np.asarray(sample_weight, dtype=np.float64)
            weights = sw if weights is None else weights * sw
        return weights

    def fit(self, X, y, sample_weight=None) -> "SVC":
        """Fit the LS-SVM on (X, y) (sklearn.cpp:147-162).

        ``sample_weight`` and the ``class_weight`` constructor parameter are
        IMPLEMENTED (Suykens' weighted LS-SVM — per-point regularizers
        1/(C s_i); the reference raises for both).
        """
        X = np.asarray(X)
        y = np.asarray(y)
        eff = self._effective_sample_weight(y, sample_weight)
        #: fit-call X shape and (after zero-weight exclusion) the kept-row
        #: mapping — support_/shape_fit_ must index the CALLER's X, not
        #: the filtered matrix (sklearn semantics)
        self._shape_fit = X.shape
        self._kept_rows = None
        if eff is not None and np.any(eff == 0.0):
            # sklearn semantics: zero-weight samples are EXCLUDED (the
            # 1/(C s_i) regularizer cannot express s_i = 0)
            keep = eff > 0.0
            if not keep.any():
                raise ValueError(
                    "All samples have zero weight — nothing to fit!"
                )
            X, y, eff = X[keep], y[keep], eff[keep]
            self._kept_rows = np.flatnonzero(keep)
        self._data = DataSet(X, y)
        if self._gamma_scale:
            # sklearn semantics: gamma = 1 / (n_features * X.var())
            var = float(X.var())
            self._svm.set_params(
                gamma=1.0 / (X.shape[1] * var) if var > 0 else 1.0
            )
        if self._max_sv is not None and self._n_landmarks is not None:
            raise AttributeError(
                "max_sv and n_landmarks are mutually exclusive!"
            )
        if (self._max_sv is not None or self._n_landmarks is not None) and (
            self._classification == "oao"
        ):
            raise AttributeError(
                "compact-model fits (max_sv/n_landmarks) support "
                "one-vs-all classification only!"
            )
        self._support_indices = None
        if self._n_landmarks is not None:
            from .sparse import nystroem_fit

            self._model, self._support_indices = nystroem_fit(
                self._svm, self._data,
                n_landmarks=self._n_landmarks,
                random_state=self._random_state or 0,
                sample_weight=eff,
                return_indices=True,
            )
            self._fit_weights = eff
            if self._probability:
                self._calibrate_compact(eff)
            return self
        if self._max_sv is not None:
            from .sparse import pruned_fit

            self._model, self._support_indices = pruned_fit(
                self._svm, self._data,
                n_sv=self._max_sv,
                epsilon=(
                    self._epsilon if self._epsilon is not None else 0.001
                ),
                max_iter=self._max_iter,
                sample_weight=eff,
                return_indices=True,
            )
            self._fit_weights = eff
            if self._probability:
                self._calibrate_compact(eff)
            return self
        kwargs = {"classification": self._classification}
        if self._epsilon is not None:
            kwargs["epsilon"] = self._epsilon
        if self._max_iter is not None:
            kwargs["max_iter"] = self._max_iter
        if eff is not None:
            kwargs["sample_weight"] = eff
        self._model = self._svm.fit(self._data, **kwargs)
        self._fit_weights = eff
        if self._probability:
            # Platt scaling on stratified-5-fold CV decision values — the
            # LIBSVM pipeline (probability.py); the reference's
            # binding rejects probability=True (sklearn.cpp:74-110)
            from .probability import calibrate_model

            calibrate_model(
                self._svm, self._model, self._data,
                random_state=self._random_state,
                epsilon=self._epsilon if self._epsilon is not None else 0.001,
                max_iter=self._max_iter,
                # keep the class/sample weights in the CV subproblems
                # (LIBSVM's svm_binary_svc_probability does the same for -wi)
                sample_weight=self._fit_weights,
            )
        return self

    def _calibrate_compact(self, eff) -> None:
        """Platt calibration for a compact fit — the shared compact
        fold-fit rule (sparse.compact_fold_fit_fn: same procedure as the
        deployed model, scaled to the fold size)."""
        from .probability import calibrate_model
        from .sparse import compact_fold_fit_fn

        eps = self._epsilon if self._epsilon is not None else 0.001
        calibrate_model(
            self._svm, self._model, self._data,
            random_state=self._random_state,
            epsilon=eps, max_iter=self._max_iter,
            sample_weight=eff,
            fit_fn=compact_fold_fit_fn(
                self._svm, n_landmarks=self._n_landmarks,
                max_sv=self._max_sv, epsilon=eps,
                max_iter=self._max_iter,
                random_state=self._random_state,
            ),
        )

    def _check_fitted(self, what: str = "estimator"):
        if self._model is None:
            raise AttributeError(
                "This SVC instance is not fitted yet. Call 'fit' with "
                "appropriate arguments before using this estimator."
            )

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        return self._svm.predict(self._model, DataSet(np.asarray(X)))

    def decision_function(self, X) -> np.ndarray:
        """Signed distance values f(x) (implemented; reference raises).

        Binary: (n,).  Multiclass OAA: the (n, C) OvR decision matrix.
        Multiclass OAO: the raw (n, C(C-1)/2) pair columns when
        ``decision_function_shape='ovo'``, else sklearn's vote-based OvR
        transform of them (oao.ovr_from_ovo).
        """
        self._check_fitted()
        values = self._svm.predict_values(self._model, DataSet(np.asarray(X)))
        from .parameter import ClassificationType

        if values.ndim == 2:
            is_oao = self._model.classification == ClassificationType.OAO
            if is_oao and self._decision_function_shape == "ovr":
                from .oao import ovr_from_ovo

                return ovr_from_ovo(values, self._model.num_classes)
            if not is_oao and self._decision_function_shape == "ovo":
                # an OAA model has no pairwise machines to report — refuse
                # loudly rather than return (n, C) where sklearn semantics
                # promise (n, C(C-1)/2)
                raise AttributeError(
                    "decision_function_shape='ovo' requires a one-vs-one "
                    "model — fit with classification='oao'"
                )
        return values

    def score(self, X, y, sample_weight=None) -> float:
        """Accuracy; ``sample_weight`` gives the weighted accuracy (sklearn
        semantics — implemented; the reference raises)."""
        self._check_fitted()
        if sample_weight is None:
            return self._svm.score(
                self._model, DataSet(np.asarray(X), np.asarray(y))
            )
        sw = np.asarray(sample_weight, dtype=np.float64)
        correct = (
            self.predict(np.asarray(X)) == np.asarray(y)
        ).astype(np.float64)
        return float(np.average(correct, weights=sw))

    def predict_proba(self, X) -> np.ndarray:
        """(n, n_classes) class probabilities in ``classes_`` order.

        Implemented via Platt scaling (probability.py); requires
        ``probability=True`` at construction, like sklearn.  The reference
        raises unconditionally.
        """
        self._check_fitted()
        if not self._probability:
            raise AttributeError(
                "predict_proba is not available when probability=False"
            )
        from .probability import predict_probabilities

        values = self._svm.predict_values(self._model, DataSet(np.asarray(X)))
        return predict_probabilities(self._model, values)

    def predict_log_proba(self, X) -> np.ndarray:
        return np.log(self.predict_proba(X))

    # -- fitted attributes (sklearn.cpp:304-420) ---------------------------
    @property
    def classes_(self) -> np.ndarray:
        self._check_fitted()
        return np.asarray(self._data.different_labels)

    @property
    def fit_status_(self) -> int:
        self._check_fitted()
        return 0

    @property
    def n_features_in_(self) -> int:
        self._check_fitted()
        return self._data.num_features

    @property
    def support_(self) -> np.ndarray:
        """Indices of the support vectors in the CALLER's training X.

        All data points are support vectors in an exact LS-SVM fit; compact
        fits (max_sv/n_landmarks) report the surviving / landmark rows.
        Zero-weight-excluded rows are never SVs, and the indices map back
        through the exclusion to the X passed to ``fit`` (sklearn
        semantics).
        """
        self._check_fitted()
        if self._support_indices is not None:
            base = np.asarray(self._support_indices, dtype=np.int32)
        else:
            base = np.arange(self._model.num_support_vectors, dtype=np.int32)
        if self._kept_rows is not None:
            return np.asarray(self._kept_rows, dtype=np.int32)[base]
        return base

    @property
    def support_vectors_(self) -> np.ndarray:
        self._check_fitted()
        return self._model.support_vectors

    @property
    def n_support_(self) -> np.ndarray:
        """Per-class count of SVs with non-zero weight (sklearn.cpp:381-412)."""
        self._check_fitted()
        # count over the MODEL's own rows — compact fits (max_sv/n_landmarks)
        # keep fewer SVs than training points
        labels = self._model.data.labels
        weights = np.asarray(self._model.alpha)
        if weights.ndim == 2:  # multiclass: a point counts when any column != 0
            weights = np.any(weights != 0.0, axis=1)
        else:
            weights = weights != 0.0
        counts = []
        for lab in self._data.different_labels:
            counts.append(int(np.sum((labels == lab) & weights)))
        return np.asarray(counts, dtype=np.int32)

    @property
    def dual_coef_(self) -> np.ndarray:
        """(1, n_SV) alpha weights — (C, n_SV) one-vs-all rows for
        multiclass models (implemented; reference raises)."""
        self._check_fitted()
        alpha = np.asarray(self._model.alpha)
        return alpha.T if alpha.ndim == 2 else alpha[None, :]

    @property
    def intercept_(self) -> np.ndarray:
        """-rho, sklearn's intercept convention (implemented; ref raises)."""
        self._check_fitted()
        return -np.atleast_1d(np.asarray(self._model.rho, dtype=np.float64))

    @property
    def n_iter_(self) -> np.ndarray:
        """CG iterations of the fit (implemented; reference raises).

        Shape (1,) for binary/OAA fits; for one-vs-one multiclass the
        per-pair-machine counts in LIBSVM machine order — sklearn's own
        multiclass ``n_iter_`` convention (one entry per ovo machine).
        """
        self._check_fitted()
        per_machine = getattr(self._model, "n_iter_per_machine", None)
        if per_machine is not None:
            return np.asarray(per_machine, dtype=np.int32)
        iters = getattr(self._model, "n_iter", None)
        if iters is None:
            raise AttributeError("'SVC' object has no attribute 'n_iter_'")
        return np.asarray([iters], dtype=np.int32)

    @property
    def shape_fit_(self) -> tuple:
        self._check_fitted()
        if self._shape_fit is not None:
            return tuple(self._shape_fit)
        return (self._data.num_data_points, self._data.num_features)

    @property
    def class_weight_(self) -> np.ndarray:
        """Per-class regularization multipliers in classes_ order
        (implemented; the reference raises)."""
        self._check_fitted()
        classes = self.classes_
        if self._class_weight is None:
            return np.ones(len(classes))
        per_class = self._per_class_weight_map(np.asarray(self._data.labels))
        return np.asarray(
            [per_class.get(str(c), 1.0) for c in classes], dtype=np.float64
        )

    @property
    def coef_(self) -> np.ndarray:
        """Primal weight vector(s) for LINEAR-kernel fits (implemented; the
        reference raises).  sklearn shapes: (1, d) binary, (n_machines, d)
        for multiclass (OAA machines or OAO pair machines).  Non-linear
        kernels raise sklearn's own error message.
        """
        self._check_fitted()
        params = self._model.params
        from .parameter import KernelFunctionType

        if params.kernel_type.value != KernelFunctionType.LINEAR:
            raise AttributeError(
                "coef_ is only available when using a linear kernel"
            )
        alpha = np.asarray(self._model.alpha)
        sv = np.asarray(self._model.support_vectors)
        if self._model.classification.value == "oao" and alpha.ndim == 2:
            from .oao import model_weight_matrix

            # the same cached layout-order-aware expansion prediction uses
            alpha = model_weight_matrix(self._model)
        W = sv.T @ (alpha if alpha.ndim == 2 else alpha[:, None])
        return W.T  # (n_machines, d)

    @property
    def probA_(self) -> np.ndarray:
        """Platt-sigmoid slope(s) (implemented when probability=True)."""
        self._check_fitted()
        if getattr(self._model, "prob_a", None) is None:
            raise AttributeError(
                "'SVC' object has no attribute 'probA_' (fit with "
                "probability=True)"
            )
        return np.asarray(self._model.prob_a)

    @property
    def probB_(self) -> np.ndarray:
        """Platt-sigmoid intercept(s) (implemented when probability=True)."""
        self._check_fitted()
        if getattr(self._model, "prob_b", None) is None:
            raise AttributeError(
                "'SVC' object has no attribute 'probB_' (fit with "
                "probability=True)"
            )
        return np.asarray(self._model.prob_b)


#: sklearn.svm.SVR constructor parameters that do not apply to LS-SVR
#: (least-squares loss has no epsilon tube / nu fraction) or are
#: libsvm-internal — passing one raises AttributeError
_SVR_UNSUPPORTED = ("epsilon", "nu", "shrinking", "cache_size")

_SVR_KNOWN = (
    "C", "kernel", "degree", "gamma", "coef0", "tol", "verbose", "max_iter",
    "max_sv", "n_landmarks", "random_state", "device",
) + _SVR_UNSUPPORTED


class SVR:
    """Least-squares SVR with the sklearn.svm.SVR interface (EXTENSION).

    Neither the bundled reference nor upstream PLSSVM supports regression;
    LS-SVR is the natural one — the SAME linear system as the classifier
    with continuous targets (Suykens' least-squares formulation), so every
    solver path (the card's kernels, cg_explicit, sharding, checkpointing)
    applies unchanged.  Unlike sklearn.svm.SVR there is NO epsilon tube
    (squared loss on every residual): passing ``epsilon`` raises.

    Model files use LIBSVM's ``epsilon_svr`` layout — the prediction
    function is identical, so saved models predict identically under
    LIBSVM's own svm-predict.
    """

    _PARAM_DEFAULTS = {
        "C": 1.0,
        "kernel": "rbf",
        "degree": 3,
        "gamma": "auto",
        "coef0": 0.0,
        "tol": 1e-3,
        "verbose": False,
        "max_iter": -1,
        "max_sv": None,
        "n_landmarks": None,
        "random_state": None,
        "device": None,
    }

    def __init__(self, **kwargs):
        self._device = kwargs.get("device")
        self._svm = CSVM(dtype=kwargs.pop("dtype", np.float64), device=self._device)
        self._svm.set_params(kernel_type="rbf")  # sklearn SVR default
        self._epsilon_tol: Optional[float] = None
        self._max_iter: Optional[int] = None
        self._data: Optional[DataSet] = None
        self._model: Optional[Model] = None
        self._gamma_scale = False
        #: compact-model fits (sparse.py) — see SVC
        self._max_sv: Optional[int] = None
        self._n_landmarks: Optional[int] = None
        self._random_state: Optional[int] = None
        self._support_indices: Optional[np.ndarray] = None
        self._user_params: dict = {}
        self._parse_params(kwargs)

    def _parse_params(self, kwargs: dict) -> None:
        for key in kwargs:
            if key not in _SVR_KNOWN:
                raise AttributeError(
                    f"Invalid parameter '{key}' for the 'SVR' constructor!"
                )
        for key in _SVR_UNSUPPORTED:
            if key in kwargs:
                raise AttributeError(
                    f"The '{key}' parameter for a call to the 'SVR' "
                    "constructor is not implemented yet!"
                )
        self._user_params.update(kwargs)
        _rebuild_on_device(self, kwargs)
        if "C" in kwargs:
            self._svm.set_params(cost=float(kwargs["C"]))
        if "kernel" in kwargs:
            self._svm.set_params(kernel_type=kwargs["kernel"])
        if "degree" in kwargs:
            self._svm.set_params(degree=int(kwargs["degree"]))
        if "gamma" in kwargs:
            gamma = kwargs["gamma"]
            if gamma == "auto":
                self._gamma_scale = False
                # clear any previously-set numeric (or fit-resolved
                # 'scale') value so the 1/n_features default applies —
                # set_params would otherwise silently keep the old gamma
                # while get_params reports 'auto'
                self._svm.params.gamma.reset()
            elif gamma == "scale":
                self._gamma_scale = True
                self._svm.params.gamma.reset()
            else:
                self._gamma_scale = False
                self._svm.set_params(gamma=float(gamma))
        if "coef0" in kwargs:
            self._svm.set_params(coef0=float(kwargs["coef0"]))
        if "tol" in kwargs:
            self._epsilon_tol = float(kwargs["tol"])
        if "verbose" in kwargs:
            set_verbosity(
                VerbosityLevel.FULL if kwargs["verbose"] else VerbosityLevel.QUIET
            )
        if "max_iter" in kwargs:
            mi = int(kwargs["max_iter"])
            self._max_iter = None if mi == -1 else mi
        if "max_sv" in kwargs:
            v = kwargs["max_sv"]
            self._max_sv = None if v is None else int(v)
        if "n_landmarks" in kwargs:
            v = kwargs["n_landmarks"]
            self._n_landmarks = None if v is None else int(v)
        if "random_state" in kwargs:
            rs = kwargs["random_state"]
            self._random_state = None if rs is None else int(rs)

    def __sklearn_tags__(self):
        from sklearn.base import BaseEstimator, RegressorMixin

        class _TagDonor(RegressorMixin, BaseEstimator):
            pass

        return _TagDonor().__sklearn_tags__()

    def get_params(self, deep: bool = True) -> dict:
        out = dict(self._PARAM_DEFAULTS)
        out.update(self._user_params)
        return out

    def set_params(self, **kwargs) -> "SVR":
        self._parse_params(kwargs)
        return self

    def fit(self, X, y, sample_weight=None) -> "SVR":
        """``sample_weight`` is implemented: Suykens' weighted LS-SVM (the
        standard robust-regression reweighting uses exactly this hook)."""
        X = np.asarray(X, dtype=np.float64)
        self._data = DataSet(
            X, np.asarray(y, dtype=np.float64), regression=True
        )
        if self._gamma_scale:
            var = float(X.var())
            self._svm.set_params(
                gamma=1.0 / (X.shape[1] * var) if var > 0 else 1.0
            )
        sw = (
            np.asarray(sample_weight, dtype=np.float64)
            if sample_weight is not None
            else None
        )
        if self._max_sv is not None and self._n_landmarks is not None:
            raise AttributeError(
                "max_sv and n_landmarks are mutually exclusive!"
            )
        self._support_indices = None
        if self._n_landmarks is not None:
            from .sparse import nystroem_fit

            self._model, self._support_indices = nystroem_fit(
                self._svm, self._data,
                n_landmarks=self._n_landmarks,
                random_state=self._random_state or 0,
                sample_weight=sw, return_indices=True,
            )
            return self
        if self._max_sv is not None:
            from .sparse import pruned_fit

            self._model, self._support_indices = pruned_fit(
                self._svm, self._data,
                n_sv=self._max_sv,
                epsilon=(
                    self._epsilon_tol
                    if self._epsilon_tol is not None else 0.001
                ),
                max_iter=self._max_iter,
                sample_weight=sw, return_indices=True,
            )
            return self
        kwargs = {}
        if self._epsilon_tol is not None:
            kwargs["epsilon"] = self._epsilon_tol
        if self._max_iter is not None:
            kwargs["max_iter"] = self._max_iter
        if sw is not None:
            kwargs["sample_weight"] = sw
        self._model = self._svm.fit(self._data, **kwargs)
        return self

    def _check_fitted(self):
        if self._model is None:
            raise AttributeError(
                "This SVR instance is not fitted yet. Call 'fit' with "
                "appropriate arguments before using this estimator."
            )

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        return self._svm.predict(self._model, DataSet(np.asarray(X)))

    def score(self, X, y, sample_weight=None) -> float:
        """Coefficient of determination R^2 (the sklearn convention);
        ``sample_weight`` gives the weighted R^2."""
        self._check_fitted()
        if sample_weight is None:
            return self._svm.score(
                self._model,
                DataSet(
                    np.asarray(X), np.asarray(y, dtype=np.float64),
                    regression=True,
                ),
            )
        sw = np.asarray(sample_weight, dtype=np.float64)
        targets = np.asarray(y, dtype=np.float64)
        values = np.asarray(self.predict(np.asarray(X)), dtype=np.float64)
        ss_res = float(np.sum(sw * (targets - values) ** 2))
        mean = float(np.average(targets, weights=sw))
        ss_tot = float(np.sum(sw * (targets - mean) ** 2))
        if ss_tot == 0.0:
            return 1.0 if ss_res == 0.0 else 0.0
        return 1.0 - ss_res / ss_tot

    # -- fitted attributes --------------------------------------------------
    @property
    def n_features_in_(self) -> int:
        self._check_fitted()
        return self._data.num_features

    @property
    def support_(self) -> np.ndarray:
        self._check_fitted()
        if self._support_indices is not None:
            return np.asarray(self._support_indices, dtype=np.int32)
        return np.arange(self._model.num_support_vectors, dtype=np.int32)

    @property
    def support_vectors_(self) -> np.ndarray:
        self._check_fitted()
        return self._model.support_vectors

    @property
    def dual_coef_(self) -> np.ndarray:
        self._check_fitted()
        return np.asarray(self._model.alpha)[None, :]

    @property
    def intercept_(self) -> np.ndarray:
        self._check_fitted()
        return -np.atleast_1d(np.asarray(self._model.rho, dtype=np.float64))

    @property
    def coef_(self) -> np.ndarray:
        self._check_fitted()
        from .parameter import KernelFunctionType

        if self._model.params.kernel_type.value != KernelFunctionType.LINEAR:
            raise AttributeError(
                "coef_ is only available when using a linear kernel"
            )
        sv = np.asarray(self._model.support_vectors)
        return (sv.T @ np.asarray(self._model.alpha))[None, :]

    @property
    def n_iter_(self) -> np.ndarray:
        self._check_fitted()
        return np.asarray([self._model.n_iter or 0], dtype=np.int32)


#: sklearn.svm.OneClassSVM parameters that are libsvm-internal knobs with no
#: LS equivalent — passing one raises AttributeError
_OC_UNSUPPORTED = ("shrinking", "cache_size")

_OC_KNOWN = (
    "kernel", "degree", "gamma", "coef0", "tol", "nu", "verbose", "max_iter",
    "C", "max_sv", "n_landmarks", "random_state", "device",
) + _OC_UNSUPPORTED


class OneClassSVM:
    """Least-squares one-class SVM with the sklearn.svm.OneClassSVM
    interface (EXTENSION — novelty detection; one_class.py).

    ``nu`` keeps its sklearn/libsvm meaning of the training outlier
    fraction (realized here as the nu-quantile decision threshold rather
    than the nu-SVM margin program).  ``C`` (non-sklearn extension kwarg,
    default 1.0) is the ridge regularization of the underlying
    ``(K + I/C) alpha = 1`` solve — sklearn's OneClassSVM folds that role
    into nu, the least-squares formulation keeps them separate.
    """

    _PARAM_DEFAULTS = {
        "kernel": "rbf",
        "degree": 3,
        "gamma": "scale",
        "coef0": 0.0,
        "tol": 1e-3,
        "nu": 0.5,
        "verbose": False,
        "max_iter": -1,
        "C": 1.0,
        "max_sv": None,
        "n_landmarks": None,
        "random_state": None,
        "device": None,
    }

    def __init__(self, **kwargs):
        self._device = kwargs.get("device")
        self._svm = CSVM(dtype=kwargs.pop("dtype", np.float64), device=self._device)
        self._svm.set_params(kernel_type="rbf")
        self._nu = 0.5
        self._epsilon_tol: Optional[float] = None
        self._max_iter: Optional[int] = None
        self._data: Optional[DataSet] = None
        self._model: Optional[Model] = None
        self._gamma_scale = True  # sklearn's OneClassSVM default
        #: compact novelty models (sparse.py) — see SVC
        self._max_sv: Optional[int] = None
        self._n_landmarks: Optional[int] = None
        self._random_state: Optional[int] = None
        self._support_indices: Optional[np.ndarray] = None
        self._user_params: dict = {}
        self._parse_params(kwargs)

    def _parse_params(self, kwargs: dict) -> None:
        for key in kwargs:
            if key not in _OC_KNOWN:
                raise AttributeError(
                    f"Invalid parameter '{key}' for the 'OneClassSVM' "
                    "constructor!"
                )
        for key in _OC_UNSUPPORTED:
            if key in kwargs:
                raise AttributeError(
                    f"The '{key}' parameter for a call to the 'OneClassSVM' "
                    "constructor is not implemented yet!"
                )
        self._user_params.update(kwargs)
        _rebuild_on_device(self, kwargs)
        if "C" in kwargs:
            self._svm.set_params(cost=float(kwargs["C"]))
        if "kernel" in kwargs:
            self._svm.set_params(kernel_type=kwargs["kernel"])
        if "degree" in kwargs:
            self._svm.set_params(degree=int(kwargs["degree"]))
        if "gamma" in kwargs:
            gamma = kwargs["gamma"]
            if gamma == "scale":
                self._gamma_scale = True
                self._svm.params.gamma.reset()  # see SVC.set_params
            elif gamma == "auto":
                self._gamma_scale = False
                self._svm.params.gamma.reset()
            else:
                self._gamma_scale = False
                self._svm.set_params(gamma=float(gamma))
        if "coef0" in kwargs:
            self._svm.set_params(coef0=float(kwargs["coef0"]))
        if "tol" in kwargs:
            self._epsilon_tol = float(kwargs["tol"])
        if "nu" in kwargs:
            self._nu = float(kwargs["nu"])
        if "verbose" in kwargs:
            set_verbosity(
                VerbosityLevel.FULL if kwargs["verbose"] else VerbosityLevel.QUIET
            )
        if "max_iter" in kwargs:
            mi = int(kwargs["max_iter"])
            self._max_iter = None if mi == -1 else mi
        if "max_sv" in kwargs:
            v = kwargs["max_sv"]
            self._max_sv = None if v is None else int(v)
        if "n_landmarks" in kwargs:
            v = kwargs["n_landmarks"]
            self._n_landmarks = None if v is None else int(v)
        if "random_state" in kwargs:
            rs = kwargs["random_state"]
            self._random_state = None if rs is None else int(rs)

    def __sklearn_tags__(self):
        from sklearn.base import BaseEstimator, OutlierMixin

        class _TagDonor(OutlierMixin, BaseEstimator):
            pass

        return _TagDonor().__sklearn_tags__()

    def get_params(self, deep: bool = True) -> dict:
        out = dict(self._PARAM_DEFAULTS)
        out.update(self._user_params)
        return out

    def set_params(self, **kwargs) -> "OneClassSVM":
        self._parse_params(kwargs)
        return self

    def fit(self, X, y=None, sample_weight=None) -> "OneClassSVM":
        """``y`` is ignored (present for the sklearn pipeline contract).

        ``sample_weight`` is IMPLEMENTED (Suykens' weighted one-class —
        the solve becomes ``(K + diag(1/(C s_i))) a = 1``; sklearn's own
        OneClassSVM supports it too).
        """
        from .one_class import fit_one_class

        X = np.asarray(X, dtype=np.float64)
        self._data = DataSet(X)
        sw = (
            np.asarray(sample_weight, dtype=np.float64)
            if sample_weight is not None
            else None
        )
        if self._gamma_scale:
            var = float(X.var())
            self._svm.set_params(
                gamma=1.0 / (X.shape[1] * var) if var > 0 else 1.0
            )
        if self._max_sv is not None and self._n_landmarks is not None:
            raise AttributeError(
                "max_sv and n_landmarks are mutually exclusive!"
            )
        self._support_indices = None
        if self._n_landmarks is not None:
            from .sparse import nystroem_fit_one_class

            self._model, self._support_indices = nystroem_fit_one_class(
                self._svm, self._data,
                n_landmarks=self._n_landmarks, nu=self._nu,
                random_state=self._random_state or 0, sample_weight=sw,
                return_indices=True,
            )
            return self
        if self._max_sv is not None:
            from .sparse import pruned_fit_one_class

            self._model, self._support_indices = pruned_fit_one_class(
                self._svm, self._data,
                n_sv=self._max_sv, nu=self._nu,
                epsilon=(
                    self._epsilon_tol
                    if self._epsilon_tol is not None else 0.001
                ),
                max_iter=self._max_iter, sample_weight=sw,
                return_indices=True,
            )
            return self
        kwargs = {"nu": self._nu}
        if self._epsilon_tol is not None:
            kwargs["epsilon"] = self._epsilon_tol
        if self._max_iter is not None:
            kwargs["max_iter"] = self._max_iter
        if sw is not None:
            kwargs["sample_weight"] = sw
        self._model = fit_one_class(self._svm, self._data, **kwargs)
        return self

    def _check_fitted(self):
        if self._model is None:
            raise AttributeError(
                "This OneClassSVM instance is not fitted yet. Call 'fit' "
                "with appropriate arguments before using this estimator."
            )

    def predict(self, X) -> np.ndarray:
        """+1 inlier / -1 outlier (the sklearn/libsvm convention)."""
        self._check_fitted()
        return self._svm.predict(self._model, DataSet(np.asarray(X)))

    def fit_predict(self, X, y=None) -> np.ndarray:
        return self.fit(X).predict(X)

    def decision_function(self, X) -> np.ndarray:
        self._check_fitted()
        return self._svm.predict_values(self._model, DataSet(np.asarray(X)))

    def score_samples(self, X) -> np.ndarray:
        """Unshifted scores: ``decision_function(X) + offset_`` (sklearn)."""
        return self.decision_function(X) + self.offset_

    # -- fitted attributes --------------------------------------------------
    @property
    def offset_(self) -> float:
        self._check_fitted()
        return float(self._model.rho)

    @property
    def n_features_in_(self) -> int:
        self._check_fitted()
        return self._data.num_features

    @property
    def support_(self) -> np.ndarray:
        self._check_fitted()
        if self._support_indices is not None:
            return np.asarray(self._support_indices, dtype=np.int32)
        return np.arange(self._model.num_support_vectors, dtype=np.int32)

    @property
    def support_vectors_(self) -> np.ndarray:
        self._check_fitted()
        return self._model.support_vectors

    @property
    def dual_coef_(self) -> np.ndarray:
        self._check_fitted()
        return np.asarray(self._model.alpha)[None, :]

    @property
    def intercept_(self) -> np.ndarray:
        self._check_fitted()
        return -np.atleast_1d(np.asarray(self._model.rho, dtype=np.float64))

    @property
    def n_iter_(self) -> int:
        self._check_fitted()
        return int(self._model.n_iter)
