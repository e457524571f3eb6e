"""Probability calibration: Platt scaling of LS-SVM decision values, and
N-fold cross-validation.

Counterpart of plssvm_tpu/probability.py: NumPy host code around the port's
``CSVM.fit`` and ``predict_values``, whose fits and predicts run on the
card's kernels.  The LIBSVM-style pipeline:

1. **Cross-validated decision values**: stratified K-fold cross-validation
   (5 folds by default, as LIBSVM's ``svm_binary_svc_probability``) gives
   each point a decision value from a model that did not train on it.  The
   folds come from ``numpy.random.default_rng(random_state)`` exactly as
   plssvm_tpu draws them, so both packages cut the same folds.
2. **Sigmoid fit**: ``P(y=+1 | f) = 1 / (1 + exp(A f + B))`` with (A, B)
   from the regularized Newton iteration of Lin, Weng & Keerthi, "A note
   on Platt's probabilistic outputs for support vector machines" (Machine
   Learning 68, 2007).

One-vs-all models fit one sigmoid per class column and normalize the
per-class probabilities to sum to one (the sklearn OvR convention).
One-vs-one models follow LIBSVM: one sigmoid per pair machine, calibrated
on cross-validated decision values within that pair's rows, and class
probabilities by Wu/Lin/Weng pairwise coupling (``oao.pairwise_coupling``,
LIBSVM's ``multiclass_probability``).  Regression models get LIBSVM's
Laplace noise scale (:func:`calibrate_svr_noise`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fit_sigmoid(
    decision_values: np.ndarray,
    targets: np.ndarray,
    *,
    max_iter: int = 100,
    min_step: float = 1e-10,
    sigma: float = 1e-12,
    eps: float = 1e-5,
) -> Tuple[float, float]:
    """Fit ``P(y=+1 | f) = 1 / (1 + exp(A f + B))`` to (f, y) pairs.

    ``targets`` is boolean (True = positive class).  Returns (A, B).
    Newton's method with backtracking line search on the regularized
    cross-entropy objective (Lin/Weng/Keerthi 2007, Algorithm 1).
    """
    f = np.asarray(decision_values, dtype=np.float64).ravel()
    y = np.asarray(targets, dtype=bool).ravel()
    prior1 = float(np.sum(y))
    prior0 = float(len(y) - prior1)

    # soft targets with the Bayesian prior correction (Platt 1999 §2.2)
    hi = (prior1 + 1.0) / (prior1 + 2.0)
    lo = 1.0 / (prior0 + 2.0)
    t = np.where(y, hi, lo)

    def objective(A: float, B: float) -> float:
        z = A * f + B
        # -t*log(p) - (1-t)*log(1-p) with p = sigmoid(-z).  np.where
        # evaluates BOTH branches, so the overflowing exp of the
        # unselected branch would spam RuntimeWarnings on well-separated
        # data — the shared softplus term exp(-|z|) never overflows
        lin = np.where(z >= 0.0, t * z, (t - 1.0) * z)
        return float(np.sum(lin + np.log1p(np.exp(-np.abs(z)))))

    A = 0.0
    B = float(np.log((prior0 + 1.0) / (prior1 + 1.0)))
    fval = objective(A, B)

    for _ in range(max_iter):
        z = A * f + B
        # p = P(y=+1|f) = sigmoid(-z); q = 1 - p — both branches stable
        ez = np.exp(-np.abs(z))
        p = np.where(z >= 0, ez / (1.0 + ez), 1.0 / (1.0 + ez))
        q = 1.0 - p
        d2 = p * q
        h11 = float(np.dot(f * f, d2)) + sigma
        h22 = float(np.sum(d2)) + sigma
        h21 = float(np.dot(f, d2))
        d1 = t - p
        g1 = float(np.dot(f, d1))
        g2 = float(np.sum(d1))
        if abs(g1) < eps and abs(g2) < eps:
            break
        # Newton direction: solve the 2x2 system H d = -g
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= min_step:
            newA, newB = A + step * dA, B + step * dB
            newf = objective(newA, newB)
            if newf < fval + 1e-4 * step * gd:
                A, B, fval = newA, newB, newf
                break
            step /= 2.0
        else:
            break  # line search failed — accept the current point
    return A, B


def sigmoid_probability(
    decision_values: np.ndarray, A: float, B: float
) -> np.ndarray:
    """``P(y=+1 | f)`` under a fitted (A, B) sigmoid, computed stably."""
    z = A * np.asarray(decision_values, dtype=np.float64) + B
    ez = np.exp(-np.abs(z))
    return np.where(z >= 0, ez / (1.0 + ez), 1.0 / (1.0 + ez))


def stratified_folds(
    labels: np.ndarray, n_folds: int, rng: np.random.Generator
) -> np.ndarray:
    """Fold index per data point, stratified by class label.

    Each class's (shuffled) members are dealt round-robin over the folds, so
    every fold sees every class whenever the class has >= n_folds members.
    """
    labels = np.asarray(labels)
    fold_of = np.empty(len(labels), dtype=np.int32)
    for lab in np.unique(labels):
        idx = np.flatnonzero(labels == lab)
        rng.shuffle(idx)
        fold_of[idx] = np.arange(len(idx)) % n_folds
    return fold_of


def cross_validated_decision_values(
    csvm,
    data,
    *,
    n_folds: int = 5,
    random_state: Optional[int] = None,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    sample_weight=None,
    fit_fn=None,
) -> np.ndarray:
    """Out-of-fold decision values for every training point.

    Trains ``n_folds`` models, each on (n_folds - 1)/n_folds of ``data``,
    and evaluates each fold's points with the model that excluded them —
    LIBSVM's ``svm_binary_svc_probability`` scheme.  Returns (n,) for
    binary data, (n, C) for multiclass.

    ``fit_fn(fold_data, fold_sample_weight) -> Model`` replaces the fold
    fit: compact models (sparse.py ``compact_fold_fit_fn``) calibrate on
    compact folds, so the sigmoid reflects the deployed model's decision
    values, not the exact fit's.
    """
    from .data_set import DataSet

    X = np.asarray(data.data)
    labels = np.asarray(data.labels)
    n = len(labels)
    fold_of, n_folds = _fold_assignments(
        labels, n_folds, random_state, stratified=True
    )

    out: Optional[np.ndarray] = None
    for k in range(n_folds):
        train_idx = np.flatnonzero(fold_of != k)
        test_idx = np.flatnonzero(fold_of == k)
        if len(test_idx) == 0:
            continue
        fold_data = DataSet(X[train_idx], labels[train_idx])
        fold_sw = (
            np.asarray(sample_weight)[train_idx]
            if sample_weight is not None
            else None
        )
        if fit_fn is not None:
            model = fit_fn(fold_data, fold_sw)
        else:
            kwargs = {} if max_iter is None else {"max_iter": max_iter}
            if fold_sw is not None:
                # keep the -wi / sample weights in the CV subproblems, as
                # LIBSVM's svm_binary_svc_probability does
                kwargs["sample_weight"] = fold_sw
            model = csvm.fit(fold_data, epsilon=epsilon, **kwargs)
        vals = csvm.predict_values(model, DataSet(X[test_idx]))
        if out is None:
            out = np.zeros((n,) + vals.shape[1:], dtype=np.float64)
        out[test_idx] = vals
    return out


def _fold_assignments(targets, n_folds, random_state, *, stratified):
    """Per-point fold indices; the ONE implementation behind every CV loop
    in this module (calibration, SVR noise, -v mode)."""
    n = len(targets)
    if n_folds < 2:
        raise ValueError(f"n_folds must be at least 2, but is {n_folds}!")
    n_folds = min(n_folds, n)
    rng = np.random.default_rng(0 if random_state is None else random_state)
    if stratified:
        return stratified_folds(targets, n_folds, rng), n_folds
    return rng.permuted(np.arange(n) % n_folds), n_folds


def cross_validate(
    csvm,
    data,
    *,
    n_folds: int = 5,
    random_state: Optional[int] = None,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    classification: str = "oaa",
    sample_weight=None,
    fit_fn=None,
) -> dict:
    """N-fold cross-validation (svm-train's ``-v n`` mode; the C++
    reference has no CV support).

    Classification: stratified folds, out-of-fold label predictions,
    returns ``{"accuracy": float, "predictions": (n,) labels}``.
    Regression data (``DataSet(..., regression=True)``): plain folds,
    returns ``{"mse": float, "scc": float, "predictions": (n,) values}``
    (LIBSVM's mean squared error / squared correlation coefficient).

    ``fit_fn(fold_data, fold_sample_weight) -> Model`` replaces the fold
    fit, as in :func:`cross_validated_decision_values`: compact fits report
    their own accuracy (the CLI's ``--cross_validation`` with ``--max_sv``
    / ``--nystroem``).
    """
    from .data_set import DataSet

    X = np.asarray(data.data)
    targets = np.asarray(data.labels)
    n = len(targets)
    regression = bool(getattr(data, "is_regression", False))
    fold_of, n_folds = _fold_assignments(
        targets, n_folds, random_state, stratified=not regression
    )

    predictions = np.empty(n, dtype=targets.dtype)
    degenerate = []
    for k in range(n_folds):
        train_idx = np.flatnonzero(fold_of != k)
        test_idx = np.flatnonzero(fold_of == k)
        if len(test_idx) == 0:
            continue
        train_targets = targets[train_idx]
        if not regression and len(set(map(str, train_targets.tolist()))) < 2:
            # degenerate fold (a singleton class landed entirely in the
            # test split): the best trainable model is the constant
            # majority-class predictor — predict it rather than crashing
            vals, counts = np.unique(
                train_targets.astype(str), return_counts=True
            )
            maj = train_targets[
                np.flatnonzero(
                    train_targets.astype(str) == vals[np.argmax(counts)]
                )[0]
            ]
            predictions[test_idx] = maj
            degenerate.append(k)
            continue
        fold_data = DataSet(X[train_idx], train_targets, regression=regression)
        fold_sw = (
            np.asarray(sample_weight)[train_idx]
            if sample_weight is not None else None
        )
        if fit_fn is not None:
            model = fit_fn(fold_data, fold_sw)
        else:
            kwargs = {} if max_iter is None else {"max_iter": max_iter}
            if fold_sw is not None:
                kwargs["sample_weight"] = fold_sw
            if not regression:
                kwargs["classification"] = classification
            model = csvm.fit(fold_data, epsilon=epsilon, **kwargs)
        predictions[test_idx] = csvm.predict(model, DataSet(X[test_idx]))
    if degenerate:
        import warnings

        warnings.warn(
            f"cross_validate: fold(s) {degenerate} had fewer than two "
            "classes in their training split (singleton class) — their "
            "test points were scored by the constant majority predictor.",
            stacklevel=2,
        )

    if regression:
        t = targets.astype(np.float64)
        v = predictions.astype(np.float64)
        mse = float(np.mean((v - t) ** 2))
        vt, vv = t - t.mean(), v - v.mean()
        denom = float(np.sum(vt * vt) * np.sum(vv * vv))
        scc = float(np.sum(vt * vv)) ** 2 / denom if denom > 0 else 0.0
        return {"mse": mse, "scc": scc, "predictions": predictions}
    accuracy = float(np.mean(predictions == targets))
    return {"accuracy": accuracy, "predictions": predictions}


def calibrate_model(
    csvm,
    model,
    data,
    *,
    n_folds: int = 5,
    random_state: Optional[int] = None,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    sample_weight=None,
    fit_fn=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fit Platt sigmoid(s) for ``model`` and store them on it.

    Binary models get one (A, B) pair fitted to the positive-class
    indicator; one-vs-all multiclass models get per-class pairs fitted to
    each class's OvA column; one-vs-one models get per-machine pairs fitted
    on the pair's own rows (LIBSVM's scheme).  Sets ``model.prob_a`` /
    ``model.prob_b`` (one value per sigmoid: 1 binary, C one-vs-all,
    C(C-1)/2 one-vs-one) and returns them.  ``fit_fn`` replaces the
    cross-validation's fold fit (:func:`cross_validated_decision_values`);
    one-vs-one models calibrate their pair machines by fits of their own.
    """
    from .parameter import ClassificationType

    if getattr(model, "is_regression", False):
        # LIBSVM's -b 1 for regression: the Laplace noise scale, stored as
        # the lone probA header value (svm_svr_probability)
        calibrate_svr_noise(
            csvm, model, data,
            n_folds=n_folds, random_state=random_state,
            epsilon=epsilon, max_iter=max_iter,
            sample_weight=sample_weight, fit_fn=fit_fn,
        )
        return model.prob_a, model.prob_b
    if (
        model.classification == ClassificationType.OAO
        and np.ndim(model.alpha) == 2
    ):
        return _calibrate_model_oao(
            csvm, model, data,
            n_folds=n_folds, random_state=random_state,
            epsilon=epsilon, max_iter=max_iter,
            sample_weight=sample_weight,
        )
    labels = np.asarray(data.labels)
    _, class_counts = np.unique(labels.astype(str), return_counts=True)
    if int(class_counts.min()) < 2:
        # a singleton class cannot be stratified: every CV training split
        # either drops the class (LIBSVM pads such subproblems with fixed
        # decision values) or keeps no test point for it.  Fall back to
        # calibrating on the (already-fit) model's training decision values
        # — biased, but well-defined — and say so.
        import warnings

        warnings.warn(
            "probability calibration: a class has fewer than 2 samples, so "
            "cross-validation is impossible — calibrating on training-set "
            "decision values instead (optimistically biased).",
            stacklevel=2,
        )
        decisions = np.asarray(csvm.predict_values(model, data), np.float64)
    else:
        decisions = cross_validated_decision_values(
            csvm, data,
            n_folds=n_folds, random_state=random_state,
            epsilon=epsilon, max_iter=max_iter,
            sample_weight=sample_weight, fit_fn=fit_fn,
        )
    different = list(data.different_labels)
    if decisions.ndim == 1:
        # binary: positive class is different_labels[1] (the +1 mapping)
        positive = labels == different[1]
        A, B = fit_sigmoid(decisions, positive)
        # store (A, B) in the MODEL's own decision orientation: the CV
        # fold decisions follow the mapper (+1 = sorted different[1]),
        # but a loaded model whose header leads with the sorted-low class
        # produces NEGATED decision values — predict_probabilities reads
        # the sigmoid as P(label_order[0] | f_model), and
        # P(neg_m | -f_m) = sigma(A f_model - B), so the flip negates B
        label_order = getattr(model, "label_order", None)
        if label_order is not None and str(label_order[0]) != str(
            different[1]
        ):
            B = -B
        prob_a = np.asarray([A], dtype=np.float64)
        prob_b = np.asarray([B], dtype=np.float64)
    else:
        pairs = [
            fit_sigmoid(decisions[:, c], labels == lab)
            for c, lab in enumerate(different)
        ]
        prob_a = np.asarray([a for a, _ in pairs], dtype=np.float64)
        prob_b = np.asarray([b for _, b in pairs], dtype=np.float64)
    model.prob_a = prob_a
    model.prob_b = prob_b
    return prob_a, prob_b


def _calibrate_model_oao(
    csvm,
    model,
    data,
    *,
    n_folds: int = 5,
    random_state: Optional[int] = None,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    sample_weight=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pair-machine Platt calibration of a one-vs-one model.

    LIBSVM's svm_train pipeline: for each pair (i, j), cross-validate a
    binary machine on the pair's rows only and fit one sigmoid to its
    out-of-fold decision values.  probA/probB get C(C-1)/2 entries in
    machine order — byte-compatible with LIBSVM's ``-b 1`` model header.
    Each pair draws its folds as plssvm_tpu's ``cross_validated_decision_values``
    does.  Where the fit batches the pair machines (``csvm``'s
    ``_use_oao_batched``), the cross-validation does too: fold k's machines
    of every pair are one batched solve (:func:`_pairs_cv_decision_values`);
    else each pair's folds are fits of their own, as in plssvm_tpu.
    """
    from .data_set import DataSet
    from .oao import class_pairs, model_class_indices

    labels = np.asarray(data.labels)
    # machine enumeration follows the MODEL's layout class order (loaded
    # LIBSVM files may carry an unsorted label header)
    idx = model_class_indices(model, labels=labels)
    X = np.asarray(data.data)
    C = data.num_different_labels
    pairs = class_pairs(C)
    rows_list = [np.flatnonzero((idx == i) | (idx == j)) for (i, j) in pairs]
    first_list = [idx[rows] == i for (i, _), rows in zip(pairs, rows_list)]
    # a pair side with < 2 samples cannot be stratified: calibrate on the
    # fitted model's own decision column (biased), as the binary path does
    # for singleton classes
    biased = [m for m, first in enumerate(first_list)
              if int(first.sum()) < 2 or int((~first).sum()) < 2]
    cv = [m for m in range(len(pairs)) if m not in biased]
    vals = {}
    for m in biased:
        vals[m] = csvm.predict_values(model, DataSet(X[rows_list[m]]))[:, m]
    if cv and csvm._use_oao_batched(cv, [rows_list[m] for m in cv], X, None):
        vals.update(zip(cv, _pairs_cv_decision_values(
            csvm, X, [rows_list[m] for m in cv], [first_list[m] for m in cv],
            n_folds=n_folds, random_state=random_state, epsilon=epsilon,
            max_iter=max_iter, sample_weight=sample_weight)))
    else:
        for m in cv:
            rows = rows_list[m]
            vals[m] = cross_validated_decision_values(
                csvm, DataSet(X[rows], np.where(first_list[m], 1.0, -1.0)),
                n_folds=n_folds, random_state=random_state,
                epsilon=epsilon, max_iter=max_iter,
                sample_weight=(
                    None if sample_weight is None
                    else np.asarray(sample_weight)[rows]
                ),
            )
    prob_a = np.zeros(len(pairs), dtype=np.float64)
    prob_b = np.zeros(len(pairs), dtype=np.float64)
    for m, first in enumerate(first_list):
        prob_a[m], prob_b[m] = fit_sigmoid(vals[m], first)
    if biased:
        import warnings

        warnings.warn(
            "probability calibration: pair machine(s) "
            f"{[pairs[m] for m in biased]} have a class side with fewer than 2 "
            "samples — calibrated on training-set decision values instead "
            "(optimistically biased).",
            stacklevel=3,
        )
    model.prob_a = prob_a
    model.prob_b = prob_b
    return prob_a, prob_b


def _pairs_cv_decision_values(
    csvm, X, rows_list, first_list, *, n_folds, random_state, epsilon, max_iter,
    sample_weight,
):
    """Out-of-fold decision values of binary machines on row subsets of X:
    machine p on ``rows_list[p]``, +1 where ``first_list[p]``, each with the
    stratified folds that :func:`cross_validated_decision_values` draws for
    it.  Fold k of every machine is one batched solve
    (``csvm._solve_pair_machines``, kernel O on the card), each fold machine
    capped at its rows as a fit would be, and its held-out rows' decision
    values are one product of all of them (kernel D on the card), the
    machines' weights as the columns of a one-vs-all shadow model over the
    rows that any of them trained on.  Returns one (len(rows_list[p]),)
    array a machine.
    """
    from .data_set import DataSet
    from .model import Model

    params = csvm.params
    folds = [_fold_assignments(np.where(first, 1.0, -1.0), n_folds, random_state,
                               stratified=True)
             for first in first_list]
    out = [np.zeros(len(rows), dtype=np.float64) for rows in rows_list]
    for k in range(max(k_p for _, k_p in folds)):
        live = [p for p, (fold_of, _) in enumerate(folds) if np.any(fold_of == k)]
        train = [rows_list[p][folds[p][0] != k] for p in live]
        test = [rows_list[p][folds[p][0] == k] for p in live]
        caps = [len(t) if max_iter is None else int(max_iter) for t in train]
        alphas, rho, _, _ = csvm._solve_pair_machines(
            params, X, train, [first_list[p][folds[p][0] != k] for p in live],
            epsilon=epsilon, max_iter_b=caps,
            sample_weight=None if sample_weight is None else np.asarray(sample_weight))
        sv = np.unique(np.concatenate(train))
        W = np.zeros((len(sv), len(live)), dtype=csvm.dtype)
        for c, (rows, alpha) in enumerate(zip(train, alphas)):
            W[np.searchsorted(sv, rows), c] = alpha
        points = np.unique(np.concatenate(test))
        values = csvm.predict_values(Model(params, DataSet(X[sv]), alpha=W, rho=rho),
                                     DataSet(X[points]))
        for c, (p, rows) in enumerate(zip(live, test)):
            out[p][folds[p][0] == k] = values[np.searchsorted(points, rows), c]
    return out


def calibrate_svr_noise(
    csvm,
    model,
    data,
    *,
    n_folds: int = 5,
    random_state: Optional[int] = None,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    sample_weight=None,
    fit_fn=None,
) -> float:
    """LIBSVM's ``svr_probability``: the Laplace noise scale of a regression
    model from cross-validated residuals.

    Implements svm.cpp's ``svm_svr_probability``: 5-fold CV predictions,
    ``mae = mean |y - f(x)|`` with outliers beyond ``5 * std`` of the
    residual distribution removed and the count-corrected rescaling.  The
    value is stored on ``model.prob_a`` (one entry) — exactly where libsvm
    writes it in ``-b 1`` epsilon_svr model files — so it round-trips
    through the probA header line.  Test-point targets are then modeled as
    ``y ~ f(x) + Laplace(scale=sigma)``.
    """
    from .data_set import DataSet

    X = np.asarray(data.data)
    targets = np.asarray(data.labels, dtype=np.float64)
    n = len(targets)
    fold_of, n_folds = _fold_assignments(
        targets, max(2, n_folds), random_state, stratified=False
    )

    predicted = np.zeros(n, dtype=np.float64)
    covered = np.zeros(n, dtype=bool)
    for k in range(n_folds):
        train_idx = np.flatnonzero(fold_of != k)
        test_idx = np.flatnonzero(fold_of == k)
        if len(test_idx) == 0 or len(train_idx) < 2:
            continue
        fold_data = DataSet(X[train_idx], targets[train_idx], regression=True)
        fold_sw = (
            np.asarray(sample_weight)[train_idx]
            if sample_weight is not None
            else None
        )
        if fit_fn is not None:
            # compact fits take compact folds (cross_validated_decision_values)
            fold_model = fit_fn(fold_data, fold_sw)
        else:
            kwargs = {} if max_iter is None else {"max_iter": max_iter}
            if fold_sw is not None:
                kwargs["sample_weight"] = fold_sw
            fold_model = csvm.fit(fold_data, epsilon=epsilon, **kwargs)
        predicted[test_idx] = csvm.predict_values(
            fold_model, DataSet(X[test_idx])
        )
        covered[test_idx] = True

    if not covered.any():
        raise ValueError(
            "Too few points to cross-validate the SVR noise scale "
            f"(n = {n}) — need at least one fold with 2+ training points!"
        )
    # points whose fold was skipped have no out-of-fold prediction; a raw
    # target is NOT a residual, so they are excluded from the estimate
    residuals = (targets - predicted)[covered]
    # libsvm: drop residuals beyond 5 sigma, rescale the mean by the
    # retained fraction (svm.cpp svm_svr_probability)
    mae = float(np.mean(np.abs(residuals)))
    std = float(np.sqrt(2.0)) * mae  # Laplace: std = sqrt(2) * scale
    keep = np.abs(residuals) <= 5.0 * std
    count = int(np.sum(keep))
    if 0 < count < residuals.size:
        mae = float(np.sum(np.abs(residuals[keep]))) / count
    sigma = mae
    model.prob_a = np.asarray([sigma], dtype=np.float64)
    model.prob_b = None
    return sigma


def _to_sorted_columns(model, P: np.ndarray) -> np.ndarray:
    """Reorder multiclass probability columns from the model's LAYOUT
    order (decision-column order — the file's label-header order for
    loaded models) to SORTED label order, the library-wide column
    convention.  In-memory models have layout == sorted and pass through
    unchanged.
    """
    layout = [str(lab) for lab in model.class_order()]
    sorted_labels = [str(lab) for lab in model.data.different_labels]
    if layout == sorted_labels:
        return P
    perm = [layout.index(lab) for lab in sorted_labels]
    return P[:, perm]


def predict_probabilities(model, decision_values: np.ndarray, *,
                          columns: str = "sorted") -> np.ndarray:
    """(n, C) class-probability matrix from decision values.

    Binary: one sigmoid, ``P(class1)`` for ``class1`` the positive mapping.
    Multiclass OvA: per-class sigmoids normalized to sum to one (the
    sklearn OvR convention).  Multiclass OvO: per-machine sigmoids
    combined by Wu/Lin/Weng pairwise coupling (LIBSVM's svm_predict_
    probability).  The columns come in sorted label order (the
    library-wide convention), or with ``columns="layout"`` in the model's
    class order (:meth:`Model.class_order`: a model file's label header,
    svm-predict ``-b 1``'s columns).  Requires a calibrated model
    (:func:`calibrate_model`).
    """
    if getattr(model, "prob_a", None) is None:
        raise ValueError(
            "The model has no probability calibration — fit with "
            "probability enabled (plssvm-torch-train --probability) or call "
            "probability.calibrate_model first!"
        )
    if getattr(model, "is_regression", False):
        raise ValueError(
            "Regression models have no class probabilities — their probA "
            "value is the Laplace noise scale (y ~ f(x) + Laplace(sigma); "
            "probability.calibrate_svr_noise)."
        )
    from .parameter import ClassificationType

    values = np.asarray(decision_values)
    if values.ndim == 1:
        # the sigmoid gives P(f>0 class): the header's label[0] for
        # file-loaded models (libsvm's probA/probB convention), the
        # mapper's +1 label for models calibrated here
        p = sigmoid_probability(values, model.prob_a[0], model.prob_b[0])
        layout = [str(lab) for lab in model.class_order()]
        if getattr(model, "label_order", None) is not None:
            pos = str(model.label_order[0])
        else:
            pos = str(model.data.different_labels[1])
        P = np.empty((len(p), 2), dtype=np.float64)
        pos_col = layout.index(pos)
        P[:, pos_col] = p
        P[:, 1 - pos_col] = 1.0 - p
    elif model.classification == ClassificationType.OAO:
        from .oao import pairwise_coupling

        r = np.stack(
            [
                sigmoid_probability(
                    values[:, m], model.prob_a[m], model.prob_b[m]
                )
                for m in range(values.shape[1])
            ],
            axis=1,
        )
        P = pairwise_coupling(r, model.num_classes)
    else:
        cols = [
            sigmoid_probability(values[:, c], model.prob_a[c], model.prob_b[c])
            for c in range(values.shape[1])
        ]
        P = np.stack(cols, axis=1)
        total = np.sum(P, axis=1, keepdims=True)
        # degenerate all-zero rows (cannot happen with finite sigmoids) guard
        P = P / np.where(total > 0, total, 1.0)
    return P if columns == "layout" else _to_sorted_columns(model, P)
