"""One-vs-one (OAO) multiclass machinery: the LIBSVM coefficient layout,
the scatter of a trained pair machine into it, pairwise voting, sklearn's
OvR transform of the pair decisions (sklearn.py) and the pairwise coupling
of calibrated machines (probability.py).

Counterpart of plssvm_tpu/oao.py (numpy only), with what training and
prediction need.
The OAO model layout is the standard LIBSVM multiclass format, so model
files written by LIBSVM's svm-train or by plssvm_tpu score here:

- machines are the C(C-1)/2 class pairs (i, j), i < j, in LIBSVM order:
  (0,1), (0,2), ..., (0,C-1), (1,2), ...; ``rho`` holds one value per
  machine in that order;
- each SV row stores C-1 coefficients (``sv_coef``): for an SV of class c,
  column k holds its dual coefficient in the machine (c vs k) when k < c and
  (c vs k+1) when k >= c;
- the decision value of machine (i, j) is
  ``f_ij(x) = sum_{p in class i} sv_coef[p, j-1] k(x_p, x)
            + sum_{p in class j} sv_coef[p, i]   k(x_p, x) - rho_ij``,
  and it votes for i when f_ij > 0 (ties in the vote count resolve to the
  lowest class index, as in LIBSVM's svm_predict).

Prediction never loops over machines: ``weight_matrix`` expands sv_coef into
a dense (n_sv, n_machines) block, so all machines evaluate as one kernel
matmat ``K(points, SV) @ W - rho`` (kernel D on the card).  Training
(csvm.py ``_fit_oao``) solves each pair machine on its class-pair rows and
writes its coefficients with :func:`scatter_pair_alphas`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def num_machines(n_classes: int) -> int:
    """C(C-1)/2 pairwise machines."""
    return n_classes * (n_classes - 1) // 2


def class_pairs(n_classes: int) -> List[Tuple[int, int]]:
    """Machine enumeration in LIBSVM order: (0,1), (0,2), ..., (1,2), ..."""
    return [
        (i, j)
        for i in range(n_classes)
        for j in range(i + 1, n_classes)
    ]


def coef_column(sv_class: int, other_class: int) -> int:
    """The sv_coef column holding an SV's coefficient for (sv_class vs other).

    LIBSVM layout: an SV of class c keeps its C-1 machine coefficients in
    ascending order of the opposing class, skipping its own class.
    """
    if other_class == sv_class:
        raise ValueError("an SV has no machine against its own class")
    return other_class if other_class < sv_class else other_class - 1


def scatter_pair_alphas(
    sv_coef: np.ndarray,
    rows: np.ndarray,
    row_is_first: np.ndarray,
    alpha: np.ndarray,
    i: int,
    j: int,
) -> None:
    """Write one pair machine's dual coefficients into the sv_coef block.

    ``rows`` are the global row indices of the (i, j) subproblem in original
    training order, ``row_is_first`` flags membership of class ``i`` (the +1
    side), ``alpha`` is the subproblem's (n_ij,) solution.
    """
    sv_coef[rows[row_is_first], coef_column(i, j)] = alpha[row_is_first]
    sv_coef[rows[~row_is_first], coef_column(j, i)] = alpha[~row_is_first]


def weight_matrix(
    sv_coef: np.ndarray, class_indices: np.ndarray, n_classes: int
) -> np.ndarray:
    """Dense (n_sv, n_machines) weight block W for one-shot OAO prediction.

    ``W[p, m]`` is SV p's coefficient in machine m — sv_coef[p, j-1] for SVs
    of class i, sv_coef[p, i] for SVs of class j, zero otherwise.
    """
    sv_coef = np.asarray(sv_coef)
    class_indices = np.asarray(class_indices)
    n_sv = sv_coef.shape[0]
    W = np.zeros((n_sv, num_machines(n_classes)), dtype=sv_coef.dtype)
    for m, (i, j) in enumerate(class_pairs(n_classes)):
        in_i = class_indices == i
        in_j = class_indices == j
        W[in_i, m] = sv_coef[in_i, coef_column(i, j)]
        W[in_j, m] = sv_coef[in_j, coef_column(j, i)]
    return W


def model_class_indices(model, labels=None) -> np.ndarray:
    """Class indices of label rows in the model's LAYOUT order.

    The layout order is ``model.class_order()`` — the file's label-header
    order for loaded models (LIBSVM writes it in appearance order, not
    sorted).  Machine enumeration, sv_coef columns and rho entries are all
    defined against it.  ``labels`` defaults to the model's own SV labels;
    another label array (a calibration set's) is indexed in the same
    layout.
    """
    order = model.class_order()
    labels = np.asarray(model.data.labels if labels is None else labels)
    idx = np.full(len(labels), -1, dtype=np.int64)
    for c, lab in enumerate(order):
        idx[labels == lab] = c
    if (idx < 0).any():
        raise ValueError("labels outside the model's class order")
    return idx


def model_weight_matrix(model) -> np.ndarray:
    """The dense (n_sv, n_machines) OAO weight block for ``model``, cached
    on the model and keyed on its alpha object, so a replaced sv_coef block
    never serves a stale expansion."""
    cached = getattr(model, "_oao_weights", None)
    if cached is not None and cached[0] is model.alpha:
        return cached[1]
    W = weight_matrix(
        np.asarray(model.alpha), model_class_indices(model),
        model.num_classes,
    )
    model._oao_weights = (model.alpha, W)
    return W


def vote(decision_values: np.ndarray, n_classes: int) -> np.ndarray:
    """(n_pred,) class indices from (n_pred, n_machines) OAO decisions.

    Machine (i, j) votes i when its decision value is positive, j otherwise
    (sign(0) votes j, matching LIBSVM's ``dec_values[pos] > 0`` test).  The
    argmax tie-break picks the lowest class index, as LIBSVM's strict
    ``vote[i] > vote[max]`` scan does.
    """
    values = np.asarray(decision_values)
    n_pred = values.shape[0]
    votes = np.zeros((n_pred, n_classes), dtype=np.int32)
    for m, (i, j) in enumerate(class_pairs(n_classes)):
        positive = values[:, m] > 0
        votes[:, i] += positive
        votes[:, j] += ~positive
    return np.argmax(votes, axis=1)


def ovr_from_ovo(decision_values: np.ndarray, n_classes: int) -> np.ndarray:
    """sklearn's (n, C) OvR transform of OvO decisions.

    sklearn.utils.multiclass._ovr_decision_function: per-class vote counts
    plus the sum of raw confidences squashed into (-1/3, 1/3), which breaks
    vote ties without ever reordering them.  An exactly-zero decision votes
    class i, as in sklearn (``dec < 0`` is False at 0); :func:`vote` keeps
    LIBSVM's opposite convention.
    """
    values = np.asarray(decision_values, dtype=np.float64)
    n_pred = values.shape[0]
    votes = np.zeros((n_pred, n_classes))
    sums = np.zeros((n_pred, n_classes))
    for m, (i, j) in enumerate(class_pairs(n_classes)):
        col = values[:, m]
        positive = col >= 0
        votes[:, i] += positive
        votes[:, j] += ~positive
        sums[:, i] += col
        sums[:, j] -= col
    scaled = sums / (3.0 * (np.abs(sums) + 1.0))
    return votes + scaled


def pairwise_coupling(
    pair_probs: np.ndarray, n_classes: int, *,
    max_iter: Optional[int] = None, eps: Optional[float] = None,
) -> np.ndarray:
    """(n, C) class probabilities from (n, n_machines) pairwise estimates
    (plssvm_tpu's ``pairwise_coupling``).

    The second method of Wu, Lin & Weng, "Probability Estimates for
    Multi-class Classification by Pairwise Coupling" (JMLR 5, 2004), the
    algorithm of LIBSVM's ``multiclass_probability``: minimize
    ``sum_ij (r_ji p_i - r_ij p_j)^2`` over the simplex by the fixed-point
    iteration on ``Q p = p^T Q p``.  ``pair_probs[:, m]`` is r_ij = P(class
    i | class i or j) for machine m = (i, j) in LIBSVM order.
    """
    r = np.clip(np.asarray(pair_probs, dtype=np.float64), 1e-7, 1.0 - 1e-7)
    n = r.shape[0]
    C = n_classes
    if max_iter is None:
        max_iter = max(100, C)  # LIBSVM: max_iter = max(100, k)
    if eps is None:
        eps = 0.005 / C  # LIBSVM's multiclass_probability default
    R = np.zeros((n, C, C))
    for m, (i, j) in enumerate(class_pairs(C)):
        R[:, i, j] = r[:, m]
        R[:, j, i] = 1.0 - r[:, m]
    # Q[t] = sum_{j != t} R[j, t]^2 on the diagonal, -R[j, t] R[t, j] off it
    Q = np.zeros((n, C, C))
    for t in range(C):
        Q[:, t, t] = np.sum(R[:, :, t] ** 2, axis=1)
        for j in range(C):
            if j != t:
                Q[:, t, j] = -R[:, j, t] * R[:, t, j]
    p = np.full((n, C), 1.0 / C)
    for _ in range(max_iter):
        Qp = np.einsum("ntj,nj->nt", Q, p)
        pQp = np.einsum("nt,nt->n", p, Qp)
        if np.all(np.max(np.abs(Qp - pQp[:, None]), axis=1) < eps):
            break
        for t in range(C):
            diff = (-Qp[:, t] + pQp) / Q[:, t, t]
            p[:, t] += diff
            # LIBSVM's recurrence: add diff to p[t], then renormalise
            # everything by 1 + diff
            pQp = (pQp + diff * (diff * Q[:, t, t] + 2.0 * Qp[:, t])) / (1.0 + diff) ** 2
            Qp = (Qp + diff[:, None] * Q[:, t, :]) / (1.0 + diff)[:, None]
            p = p / (1.0 + diff)[:, None]
    return p
