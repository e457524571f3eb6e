"""One-vs-one (OAO) multiclass prediction: the LIBSVM coefficient layout and
pairwise voting.

Counterpart of plssvm_tpu/oao.py (numpy only), with what prediction needs.
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
matmat ``K(points, SV) @ W - rho`` (kernel D on the card).  Training the
pair machines is not ported yet (ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

from typing import List, Tuple

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


def model_class_indices(model) -> np.ndarray:
    """Class indices of the model's SV labels in its LAYOUT order.

    The layout order is ``model.class_order()`` — the file's label-header
    order for loaded models (LIBSVM writes it in appearance order, not
    sorted).  Machine enumeration, sv_coef columns and rho entries are all
    defined against it.
    """
    order = model.class_order()
    labels = np.asarray(model.data.labels)
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
