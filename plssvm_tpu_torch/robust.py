"""Robust LS-SVR: iteratively reweighted fits.

Counterpart of plssvm_tpu/robust.py: the weighting of Suykens, De
Brabanter, Lukas & Vandewalle, "Weighted least squares support vector
machines: robustness and sparse approximation" (Neurocomputing 48, 2002).
The squared loss makes plain LS-SVR sensitive to outliers; refitting with
per-sample weights from the previous fit's residuals restores robustness.

Per iteration, with residuals ``e_k = y_k - f(x_k)`` and the robust scale
``s_hat = IQR(e) / 1.349``, each sample's weight is the paper's piecewise
score:

    v_k = 1                              if |e_k / s_hat| <= c1
    v_k = (c2 - |e_k / s_hat|)/(c2 - c1) if c1 < |e_k / s_hat| <= c2
    v_k = 1e-4                           otherwise   (outlier: ~ignored)

with c1 = 2.5, c2 = 3.0.  Each refit is the port's ``CSVM.fit`` with
``sample_weight`` (``1/(C v_k)`` on the diagonal) warm-started from the
previous alpha (``initial_model``); with ``solver='cg_explicit'`` the
kernel matrix cached on the data set serves every refit (it does not
depend on the weights).  NumPy host code around the card's fits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def hampel_weights(
    residuals: np.ndarray, *, c1: float = 2.5, c2: float = 3.0,
    floor: float = 1e-4,
) -> np.ndarray:
    """Per-sample robustness weights from fit residuals (Suykens 2002)."""
    e = np.asarray(residuals, dtype=np.float64)
    q75, q25 = np.percentile(e, [75.0, 25.0])
    s_hat = (q75 - q25) / 1.349
    if s_hat <= 0.0:
        # a zero IQR (an exactly-interpolated majority) must not disable
        # robustness — fall back to the MAD scale, then to mean |e|
        med = np.median(e)
        s_hat = 1.4826 * float(np.median(np.abs(e - med)))
    if s_hat <= 0.0:
        s_hat = float(np.mean(np.abs(e)))
    if s_hat <= 0.0:
        return np.ones_like(e)  # all residuals are exactly zero
    z = np.abs(e / s_hat)
    w = np.ones_like(e)
    mid = (z > c1) & (z <= c2)
    w[mid] = (c2 - z[mid]) / (c2 - c1)
    w[z > c2] = floor
    return np.maximum(w, floor)


def reweighted_fit(
    csvm,
    data,
    *,
    iterations: int = 2,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    c1: float = 2.5,
    c2: float = 3.0,
):
    """Robust LS-SVR: plain fit, then ``iterations`` reweighted refits.

    ``data`` must be a regression DataSet (``DataSet(..., regression=True)``).
    Returns the final (weighted) Model.  Composes the framework's
    primitives: weighted solves (1/(C v_k) regularizers), warm starts, and
    the cost-independent explicit kernel-matrix cache.
    """
    from .exceptions import InvalidParameterError

    if not getattr(data, "is_regression", False):
        raise InvalidParameterError(
            "reweighted_fit expects a regression DataSet "
            "(DataSet(..., regression=True)) — for classification, pass "
            "class/sample weights to fit directly!"
        )
    if iterations < 1:
        raise InvalidParameterError(
            f"iterations must be at least 1, but is {iterations}!"
        )
    kwargs = {} if max_iter is None else {"max_iter": max_iter}
    model = csvm.fit(data, epsilon=epsilon, **kwargs)
    targets = np.asarray(data.labels, dtype=np.float64)
    for _ in range(iterations):
        # predict_values ignores labels — the training DataSet serves as
        # the prediction points without copying the matrix
        residuals = targets - np.asarray(
            csvm.predict_values(model, data), dtype=np.float64
        )
        weights = hampel_weights(residuals, c1=c1, c2=c2)
        model = csvm.fit(
            data, epsilon=epsilon, sample_weight=weights,
            initial_model=model, **kwargs,
        )
    return model
