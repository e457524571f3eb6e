"""The per-entry check of the chi-squared kernels E-H: one-hot right-hand
sides make each output entry one value of K, held against the plain
version in float64 on the same values.  ``chip_smoke.py`` runs it at the
main paths' shapes and ``tests/test_torch_cuda.py`` on the cases of
:func:`entry_cases`."""

from __future__ import annotations

import numpy as np
import torch

from ..kernel_functions import pairwise_distance
from ..parameter import KernelFunctionType
from . import matvec

CHI2 = KernelFunctionType.CHI_SQUARED


def entry_cases(d: int, gen: torch.Generator, m: int = 300):
    """(name, X (m, d) float64, columns) of the per-entry check: rows in
    [0, 1) with about a third of the entries 0, one row all 0 and one with
    a single non-zero, as they are ("zero-rich"), scaled by 1e-18 and by
    1e12, and with a tenth of the non-zeros made 1e-40, which is subnormal
    in float32 ("subnormal"); columns holds the rows whose kernel columns
    are checked, the two special rows among them."""
    X = torch.rand(m, d, generator=gen, dtype=torch.float64)
    X[X < 0.33] = 0.0
    zero, single = m // 2, m // 3
    X[zero] = 0.0
    X[single] = 0.0
    X[single, d // 2] = 0.7
    columns = [zero, single, 0, 1, m - 1, 7, 11, 50, 101, 203, 250, 280]
    sub = X.clone()
    tiny = (torch.rand(m, d, generator=gen, dtype=torch.float64) < 0.1) & (sub > 0)
    sub[tiny] = 1e-40
    return (("zero-rich", X, columns), ("1e-18", X * 1e-18, columns),
            ("1e12", X * 1e12, columns), ("subnormal", sub, columns))


def chi2_gamma(X: torch.Tensor, columns) -> float:
    """1 / the mean chi-squared distance between the rows of X and the
    rows ``columns``, in float64, rounded to float32 (the value all the
    versions are given)."""
    Xd = X.double()
    return float(np.float32(1.0 / float(pairwise_distance(Xd, Xd[columns], CHI2).mean())))


def entry_errors(kernel, X: torch.Tensor, columns, gamma: float, *,
                 points=None, one_column: bool = False):
    """Worst relative error of an entry of K(points, X[columns]) (points
    default X) from ``kernel`` and from the plain version in X's type,
    each against the plain version in float64 on the same values:
    (kernel's, plain's).  The kernel gets one-hot right-hand sides, so each
    output entry is one kernel value: ``kernel(X, V)`` for a symmetric
    kernel (E, G; points None) or ``kernel(points, X, V)`` (F, H), V (m,
    C), or, with ``one_column``, one call per column with a vector e_j."""
    m, n = X.shape[0], len(columns)
    onehot = torch.zeros(m, n, dtype=X.dtype, device=X.device)
    onehot[columns, torch.arange(n, device=X.device)] = 1.0
    operands = (X,) if points is None else (points, X)
    rows = X if points is None else points
    kw = dict(kind=CHI2, gamma=gamma)
    if one_column:
        got = torch.stack([kernel(*operands, onehot[:, c].contiguous(), **kw)
                           for c in range(n)], dim=1)
    else:
        got = kernel(*operands, onehot, **kw)
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    plain = matvec.distance_matmat_rect_plain(rows, X[columns], eye, **kw)
    want = matvec.distance_matmat_rect_plain(rows.double(), X[columns].double(),
                                             eye.double(), **kw)
    plain_err = float(((plain.double() - want).abs() / want).max())
    if not torch.isfinite(got).all():
        return float("inf"), plain_err
    return float(((got.double() - want).abs() / want).max()), plain_err
