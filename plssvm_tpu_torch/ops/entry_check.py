"""The per-entry check of the chi-squared kernels E-H: one-hot right-hand
sides make each output entry one value of K, held against a reference on
the same values: the plain version in float64 for float32 operands, the
same function in long double (numpy) for float64 ones.  ``chip_smoke.py``
runs it at the main paths' shapes and ``tests/test_torch_cuda.py`` on the
cases of :func:`entry_cases`.  :func:`chi2_f64_in_range` says whether
float64 operands take the kernels' divide-free quotient on every chunk."""

from __future__ import annotations

import numpy as np
import torch

from ..kernel_functions import pairwise_distance
from ..parameter import KernelFunctionType
from . import matvec

CHI2 = KernelFunctionType.CHI_SQUARED

#: the binary exponents of the non-zero float64 values for which kernels
#: E-H, L and M compute a chi-squared term without a divide (csrc/gram_tile.cuh
#: kChi2F64MinExponent, kChi2F64MaxExponent): 2^-433 <= |v| < 2^511; a
#: staged chunk holding any other non-zero value takes the IEEE divide
CHI2_F64_EXPONENTS = (-433, 510)


def chi2_f64_in_range(X: torch.Tensor) -> bool:
    """Whether every value of X is 0 or has its binary exponent in
    :data:`CHI2_F64_EXPONENTS` (no infinity, NaN or subnormal): then every
    chunk of a float64 chi-squared kernel on X takes the divide-free pass."""
    values = X.detach().double().abs().flatten()
    nonzero = values[values != 0]
    if not bool(torch.isfinite(nonzero).all()):
        return False
    exponents = torch.frexp(nonzero).exponent - 1  # 2^e <= |v| < 2^(e + 1)
    lo, hi = CHI2_F64_EXPONENTS
    return bool(((exponents >= lo) & (exponents <= hi)).all())


def entry_cases(d: int, gen: torch.Generator, m: int = 300, *,
                out_of_range: bool = False):
    """(name, X (m, d) float64, columns) of the per-entry check: rows in
    [0, 1) with about a third of the entries 0, one row all 0 and one with
    a single non-zero, as they are ("zero-rich"), scaled by 1e-18 and by
    1e12, and with a tenth of the non-zeros made 1e-40, which is subnormal
    in float32 ("subnormal"); columns holds the rows whose kernel columns
    are checked, the two special rows among them.  With ``out_of_range``
    three float64 cases follow, outside the range of
    :func:`chi2_f64_in_range`: the zero-rich rows scaled by 1e-200 (every
    diff^2 underflows to 0) and by 1e200 (every non-zero diff^2
    overflows), and "mixed", the features of every second 16-feature chunk
    (the kernels' staging chunk), the first among them, scaled by 1e-200,
    so that a row's chunks fall out of and into the range by turns."""
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
    cases = (("zero-rich", X, columns), ("1e-18", X * 1e-18, columns),
             ("1e12", X * 1e12, columns), ("subnormal", sub, columns))
    if not out_of_range:
        return cases
    mixed = X.clone()
    for k0 in range(0, d, 32):
        mixed[:, k0:k0 + 16] *= 1e-200
    return cases + (("1e-200", X * 1e-200, columns), ("1e200", X * 1e200, columns),
                    ("mixed", mixed, columns))


def _chi2_longdouble(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The chi-squared distances between the rows and the columns, (rows,
    columns), in long double: no square of a float64 value over- or
    underflows there."""
    rows, cols = rows.astype(np.longdouble), cols.astype(np.longdouble)
    out = np.empty((len(rows), len(cols)), dtype=np.longdouble)
    for j, col in enumerate(cols):
        diff, den = rows - col, rows + col
        safe = np.where(den != 0, den, np.longdouble(1))
        out[:, j] = np.where(den != 0, diff * diff / safe, np.longdouble(0)).sum(axis=1)
    return out


def chi2_gamma(X: torch.Tensor, columns) -> float:
    """1 / the mean chi-squared distance between the rows of X and the
    rows ``columns`` (the value all the versions are given): for float32 X
    in float64, rounded to float32; for float64 X in long double, rounded
    to float64, so that rows scaled to 1e-200 or 1e200 still get a finite,
    non-zero gamma."""
    if X.dtype == torch.float64:
        Xn = X.cpu().numpy()
        return float(1 / _chi2_longdouble(Xn, Xn[columns]).mean())
    Xd = X.double()
    return float(np.float32(1.0 / float(pairwise_distance(Xd, Xd[columns], CHI2).mean())))


def entry_errors(kernel, X: torch.Tensor, columns, gamma: float, *,
                 points=None, one_column: bool = False):
    """Worst relative error of an entry of K(points, X[columns]) (points
    default X) from ``kernel`` and from the plain version in X's type,
    each against a reference on the same values: (kernel's, plain's).  The
    reference is the plain version in float64 for float32 X, and for
    float64 X the same function in long double (``exp(-gamma * dist)``
    with ``dist`` from :func:`_chi2_longdouble`).  The kernel gets one-hot
    right-hand sides, so each output entry is one kernel value:
    ``kernel(X, V)`` for a symmetric kernel (E, G; points None) or
    ``kernel(points, X, V)`` (F, H), V (m, C), or, with ``one_column``,
    one call per column with a vector e_j."""
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
    if X.dtype == torch.float64:
        dist = _chi2_longdouble(rows.cpu().numpy(), X[columns].cpu().numpy())
        want = np.exp(-np.longdouble(gamma) * dist)

        def err(values):
            return float(np.max(np.abs(values.cpu().numpy().astype(np.longdouble) - want)
                                / want))
    else:
        want = matvec.distance_matmat_rect_plain(rows.double(), X[columns].double(),
                                                 eye.double(), **kw)

        def err(values):
            return float(((values.double() - want).abs() / want).max())
    plain_err = err(plain)
    if not torch.isfinite(got).all():
        return float("inf"), plain_err
    return err(got), plain_err
