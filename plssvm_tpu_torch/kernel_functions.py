"""The SVM kernel functions, as epilogues over Gram and distance blocks
(PyTorch).

reference: include/plssvm/kernel_function_types.hpp:75-97 —
linear ``u.v``; polynomial ``(gamma*u.v + coef0)^degree``;
rbf ``exp(-gamma*|u-v|^2)``; sigmoid ``tanh(gamma*u.v + coef0)``;
laplacian ``exp(-gamma*|u-v|_1)``; chi-squared
``exp(-gamma*sum_k (u_k-v_k)^2/(u_k+v_k))`` (the last three are extensions
matching upstream PLSSVM v3).  Counterpart of plssvm_tpu/kernel_functions.py,
with the same formulas in the same order so that both packages round alike.

- **Gram kernels** (linear / polynomial / rbf / sigmoid): a Gram block
  ``G = X_i @ X_j^T`` is one matrix product and the kernel is applied
  elementwise, using ``|u-v|^2 = |u|^2 + |v|^2 - 2 u.v`` for RBF.  The
  hand-written CUDA kernels (csrc/gram_matvec.cu, gram_matmat.cu) apply the
  same epilogue to the tile they hold in registers.
- **Distance kernels** (laplacian / chi-squared): the L1 / chi-squared
  distance does not factor through a matrix product, so a distance block is
  a broadcast reduction over pairs and features (:func:`pairwise_distance`),
  tiled so its temporaries stay bounded, then ``exp(-gamma * dist)``.
  Chi-squared takes ``0/0`` as 0 with a select, as plssvm_tpu does, so
  features where both operands are 0 add nothing.  The CUDA kernels
  (csrc/distance.cu) run the same pair operation in their register tile.
"""

from __future__ import annotations

import numpy as np
import torch

from .parameter import KernelFunctionType, Parameter

#: kernels over a non-Euclidean pairwise distance (no Gram factorisation)
DISTANCE_KERNELS = frozenset(
    {KernelFunctionType.LAPLACIAN, KernelFunctionType.CHI_SQUARED}
)


def apply_kernel_to_gram(
    gram: torch.Tensor,
    sq_row,
    sq_col,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
) -> torch.Tensor:
    """Apply a *Gram* kernel elementwise to a Gram block.

    ``gram[i, j] = x_i . x_j``; ``sq_row`` / ``sq_col`` are the squared norms
    broadcast along rows / columns (only used by RBF).  ``degree`` is raised
    by repeated squaring, like the reference's ``std::pow`` with an integer
    exponent (kernel_function_types.hpp:86).
    """
    if kind == KernelFunctionType.LINEAR:
        return gram
    if kind == KernelFunctionType.POLYNOMIAL:
        base = gamma * gram + coef0
        return _integer_power(base, degree)
    if kind == KernelFunctionType.RBF:
        sq_dist = sq_row + sq_col - 2.0 * gram
        return torch.exp(-gamma * sq_dist)
    if kind == KernelFunctionType.SIGMOID:
        return torch.tanh(gamma * gram + coef0)
    raise ValueError(f"kernel function type {kind!r} is not Gram-expressible")


def kernel_self_diag(
    sq_norms: torch.Tensor,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
) -> torch.Tensor:
    """``k(x, x)`` from squared norms — the kernel-matrix diagonal.

    Used for ``QA_cost = k(x_last, x_last) + 1/C`` (reference:
    gpu_csvm.hpp:508).  Every distance kernel has ``k(x, x) = exp(0) = 1``.
    """
    if kind == KernelFunctionType.LINEAR:
        return sq_norms
    if kind == KernelFunctionType.POLYNOMIAL:
        return _integer_power(gamma * sq_norms + coef0, degree)
    if kind == KernelFunctionType.SIGMOID:
        return torch.tanh(gamma * sq_norms + coef0)
    # RBF / LAPLACIAN / CHI_SQUARED: k(x, x) = 1
    return torch.ones_like(sq_norms)


def _integer_power(base: torch.Tensor, degree: int) -> torch.Tensor:
    """x**degree by repeated squaring for an integer degree."""
    if degree < 0:
        return 1.0 / _integer_power(base, -degree)
    if degree == 0:
        return torch.ones_like(base)
    result = None
    acc = base
    n = degree
    while n > 0:
        if n & 1:
            result = acc if result is None else result * acc
        acc = acc * acc
        n >>= 1
    return result


def kernel_block(
    Xb: torch.Tensor,
    Y: torch.Tensor,
    sq_row: torch.Tensor,
    sq_col: torch.Tensor,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
) -> torch.Tensor:
    """Dense kernel block ``K[i, j] = k(Xb_i, Y_j)`` -> (b, m).

    Gram kernels: one matrix product plus the epilogue.  Distance kernels:
    the tiled pairwise distance plus ``exp`` (``sq_row`` / ``sq_col`` are
    not read and may be None).  The block primitive behind the plain matvec
    and predict versions (ops/matvec.py).
    """
    if kind in DISTANCE_KERNELS:
        return torch.exp(-gamma * pairwise_distance(Xb, Y, kind))
    gram = Xb @ Y.T
    return apply_kernel_to_gram(
        gram, sq_row[:, None], sq_col[None, :], kind, gamma, coef0, degree
    )


def kernel_function(u, v, params: Parameter, num_features=None) -> float:
    """Evaluate ``k(u, v)`` for single vectors (host-side convenience).

    reference: kernel_function_types.hpp:114-115 (runtime-dispatched
    kernel_function used for QA_cost on the host, gpu_csvm.hpp:508).
    """
    u = np.asarray(u)
    v = np.asarray(v)
    kind = params.kernel_type.value
    gamma = params.resolved_gamma(num_features if num_features is not None else u.shape[-1])
    if kind == KernelFunctionType.LINEAR:
        return float(np.dot(u, v))
    if kind == KernelFunctionType.POLYNOMIAL:
        return float((gamma * np.dot(u, v) + params.coef0.value) ** params.degree.value)
    if kind == KernelFunctionType.RBF:
        diff = u - v
        return float(np.exp(-gamma * np.dot(diff, diff)))
    if kind == KernelFunctionType.SIGMOID:
        return float(np.tanh(gamma * np.dot(u, v) + params.coef0.value))
    if kind == KernelFunctionType.LAPLACIAN:
        return float(np.exp(-gamma * np.sum(np.abs(u - v))))
    if kind == KernelFunctionType.CHI_SQUARED:
        den = u + v
        num = (u - v) ** 2
        terms = np.divide(num, den, out=np.zeros_like(num, dtype=np.float64),
                          where=den != 0)
        return float(np.exp(-gamma * np.sum(terms)))
    raise ValueError(f"unknown kernel function type {kind!r}")


def kernel_against_point(
    X: torch.Tensor,
    point: torch.Tensor,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
) -> torch.Tensor:
    """Vectorized ``k(x_i, point)`` for all rows of ``X`` (the "q kernel").

    reference: src/plssvm/backends/CUDA/q_kernel.cu:16-49 — one thread per
    row; here one matrix-vector product plus the epilogue (Gram kernels) or
    a row-blocked distance (distance kernels).
    """
    if kind in DISTANCE_KERNELS:
        return torch.exp(-gamma * distance_to_point(X, point, kind))
    gram = X @ point  # (n,)
    if kind == KernelFunctionType.LINEAR:
        return gram
    if kind == KernelFunctionType.POLYNOMIAL:
        return _integer_power(gamma * gram + coef0, degree)
    if kind == KernelFunctionType.SIGMOID:
        return torch.tanh(gamma * gram + coef0)
    if kind == KernelFunctionType.RBF:
        sq_x = torch.sum(X * X, dim=-1)
        sq_p = torch.dot(point, point)
        return torch.exp(-gamma * (sq_x + sq_p - 2.0 * gram))
    raise ValueError(f"unknown kernel function type {kind!r}")


# ---------------------------------------------------------------------------
# Distance kernels: tiled pairwise L1 / chi-squared distance
# ---------------------------------------------------------------------------


def _distance_tile(A: torch.Tensor, B: torch.Tensor, kind: KernelFunctionType) -> torch.Tensor:
    """Pairwise distance of two small tiles: (a, d) x (b, d) -> (a, b).

    laplacian: ``sum_k |A_ik - B_jk|``; chi-squared:
    ``sum_k (A_ik - B_jk)^2 / (A_ik + B_jk)`` with the 0/0 limit taken as 0.
    """
    diff = A[:, None, :] - B[None, :, :]
    if kind == KernelFunctionType.LAPLACIAN:
        return torch.sum(torch.abs(diff), dim=-1)
    den = A[:, None, :] + B[None, :, :]
    nonzero = den != 0
    safe = torch.where(nonzero, den, torch.ones_like(den))
    return torch.sum(
        torch.where(nonzero, diff * diff / safe, torch.zeros_like(den)), dim=-1
    )


def pairwise_distance(
    Xb: torch.Tensor,
    Y: torch.Tensor,
    kind: KernelFunctionType,
    *,
    col_block: int = 256,
    feature_block: int = 256,
) -> torch.Tensor:
    """Pairwise distance block ``D[i, j] = dist(Xb_i, Y_j)`` -> (b, m).

    Tiled over Y's rows and the feature axis, so the broadcast temporary
    holds at most ``b * col_block * feature_block`` elements whatever the
    operand sizes.  The tiles follow the tensors' own lengths: a prime row
    count or a ragged feature tail needs no padding.
    """
    b, d = Xb.shape
    m = Y.shape[0]
    out = torch.zeros((b, m), dtype=Xb.dtype, device=Xb.device)
    for j in range(0, m, col_block):
        Yc = Y[j:j + col_block]
        for k in range(0, d, feature_block):
            out[:, j:j + col_block] += _distance_tile(
                Xb[:, k:k + feature_block], Yc[:, k:k + feature_block], kind
            )
    return out


def distance_to_point(
    X: torch.Tensor,
    point: torch.Tensor,
    kind: KernelFunctionType,
    *,
    row_block: int = 4096,
) -> torch.Tensor:
    """``dist(x_i, point)`` for all rows of ``X`` -> (m,), row-blocked."""
    out = torch.empty((X.shape[0],), dtype=X.dtype, device=X.device)
    for i in range(0, X.shape[0], row_block):
        out[i:i + row_block] = _distance_tile(
            X[i:i + row_block], point[None, :], kind
        )[:, 0]
    return out
