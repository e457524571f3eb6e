"""The SVM kernel functions, as epilogues over Gram blocks (PyTorch).

reference: include/plssvm/kernel_function_types.hpp:75-97 —
linear ``u.v``; polynomial ``(gamma*u.v + coef0)^degree``;
rbf ``exp(-gamma*|u-v|^2)``; sigmoid ``tanh(gamma*u.v + coef0)`` (an
extension matching upstream PLSSVM v3).  Counterpart of
plssvm_tpu/kernel_functions.py, with the same formulas in the same order
so that both packages round alike.

A Gram block ``G = X_i @ X_j^T`` is one matrix product and the kernel is
applied elementwise, using ``|u-v|^2 = |u|^2 + |v|^2 - 2 u.v`` for RBF.  The
hand-written CUDA kernels (csrc/gram_matvec.cu) apply the same epilogue to
the tile they hold in registers.

The distance kernels (laplacian, chi-squared) are not ported yet
(ROADMAP Queue 1, item 5): every entry point raises :class:`NotPortedError`
for them.
"""

from __future__ import annotations

import numpy as np
import torch

from .exceptions import NotPortedError
from .parameter import KernelFunctionType, Parameter

#: kernels over a non-Euclidean pairwise distance — not ported yet
DISTANCE_KERNELS = frozenset(
    {KernelFunctionType.LAPLACIAN, KernelFunctionType.CHI_SQUARED}
)


def check_ported_kernel(kind: KernelFunctionType) -> None:
    """Raise :class:`NotPortedError` for the kernels this package lacks."""
    if kind in DISTANCE_KERNELS:
        raise NotPortedError(
            f"the {kind} kernel is not ported yet (ROADMAP Queue 1, item 5: "
            "distance kernels)"
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
    check_ported_kernel(kind)
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
    gpu_csvm.hpp:508).
    """
    check_ported_kernel(kind)
    if kind == KernelFunctionType.LINEAR:
        return sq_norms
    if kind == KernelFunctionType.POLYNOMIAL:
        return _integer_power(gamma * sq_norms + coef0, degree)
    if kind == KernelFunctionType.SIGMOID:
        return torch.tanh(gamma * sq_norms + coef0)
    # RBF: k(x, x) = 1
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

    One matrix product plus the epilogue: the block primitive behind the
    plain matvec and predict versions (ops/matvec.py).
    """
    check_ported_kernel(kind)
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
    check_ported_kernel(kind)
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
    row; here one matrix-vector product plus the epilogue.
    """
    check_ported_kernel(kind)
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
