"""Matrix-free Conjugate Gradient solvers for the LS-SVM dual system: binary,
and one-vs-all multiclass as one block CG.

Counterpart of plssvm_tpu/solver/cg.py.  Solves ``(K + I/C) a = y`` after
the dimensionality reduction that folds the last data point into the system
(reference: include/plssvm/backends/gpu_csvm.hpp:477-654,
src/plssvm/backends/OpenMP/csvm.cpp:71-183):

- ``dept = n - 1`` rows are solved, not ``n``
- ``q[i] = k(x_i, x_last)``; ``QA_cost = k(x_last, x_last) + 1/C``
- rhs ``b[i] = y[i] - y[n-1]``
- implicit matrix ``A_hat[i][j] = k(x_i,x_j) + QA_cost - q[i] - q[j]``
  plus ``1/C`` on the diagonal
- start vector ``x = 1``; residual ``r = b - A_hat x``
- stop when ``r.r <= eps^2 * (r0.r0)``; every 50th iteration the residual is
  recomputed exactly as ``r = b - A_hat x`` to fight floating-point drift
- bias ``= y_last + QA_cost * sum(alpha) - q.alpha``;
  ``alpha_n = -sum(alpha)``; returns ``rho = -bias``

The JAX package runs the loop as one ``lax.while_loop`` on the device.  Here
it is a Python loop over eager PyTorch ops, and the stop test reads
``delta > target`` on the host once per iteration.  The iteration count,
the exact-residual cadence and the bias formulas are the reference's.  The
kernels mask ragged edges themselves, so the system has exactly ``dept``
rows: no padding, no mask.

The one-vs-all solve (``solve_ls_svm_multi``) runs the C binary systems,
which share the implicit matrix and differ only in their right-hand sides,
as one block CG: each iteration applies ``K`` once to the (m, C) block of
search directions, through kernel C (ops/gram_matmat.py).  The laplacian
and chi-squared kernels take kernels E and G (ops/distance.py) instead.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..exceptions import NotPortedError
from ..kernel_functions import (
    DISTANCE_KERNELS,
    kernel_against_point,
    kernel_self_diag,
)
from ..ops.distance import distance_matmat_sym, distance_matvec_sym
from ..ops.gram_matmat import gram_matmat_sym
from ..ops.gram_matvec import gram_matvec_sym
from ..ops.matvec import (
    distance_matmat_plain,
    distance_matvec_plain,
    kernel_matmat_plain,
    kernel_matvec_plain,
    linear_kernel_matvec,
)
from ..parameter import KernelFunctionType

#: exact-residual recomputation cadence (reference: gpu_csvm.hpp:595)
EXACT_RESIDUAL_INTERVAL = 50


def _two_sum(a, b):
    """Error-free transformation: a + b = s + err exactly (Knuth TwoSum)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def compensated_sum(x: torch.Tensor) -> torch.Tensor:
    """Double-float pairwise sum: ~exact accumulation in the input dtype.

    At every halving step the rounding error of each addition is captured by
    TwoSum and carried in a compensation vector; an odd length is padded
    with one zero first, exactly as plssvm_tpu's fold.  The result equals
    f64 accumulation of the (already rounded) f32 inputs to within
    O(eps^2).  Each step is a few eager ops: they are never fused, so no
    compiler can contract TwoSum's arithmetic into FMAs.  Reduces a 1-D
    input to a 0-d tensor, and a 2-D input along axis 0: one compensated
    sum per column, the block CG's per-class reduction.
    """
    s = x if x.ndim > 1 else x.reshape(-1)
    c = torch.zeros_like(s)
    while s.shape[0] > 1:
        n = s.shape[0]
        half = (n + 1) // 2
        if n % 2 == 1:
            pad = torch.zeros((1,) + s.shape[1:], dtype=s.dtype, device=s.device)
            s = torch.cat([s, pad])
            c = torch.cat([c, pad])
        s, err = _two_sum(s[:half], s[half:])
        c = c[:half] + c[half:] + err
    return (s + c)[0]


def compensated_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product with double-float accumulation of the products."""
    return compensated_sum(a * b)


def _scalar_reductions(scalars: str):
    """(dot, vsum) pair for the requested scalar accumulation mode."""
    if scalars == "compensated":
        return compensated_dot, compensated_sum
    return torch.dot, torch.sum


class CGResult(NamedTuple):
    """Solve outputs over the ``dept`` rows."""

    x: torch.Tensor           # solution
    rho: torch.Tensor         # -bias
    alpha_last: torch.Tensor  # the folded-out last alpha = -sum(x)
    iterations: int
    delta: torch.Tensor       # final squared residual norm
    delta0: torch.Tensor      # initial squared residual norm


def _make_kernel_matvec(kind: KernelFunctionType, degree: int, impl: str) -> Callable:
    """Select the K@v implementation: ``impl="cuda"`` the hand kernel A, or
    kernel E for a distance kernel (plain versions on CPU tensors);
    ``"torch"`` the plain versions.  The linear kernel always takes the
    factored O(n d) product."""
    if kind == KernelFunctionType.LINEAR:
        return lambda X, sq_norms, v, gamma, coef0: linear_kernel_matvec(X, v)
    if kind in DISTANCE_KERNELS:
        dist = distance_matvec_sym if impl == "cuda" else distance_matvec_plain
        return lambda X, sq_norms, v, gamma, coef0: dist(X, v, kind=kind, gamma=gamma)
    sym = gram_matvec_sym if impl == "cuda" else kernel_matvec_plain

    def kv(X, sq_norms, v, gamma, coef0):
        return sym(X, sq_norms, v, kind=kind, gamma=gamma, coef0=coef0,
                   degree=degree)

    return kv


def cg_ls_svm_core(
    X: torch.Tensor,       # (dept, d) all rows but the last
    x_last: torch.Tensor,  # (d,) the folded-out last data point
    y: torch.Tensor,       # (dept,) mapped labels
    y_last: float,         # mapped label of the last point
    gamma: float,
    coef0: float,
    cost: float,
    eps: float,
    max_iter: int,
    *,
    kind: KernelFunctionType,
    degree: int,
    kernel_mv: Callable,   # (X, sq_norms, v, gamma, coef0) -> K @ v
    dot: Callable = torch.dot,
    vsum: Callable = torch.sum,
) -> CGResult:
    """The CG algorithm of plssvm_tpu's ``cg_ls_svm_core``, unpreconditioned
    and cold-started (x0 = 1)."""
    cost_inv = 1.0 / cost
    sq_norms = torch.sum(X * X, dim=-1)

    # q[i] = k(x_i, x_last)  (reference: gpu_csvm.hpp:505, q_kernel.cu:16-49)
    q = kernel_against_point(X, x_last, kind, gamma, coef0, degree)
    # QA_cost = k(x_last, x_last) + 1/C  (gpu_csvm.hpp:508)
    xl_sq = torch.dot(x_last, x_last)
    QA_cost = kernel_self_diag(xl_sq, kind, gamma, coef0, degree) + cost_inv

    # rhs: b = y[:dept] - y_last  (gpu_csvm.hpp:511-513)
    b = y - y_last

    def matvec(v):
        # A_hat @ v = K@v + (QA_cost - q)*sum(v) - (q.v)*1 + 1/C * v
        s = vsum(v)
        qv = dot(q, v)
        out = kernel_mv(X, sq_norms, v, gamma, coef0)
        return out + (QA_cost - q) * s - qv + cost_inv * v

    # start vector x = 1 (OpenMP/csvm.cpp:95)
    x = torch.ones_like(y)
    r = b - matvec(x)
    delta = dot(r, r)
    delta0 = delta
    d = r
    target = eps * eps * delta0

    it = 0
    while it < max_iter and bool(delta > target):
        Ad = matvec(d)
        alpha_cd = delta / dot(d, Ad)
        x = x + alpha_cd * d
        if it % EXACT_RESIDUAL_INTERVAL == EXACT_RESIDUAL_INTERVAL - 1:
            # every 50th iteration: exact residual (gpu_csvm.hpp:595-609)
            r = b - matvec(x)
        else:
            r = r - alpha_cd * Ad
        delta_new = dot(r, r)
        beta = delta_new / delta
        d = beta * d + r
        delta = delta_new
        it += 1

    # bias and the folded-out last alpha (gpu_csvm.hpp:648-653)
    alpha_sum = vsum(x)
    bias = y_last + QA_cost * alpha_sum - dot(q, x)
    return CGResult(
        x=x, rho=-bias, alpha_last=-alpha_sum, iterations=it,
        delta=delta, delta0=delta0,
    )


def solve_ls_svm(
    X: torch.Tensor,
    x_last: torch.Tensor,
    y: torch.Tensor,
    y_last: float,
    gamma: float,
    coef0: float,
    cost: float,
    eps: float,
    max_iter: int,
    *,
    kind: KernelFunctionType,
    degree: int,
    impl: str = "torch",
    scalars: str = "plain",
    gram_precision: str = "f32",
) -> CGResult:
    """Run the LS-SVM CG solve on the device that holds ``X``.

    ``scalars="compensated"`` accumulates the CG scalar reductions (delta,
    d.Ad, q.v, sums) with double-float TwoSum folds.  ``gram_precision``
    "f32" and "highest" both run full-precision FMA in the CUDA kernels;
    "bf16" is not ported (ROADMAP Queue 4) and raises on ``impl="cuda"``.
    The plain versions ignore the knob, as plssvm_tpu's XLA path does.
    """
    _check_gram_precision(impl, gram_precision)
    dot, vsum = _scalar_reductions(scalars)
    return cg_ls_svm_core(
        X, x_last, y, y_last, gamma, coef0, cost, eps, max_iter,
        kind=kind, degree=degree, kernel_mv=_make_kernel_matvec(kind, degree, impl),
        dot=dot, vsum=vsum,
    )


def _check_gram_precision(impl: str, gram_precision: str) -> None:
    if impl == "cuda" and gram_precision == "bf16":
        raise NotPortedError(
            "gram_precision='bf16' is not ported to the CUDA kernels yet "
            "(ROADMAP Queue 4: bf16 operands with f32 accumulation)"
        )


class MultiCGResult(NamedTuple):
    """Block-CG outputs for C one-vs-all classes over the ``dept`` rows."""

    x: torch.Tensor           # (dept, C) solutions
    rho: torch.Tensor         # (C,) -bias per class
    alpha_last: torch.Tensor  # (C,) folded-out last alpha per class
    iterations: int           # block iterations run (the slowest class's)
    iterations_per_class: torch.Tensor  # (C,) iterations each class was active
    delta: torch.Tensor       # (C,) final squared residual norms
    delta0: torch.Tensor      # (C,) initial squared residual norms


def _make_kernel_matmat(kind: KernelFunctionType, degree: int, impl: str) -> Callable:
    """Select the K@V implementation for V (m, C): ``impl="cuda"`` the hand
    kernel C, or kernel G for a distance kernel (plain versions on CPU
    tensors); ``"torch"`` the plain versions.  The linear kernel takes the
    factored X (X^T V) product."""
    if kind == KernelFunctionType.LINEAR:
        return lambda X, sq_norms, V, gamma, coef0: linear_kernel_matvec(X, V)
    if kind in DISTANCE_KERNELS:
        dist = distance_matmat_sym if impl == "cuda" else distance_matmat_plain
        return lambda X, sq_norms, V, gamma, coef0: dist(X, V, kind=kind, gamma=gamma)
    sym = gram_matmat_sym if impl == "cuda" else kernel_matmat_plain

    def kmm(X, sq_norms, V, gamma, coef0):
        return sym(X, sq_norms, V, kind=kind, gamma=gamma, coef0=coef0,
                   degree=degree)

    return kmm


def cg_ls_svm_multi_core(
    X: torch.Tensor,       # (dept, d) all rows but the last
    x_last: torch.Tensor,  # (d,) the folded-out last data point
    Y: torch.Tensor,       # (dept, C) one-vs-all targets
    y_last: torch.Tensor,  # (C,) targets of the last point
    gamma: float,
    coef0: float,
    cost: float,
    eps: float,
    max_iter: int,
    *,
    kind: KernelFunctionType,
    degree: int,
    kernel_mm: Callable,   # (X, sq_norms, V, gamma, coef0) -> K @ V
    colsum: Callable = None,  # (m, C) -> (C,)
) -> MultiCGResult:
    """The block CG of plssvm_tpu's ``cg_ls_svm_multi_core``,
    unpreconditioned and cold-started (x0 = 1).

    Per-class scalars (alpha_cd, beta, delta) are vectors of length C.  A
    class whose residual meets ``delta_c <= eps^2 * delta0_c`` is frozen:
    its step and beta are 0 and its x / r / d stay as they are, so late
    classes never perturb finished ones.  The loop runs until every class
    meets the rule or ``max_iter``; the every-50th exact residual applies
    to the whole block.
    """
    if colsum is None:
        def colsum(M):
            return torch.sum(M, dim=0)
    cost_inv = 1.0 / cost
    sq_norms = torch.sum(X * X, dim=-1)
    q = kernel_against_point(X, x_last, kind, gamma, coef0, degree)
    xl_sq = torch.dot(x_last, x_last)
    QA_cost = kernel_self_diag(xl_sq, kind, gamma, coef0, degree) + cost_inv
    B = Y - y_last[None, :]

    def matmat(V):
        # A_hat @ V column-wise; the rank-1 terms need the per-column sums
        s = colsum(V)
        qv = colsum(q[:, None] * V)
        out = kernel_mm(X, sq_norms, V, gamma, coef0)
        return out + (QA_cost - q)[:, None] * s[None, :] - qv[None, :] + cost_inv * V

    x = torch.ones_like(Y)
    r = B - matmat(x)
    delta = colsum(r * r)
    delta0 = delta
    d = r
    target = eps * eps * delta0
    itpc = torch.zeros(Y.shape[1], dtype=torch.int64, device=Y.device)
    one = torch.ones_like(delta)
    zero = torch.zeros_like(delta)

    it = 0
    while it < max_iter:
        active = delta > target
        if not bool(active.any()):
            break
        Ad = matmat(d)
        dAd = colsum(d * Ad)
        alpha_cd = torch.where(active, delta / torch.where(active, dAd, one), zero)
        x = x + alpha_cd[None, :] * d
        if it % EXACT_RESIDUAL_INTERVAL == EXACT_RESIDUAL_INTERVAL - 1:
            r = B - matmat(x)
        else:
            r = r - alpha_cd[None, :] * Ad
        delta_new = colsum(r * r)
        beta = torch.where(active, delta_new / delta, zero)
        d = torch.where(active[None, :], beta[None, :] * d + r, d)
        delta = delta_new
        itpc = itpc + active
        it += 1

    alpha_sum = colsum(x)
    bias = y_last + QA_cost * alpha_sum - colsum(q[:, None] * x)
    return MultiCGResult(
        x=x, rho=-bias, alpha_last=-alpha_sum, iterations=it,
        iterations_per_class=itpc, delta=delta, delta0=delta0,
    )


def solve_ls_svm_multi(
    X: torch.Tensor,
    x_last: torch.Tensor,
    Y: torch.Tensor,
    y_last: torch.Tensor,
    gamma: float,
    coef0: float,
    cost: float,
    eps: float,
    max_iter: int,
    *,
    kind: KernelFunctionType,
    degree: int,
    impl: str = "torch",
    scalars: str = "plain",
    gram_precision: str = "f32",
) -> MultiCGResult:
    """Run the one-vs-all block-CG solve on the device that holds ``X``.

    ``Y`` (dept, C) and ``y_last`` (C,) are the one-vs-all targets;
    ``scalars`` and ``gram_precision`` as in :func:`solve_ls_svm`, with the
    compensated sums taken per column.
    """
    _check_gram_precision(impl, gram_precision)
    if scalars == "compensated":
        colsum = compensated_sum
    else:
        def colsum(M):
            return torch.sum(M, dim=0)
    return cg_ls_svm_multi_core(
        X, x_last, Y, y_last, gamma, coef0, cost, eps, max_iter,
        kind=kind, degree=degree,
        kernel_mm=_make_kernel_matmat(kind, degree, impl), colsum=colsum,
    )
