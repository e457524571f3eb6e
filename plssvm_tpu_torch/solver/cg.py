"""Matrix-free Conjugate Gradient solvers for the LS-SVM dual system: binary,
one-vs-all multiclass as one block CG, and the one-vs-one pair machines as
one batched CG.

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

``gram_precision`` is the Gram tier of every kernel product of a solve,
the initial and every-50th exact residuals included: the reference found
that mixing tiers breaks conjugacy (plssvm_tpu/solver/cg.py:1125-1137).  On
float32 CUDA tensors "f32" runs kernels A and C on the tensor cores with
TF32 operands, "bf16" with bf16 operands, "highest" in three TF32 passes
over the split operand (hi hi^T + hi lo^T + lo hi^T); float64 CUDA tensors run them on the FP64 tensor cores (the DMMA tile) at
every tier.

The extras of plssvm_tpu's cores are the same here: ``x_init`` warm-starts
from a previous fit's alpha with the stop target anchored to the cold start
(one more exact product); ``weights`` / ``weight_last`` put Suykens'
``1/(C s_i)`` on the diagonal; ``preconditioner="jacobi"`` runs PCG with
the diagonal of the implicit matrix (the stop rule stays ``r.r``);
``init_state`` resumes a checkpointed solve (solver/checkpoint.py); and
``debug=True`` checks the CG state for NaN/Inf where plssvm_tpu places its
``checkify`` guards, raising :class:`NumericCheckError` with plssvm_tpu's
message.  The guards cost one host sync each, so they run only when asked.

The one-vs-all solve (``solve_ls_svm_multi``) runs the C binary systems,
which share the implicit matrix and differ only in their right-hand sides,
as one block CG: each iteration applies ``K`` once to the (m, C) block of
search directions, through kernel C (ops/gram_matmat.py).  The laplacian
and chi-squared kernels take kernels E and G (ops/distance.py) instead.

The one-vs-one solve (``solve_ls_svm_pairs``) runs the C(C-1)/2 pair
machines, each an independent system over its own rows, as one batched CG
with (P,) vectors of CG scalars: each iteration applies every machine's
``K_p`` once through kernel O (ops/pairs.py) at the solve's Gram tier (the
Gram kinds in float32 on the tensor cores at "f32" and "bf16", in float64
on the FP64 tensor cores), and a machine freezes at its own stop rule or
cap.

The one-class solve (``ridge_cg_core``, driven by one_class.py) is plain
ridge CG on ``(K + I/C) a = 1`` with the same stop rule and cadence: no
folded-out row, the cold start x0 = 0.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..exceptions import NumericCheckError
from ..kernel_functions import (
    DISTANCE_KERNELS,
    kernel_against_point,
    kernel_self_diag,
)
from ..ops.distance import distance_matmat_sym, distance_matvec_sym
from ..ops.gram_matmat import gram_matmat_sym
from ..ops.gram_matvec import gram_matvec_sym, tier_operand, uses_tensor_cores
from ..ops.pairs import (
    linear_pairs_matvec, pairs_matvec, pairs_matvec_plain, pairs_operand,
)
from ..ops.matvec import (
    check_precision,
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


def machine_sums(V: torch.Tensor,
                 stack: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Row sums of a (P, m) block of pair machines, one ``torch.sum``.  Its
    order on a CUDA device depends on the block's shape, so with ``stack =
    (P_stack, lo)`` (the block is machines ``lo..lo+P`` of a stack of
    ``P_stack``) the block is zero-padded to the stack's shape first: each
    machine then sums as it does in the whole stack."""
    P = V.shape[0]
    P_stack, lo = (P, 0) if stack is None else stack
    if P_stack != P:
        V = torch.nn.functional.pad(V, (0, 0, lo, P_stack - lo - P))
    return torch.sum(V, dim=1)[lo:lo + P]


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
    delta0: torch.Tensor      # squared residual norm of the cold start
    r: torch.Tensor           # final residual
    d: torch.Tensor           # final search direction


def _check_finite(ok: torch.Tensor, message: Callable[[], str],
                  agree: Optional[Callable[[bool], bool]] = None) -> None:
    """A ``debug=True`` guard: raise :class:`NumericCheckError` carrying
    plssvm_tpu's checkify message (made only then) unless every entry of
    ``ok`` holds.  ``agree`` turns this process's verdict into the one
    every process of a multi-process solve reaches (each holds a slice of
    the CG state, and all must raise or go on together)."""
    verdict = bool(torch.all(ok))
    if agree is not None:
        verdict = agree(verdict)
    if not verdict:
        raise NumericCheckError(message())


def _regularizer(cost: float, weights: Optional[torch.Tensor], weight_last):
    """``(civ, civ_last)``: the diagonal regularizer of the dept rows and of
    the folded-out last row, ``1/C`` or Suykens' ``1/(C s_i)`` (plssvm_tpu's
    weighted LS-SVM).  The weighted one is a true division in the solve's
    dtype, as plssvm_tpu computes it."""
    cost_inv = 1.0 / cost
    if weights is None:
        return cost_inv, cost_inv
    return (torch.full_like(weights, cost_inv) / weights,
            cost_inv / float(weight_last))


def _jacobi(sq_norms, q, QA_cost, civ, kind, gamma, coef0, degree):
    """``1 / diag(A_hat)`` with ``diag = k(x_i, x_i) + QA_cost - 2 q_i +
    civ_i`` (plssvm_tpu's Jacobi preconditioner), from the squared norms
    the solve already holds: no kernel product."""
    k_diag = kernel_self_diag(sq_norms, kind, gamma, coef0, degree)
    return torch.reciprocal(k_diag + QA_cost - 2.0 * q + civ)


def _gram_product(sym, plain, kind, degree, impl, gram_precision) -> Callable:
    """(X, sq_norms, V, gamma, coef0) -> K @ V through the hand kernel
    ``sym`` at the solve's tier (``impl="cuda"``; its plain version on CPU
    tensors), or through ``plain`` at full precision (``"torch"``, which
    ignores the tier, as plssvm_tpu's XLA path does).  Where X takes a
    tensor-core tile, its operand copy (``tier_operand``: at "highest" the
    split stack, twice X) is made at the first product and handed to every
    later one of the same X: once per solve, not once per product."""
    if impl != "cuda":
        def kv_plain(X, sq_norms, V, gamma, coef0):
            return plain(X, sq_norms, V, kind=kind, gamma=gamma, coef0=coef0,
                         degree=degree, precision="f32")

        return kv_plain
    made = {}

    def kv(X, sq_norms, V, gamma, coef0):
        operand = None
        if uses_tensor_cores(X, gram_precision):
            if made.get("X") is not X:
                made.update(X=X, operand=tier_operand(X, gram_precision))
            operand = made["operand"]
        return sym(X, sq_norms, V, kind=kind, gamma=gamma, coef0=coef0,
                   degree=degree, precision=gram_precision, operand=operand)

    return kv


def _make_kernel_matvec(kind: KernelFunctionType, degree: int, impl: str,
                        gram_precision: str = "f32") -> Callable:
    """Select the K@v implementation: ``impl="cuda"`` the hand kernel A at
    the tier ``gram_precision``, or kernel E for a distance kernel (plain
    versions on CPU tensors); ``"torch"`` the plain versions.  The linear
    kernel always takes the factored O(n d) product."""
    if kind == KernelFunctionType.LINEAR:
        return lambda X, sq_norms, v, gamma, coef0: linear_kernel_matvec(X, v)
    if kind in DISTANCE_KERNELS:
        dist = distance_matvec_sym if impl == "cuda" else distance_matvec_plain
        return lambda X, sq_norms, v, gamma, coef0: dist(X, v, kind=kind, gamma=gamma)
    return _gram_product(gram_matvec_sym, kernel_matvec_plain, kind, degree,
                         impl, gram_precision)


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
    preconditioner: str = "none",  # "none" (the reference) | "jacobi"
    x_init: Optional[torch.Tensor] = None,   # warm start (replaces x0 = 1)
    weights: Optional[torch.Tensor] = None,  # (dept,) sample weights s_i
    weight_last=None,      # the folded-out last row's weight
    init_state=None,       # (x, r, d, delta, delta0, iteration) to resume
    debug: bool = False,   # NaN/Inf guards on the CG state
    point_kernel: Callable = kernel_against_point,  # q = k(X, x_last)
    agree: Optional[Callable[[bool], bool]] = None,  # the guards' joint verdict
) -> CGResult:
    """The CG algorithm of plssvm_tpu's ``cg_ls_svm_core``.

    Cold-started from x0 = 1 by default.  ``x_init`` starts from a previous
    fit's alpha; the relative stop target stays anchored to the cold start's
    residual (one more exact product), so a warm fit stops at the accuracy
    a cold fit would.  ``init_state`` continues a solve after its
    ``iteration``-th step with the saved x, r, d and residual norms: the
    every-50th exact residual keeps its cadence, and the result equals the
    uninterrupted solve's.  ``preconditioner="jacobi"`` is PCG with the
    diagonal of the implicit matrix; the stop rule stays ``r.r <= eps^2
    r0.r0``.  ``debug`` raises :class:`NumericCheckError` on a non-finite
    initial residual, step size, residual or iterate.

    X, y, the weights and the CG vectors may be one process's rows of a
    multi-process solve: ``kernel_mv``, ``dot`` and ``vsum`` then span
    every process, ``agree`` joins the debug guards' verdicts, and every
    branch the loop takes reads only such joint values.  ``point_kernel``
    computes q (the row-sharded ring takes it shard by shard, as its
    processes do).
    """
    civ, civ_last = _regularizer(cost, weights, weight_last)
    sq_norms = torch.sum(X * X, dim=-1)

    # q[i] = k(x_i, x_last)  (reference: gpu_csvm.hpp:505, q_kernel.cu:16-49)
    q = point_kernel(X, x_last, kind, gamma, coef0, degree)
    # QA_cost = k(x_last, x_last) + 1/C  (gpu_csvm.hpp:508); the 1/C is the
    # folded-out last row's regularizer
    xl_sq = torch.dot(x_last, x_last)
    QA_cost = kernel_self_diag(xl_sq, kind, gamma, coef0, degree) + civ_last

    # rhs: b = y[:dept] - y_last  (gpu_csvm.hpp:511-513)
    b = y - y_last

    def matvec(v):
        # A_hat @ v = K@v + (QA_cost - q)*sum(v) - (q.v)*1 + 1/C * v
        s = vsum(v)
        qv = dot(q, v)
        out = kernel_mv(X, sq_norms, v, gamma, coef0)
        return out + (QA_cost - q) * s - qv + civ * v

    use_pcg = preconditioner == "jacobi"
    if use_pcg:
        minv = _jacobi(sq_norms, q, QA_cost, civ, kind, gamma, coef0, degree)

    if init_state is None:
        # start vector x = 1 (OpenMP/csvm.cpp:95), or the caller's warm start
        x = torch.ones_like(y) if x_init is None else x_init.to(y.dtype)
        r = b - matvec(x)
        delta = dot(r, r)
        if x_init is None:
            delta0 = delta
        else:
            r_cold = b - matvec(torch.ones_like(y))
            delta0 = dot(r_cold, r_cold)
        d = minv * r if use_pcg else r
        it = 0
    else:
        x, r, d, delta, delta0, it = init_state
        it = int(it)
    target = eps * eps * delta0
    if debug:
        # NaN > target is False: a NaN residual would end the loop at once
        # with a garbage "converged" model
        _check_finite(torch.isfinite(delta), lambda:
                      "initial CG residual |r0|^2 is non-finite — the training "
                      "data, labels or kernel parameters contain NaN/Inf", agree)
    # r.z for the current residual; a resumed d is not z, so from r
    rz = dot(r, minv * r) if use_pcg else delta

    while it < max_iter and bool(delta > target):
        Ad = matvec(d)
        dAd = dot(d, Ad)
        alpha_cd = rz / dAd
        x = x + alpha_cd * d
        if it % EXACT_RESIDUAL_INTERVAL == EXACT_RESIDUAL_INTERVAL - 1:
            # every 50th iteration: exact residual (gpu_csvm.hpp:595-609)
            r = b - matvec(x)
        else:
            r = r - alpha_cd * Ad
        delta_new = dot(r, r)
        if debug:
            _check_finite(torch.isfinite(alpha_cd), lambda:
                          f"CG step size rz/d.Ad became non-finite at iteration {it} "
                          f"(d.Ad = {float(dAd)}) — singular/indefinite system or "
                          "numeric blowup", agree)
            _check_finite(torch.isfinite(delta_new), lambda:
                          f"CG residual |r|^2 became non-finite at iteration {it}", agree)
            _check_finite(torch.isfinite(x), lambda:
                          f"CG iterate x contains non-finite values at iteration {it}",
                          agree)
        if use_pcg:
            z = minv * r
            rz_new = dot(r, z)
        else:
            z = r
            rz_new = delta_new
        beta = rz_new / rz
        d = beta * d + z
        delta = delta_new
        rz = rz_new
        it += 1

    # bias and the folded-out last alpha (gpu_csvm.hpp:648-653)
    alpha_sum = vsum(x)
    bias = y_last + QA_cost * alpha_sum - dot(q, x)
    return CGResult(
        x=x, rho=-bias, alpha_last=-alpha_sum, iterations=it,
        delta=delta, delta0=delta0, r=r, d=d,
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
    **extras,
) -> CGResult:
    """Run the LS-SVM CG solve on the device that holds ``X``.

    ``scalars="compensated"`` accumulates the CG scalar reductions (delta,
    d.Ad, q.v, sums) with double-float TwoSum folds.  ``gram_precision``
    is the tier of every Gram product of the solve on ``impl="cuda"``: on
    float32 CUDA tensors "f32" takes kernel A's tensor-core tile with TF32
    operands, "bf16" with bf16 operands, "highest" three TF32 passes over
    the split operand, the operand copy made once per solve; on CPU
    tensors the plain version at the tier ("f32" and "highest" full
    float32, "bf16" on bf16-rounded X).  float64 computes in
    float64 at every tier.  ``impl="torch"`` ignores the tier, as
    plssvm_tpu's XLA path does.  ``extras`` are the core's
    ``preconditioner``, ``x_init``, ``weights`` / ``weight_last``,
    ``init_state`` and ``debug``; the compensated reductions also take the
    preconditioned ``r.z``.
    """
    check_precision(gram_precision)
    dot, vsum = _scalar_reductions(scalars)
    return cg_ls_svm_core(
        X, x_last, y, y_last, gamma, coef0, cost, eps, max_iter,
        kind=kind, degree=degree,
        kernel_mv=_make_kernel_matvec(kind, degree, impl, gram_precision),
        dot=dot, vsum=vsum, **extras,
    )


def ridge_cg_core(
    b: torch.Tensor,       # (m,) right-hand side: ones for the one-class solve
    matvec: Callable,      # v -> A @ v
    dot: Callable = torch.dot,
    *,
    eps: float,
    max_iter: int,
    x_init: Optional[torch.Tensor] = None,  # warm start (pruning refits)
    init_state=None,       # (x, r, d, delta, delta0, iteration) to resume
    debug: bool = False,   # NaN/Inf guards on the CG state
    agree: Optional[Callable[[bool], bool]] = None,  # the guards' joint verdict
):
    """Plain ridge CG ``A x = b``: plssvm_tpu's ``ridge_cg_core``.

    The one-class LS-SVM solve (one_class.py): ``A = K + I/C``, the
    classifier's implicit matrix with q = 0 and QA_cost = 0, so there is
    no folded-out row, no rank-one term and no bias.  The stop rule is the
    classifier's, ``r.r <= eps^2 delta0``, with an exact residual every
    50th iteration.  The cold start is x0 = 0, so ``delta0 = b.b``;
    ``x_init`` starts from a previous solve with the target still anchored
    there (no extra product).  ``init_state`` continues a checkpointed
    solve after its ``iteration``-th step.  ``dot`` is the reference's
    plain dot (or its sharded sum of partials); ``debug`` raises
    :class:`NumericCheckError` with plssvm_tpu's messages (``agree`` as in
    :func:`cg_ls_svm_core`).

    Returns ``(x, r, d, delta, delta0, iterations)``: r, d and delta are
    the live state a checkpoint keeps.
    """
    if init_state is not None:
        x, r, d, delta, delta0, it = init_state
        it = int(it)
    else:
        delta0 = dot(b, b)
        if x_init is None:
            x = torch.zeros_like(b)
            r = b
            delta = delta0
        else:
            x = x_init.to(b.dtype)
            r = b - matvec(x)
            delta = dot(r, r)
        d = r
        it = 0
    target = eps * eps * delta0
    if debug:
        _check_finite(torch.isfinite(delta), lambda:
                      "initial ridge-CG residual |r0|^2 is non-finite — the training "
                      "data or kernel parameters contain NaN/Inf", agree)

    while it < max_iter and bool(delta > target):
        Ad = matvec(d)
        dAd = dot(d, Ad)
        a = delta / dAd
        x = x + a * d
        if it % EXACT_RESIDUAL_INTERVAL == EXACT_RESIDUAL_INTERVAL - 1:
            r = b - matvec(x)
        else:
            r = r - a * Ad
        delta_new = dot(r, r)
        if debug:
            _check_finite(torch.isfinite(a), lambda:
                          f"ridge-CG step size became non-finite at iteration {it} "
                          f"(d.Ad = {float(dAd)})", agree)
            _check_finite(torch.isfinite(delta_new), lambda:
                          f"ridge-CG residual |r|^2 became non-finite at iteration {it}",
                          agree)
            _check_finite(torch.isfinite(x), lambda:
                          f"ridge-CG iterate contains non-finite values at iteration {it}",
                          agree)
        beta = delta_new / delta
        d = r + beta * d
        delta = delta_new
        it += 1
    return x, r, d, delta, delta0, it


class MultiCGResult(NamedTuple):
    """Block-CG outputs for C one-vs-all classes over the ``dept`` rows."""

    x: torch.Tensor           # (dept, C) solutions
    rho: torch.Tensor         # (C,) -bias per class
    alpha_last: torch.Tensor  # (C,) folded-out last alpha per class
    iterations: int           # block iterations run (the slowest class's)
    iterations_per_class: torch.Tensor  # (C,) iterations each class was active
    delta: torch.Tensor       # (C,) final squared residual norms
    delta0: torch.Tensor      # (C,) squared residual norms of the cold start
    r: torch.Tensor           # (dept, C) final residuals
    d: torch.Tensor           # (dept, C) final search directions


def _make_kernel_matmat(kind: KernelFunctionType, degree: int, impl: str,
                        gram_precision: str = "f32") -> Callable:
    """Select the K@V implementation for V (m, C): ``impl="cuda"`` the hand
    kernel C at the tier ``gram_precision``, or kernel G for a distance
    kernel (plain versions on CPU tensors); ``"torch"`` the plain versions.
    The linear kernel takes the factored X (X^T V) product."""
    if kind == KernelFunctionType.LINEAR:
        return lambda X, sq_norms, V, gamma, coef0: linear_kernel_matvec(X, V)
    if kind in DISTANCE_KERNELS:
        dist = distance_matmat_sym if impl == "cuda" else distance_matmat_plain
        return lambda X, sq_norms, V, gamma, coef0: dist(X, V, kind=kind, gamma=gamma)
    return _gram_product(gram_matmat_sym, kernel_matmat_plain, kind, degree,
                         impl, gram_precision)


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
    preconditioner: str = "none",
    x_init: Optional[torch.Tensor] = None,   # (dept, C) warm-start block
    weights: Optional[torch.Tensor] = None,  # (dept,) sample weights
    weight_last=None,
    init_state=None,       # (x, r, d, delta, delta0, iteration, itpc)
    debug: bool = False,
    point_kernel: Callable = kernel_against_point,
    agree: Optional[Callable[[bool], bool]] = None,
) -> MultiCGResult:
    """The block CG of plssvm_tpu's ``cg_ls_svm_multi_core``.

    Per-class scalars (alpha_cd, beta, delta, r.z) are vectors of length C.
    A class whose residual meets ``delta_c <= eps^2 * delta0_c`` is frozen:
    its step and beta are 0 and its x / r / d stay as they are, so late
    classes never perturb finished ones.  The loop runs until every class
    meets the rule or ``max_iter``; the every-50th exact residual applies
    to the whole block.  The extras are the binary core's, per column:
    the warm start's stop targets anchored to the cold start, the weighted
    diagonal, Jacobi (one diagonal for every class), resume (with the
    per-class counts ``itpc``) and the debug guards.  ``point_kernel`` and
    ``agree`` as in :func:`cg_ls_svm_core`: a multi-process solve runs
    this loop on each process's rows.
    """
    if colsum is None:
        def colsum(M):
            return torch.sum(M, dim=0)
    civ, civ_last = _regularizer(cost, weights, weight_last)
    civ_col = civ if weights is None else civ[:, None]
    sq_norms = torch.sum(X * X, dim=-1)
    q = point_kernel(X, x_last, kind, gamma, coef0, degree)
    xl_sq = torch.dot(x_last, x_last)
    QA_cost = kernel_self_diag(xl_sq, kind, gamma, coef0, degree) + civ_last
    B = Y - y_last[None, :]

    def matmat(V):
        # A_hat @ V column-wise; the rank-1 terms need the per-column sums
        s = colsum(V)
        qv = colsum(q[:, None] * V)
        out = kernel_mm(X, sq_norms, V, gamma, coef0)
        return out + (QA_cost - q)[:, None] * s[None, :] - qv[None, :] + civ_col * V

    use_pcg = preconditioner == "jacobi"
    if use_pcg:
        minv = _jacobi(sq_norms, q, QA_cost, civ, kind, gamma, coef0, degree)[:, None]

    if init_state is None:
        x = torch.ones_like(Y) if x_init is None else x_init.to(Y.dtype)
        r = B - matmat(x)
        delta = colsum(r * r)
        if x_init is None:
            delta0 = delta
        else:
            # the stop targets anchored to the cold start (see the binary core)
            r_cold = B - matmat(torch.ones_like(Y))
            delta0 = colsum(r_cold * r_cold)
        d = minv * r if use_pcg else r
        it = 0
        itpc = torch.zeros(Y.shape[1], dtype=torch.int64, device=Y.device)
    else:
        x, r, d, delta, delta0, it, itpc = init_state
        it = int(it)
        itpc = itpc.to(device=Y.device, dtype=torch.int64)
    target = eps * eps * delta0
    if debug:
        _check_finite(torch.isfinite(delta), lambda:
                      "initial block-CG residuals contain non-finite values — the "
                      "training data, labels or kernel parameters contain NaN/Inf", agree)
    rz = colsum(r * (minv * r)) if use_pcg else delta
    one = torch.ones_like(delta)
    zero = torch.zeros_like(delta)

    while it < max_iter:
        active = delta > target
        if not bool(active.any()):
            break
        Ad = matmat(d)
        dAd = colsum(d * Ad)
        alpha_cd = torch.where(active, rz / torch.where(active, dAd, one), zero)
        x = x + alpha_cd[None, :] * d
        if it % EXACT_RESIDUAL_INTERVAL == EXACT_RESIDUAL_INTERVAL - 1:
            r = B - matmat(x)
        else:
            r = r - alpha_cd[None, :] * Ad
        delta_new = colsum(r * r)
        if debug:
            _check_finite(torch.isfinite(alpha_cd), lambda:
                          f"block-CG step sizes contain non-finite values at iteration "
                          f"{it} — singular/indefinite system or numeric blowup", agree)
            _check_finite(torch.isfinite(delta_new), lambda:
                          f"block-CG residuals contain non-finite values at iteration {it}",
                          agree)
            _check_finite(torch.isfinite(x), lambda:
                          f"block-CG iterate contains non-finite values at iteration {it}",
                          agree)
        if use_pcg:
            z = minv * r
            rz_new = colsum(r * z)
        else:
            z = r
            rz_new = delta_new
        beta = torch.where(active, rz_new / rz, zero)
        d = torch.where(active[None, :], beta[None, :] * d + z, d)
        delta = delta_new
        rz = rz_new
        itpc = itpc + active
        it += 1

    alpha_sum = colsum(x)
    bias = y_last + QA_cost * alpha_sum - colsum(q[:, None] * x)
    return MultiCGResult(
        x=x, rho=-bias, alpha_last=-alpha_sum, iterations=it,
        iterations_per_class=itpc, delta=delta, delta0=delta0, r=r, d=d,
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
    **extras,
) -> MultiCGResult:
    """Run the one-vs-all block-CG solve on the device that holds ``X``.

    ``Y`` (dept, C) and ``y_last`` (C,) are the one-vs-all targets;
    ``scalars``, ``gram_precision`` and ``extras`` as in
    :func:`solve_ls_svm`, with the compensated sums taken per column.
    """
    check_precision(gram_precision)
    if scalars == "compensated":
        colsum = compensated_sum
    else:
        def colsum(M):
            return torch.sum(M, dim=0)
    return cg_ls_svm_multi_core(
        X, x_last, Y, y_last, gamma, coef0, cost, eps, max_iter,
        kind=kind, degree=degree,
        kernel_mm=_make_kernel_matmat(kind, degree, impl, gram_precision),
        colsum=colsum, **extras,
    )


class PairsCGResult(NamedTuple):
    """Batched pair-machine CG outputs (still padded per machine)."""

    x: torch.Tensor            # (P, m) solutions over the padded dept axes
    rho: torch.Tensor          # (P,) -bias per machine
    alpha_last: torch.Tensor   # (P,) folded-out last alpha per machine
    iterations: int            # block iterations run (= max over machines)
    iterations_per_pair: torch.Tensor  # (P,) iterations each machine was active
    delta: torch.Tensor        # (P,) final squared residual norms
    delta0: torch.Tensor       # (P,) squared residual norms of the cold start


def cg_ls_svm_pairs_core(
    Xb: torch.Tensor,        # (P, m, d) per-machine rows (zero-padded)
    x_last_b: torch.Tensor,  # (P, d) each machine's folded-out last point
    Yb: torch.Tensor,        # (P, m) +-1 targets, 0 on padding
    y_last_b: torch.Tensor,  # (P,) targets of the folded-out last points
    maskb: torch.Tensor,     # (P, m) 1 on real rows, 0 on padding
    gamma: float,
    coef0: float,
    cost: float,
    eps: float,
    max_iter_b: torch.Tensor,  # (P,) per-machine iteration caps
    *,
    kind: KernelFunctionType,
    degree: int,
    kernel_bmv: Callable,    # (Xb, sq_b, V, gamma, coef0) -> batched K_p @ v_p
    bdot: Callable = None,   # per-machine dot: (P, m) x (P, m) -> (P,)
    bsum: Callable = None,   # per-machine sum: (P, m) -> (P,)
    preconditioner: str = "none",
    x_init: Optional[torch.Tensor] = None,       # (P, m) warm-start block
    weights: Optional[torch.Tensor] = None,      # (P, m) per-sample weights
    weight_last: Optional[torch.Tensor] = None,  # (P,) folded-out last weights
    debug: bool = False,
) -> PairsCGResult:
    """All C(C-1)/2 one-vs-one machines solved as one batched CG
    (plssvm_tpu's ``cg_ls_svm_pairs_core``).

    Each pair machine is an independent LS-SVM system over its own rows, so
    every quantity carries a leading machine axis: data (P, m, d), the
    kernel product a batched ``K_p @ v_p`` and the CG scalars (alpha_cd,
    beta, delta, r.z) (P,) vectors.  Per machine the algorithm is the binary
    core's: a machine freezes (its step and beta 0, its x and d kept) once
    ``delta_p <= eps^2 delta0_p`` or at its own cap ``max_iter_b[p]``; the
    every-50th exact residual applies to the whole block.  The loop syncs
    with the host once per iteration, on whether any machine is active.
    The extras are the binary core's, per machine: ``x_init`` with the stop
    targets anchored to the cold start, the weighted diagonal, Jacobi and
    the ``debug`` guards (plssvm_tpu's messages).
    """
    dtype = Xb.dtype
    cost_inv = 1.0 / cost
    if weights is None:
        civ = cost_inv
        civ_last = cost_inv
    else:
        civ = (torch.full_like(weights, cost_inv) / weights) * maskb
        civ_last = cost_inv / weight_last
    sq_b = torch.sum(Xb * Xb, dim=-1)  # (P, m)
    if bdot is None:
        def bdot(A, V):
            return torch.sum(A * V, dim=1)
    if bsum is None:
        def bsum(V):
            return torch.sum(V, dim=1)

    # per-machine q / QA_cost (the reference's vmapped "q kernel")
    q = torch.stack([
        kernel_against_point(Xb[p], x_last_b[p], kind, gamma, coef0, degree)
        for p in range(Xb.shape[0])
    ]) * maskb
    xl_sq = torch.sum(x_last_b * x_last_b, dim=-1)
    QA_cost = kernel_self_diag(xl_sq, kind, gamma, coef0, degree) + civ_last  # (P,)

    B = (Yb - y_last_b[:, None]) * maskb

    def matvec(V):
        s = bsum(V)
        qv = bdot(q, V)
        out = kernel_bmv(Xb, sq_b, V, gamma, coef0)
        out = out + (QA_cost[:, None] - q) * s[:, None] - qv[:, None] + civ * V
        return out * maskb

    use_pcg = preconditioner == "jacobi"
    if use_pcg:
        k_diag = kernel_self_diag(sq_b, kind, gamma, coef0, degree)
        minv = maskb / (k_diag + QA_cost[:, None] - 2.0 * q + civ)

    ones = maskb.to(dtype)
    if x_init is None:
        x = ones
        r = B - matvec(x)
        delta = bdot(r, r)
        delta0 = delta
    else:
        x = x_init.to(dtype) * maskb
        r = B - matvec(x)
        delta = bdot(r, r)
        # the stop targets anchored to the cold start (see the binary core)
        r_cold = B - matvec(ones)
        delta0 = bdot(r_cold, r_cold)
    d = minv * r if use_pcg else r
    target = eps * eps * delta0
    if debug:
        _check_finite(torch.isfinite(delta), lambda:
                      "initial pair-CG residuals contain non-finite values — the "
                      "training data, labels or kernel parameters contain NaN/Inf")
    rz = bdot(r, minv * r) if use_pcg else delta
    max_iter_b = max_iter_b.to(device=Yb.device, dtype=torch.int64)
    itpp = torch.zeros_like(max_iter_b)
    one = torch.ones_like(delta)
    zero = torch.zeros_like(delta)
    it = 0

    while True:
        active = (delta > target) & (itpp < max_iter_b)
        if not bool(active.any()):
            break
        Ad = matvec(d)
        dAd = bdot(d, Ad)
        alpha_cd = torch.where(active, rz / torch.where(active, dAd, one), zero)
        x = x + alpha_cd[:, None] * d
        if it % EXACT_RESIDUAL_INTERVAL == EXACT_RESIDUAL_INTERVAL - 1:
            r = B - matvec(x)
        else:
            r = r - alpha_cd[:, None] * Ad
        delta = bdot(r, r)
        if debug:
            _check_finite(torch.isfinite(alpha_cd), lambda:
                          f"pair-CG step sizes contain non-finite values at iteration {it}")
            _check_finite(torch.isfinite(delta), lambda:
                          f"pair-CG residuals contain non-finite values at iteration {it}")
            _check_finite(torch.isfinite(x), lambda:
                          f"pair-CG iterate contains non-finite values at iteration {it}")
        if use_pcg:
            z = minv * r
            rz_new = bdot(r, z)
        else:
            z = r
            rz_new = delta
        beta = torch.where(active, rz_new / rz, zero)
        d = torch.where(active[:, None], beta[:, None] * d + z, d)
        rz = rz_new
        itpp = itpp + active
        it += 1

    alpha_sum = bsum(x)  # (P,)
    bias = y_last_b + QA_cost * alpha_sum - bdot(q, x)
    return PairsCGResult(
        x=x, rho=-bias, alpha_last=-alpha_sum, iterations=it,
        iterations_per_pair=itpp, delta=delta, delta0=delta0,
    )


def _make_pairs_matvec(kind: KernelFunctionType, degree: int, impl: str,
                       lens: torch.Tensor, gram_precision: str,
                       Xb: torch.Tensor) -> Callable:
    """The batched product of the pairs solve of the stack ``Xb`` over
    machines of ``lens`` real rows: ``impl="cuda"`` kernel O (ops/pairs.py)
    at the solve's tier, on the operand copy that the tensor-core walks read
    (``pairs_operand``), made here once for the whole solve (on CPU tensors
    the plain version at full precision); ``"torch"`` the plain version at
    full precision; the linear kernel the factored ``Xb (Xb^T v)`` (two
    ``torch.bmm``)."""
    if kind == KernelFunctionType.LINEAR:
        return lambda Xb, sq_b, V, gamma, coef0: linear_pairs_matvec(Xb, V)
    sq_read = kind not in DISTANCE_KERNELS
    if impl != "cuda":
        def plain(Xb, sq_b, V, gamma, coef0):
            return pairs_matvec_plain(Xb, sq_b if sq_read else None, V, lens, kind=kind,
                                      gamma=gamma, coef0=coef0, degree=degree,
                                      precision="highest")

        return plain
    operand = pairs_operand(Xb, kind, gram_precision)

    def kv(Xb, sq_b, V, gamma, coef0):
        return pairs_matvec(Xb, sq_b if sq_read else None, V, lens, kind=kind,
                            gamma=gamma, coef0=coef0, degree=degree,
                            precision=gram_precision, operand=operand)

    return kv


def solve_ls_svm_pairs(
    Xb: torch.Tensor,
    x_last_b: torch.Tensor,
    Yb: torch.Tensor,
    y_last_b: torch.Tensor,
    maskb: torch.Tensor,
    gamma: float,
    coef0: float,
    cost: float,
    eps: float,
    max_iter_b: torch.Tensor,
    *,
    kind: KernelFunctionType,
    degree: int,
    impl: str = "torch",
    scalars: str = "plain",
    gram_precision: str = "f32",
    stack: Optional[Tuple[int, int]] = None,
    **extras,
) -> PairsCGResult:
    """The batched one-vs-one LS-SVM CG solve on the device that holds
    ``Xb`` (plssvm_tpu's ``solve_ls_svm_pairs``).

    Machine p's real rows are the first ``maskb[p].sum()`` of its block
    (the mask is a prefix).  The product is kernel O on ``impl="cuda"`` at
    the Gram tier ``gram_precision``, every product of the solve at that one
    tier, as the reference's batched product runs at its default one (the
    plain version at full precision on CPU tensors and for ``"torch"``,
    which ignores the tier).
    ``scalars="compensated"`` takes the per-machine dots and sums as
    compensated folds over the transposed (m, P) blocks, one per machine
    (plssvm_tpu's ``compensated_sum((A * V).T)``), elementwise steps that
    sum each machine alike in a block of any size.  ``"plain"`` takes them
    as :func:`machine_sums`, with ``stack = (P_stack, lo)`` for the
    machine-axis split's group at machines ``lo..lo+P`` of a stack of
    ``P_stack``, so that each machine sums as it does on one device.  ``extras`` are the core's ``preconditioner``, ``x_init``,
    ``weights`` / ``weight_last`` and ``debug``.
    """
    check_precision(gram_precision)
    lens = (maskb != 0).sum(dim=1).to(torch.int64)
    if scalars == "compensated":
        def fold(V):
            return compensated_sum(V.T)
    else:
        def fold(V):
            return machine_sums(V, stack)

    def bdot(A, V):
        return fold(A * V)

    return cg_ls_svm_pairs_core(
        Xb, x_last_b, Yb, y_last_b, maskb, gamma, coef0, cost, eps, max_iter_b,
        kind=kind, degree=degree,
        kernel_bmv=_make_pairs_matvec(kind, degree, impl, lens, gram_precision, Xb),
        bdot=bdot, bsum=fold, **extras,
    )
