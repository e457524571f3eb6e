"""One-class LS-SVM: novelty detection through the classifier's kernels.

Counterpart of plssvm_tpu/one_class.py (Choi, "Least squares one-class
support vector machine", Pattern Recognition Letters 30, 2009): the training
cloud is described by ``g(x) = sum_i alpha_i k(x_i, x)`` with alpha the
solution of the ridge system

    (K + I/C) alpha = 1,

and the threshold ``rho`` is the ``nu``-quantile of the training scores
``g = K alpha``, so about ``nu`` of the training points fall outside.  The
decision function and the model file are LIBSVM's one-class form
``f(x) = sum_i alpha_i k(x_i, x) - rho`` (``svm_type one_class``, no label
lines), so LIBSVM's ``-s 2`` models predict here and the other way round.

The ridge matrix is the classifier's implicit matrix with q = 0 and
QA_cost = 0, so the solve runs on the classifier's products: kernel A at
the fit's Gram tier (its operand copy made once per solve) or kernel E for
the distance kernels (``solver/cg.py::_make_kernel_matvec``), the stored K
of the explicit solver (kernel N or the cuBLAS build, ``explicit_product``),
or with ``CSVM(devices=...)`` the row-sharded ring
(``parallel/sharded.py::ridge_sharded_operators``).  The CG is
``solver/cg.py::ridge_cg_core``, a Python loop with one host sync per
iteration; the scores ``g`` are one more product.  The port pads nothing:
the system has the data set's n rows.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .data_set import DataSet
from .exceptions import InvalidParameterError, NotPortedError
from .model import Model
from .parameter import KernelFunctionType
from .solver.cg import _make_kernel_matvec, ridge_cg_core
from .solver.explicit import _explicit_matvec
from .utils.logger import VerbosityLevel, log
from .utils.tracker import add_tracking_entry


def _validate_one_class_args(nu, epsilon, max_iter, n):
    if not 0.0 < nu < 1.0:
        raise InvalidParameterError(f"nu must be in (0, 1), but is {nu}!")
    if epsilon <= 0.0:
        # plssvm_tpu's wording, which repeats the reference's (csvm.hpp:284)
        raise InvalidParameterError(
            f"epsilon must be less than 0.0, but is {epsilon}!"
        )
    if max_iter is None:
        max_iter = n
    elif max_iter <= 0:
        raise InvalidParameterError(
            f"max_iter must be greater than 0, but is {max_iter}!"
        )
    return max_iter


def _log_one_class_result(iterations, max_iter, delta, epsilon, nu):
    log(
        VerbosityLevel.FULL | VerbosityLevel.LIBSVM,
        "optimization finished, #iter = {}\n", iterations,
    )
    add_tracking_entry("cg", "iterations", iterations)
    add_tracking_entry("cg", "max_iterations", int(max_iter))
    add_tracking_entry("cg", "residuum", float(delta))
    add_tracking_entry("cg", "epsilon", float(epsilon))
    add_tracking_entry("parameter", "nu", float(nu))


def _one_class_civ(cost, sample_weight, n, dt):
    """Per-row ridge regularizer ``1/(C s_i)`` as a validated (n,) array,
    or None for the unweighted scalar case (Suykens' weighting)."""
    if sample_weight is None:
        return None
    sample_weight = np.asarray(sample_weight, dtype=np.float64)
    if sample_weight.shape != (n,):
        raise InvalidParameterError(
            f"sample_weight must have one entry per data point ({n}), "
            f"but has shape {sample_weight.shape}!"
        )
    if not np.all(sample_weight > 0.0):
        raise InvalidParameterError("sample_weight entries must all be positive!")
    return (1.0 / (cost * sample_weight)).astype(dt)


def _run_ridge_segments(solve_once, resume_once, X, b, params_repr, epsilon, max_iter,
                        checkpoint_path, checkpoint_interval):
    """Segmented one-class ridge CG with checkpoint/resume (plssvm_tpu's
    ``_run_ridge_segments``): the solve runs in ``checkpoint_interval``
    segments, the state is saved between them, a file that matches the
    problem is resumed from, and the file goes when the solve ends.
    ``solve_once(seg_end)`` / ``resume_once(seg_end, state)`` return
    ridge_cg_core's tuple; the state arrives as host arrays."""
    from .solver.checkpoint import (
        CGCheckpoint,
        load_checkpoint,
        problem_fingerprint,
        save_checkpoint,
    )

    def host(t):
        return t.detach().cpu().numpy()

    fingerprint = problem_fingerprint(X, b, params_repr, epsilon)
    ckpt = load_checkpoint(checkpoint_path, fingerprint)
    if ckpt is not None:
        log(
            VerbosityLevel.FULL,
            "Resuming one-class CG from checkpoint '{}' at iteration {}.\n",
            checkpoint_path, ckpt.iteration,
        )
    while True:
        if ckpt is None:
            res = solve_once(min(int(checkpoint_interval), int(max_iter)))
        else:
            seg_end = min(int(ckpt.iteration) + int(checkpoint_interval), int(max_iter))
            res = resume_once(seg_end, (np.asarray(ckpt.x), np.asarray(ckpt.r),
                                        np.asarray(ckpt.d), ckpt.delta, ckpt.delta0,
                                        int(ckpt.iteration)))
        x, r, d, delta, delta0, iterations = res
        delta_f = float(delta)
        delta0_f = float(delta0)
        converged = delta_f <= float(epsilon) ** 2 * delta0_f
        if converged or iterations >= int(max_iter):
            break
        if ckpt is not None and iterations <= int(ckpt.iteration):
            break  # the epsilon boundary: accept the solver's verdict
        ckpt = CGCheckpoint(x=host(x), r=host(r), d=host(d), delta=delta_f,
                            delta0=delta0_f, iteration=iterations,
                            fingerprint=fingerprint)
        save_checkpoint(checkpoint_path, ckpt)
    try:
        if os.path.isfile(checkpoint_path):
            os.remove(checkpoint_path)
    except OSError:
        pass
    return res


def fit_one_class(
    csvm,
    data: DataSet,
    *,
    nu: float = 0.5,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    initial_model: Optional[Model] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_interval: int = 1000,
    sample_weight=None,
) -> Model:
    """Fit a one-class LS-SVM on ``data``'s points (labels are ignored).

    ``nu`` is the training outlier fraction: ``rho`` is the
    ``nu``-quantile of the training scores, so about ``nu`` of the training
    points get ``f(x) < 0``.  Returns a Model with ``is_one_class`` set:
    ``csvm.predict`` gives +1 (inlier) / -1 (outlier),
    ``csvm.predict_values`` the decision values, ``model.save`` LIBSVM's
    ``one_class`` layout.

    ``csvm``'s device, backend, Gram tier, solver (``_use_explicit_solver``,
    the classifier's rule) and ``devices`` apply as in ``CSVM.fit``:
    ``devices`` runs the solve on the row-sharded ring with the dots summed
    per shard (compensated for a float32 solve, as plssvm_tpu's sharded
    solve); one device takes plssvm_tpu's plain dot.  ``initial_model``
    warm-starts CG from a previous one-class fit on the same points (the
    stop target stays the cold start's); ``sample_weight`` puts ``1/(C
    s_i)`` on the diagonal; ``checkpoint_path`` saves the CG state every
    ``checkpoint_interval`` iterations and resumes from a matching file.
    """
    n = data.num_data_points
    d = data.num_features
    max_iter = _validate_one_class_args(nu, epsilon, max_iter, n)
    if checkpoint_path is not None:
        if int(checkpoint_interval) < 1:
            raise InvalidParameterError(
                f"checkpoint_interval must be at least 1, but is {checkpoint_interval}!"
            )
        if initial_model is not None:
            raise InvalidParameterError(
                "initial_model cannot be combined with CG-state "
                "checkpointing (the checkpoint already carries the "
                "solver state)!"
            )
    params = csvm.params.copy()
    if params.gamma.is_default():
        params.gamma.value = 1.0 / d
    kind = params.kernel_type.value
    if kind == KernelFunctionType.CHI_SQUARED and np.any(np.asarray(data.data) < 0.0):
        raise InvalidParameterError("chi-squared kernel requires non-negative data!")
    if initial_model is not None and initial_model.num_support_vectors != n:
        raise InvalidParameterError(
            f"initial_model has {initial_model.num_support_vectors} "
            f"support vectors but the data set has {n} points!"
        )

    dt = csvm.dtype
    X_host = np.asarray(data.data, dtype=dt)
    civ = _one_class_civ(params.cost.value, sample_weight, n, dt)
    n_dev = len(csvm.devices[:n]) if csvm.devices else 1
    use_explicit = csvm._use_explicit_solver(n, d, kind, n_dev, 1, data)
    add_tracking_entry("cg", "solver", "cg_explicit" if use_explicit else "cg_implicit")

    X = csvm._tensor(X_host)
    gamma = params.resolved_gamma(d)
    coef0 = params.coef0.value
    degree = params.degree.value
    impl = csvm._impl()
    K = (csvm._build_explicit_k(data, X, gamma, coef0, kind, degree)
         if use_explicit else None)
    if csvm.devices is not None:
        from .parallel.sharded import ridge_sharded_operators

        kernel_mv, dot = ridge_sharded_operators(
            X, devices=csvm.devices, kind=kind, degree=degree, impl=impl,
            scalars=csvm.scalar_precision, gram_precision=csvm.gram_precision,
            kernel_matrix=K)
    else:
        kernel_mv = (_explicit_matvec(K) if use_explicit
                     else _make_kernel_matvec(kind, degree, impl, csvm.gram_precision))
        dot = torch.dot
    sq = torch.sum(X * X, dim=-1)
    cost_inv = 1.0 / params.cost.value if civ is None else csvm._tensor(civ)
    b = torch.ones(n, dtype=X.dtype, device=X.device)

    def matvec(v):
        return kernel_mv(X, sq, v, gamma, coef0) + cost_inv * v

    x_init = (None if initial_model is None
              else csvm._tensor(np.asarray(initial_model.alpha, dtype=dt)))

    def solve_once(seg_end):
        return ridge_cg_core(b, matvec, dot, eps=epsilon, max_iter=seg_end, x_init=x_init,
                             debug=csvm.debug)

    def resume_once(seg_end, state):
        x, r, d_, delta, delta0, it = state
        placed = tuple(torch.as_tensor(np.asarray(a, dtype=dt), device=X.device)
                       for a in (x, r, d_, delta, delta0))
        return ridge_cg_core(b, matvec, dot, eps=epsilon, max_iter=seg_end,
                             init_state=placed + (it,), debug=csvm.debug)

    if checkpoint_path is None:
        res = solve_once(max_iter)
    else:
        params_repr = repr(params) + "|one_class"
        if civ is not None:
            from .solver.checkpoint import weights_digest_suffix

            params_repr += weights_digest_suffix(sample_weight)
        res = _run_ridge_segments(solve_once, resume_once, X, b, params_repr, epsilon,
                                  max_iter, checkpoint_path, int(checkpoint_interval))
    x, _r, _d, delta, _delta0, iterations = res
    # the training scores g = K alpha, for the nu-quantile threshold
    g = kernel_mv(X, sq, x, gamma, coef0)
    alpha = x.cpu().numpy()
    g = g.cpu().numpy().astype(np.float64)

    _log_one_class_result(iterations, max_iter, float(delta), epsilon, nu)
    rho = float(np.quantile(g, nu))
    model = Model(params, DataSet(X_host, dtype=dt), alpha=alpha, rho=rho)
    model.is_one_class = True
    model.n_iter = iterations
    return model


def fit_one_class_multihost(csvm, filename: str, **kwargs) -> Model:
    """plssvm_tpu's multi-host one-class fit (each host parses its row
    window of ``filename``): not ported yet."""
    raise NotPortedError(
        "fit_one_class_multihost is not ported yet (ROADMAP Queue 1, item 10: "
        "parallel/multihost.py on torch.distributed)"
    )
