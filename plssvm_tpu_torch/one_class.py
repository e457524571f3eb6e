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

from typing import Optional

import numpy as np
import torch

from .data_set import DataSet
from .exceptions import InvalidParameterError
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


def _one_class_repr(params, civ, sample_weight) -> str:
    """The parameters in a one-class checkpoint's fingerprint, with the
    digest of the sample weights."""
    params_repr = repr(params) + "|one_class"
    if civ is not None:
        from .solver.checkpoint import weights_digest_suffix

        params_repr += weights_digest_suffix(sample_weight)
    return params_repr


def _ridge_state(dt, device, lo, hi):
    """``place`` of ``run_segments`` for the ridge solve: rows [lo, hi) of
    a checkpoint's state on ``device``."""
    def place(ckpt):
        return tuple(torch.as_tensor(np.asarray(a, dtype=dt), device=device)
                     for a in (ckpt.x[lo:hi], ckpt.r[lo:hi], ckpt.d[lo:hi], ckpt.delta,
                               ckpt.delta0)) + (int(ckpt.iteration),)

    return place


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

    def solve(seg_end, init_state=None):
        return ridge_cg_core(b, matvec, dot, eps=epsilon, max_iter=seg_end,
                             x_init=None if init_state is not None else x_init,
                             init_state=init_state, debug=csvm.debug)

    if checkpoint_path is None:
        res = solve(max_iter)
    else:
        from .solver.checkpoint import problem_fingerprint, run_segments

        fingerprint = problem_fingerprint(X, b, _one_class_repr(params, civ, sample_weight),
                                          epsilon)
        res = run_segments(solve, _ridge_state(dt, X.device, 0, n), fingerprint=fingerprint,
                           epsilon=epsilon, max_iter=int(max_iter), path=checkpoint_path,
                           interval=int(checkpoint_interval), ridge=True,
                           label="one-class CG")
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


def fit_one_class_multihost(
    csvm,
    filename: str,
    *,
    nu: float = 0.5,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    sample_weight=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_interval: int = 1000,
    initial_model: Optional[Model] = None,
) -> Model:
    """A one-class fit of ``filename`` over the processes of a
    ``torch.distributed`` job (plssvm_tpu's ``fit_one_class_multihost``).

    Each rank parses only its window of rows ``shard_bounds(n, world)[rank]``
    (labels ignored); the ridge CG runs on the ring of ranks
    (``parallel/multihost.py::rank_product``, or each rank's row block of
    the explicit K) with the dots summed in rank order; rho is the
    ``nu``-quantile of the scores gathered from every rank, so every rank
    returns the same model.  ``sample_weight`` (one per file row) and
    ``initial_model`` (a one-class fit of the same file: its rows keep the
    file's order) are sliced to each window; ``checkpoint_path`` (on
    storage every rank reads) saves from rank 0, the fingerprint binding
    every window's bytes through a digest gathered from each rank.  At one
    process it equals :func:`fit_one_class` on the file up to the order of
    its sums.
    """
    import hashlib
    import time

    from .parallel import multihost as mh

    start = time.perf_counter()
    if checkpoint_path is not None and int(checkpoint_interval) < 1:
        raise InvalidParameterError(
            f"checkpoint_interval must be at least 1, but is {checkpoint_interval}!"
        )
    if initial_model is not None and checkpoint_path is not None:
        raise InvalidParameterError(
            "initial_model cannot be combined with CG-state "
            "checkpointing (the checkpoint already carries the "
            "solver state)!"
        )
    group = mh.rank_group(csvm)
    dt = csvm.dtype
    windows = mh._FileWindows(filename, dt)
    n, d = windows.n, windows.d
    max_iter = _validate_one_class_args(nu, epsilon, max_iter, n)
    params = csvm.params.copy()
    if params.gamma.is_default():
        params.gamma.value = 1.0 / d
    kind = params.kernel_type.value
    civ = _one_class_civ(params.cost.value, sample_weight, n, dt)
    if initial_model is not None and initial_model.num_support_vectors != n:
        raise InvalidParameterError(
            f"initial_model has {initial_model.num_support_vectors} "
            f"support vectors but the data set has {n} points!"
        )
    bounds = mh.rank_bounds(group, n)
    lo, hi = bounds[group.rank]
    windows.check_index(group)
    X_win = windows.rows(lo, hi)
    mh.check_chi_squared(group, kind, mh._local_min(X_win),
                         "chi-squared kernel requires non-negative data!")

    X = csvm._tensor(X_win)
    gamma, coef0, degree = params.resolved_gamma(d), params.coef0.value, params.degree.value
    impl = csvm._impl()
    use_explicit = mh.use_explicit_solver(csvm, group, bounds, d, kind)
    add_tracking_entry("cg", "solver", "cg_explicit" if use_explicit else "cg_implicit")
    if use_explicit:
        K_p = mh.build_rank_kernel_matrix(group, bounds, X, gamma, coef0, kind=kind,
                                          degree=degree, precision=csvm.gram_precision,
                                          impl=impl)
        kernel_mv = mh.rank_explicit_product(group, bounds, K_p)
    else:
        kernel_mv = mh.rank_product(group, bounds, X, kind=kind, degree=degree, impl=impl,
                                    precision=csvm.gram_precision)
    dot, _, _ = mh.rank_reductions(group, bounds, csvm.scalar_precision)
    cost_inv = 1.0 / params.cost.value if civ is None else csvm._tensor(civ[lo:hi])
    b = torch.ones(hi - lo, dtype=X.dtype, device=X.device)

    def matvec(v):
        return kernel_mv(X, None, v, gamma, coef0) + cost_inv * v

    x_init = (None if initial_model is None
              else csvm._tensor(np.asarray(initial_model.alpha, dtype=dt)[lo:hi]))

    def solve(seg_end, init_state=None):
        return ridge_cg_core(b, matvec, dot, eps=epsilon, max_iter=seg_end,
                             x_init=None if init_state is not None else x_init,
                             init_state=init_state, debug=csvm.debug, agree=group.agree)

    if checkpoint_path is None:
        res = solve(max_iter)
    else:
        from .solver.checkpoint import run_segments

        # no label column or folded row to bind the data: every rank's
        # window digest, gathered, binds it
        digest = np.frombuffer(hashlib.sha256(np.ascontiguousarray(X_win).tobytes())
                               .digest(), dtype=np.uint8).astype(np.float64)
        fingerprint = mh._multihost_fingerprint(
            n, d, _one_class_repr(params, civ, sample_weight), epsilon,
            group.host_values(digest), np.zeros(1), n)
        res = run_segments(solve, _ridge_state(dt, X.device, lo, hi), fingerprint=fingerprint,
                           epsilon=epsilon, max_iter=int(max_iter), path=checkpoint_path,
                           interval=int(checkpoint_interval), ridge=True,
                           label="multi-process one-class CG", group=group, bounds=bounds)
    x, r, d_, delta, _delta0, iterations = res
    mh._record((lo, hi), dict(X=X.shape[0], x=x.shape[0], r=r.shape[0], d=d_.shape[0]))
    # the training scores g = K alpha of every rank, for the nu-quantile
    g = group.all_gather_rows(kernel_mv(X, None, x, gamma, coef0), bounds)
    alpha = group.all_gather_rows(x, bounds).cpu().numpy()
    g = g.cpu().numpy().astype(np.float64)
    if group.rank == 0:
        _log_one_class_result(iterations, max_iter, float(delta), epsilon, nu)
    mh._track(group, start, iterations, float(delta), libsvm=False)
    rho = float(np.quantile(g, nu))
    X_full = X_win if group.world == 1 else windows.rows(0, n)
    model = Model(params, DataSet(np.asarray(X_full, dtype=dt), dtype=dt), alpha=alpha,
                  rho=rho)
    model.is_one_class = True
    model.n_iter = iterations
    return model
