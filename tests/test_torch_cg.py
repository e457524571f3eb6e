"""The port's CG solver against plssvm_tpu's.

Compensated scalars: the same TwoSum fold in both packages, odd lengths
included, must give the same bits.  ``solve_ls_svm`` against
``plssvm_tpu.solver.cg.solve_ls_svm(impl="xla")`` on seeded overlapping
blobs (n=300, d=20), RBF and polynomial:

- f64: same iteration count, alpha rtol 1e-8 (relative to max|alpha|),
  rho within 1e-9.  The CG path from the reference's start vector x = 1
  begins with a residual ~1e8 times the final one, so rounding noise in
  the early steps is amplified: on some problems plssvm_tpu disagrees with
  itself by 1e-5 in rho when only its row block (its summation order)
  changes.  The configurations below are ones where plssvm_tpu agrees with
  itself across row blocks by far more than the tolerance, so that the
  comparison measures the port and not that noise;
- f32 with compensated scalars: iterations within 2, alpha rtol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plssvm_tpu.solver.cg as jcg
import plssvm_tpu_torch.solver.cg as tcg
from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind

N, D = 300, 20


def blobs(shift, seed=0):
    """Two overlapping Gaussian classes, means +-shift per feature."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(N) < 0.5, -1.0, 1.0)
    X = rng.normal(size=(N, D)) + shift * y[:, None]
    return X, y


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001, 4097])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compensated_sum_and_dot_match_bitwise(n, dtype):
    rng = np.random.default_rng(n)
    # large dynamic range, so the compensation carries real information
    a = (rng.normal(size=n) * 10.0 ** rng.integers(-6, 6, size=n)).astype(dtype)
    b = rng.normal(size=n).astype(dtype)
    want = np.asarray(jcg.compensated_sum(jnp.asarray(a)))
    got = tcg.compensated_sum(torch.from_numpy(a)).numpy()
    assert got.dtype == want.dtype and got == want
    want = np.asarray(jcg.compensated_dot(jnp.asarray(a), jnp.asarray(b)))
    got = tcg.compensated_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got == want


def _solve_both(kind_name, X, y, dtype, *, C, eps, coef0, scalars):
    jkind = getattr(JKind, kind_name.upper())
    tkind = getattr(TKind, kind_name.upper())
    Xd, yd = X.astype(dtype), y.astype(dtype)
    gamma = 1.0 / D
    ref = jcg.solve_ls_svm(
        jnp.asarray(Xd[:-1]), jnp.asarray(Xd[-1]), jnp.asarray(yd[:-1]),
        jnp.asarray(yd[-1]), jnp.ones(N - 1, dtype), jnp.asarray(gamma, dtype),
        jnp.asarray(coef0, dtype), jnp.asarray(C, dtype),
        jnp.asarray(eps, dtype), jnp.asarray(N, jnp.int32),
        kind=jkind, degree=3, impl="xla", scalars=scalars,
    )
    got = tcg.solve_ls_svm(
        torch.from_numpy(Xd[:-1]), torch.from_numpy(Xd[-1]),
        torch.from_numpy(yd[:-1]), float(yd[-1]), gamma, coef0, C, eps, N,
        kind=tkind, degree=3, impl="torch", scalars=scalars,
    )
    return ref, got


@pytest.mark.parametrize(
    "kind_name,shift,eps,coef0",
    [("rbf", 1.0, 1e-9, 0.0), ("polynomial", 0.4, 1e-11, 0.0)],
)
def test_solve_f64_matches_reference(kind_name, shift, eps, coef0):
    X, y = blobs(shift)
    ref, got = _solve_both(
        kind_name, X, y, np.float64, C=0.1, eps=eps, coef0=coef0,
        scalars="plain",
    )
    assert got.iterations == int(ref.iterations) >= 8
    ref_x = np.asarray(ref.x)
    np.testing.assert_allclose(
        got.x.numpy(), ref_x, rtol=0, atol=1e-8 * np.abs(ref_x).max()
    )
    assert abs(float(got.alpha_last) - float(ref.alpha_last)) <= 1e-8 * np.abs(ref_x).max()


@pytest.mark.parametrize("kind_name,coef0", [("rbf", 0.0), ("polynomial", 1.0)])
def test_solve_f32_compensated_matches_reference(kind_name, coef0):
    X, y = blobs(0.4)
    ref, got = _solve_both(
        kind_name, X, y, np.float32, C=1.0, eps=1e-3, coef0=coef0,
        scalars="compensated",
    )
    assert abs(got.iterations - int(ref.iterations)) <= 2
    ref_x = np.asarray(ref.x)
    np.testing.assert_allclose(
        got.x.numpy(), ref_x, rtol=0, atol=1e-3 * np.abs(ref_x).max()
    )


def test_exact_residual_cadence():
    """Every 50th iteration recomputes the residual from scratch: one extra
    matvec at iteration 49.  Run to max_iter=60 on a linear problem that
    converges long before, the port's iterate equals the reference's."""
    rng = np.random.default_rng(5)
    d = 100
    y = np.where(rng.random(N) < 0.5, -1.0, 1.0)
    X = rng.normal(size=(N, d)) + 0.2 * y[:, None]
    calls = []

    def counting_mv(X_, sq, v, gamma, coef0):
        calls.append(1)
        return X_ @ (X_.T @ v)

    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    got = tcg.cg_ls_svm_core(
        Xt[:-1], Xt[-1], yt[:-1], float(y[-1]), 1.0 / d, 0.0, 1.0, 1e-30, 60,
        kind=TKind.LINEAR, degree=3, kernel_mv=counting_mv,
    )
    assert got.iterations == 60
    assert len(calls) == 1 + 60 + 1  # initial residual, iterations, it=49
    ref = jcg.solve_ls_svm(
        jnp.asarray(X[:-1]), jnp.asarray(X[-1]), jnp.asarray(y[:-1]),
        jnp.asarray(y[-1]), jnp.ones(N - 1), jnp.asarray(1.0 / d),
        jnp.asarray(0.0), jnp.asarray(1.0), jnp.asarray(1e-30),
        jnp.asarray(60, jnp.int32), kind=JKind.LINEAR, degree=3, impl="xla",
    )
    ref_x = np.asarray(ref.x)
    np.testing.assert_allclose(
        got.x.numpy(), ref_x, rtol=0, atol=1e-8 * np.abs(ref_x).max()
    )
