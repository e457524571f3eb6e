"""Robust LS-SVR (iteratively reweighted refits) of the port against
plssvm_tpu's, on the CPU.

``plssvm_tpu_torch/robust.py`` is plssvm_tpu's NumPy host code over the
port's ``fit(sample_weight=, initial_model=)``.  ``hampel_weights`` is held
exactly against plssvm_tpu's on the same residuals; ``reweighted_fit``
against plssvm_tpu's with ``CSVM(backend="xla", dtype=np.float64)`` at
epsilon 1e-12 on a seeded Friedman #1 set with 5 % of its targets shifted
by six standard deviations: alpha within 1e-8 of its largest magnitude, rho
within 1e-8.  The iteration counts are not compared: the weighted,
warm-started refits sit on a flat stretch of their residual curve, where
plssvm_tpu's own implicit and explicit solves of the same refit differ by
up to four iterations at epsilon 1e-10 on these seeds (ROADMAP Queue 3
item 5).
"""

import numpy as np
import pytest

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu import robust as j_robust
from plssvm_tpu_torch import robust as t_robust
from plssvm_tpu_torch.exceptions import InvalidParameterError

#: the refits' epsilon: at 1e-10 plssvm_tpu's own implicit and explicit
#: solves of these refits give alphas 1.4e-8 apart (relative to the largest)
EPS = 1e-12
TOL = 1e-8


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def _contaminated(n=150, d=6, seed=0, share=0.05):
    """Friedman #1 targets, a ``share`` of them shifted by +-6 standard
    deviations; the clean targets returned beside."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    clean = (10 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20 * (X[:, 2] - 0.5) ** 2
             + 10 * X[:, 3] + 5 * X[:, 4])
    y = clean + rng.normal(size=n)
    bad = rng.choice(n, int(share * n), replace=False)
    y[bad] += 6.0 * y.std() * rng.choice([-1.0, 1.0], len(bad))
    return X, y, clean


@pytest.mark.parametrize("case", ["normal", "heavy", "zero_iqr", "zero_mad", "all_zero",
                                  "custom_cuts"])
def test_hampel_weights(case):
    rng = np.random.default_rng(1)
    e = {"normal": rng.normal(size=300),
         "heavy": rng.standard_t(1.5, size=300),
         "zero_iqr": np.concatenate([np.zeros(90), rng.normal(size=10) * 5]),
         "zero_mad": np.concatenate([np.zeros(99), [3.0]]),
         "all_zero": np.zeros(20),
         "custom_cuts": rng.laplace(size=200)}[case]
    kw = dict(c1=1.5, c2=4.0, floor=1e-3) if case == "custom_cuts" else {}
    got = t_robust.hampel_weights(e, **kw)
    want = j_robust.hampel_weights(e, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.min() > 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("kernel,solver", [("rbf", "cg_implicit"), ("rbf", "cg_explicit"),
                                           ("laplacian", "cg_implicit")])
def test_reweighted_fit_against_the_reference(kernel, solver):
    X, y, _ = _contaminated()
    fits = []
    for package, where in ((plssvm_tpu_torch, dict(device="cpu")),
                           (plssvm_tpu, dict(backend="xla"))):
        svm = package.CSVM(dtype=np.float64, kernel_type=kernel, cost=10.0, solver=solver,
                           **where)
        fits.append(package.reweighted_fit(svm, package.DataSet(X, y, regression=True),
                                           iterations=2, epsilon=EPS))
    got, want = fits
    assert got.is_regression
    alpha = np.asarray(want.alpha)
    np.testing.assert_allclose(got.alpha, alpha, rtol=0, atol=TOL * np.abs(alpha).max())
    assert abs(got.rho - want.rho) <= TOL * max(1.0, abs(want.rho))


def test_reweighted_fit_resists_the_outliers():
    """The robust fit's held-out R^2 against the clean targets beats the
    plain fit's on the contaminated set."""
    X, y, clean = _contaminated(n=400, seed=2)
    svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="rbf", cost=10.0)
    train = plssvm_tpu_torch.DataSet(X[:300], y[:300], regression=True)
    test = plssvm_tpu_torch.DataSet(X[300:], clean[300:], regression=True)
    plain = svm.fit(train, epsilon=1e-6)
    robust = plssvm_tpu_torch.reweighted_fit(svm, train, iterations=2, epsilon=1e-6)
    assert svm.score(robust, test) > svm.score(plain, test)


def test_refits_reuse_the_stored_kernel_matrix():
    """With the explicit solver the kernel matrix cached on the data set
    serves every refit (it does not depend on the weights): one build,
    then build times of 0.0."""
    X, y, _ = _contaminated(seed=3)
    svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="rbf",
                                solver="cg_explicit")
    plssvm_tpu_torch.global_tracker.clear()
    plssvm_tpu_torch.reweighted_fit(svm, plssvm_tpu_torch.DataSet(X, y, regression=True),
                                    iterations=3, epsilon=1e-6)
    builds = [v for k, v in plssvm_tpu_torch.global_tracker.entries()["cg"]
              if k == "kernel_matrix_build_time"]
    assert len(builds) == 4 and builds[0] > 0.0 and builds[1:] == [0.0, 0.0, 0.0]


def test_reweighted_fit_refusals():
    X, y, _ = _contaminated(n=40)
    svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64)
    with pytest.raises(InvalidParameterError, match="regression DataSet"):
        plssvm_tpu_torch.reweighted_fit(svm, plssvm_tpu_torch.DataSet(X, y > y.mean()))
    with pytest.raises(InvalidParameterError, match="iterations must be at least 1"):
        plssvm_tpu_torch.reweighted_fit(
            svm, plssvm_tpu_torch.DataSet(X, y, regression=True), iterations=0)
