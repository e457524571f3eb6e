"""The port's kernel functions against plssvm_tpu's, in float64.

Same numpy inputs through both packages for linear / polynomial / RBF /
sigmoid, polynomial degrees 0-4; rtol 1e-12.  The distance kernels have no
Gram form: asked for one, both packages raise (their values are held
against plssvm_tpu in tests/test_torch_distance.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plssvm_tpu.kernel_functions as jk
import plssvm_tpu_torch.kernel_functions as tk
from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu.parameter import Parameter as JParameter
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind
from plssvm_tpu_torch.parameter import Parameter as TParameter

RTOL = 1e-12
CASES = [("linear", 3), ("sigmoid", 3), ("rbf", 3)] + [
    ("polynomial", deg) for deg in range(5)
]
GAMMA, COEF0 = 0.3, 0.75


@pytest.fixture
def data():
    rng = np.random.default_rng(41)
    return rng.normal(size=(13, 6)), rng.normal(size=(9, 6)), rng.normal(size=6)


def _kinds(name):
    return getattr(JKind, name.upper()), getattr(TKind, name.upper())


@pytest.mark.parametrize("name,degree", CASES)
def test_apply_kernel_to_gram_and_kernel_block(data, name, degree):
    X, Y, _ = data
    jkind, tkind = _kinds(name)
    sqx, sqy = (X * X).sum(1), (Y * Y).sum(1)
    want = np.asarray(jk.kernel_block(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(sqx), jnp.asarray(sqy),
        jkind, GAMMA, COEF0, degree,
    ))
    got = tk.kernel_block(
        torch.from_numpy(X), torch.from_numpy(Y), torch.from_numpy(sqx),
        torch.from_numpy(sqy), tkind, GAMMA, COEF0, degree,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    gram = X @ Y.T
    want = np.asarray(jk.apply_kernel_to_gram(
        jnp.asarray(gram), jnp.asarray(sqx)[:, None], jnp.asarray(sqy)[None, :],
        jkind, GAMMA, COEF0, degree,
    ))
    got = tk.apply_kernel_to_gram(
        torch.from_numpy(gram), torch.from_numpy(sqx)[:, None],
        torch.from_numpy(sqy)[None, :], tkind, GAMMA, COEF0, degree,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("name,degree", CASES)
def test_kernel_self_diag_and_against_point(data, name, degree):
    X, _, p = data
    jkind, tkind = _kinds(name)
    sq = (X * X).sum(1)
    want = np.asarray(jk.kernel_self_diag(jnp.asarray(sq), jkind, GAMMA, COEF0, degree))
    got = tk.kernel_self_diag(torch.from_numpy(sq), tkind, GAMMA, COEF0, degree).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    want = np.asarray(jk.kernel_against_point(
        jnp.asarray(X), jnp.asarray(p), jkind, GAMMA, COEF0, degree
    ))
    got = tk.kernel_against_point(
        torch.from_numpy(X), torch.from_numpy(p), tkind, GAMMA, COEF0, degree
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("name,degree", CASES)
def test_kernel_function(data, name, degree):
    X, Y, _ = data
    kw = dict(kernel_type=name, gamma=GAMMA, coef0=COEF0, degree=degree)
    want = jk.kernel_function(X[0], Y[0], JParameter(**kw))
    got = tk.kernel_function(X[0], Y[0], TParameter(**kw))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("name", ["laplacian", "chi_squared"])
def test_distance_kernels_raise(data, name):
    """apply_kernel_to_gram raises ValueError for a distance kernel in both
    packages; the entry points that serve them agree with plssvm_tpu."""
    X, Y, p = data
    X, Y, p = np.abs(X), np.abs(Y), np.abs(p)  # chi-squared's domain
    jkind, tkind = _kinds(name)
    gram = X @ Y.T
    with pytest.raises(ValueError, match="not Gram-expressible"):
        jk.apply_kernel_to_gram(jnp.asarray(gram), 0.0, 0.0, jkind, GAMMA, COEF0, 3)
    with pytest.raises(ValueError, match="not Gram-expressible"):
        tk.apply_kernel_to_gram(torch.from_numpy(gram), 0.0, 0.0, tkind, GAMMA, COEF0, 3)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    want = np.asarray(jk.kernel_block(
        jnp.asarray(X), jnp.asarray(Y), jnp.zeros(13), jnp.zeros(9), jkind,
        GAMMA, COEF0, 3,
    ))
    got = tk.kernel_block(Xt, Yt, None, None, tkind, GAMMA, COEF0, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    want = np.asarray(jk.kernel_against_point(
        jnp.asarray(X), jnp.asarray(p), jkind, GAMMA, COEF0, 3
    ))
    got = tk.kernel_against_point(Xt, torch.from_numpy(p), tkind, GAMMA, COEF0, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    want = jk.kernel_function(X[0], Y[0], JParameter(kernel_type=name))
    got = tk.kernel_function(X[0], Y[0], TParameter(kernel_type=name))
    assert got == pytest.approx(want, rel=RTOL)
