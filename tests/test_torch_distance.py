"""The laplacian and chi-squared kernels: the port against plssvm_tpu.

Inputs are made from a seed with numpy and handed to both packages;
plssvm_tpu runs as its own tests run it on the CPU (``backend="xla"``,
``solver="cg_implicit"``, float64, and its Pallas distance kernels K7 and
K9 in interpret mode).

- the kernel functions (pairwise distance, distance to a point, kernel
  block, q vector, diagonal, host ``kernel_function``) in float64 at rtol
  1e-12, on a prime row count, a feature count that is no multiple of 16,
  and chi-squared inputs with zero entries and an all-zero row (0/0 is 0);
- the plain distance versions (the oracles of kernels E-H) against K7 and
  K9 in interpret mode in float32 at tests/test_ops.py's tolerances (rtol
  3e-5 / atol 1e-5 for the matvec, 5e-5 for the matmat), and against
  plssvm_tpu's XLA upper-triangle walk in float64 at 1e-12 of max|value|;
- the CG, binary and one-vs-all block, in float64 against
  ``solve_ls_svm`` / ``solve_ls_svm_multi``: the same iteration counts,
  rho and alpha within 1e-8 (tests/test_torch_csvm.py says why the solves
  run to epsilon 1e-10).  The seeds are ones where plssvm_tpu's own counts
  and rho (within 1e-10) do not change with its row block (16, 64, 256);
- ``CSVM`` and both CLIs end to end, model files carried across with
  ``model_from_numpy``, one-vs-one chi-squared model files, and the
  chi-squared data check: the same labels, decision values within 1e-8,
  the same error messages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plssvm_tpu
import plssvm_tpu.kernel_functions as jk
import plssvm_tpu.solver.cg as jcg
import plssvm_tpu_torch
import plssvm_tpu_torch.kernel_functions as tk
import plssvm_tpu_torch.solver.cg as tcg
from plssvm_tpu.cli import predict as j_predict_cli
from plssvm_tpu.cli import train as j_train_cli
from plssvm_tpu.ops.matvec import distance_kernel_matvec_sym
from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu.parameter import Parameter as JParameter
from plssvm_tpu_torch.cli import predict as t_predict_cli
from plssvm_tpu_torch.cli import train as t_train_cli
from plssvm_tpu_torch.ops import _build, distance, matvec
from plssvm_tpu_torch.parameter import ClassificationType
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind
from plssvm_tpu_torch.parameter import Parameter as TParameter

KINDS = ["laplacian", "chi_squared"]
RTOL = 1e-12
EPS = 1e-10
TOL = 1e-8
#: per (kernel, class count), a seed whose reference iteration counts and
#: rho do not move with plssvm_tpu's row block (see above)
STABLE_SEED = {
    ("laplacian", 2): 3, ("laplacian", 3): 3, ("laplacian", 4): 1,
    ("chi_squared", 2): 1, ("chi_squared", 3): 2, ("chi_squared", 4): 2,
}


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def _kinds(name):
    return getattr(JKind, name.upper()), getattr(TKind, name.upper())


def histograms(rng, m, d):
    """Non-negative rows, about 30 % of the entries 0 and the last row all
    0."""
    X = np.abs(rng.normal(size=(m, d)))
    X[X < 0.4] = 0.0
    X[-1] = 0.0
    return X


def classes(n_classes, seed, n=240, d=10):
    """Gaussian classes around seeded means, scaled to [0, 1] with the
    training rows' factors (the test rows clipped at 0, for chi-squared);
    the first 200 rows train, the rest test."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n)
    X = rng.normal(size=(n, d)) + 0.8 * rng.normal(size=(n_classes, d))[labels]
    lo, hi = X[:200].min(0), X[:200].max(0)
    X = np.clip((X - lo) / (hi - lo), 0.0, None)
    return X[:200], labels[:200], X[200:], labels[200:]


# -- the kernel functions ---------------------------------------------------


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("b,m,d", [(13, 9, 6), (7, 263, 300), (31, 37, 17)])
def test_pairwise_distance_and_kernel_block(name, b, m, d):
    """m = 263 and d = 300 cross the 256-wide column and feature tiles."""
    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(b * m + d)
    A, B = histograms(rng, b, d), histograms(rng, m, d)
    want = np.asarray(jk.pairwise_distance(jnp.asarray(A), jnp.asarray(B), jkind))
    got = tk.pairwise_distance(torch.from_numpy(A), torch.from_numpy(B), tkind).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1, -1] == 0.0  # two all-zero rows: every term is 0/0
    sq_a, sq_b = (A * A).sum(1), (B * B).sum(1)
    want = np.asarray(jk.kernel_block(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(sq_a), jnp.asarray(sq_b),
        jkind, 0.3, 0.0, 3,
    ))
    got = tk.kernel_block(
        torch.from_numpy(A), torch.from_numpy(B), None, None, tkind, 0.3, 0.0, 3
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("m", [1, 37, 4099])
def test_distance_to_point_and_kernel_against_point(name, m):
    """m = 4099 is prime and crosses distance_to_point's 4096-row block."""
    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(m)
    X = histograms(rng, m, 19)
    for p in (X[0], np.zeros(19)):
        want = np.asarray(jk.distance_to_point(jnp.asarray(X), jnp.asarray(p), jkind))
        got = tk.distance_to_point(torch.from_numpy(X), torch.from_numpy(p), tkind).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL)
        want = np.asarray(jk.kernel_against_point(
            jnp.asarray(X), jnp.asarray(p), jkind, 0.2, 0.0, 3
        ))
        got = tk.kernel_against_point(
            torch.from_numpy(X), torch.from_numpy(p), tkind, 0.2, 0.0, 3
        ).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("name", KINDS)
def test_kernel_self_diag_and_kernel_function(name):
    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(3)
    X = histograms(rng, 5, 8)
    sq = (X * X).sum(1)
    want = np.asarray(jk.kernel_self_diag(jnp.asarray(sq), jkind, 0.3, 0.0, 3))
    got = tk.kernel_self_diag(torch.from_numpy(sq), tkind, 0.3, 0.0, 3).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.ones(5))
    for u, v in ((X[0], X[2]), (X[4], X[4]), (X[4], X[3])):
        want = jk.kernel_function(u, v, JParameter(kernel_type=name, gamma=0.3))
        got = tk.kernel_function(u, v, TParameter(kernel_type=name, gamma=0.3))
        assert got == pytest.approx(want, rel=RTOL)


# -- the plain versions against K7 and K9 -----------------------------------


def _pallas_matvec(X, Y, vy, vx, jkind, gamma, symmetric):
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_distance import distance_matvec_pallas_dual

    with pltpu.force_tpu_interpret_mode():
        r, c = distance_matvec_pallas_dual(
            jnp.asarray(X), jnp.asarray(Y), jnp.asarray(vy), jnp.asarray(vx),
            kind=jkind, gamma=gamma, symmetric=symmetric,
        )
    return np.asarray(r, np.float64), np.asarray(c, np.float64)


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("shape", [(256, 256), (384, 128), (256, 640)])
def test_plain_sym_matches_k7(name, shape):
    """Kernel E's oracle against K7's upper-triangle walk (r + c)."""
    jkind, tkind = _kinds(name)
    m, d = shape
    rng = np.random.default_rng(1)
    X = np.abs(rng.normal(size=(m, d))).astype(np.float32)
    v = rng.normal(size=(m,)).astype(np.float32)
    gamma = 0.5 / d
    r, c = _pallas_matvec(X, X, v, v, jkind, gamma, True)
    got = matvec.distance_matvec_plain(
        torch.from_numpy(X), torch.from_numpy(v), kind=tkind, gamma=gamma
    ).numpy()
    np.testing.assert_allclose(got, r + c, rtol=3e-5, atol=1e-5)


@pytest.mark.parametrize("name", KINDS)
def test_plain_rect_matches_k7_both_contractions(name):
    """K7 with symmetric=False gives (K @ vy, K^T @ vx); kernel F's oracle
    gives each from its own side."""
    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(2)
    mr, mc, d = 256, 128, 192
    X = np.abs(rng.normal(size=(mr, d))).astype(np.float32)
    Y = np.abs(rng.normal(size=(mc, d))).astype(np.float32)
    vy = rng.normal(size=(mc,)).astype(np.float32)
    vx = rng.normal(size=(mr,)).astype(np.float32)
    r, c = _pallas_matvec(X, Y, vy, vx, jkind, 0.01, False)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    kw = dict(kind=tkind, gamma=0.01)
    rows = matvec.distance_matvec_rect_plain(Xt, Yt, torch.from_numpy(vy), **kw).numpy()
    cols = matvec.distance_matvec_rect_plain(Yt, Xt, torch.from_numpy(vx), **kw).numpy()
    np.testing.assert_allclose(rows, r, rtol=3e-5, atol=1e-5)
    np.testing.assert_allclose(cols, c, rtol=3e-5, atol=1e-5)


@pytest.mark.parametrize("name", KINDS)
def test_plain_matmats_match_k9(name):
    """Kernel G's oracle against K9's symmetric walk (through its
    composition), kernel H's against K9 with symmetric=False, C = 3."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_distance import (
        distance_matmat_pallas_big,
        distance_matmat_pallas_dual,
    )
    from plssvm_tpu.ops.pallas_matvec import pack_class_major

    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(6)
    m, d, C = 256, 192, 3
    X = np.abs(rng.normal(size=(m, d))).astype(np.float32)
    V = rng.normal(size=(m, C)).astype(np.float32)
    Y = np.abs(rng.normal(size=(128, d))).astype(np.float32)
    Vy = rng.normal(size=(128, C)).astype(np.float32)
    gamma = 0.02
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(distance_matmat_pallas_big(
            jnp.asarray(X), jnp.asarray(V), kind=jkind, gamma=gamma
        ), np.float64)
        r, c = distance_matmat_pallas_dual(
            jnp.asarray(X), jnp.asarray(Y), pack_class_major(jnp.asarray(Vy)),
            pack_class_major(jnp.asarray(V)), kind=jkind, gamma=gamma,
            symmetric=False,
        )
    kw = dict(kind=tkind, gamma=gamma)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    got = matvec.distance_matmat_plain(Xt, torch.from_numpy(V), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
    rows = matvec.distance_matmat_rect_plain(Xt, Yt, torch.from_numpy(Vy), **kw).numpy()
    cols = matvec.distance_matmat_rect_plain(Yt, Xt, torch.from_numpy(V), **kw).numpy()
    np.testing.assert_allclose(rows, np.asarray(r)[:C].T, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(cols, np.asarray(c)[:C].T, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("n_classes", [None, 4])
def test_plain_versions_match_xla_triangle_f64(name, n_classes):
    """The full-square plain versions against plssvm_tpu's upper-triangle
    XLA walk (100-row blocks), (m,) and (m, C) right-hand sides; the
    rectangular ones against rows of the square."""
    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(7)
    m, d = 300, 23
    X = histograms(rng, m, d)
    v = rng.normal(size=(m,) if n_classes is None else (m, n_classes))
    want = np.asarray(distance_kernel_matvec_sym(
        jnp.asarray(X), jnp.asarray(v), 1.0 / d, kind=jkind, row_block=100
    ))
    kw = dict(kind=tkind, gamma=1.0 / d)
    Xt, vt = torch.from_numpy(X), torch.from_numpy(v)
    sym, rect = (
        (matvec.distance_matvec_plain, matvec.distance_matvec_rect_plain)
        if n_classes is None
        else (matvec.distance_matmat_plain, matvec.distance_matmat_rect_plain)
    )
    atol = 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(sym(Xt, vt, **kw).numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(
        rect(Xt[:41], Xt, vt, **kw).numpy(), want[:41], rtol=0, atol=atol
    )


class TestWrappers:
    def test_cpu_tensors_take_the_plain_versions(self):
        rng = np.random.default_rng(8)
        X = torch.from_numpy(histograms(rng, 40, 5))
        V = torch.from_numpy(rng.normal(size=(40, 3)))
        kw = dict(kind=TKind.CHI_SQUARED, gamma=0.2)
        distance.reset_counts()
        assert torch.equal(
            distance.distance_matvec_sym(X, V[:, 0], **kw),
            matvec.distance_matvec_plain(X, V[:, 0], **kw),
        )
        assert torch.equal(
            distance.distance_matvec_rect(X[:7], X, V[:, 0], **kw),
            matvec.distance_matvec_rect_plain(X[:7], X, V[:, 0], **kw),
        )
        sym = distance.distance_matmat_sym(X, V, **kw)
        assert torch.equal(sym, matvec.distance_matmat_plain(X, V, **kw))
        rect = distance.distance_matmat_rect(X[:7], X, V, **kw)
        torch.testing.assert_close(rect, sym[:7], rtol=1e-12, atol=1e-12)
        assert (
            distance.matvec_sym_launches, distance.matvec_rect_launches,
            distance.matmat_sym_launches, distance.matmat_rect_launches,
        ) == (0, 0, 0, 0)
        assert (matvec.dist_sym_plain_calls, matvec.dist_rect_plain_calls) == (2, 2)
        assert (matvec.dist_sym_matmat_plain_calls, matvec.dist_rect_matmat_plain_calls) == (2, 1)
        distance.reset_counts()
        assert matvec.dist_sym_matmat_plain_calls == 0

    def test_refuses_other_kinds_and_devices(self):
        X = torch.ones(4, 3)
        with pytest.raises(ValueError, match="laplacian or chi_squared"):
            distance.distance_matvec_sym(X, X[:, 0], kind=TKind.RBF, gamma=0.1)
        meta = torch.ones(4, 3, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            distance.distance_matmat_rect(meta, meta, meta, kind=TKind.LAPLACIAN, gamma=0.1)


def test_kernel_resources_reads_the_distance_kernels(tmp_path, monkeypatch):
    """kernel_resources() names every instantiation -Xptxas -v reports,
    the distance kernels' laplacian (4) and chi-squared (5) included."""
    library = tmp_path / "libplssvm_gram_0.so"
    library.with_name(library.name + ".ptxas.txt").write_text(
        "== distance.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_126distance_matvec_sym_kernelIfLi5EEEvPKT_S3_PS1_llS1_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_126distance_matvec_sym_kernelIfLi5EEEvPKT_S3_PS1_llS1_\n"
        "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 25088 bytes smem, 408 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_127distance_matmat_rect_kernelIdLi4EEEvPKT_S3_S3_PS1_lllllS1_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_127distance_matmat_rect_kernelIdLi4EEEvPKT_S3_S3_PS1_lllllS1_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 90 registers, 20800 bytes smem, 432 bytes cmem[0]\n"
        "== gram_matvec.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_122gram_matvec_sym_kernelIfLi2EEEvPKT_S3_S3_PS1_lliS1_S1_' for 'sm_90a'\n"
        "ptxas info    : Used 128 registers, 24832 bytes smem, 420 bytes cmem[0]\n",
        encoding="utf-8",
    )
    monkeypatch.setattr(_build, "library_path", lambda: library)
    assert _build.kernel_resources() == {
        "distance_matvec_sym f32 chi_squared": {
            "spill_bytes": 20, "registers": 255, "smem_bytes": 25088,
        },
        "distance_matmat_rect f64 laplacian": {
            "spill_bytes": 0, "registers": 90, "smem_bytes": 20800,
        },
        "gram_matvec_sym f32 rbf": {"registers": 128, "smem_bytes": 24832},
    }


# -- CG, binary and one-vs-all block ----------------------------------------


def _solve_both(name, n_classes, scalars):
    jkind, tkind = _kinds(name)
    X, labels, _, _ = classes(n_classes, STABLE_SEED[(name, n_classes)])
    n, d = X.shape
    args = (1.0 / d, 0.0, 1.0, EPS, n)
    jargs = [jnp.asarray(a) for a in args[:-1]] + [jnp.asarray(n, jnp.int32)]
    if n_classes == 2:
        y = np.where(labels == labels[0], 1.0, -1.0)
        ref = jcg.solve_ls_svm(
            jnp.asarray(X[:-1]), jnp.asarray(X[-1]), jnp.asarray(y[:-1]),
            jnp.asarray(y[-1]), jnp.ones(n - 1), *jargs, kind=jkind,
            degree=3, impl="xla", scalars=scalars,
        )
        got = tcg.solve_ls_svm(
            torch.from_numpy(X[:-1]), torch.from_numpy(X[-1]),
            torch.from_numpy(y[:-1]), float(y[-1]), *args, kind=tkind,
            degree=3, impl="torch", scalars=scalars,
        )
        return ref, got
    Y = np.where(labels[:, None] == np.arange(n_classes)[None, :], 1.0, -1.0)
    ref = jcg.solve_ls_svm_multi(
        jnp.asarray(X[:-1]), jnp.asarray(X[-1]), jnp.asarray(Y[:-1]),
        jnp.asarray(Y[-1]), jnp.ones(n - 1), *jargs, kind=jkind, degree=3,
        impl="xla", scalars=scalars,
    )
    got = tcg.solve_ls_svm_multi(
        torch.from_numpy(X[:-1]), torch.from_numpy(X[-1]),
        torch.from_numpy(Y[:-1]), torch.from_numpy(Y[-1]), *args, kind=tkind,
        degree=3, impl="torch", scalars=scalars,
    )
    return ref, got


@pytest.mark.parametrize("scalars", ["plain", "compensated"])
@pytest.mark.parametrize("n_classes", [2, 3, 4])
@pytest.mark.parametrize("name", KINDS)
def test_cg_matches_reference(name, n_classes, scalars):
    ref, got = _solve_both(name, n_classes, scalars)
    assert got.iterations == int(ref.iterations) >= 10
    if n_classes > 2:
        np.testing.assert_array_equal(
            got.iterations_per_class.numpy(), np.asarray(ref.iterations_per_class)
        )
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        got.alpha_last.numpy(), np.asarray(ref.alpha_last), rtol=0, atol=TOL
    )


# -- CSVM, CLIs, carried models, the data check ------------------------------


def _fit_both(name, n_classes, **fit_kw):
    Xtr, ytr, Xte, yte = classes(n_classes, STABLE_SEED[(name, n_classes)])
    j_svm = plssvm_tpu.CSVM(
        backend="xla", solver="cg_implicit", dtype=np.float64,
        kernel_type=name, cost=1.0,
    )
    t_svm = plssvm_tpu_torch.CSVM(
        backend="torch", device="cpu", dtype=np.float64, kernel_type=name,
        cost=1.0, solver="cg_implicit",
    )
    return (
        j_svm, j_svm.fit(plssvm_tpu.DataSet(Xtr, ytr), epsilon=EPS, **fit_kw),
        plssvm_tpu.DataSet(Xte, yte),
        t_svm, t_svm.fit(plssvm_tpu_torch.DataSet(Xtr, ytr), epsilon=EPS),
        plssvm_tpu_torch.DataSet(Xte, yte),
    )


@pytest.mark.parametrize("name,n_classes", [("laplacian", 2), ("chi_squared", 3)])
def test_fit_save_load_predict(name, n_classes, tmp_path):
    j_svm, j_model, j_test, t_svm, t_model, t_test = _fit_both(name, n_classes)
    assert t_model.n_iter == j_model.n_iter
    np.testing.assert_allclose(t_model.rho, j_model.rho, rtol=0, atol=TOL)
    np.testing.assert_allclose(t_model.alpha, j_model.alpha, rtol=0, atol=TOL)
    path = os.path.join(tmp_path, "port.model")
    t_model.save(path)
    loaded = plssvm_tpu_torch.Model.load(path)
    assert loaded.params.equivalent(t_model.params)
    assert str(loaded.params.kernel_type.value) == name
    want = j_svm.predict_values(j_model, j_test)
    for model in (t_model, loaded):
        np.testing.assert_allclose(
            t_svm.predict_values(model, t_test), want, rtol=0, atol=TOL
        )
        np.testing.assert_array_equal(
            t_svm.predict(model, t_test), j_svm.predict(j_model, j_test)
        )
        assert t_svm.score(model, t_test) == j_svm.score(j_model, j_test)


@pytest.mark.parametrize("name,n_classes", [("laplacian", 2), ("chi_squared", 3)])
def test_cuda_backend_takes_the_plain_versions_on_cpu(name, n_classes):
    Xtr, ytr, Xte, yte = classes(n_classes, 9)
    kw = dict(dtype=np.float64, device="cpu", kernel_type=name, solver="cg_implicit")
    cuda_svm = plssvm_tpu_torch.CSVM(backend="cuda", **kw)
    torch_svm = plssvm_tpu_torch.CSVM(backend="torch", **kw)
    train, test = plssvm_tpu_torch.DataSet(Xtr, ytr), plssvm_tpu_torch.DataSet(Xte, yte)
    distance.reset_counts()
    a, b = cuda_svm.fit(train), torch_svm.fit(train)
    assert np.array_equal(a.rho, b.rho) and np.array_equal(a.alpha, b.alpha)
    assert np.array_equal(cuda_svm.predict_values(a, test), torch_svm.predict_values(b, test))
    launches = (distance.matvec_sym_launches, distance.matvec_rect_launches,
                distance.matmat_sym_launches, distance.matmat_rect_launches)
    assert launches == (0, 0, 0, 0)


@pytest.mark.parametrize("flag,n_classes", [("4", 2), ("5", 3)])
def test_cli_train_predict_against_reference(flag, n_classes, tmp_path):
    name = "laplacian" if flag == "4" else "chi_squared"
    Xtr, ytr, Xte, yte = classes(n_classes, STABLE_SEED[(name, n_classes)])
    train_file = os.path.join(tmp_path, "train.libsvm")
    test_file = os.path.join(tmp_path, "test.libsvm")
    plssvm_tpu_torch.DataSet(Xtr, ytr).save(train_file)
    plssvm_tpu_torch.DataSet(Xte, yte).save(test_file)
    common = ["-t", flag, "-e", str(EPS), "--use_double_as_real_type", "-q"]
    files = {}
    for key, train_cli, predict_cli, backend, where in (
        ("j", j_train_cli, j_predict_cli, ["-b", "xla", "--solver", "cg_implicit"], []),
        ("t", t_train_cli, t_predict_cli, ["-b", "torch", "--solver", "cg_implicit"],
         ["-p", "cpu"]),
    ):
        model = os.path.join(tmp_path, f"{key}.model")
        out = os.path.join(tmp_path, f"{key}.predict")
        assert train_cli.main(common + backend + where + [train_file, model]) == 0
        assert predict_cli.main(
            ["--use_double_as_real_type", "-q", "-b", backend[1], *where, test_file, model, out]
        ) == 0
        files[key] = (model, out)
    j_model = plssvm_tpu.Model.load(files["j"][0])
    t_model = plssvm_tpu_torch.Model.load(files["t"][0])
    assert str(t_model.params.kernel_type.value) == name
    np.testing.assert_allclose(t_model.rho, j_model.rho, rtol=0, atol=TOL)
    np.testing.assert_allclose(t_model.alpha, j_model.alpha, rtol=0, atol=TOL)
    with open(files["j"][1]) as fj, open(files["t"][1]) as ft:
        assert ft.read() == fj.read()


def test_oao_chi_squared_model_file_predicts_like_the_reference(tmp_path):
    """A one-vs-one chi-squared model trained by plssvm_tpu: through kernel
    H's plain version, C(C-1)/2 decision columns, voted labels."""
    Xtr, ytr, Xte, yte = classes(4, 7)
    j_svm = plssvm_tpu.CSVM(
        backend="xla", solver="cg_implicit", dtype=np.float64,
        kernel_type="chi_squared", cost=1.0,
    )
    path = os.path.join(tmp_path, "oao.model")
    j_svm.fit(plssvm_tpu.DataSet(Xtr, ytr), epsilon=EPS, classification="oao").save(path)
    j_loaded = plssvm_tpu.Model.load(path)
    t_loaded = plssvm_tpu_torch.Model.load(path)
    assert t_loaded.classification == ClassificationType.OAO
    j_test, t_test = plssvm_tpu.DataSet(Xte, yte), plssvm_tpu_torch.DataSet(Xte, yte)
    t_svm = plssvm_tpu_torch.CSVM(backend="cuda", device="cpu", dtype=np.float64)
    matvec.dist_rect_matmat_plain_calls = 0
    got = t_svm.predict_values(t_loaded, t_test)
    want = j_svm.predict_values(j_loaded, j_test)
    assert got.shape == want.shape == (40, 6)
    assert matvec.dist_rect_matmat_plain_calls == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(
        t_svm.predict(t_loaded, t_test), j_svm.predict(j_loaded, j_test)
    )


@pytest.mark.parametrize("name,n_classes", [("laplacian", 2), ("chi_squared", 4)])
def test_model_from_numpy_predicts_like_the_reference(name, n_classes):
    j_svm, j_model, j_test, t_svm, _, t_test = _fit_both(name, n_classes)
    carried = plssvm_tpu_torch.model_from_numpy(
        j_model.params, j_model.support_vectors, j_model.alpha, j_model.rho,
        j_model.data.labels, label_order=j_model.label_order,
        classification=j_model.classification,
    )
    assert str(carried.params.kernel_type.value) == name
    np.testing.assert_allclose(
        t_svm.predict_values(carried, t_test),
        j_svm.predict_values(j_model, j_test), rtol=0, atol=TOL,
    )
    np.testing.assert_array_equal(
        t_svm.predict(carried, t_test), j_svm.predict(j_model, j_test)
    )


@pytest.mark.parametrize("n_classes", [2, 3])
def test_chi_squared_refuses_negative_data(n_classes):
    """Negative training data and negative predict points raise
    InvalidParameterError with plssvm_tpu's message, in fit and predict."""
    Xtr, ytr, Xte, yte = classes(n_classes, 4)
    bad_train = Xtr.copy()
    bad_train[5, 2] = -0.25
    bad_test = Xte.copy()
    bad_test[3, 1] = -1.5
    messages = []
    for pkg, where in ((plssvm_tpu, dict(backend="xla")),
                       (plssvm_tpu_torch, dict(backend="torch", device="cpu"))):
        svm = pkg.CSVM(**where, dtype=np.float64, kernel_type="chi_squared")
        with pytest.raises(pkg.InvalidParameterError) as fit_err:
            svm.fit(pkg.DataSet(bad_train, ytr))
        model = svm.fit(pkg.DataSet(Xtr, ytr), epsilon=1e-3)
        with pytest.raises(pkg.InvalidParameterError) as predict_err:
            svm.predict(model, pkg.DataSet(bad_test, yte))
        messages.append((str(fit_err.value), str(predict_err.value)))
    assert messages[1] == messages[0]
    assert "training data contains -0.25" in messages[0][0]
    assert "predict points contains -1.5" in messages[0][1]
