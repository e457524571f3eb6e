"""One-vs-all multiclass and one-vs-one predict: the port against plssvm_tpu.

Inputs are made from a seed with numpy and handed to both packages;
plssvm_tpu runs as its own tests run it on the CPU (``backend="xla"``,
float64, and its Pallas block matmat K4 in interpret mode).

- ``compensated_sum`` on an (m, C) float32 block: one TwoSum fold per
  column, the same bits as plssvm_tpu's, odd and even m;
- the plain block matmats (the oracles of kernels C and D) against K4 in
  interpret mode at the tolerances tests/test_ops.py holds K4 to (f32,
  rtol/atol 2e-5 symmetric, rtol 2e-4 / atol 1e-5 rectangular), and
  against ``kernel_matvec_xla`` with an (m, C) right-hand side in float64
  at 1e-12 relative to max|value|;
- the block CG against ``solve_ls_svm_multi`` in float64: the same
  ``iterations`` and ``iterations_per_class``, rho and alpha within 1e-8;
- ``CSVM`` fit -> save -> load -> predict_values / predict / score, the
  CLIs, ``model_from_numpy`` and one-vs-one model files against
  plssvm_tpu: the same labels, decision values within 1e-8.

The 1e-8 tolerances on CG results hold because the solves run to epsilon
1e-10 (tests/test_torch_csvm.py says why an early stop cannot be compared
that closely).  The iteration counts are compared exactly, so the seeds
are ones where plssvm_tpu's own per-class counts do not change with its
row block (16, 64 or 256 rows, plain and compensated scalars): on others a
class's last residual lands within rounding of its target, and plssvm_tpu
disagrees with itself by one iteration.  Seeds 3 (three classes) and 1
(four classes) also stop their classes at different iterations.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plssvm_tpu
import plssvm_tpu.solver.cg as jcg
import plssvm_tpu_torch
import plssvm_tpu_torch.solver.cg as tcg
from plssvm_tpu.cli import predict as j_predict_cli
from plssvm_tpu.cli import train as j_train_cli
from plssvm_tpu.ops.matvec import kernel_matvec_xla
from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu_torch.cli import predict as t_predict_cli
from plssvm_tpu_torch.cli import train as t_train_cli
from plssvm_tpu_torch.ops import gram_matmat, matvec
from plssvm_tpu_torch.parameter import ClassificationType
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind

EPS = 1e-10
TOL = 1e-8
KERNELS = ["rbf", "polynomial", "linear"]
#: per class count, a seed whose iteration counts are stable (see above)
STABLE_SEED = {3: 3, 4: 1}


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def _kinds(name):
    return getattr(JKind, name.upper()), getattr(TKind, name.upper())


def classes(n_classes, seed=0, n=240, d=10):
    """Gaussian classes around seeded means, scaled to [-1, 1] with the
    training rows' factors; the first 200 rows train, the rest test."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n)
    X = rng.normal(size=(n, d)) + 0.8 * rng.normal(size=(n_classes, d))[labels]
    lo, hi = X[:200].min(0), X[:200].max(0)
    X = 2.0 * (X - lo) / (hi - lo) - 1.0
    return X[:200], labels[:200], X[200:], labels[200:]


# -- the compensated-sum repair -------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 7, 100, 1001, 4096])
@pytest.mark.parametrize("n_classes", [3, 10])
def test_compensated_sum_columns_match_bitwise(m, n_classes):
    rng = np.random.default_rng(m + n_classes)
    # large dynamic range, so the compensation carries real information
    a = (
        rng.normal(size=(m, n_classes))
        * 10.0 ** rng.integers(-6, 6, size=(m, n_classes))
    ).astype(np.float32)
    want = np.asarray(jcg.compensated_sum(jnp.asarray(a)))
    got = tcg.compensated_sum(torch.from_numpy(a)).numpy()
    assert got.shape == want.shape == (n_classes,)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # each column is its own 1-D fold
    for c in range(n_classes):
        col = tcg.compensated_sum(torch.from_numpy(np.ascontiguousarray(a[:, c])))
        assert col.ndim == 0 and col.item() == got[c]


# -- the plain block matmats against K4 and kernel_matvec_xla ---------------


@pytest.mark.parametrize("kernel_name", ["polynomial", "rbf"])
@pytest.mark.parametrize("n_classes", [3, 5])
def test_plain_matmat_matches_pallas_k4_symmetric(kernel_name, n_classes):
    """m = 768 is a 3 x 3 grid of K4's 256 tiles."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matmat_pallas_big

    jkind, tkind = _kinds(kernel_name)
    m, d = 768, 256
    rng = np.random.default_rng(21)
    X = rng.normal(size=(m, d)).astype(np.float32) * 0.2
    V = rng.normal(size=(m, n_classes)).astype(np.float32)
    gamma, coef0 = 1.0 / d, 1.0
    Xj = jnp.asarray(X)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(kernel_matmat_pallas_big(
            Xj, jnp.sum(Xj * Xj, axis=-1), jnp.asarray(V), kind=jkind,
            gamma=jnp.float32(gamma), coef0=jnp.float32(coef0), degree=3,
        ))
    Xt = torch.from_numpy(X)
    got = matvec.kernel_matmat_plain(
        Xt, (Xt * Xt).sum(-1), torch.from_numpy(V), kind=tkind, gamma=gamma,
        coef0=coef0, degree=3,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_matmat_rect_matches_pallas_k4_both_contractions():
    """K4 with symmetric=False gives (K @ Vy^T, K^T @ Vx^T), class-major;
    the rectangular plain matmat gives each from its own side."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matmat_pallas_dual

    rng = np.random.default_rng(23)
    m1, m2, d, C = 256, 384, 128, 3
    A = rng.normal(size=(m1, d)).astype(np.float32) * 0.2
    B = rng.normal(size=(m2, d)).astype(np.float32) * 0.2
    Va = rng.normal(size=(m1, C)).astype(np.float32)
    Vb = rng.normal(size=(m2, C)).astype(np.float32)
    sqa, sqb = (A * A).sum(1), (B * B).sum(1)
    gamma = 0.01
    pad_a = np.zeros((8, m1), np.float32)
    pad_a[:C] = Va.T
    pad_b = np.zeros((8, m2), np.float32)
    pad_b[:C] = Vb.T
    with pltpu.force_tpu_interpret_mode():
        r, c = kernel_matmat_pallas_dual(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(sqa), jnp.asarray(sqb),
            jnp.asarray(pad_b), jnp.asarray(pad_a), kind=JKind.RBF,
            gamma=jnp.float32(gamma), coef0=jnp.float32(0.0), degree=3,
        )
    kw = dict(kind=TKind.RBF, gamma=gamma, coef0=0.0, degree=3)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    rows = matvec.kernel_matmat_rect_plain(
        At, Bt, torch.from_numpy(sqa), torch.from_numpy(sqb),
        torch.from_numpy(Vb), **kw,
    ).numpy()
    cols = matvec.kernel_matmat_rect_plain(
        Bt, At, torch.from_numpy(sqb), torch.from_numpy(sqa),
        torch.from_numpy(Va), **kw,
    ).numpy()
    np.testing.assert_allclose(rows, np.asarray(r)[:C].T, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(cols, np.asarray(c)[:C].T, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("kernel_name", ["polynomial", "rbf", "sigmoid"])
def test_plain_matmats_match_xla_f64(kernel_name):
    """Both plain matmats against kernel_matvec_xla with an (m, C) block in
    float64.  The rectangular one is the top rows of the symmetric product
    over the stacked rows [P; S] with [0; A] on the right."""
    jkind, tkind = _kinds(kernel_name)
    rng = np.random.default_rng(24)
    m, n_p, d, C = 300, 77, 17, 4
    S = rng.normal(size=(m, d)) * 0.3
    P = rng.normal(size=(n_p, d)) * 0.3
    V = rng.normal(size=(m, C))
    kw = dict(gamma=1.0 / d, coef0=0.5, degree=3)

    def xla(Z, W):
        Zj = jnp.asarray(Z)
        return np.asarray(kernel_matvec_xla(
            Zj, jnp.sum(Zj * Zj, axis=-1), jnp.asarray(W), kind=jkind,
            row_block=64, **kw,
        ))

    St, Pt = torch.from_numpy(S), torch.from_numpy(P)
    sym = matvec.kernel_matmat_plain(
        St, (St * St).sum(-1), torch.from_numpy(V), kind=tkind, **kw
    ).numpy()
    want = xla(S, V)
    np.testing.assert_allclose(sym, want, rtol=0, atol=1e-12 * np.abs(want).max())
    rect = matvec.kernel_matmat_rect_plain(
        Pt, St, (Pt * Pt).sum(-1), (St * St).sum(-1), torch.from_numpy(V),
        kind=tkind, **kw,
    ).numpy()
    want = xla(np.vstack([P, S]), np.vstack([np.zeros((n_p, C)), V]))[:n_p]
    np.testing.assert_allclose(rect, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_linear_kernel_matvec_takes_a_block():
    rng = np.random.default_rng(25)
    X, V = rng.normal(size=(50, 6)), rng.normal(size=(50, 3))
    got = matvec.linear_kernel_matvec(torch.from_numpy(X), torch.from_numpy(V))
    np.testing.assert_allclose(got.numpy(), (X @ X.T) @ V, rtol=1e-12)


def test_wrappers_take_the_plain_versions_on_cpu():
    rng = np.random.default_rng(26)
    X = torch.from_numpy(rng.normal(size=(40, 5)))
    V = torch.from_numpy(rng.normal(size=(40, 3)))
    sq = (X * X).sum(-1)
    kw = dict(kind=TKind.RBF, gamma=0.2, coef0=0.0, degree=3)
    gram_matmat.reset_counts()
    sym = gram_matmat.gram_matmat_sym(X, sq, V, **kw)
    rect = gram_matmat.gram_matmat_rect(X[:7], X, sq[:7], sq, V, **kw)
    assert torch.equal(sym, matvec.kernel_matmat_plain(X, sq, V, **kw))
    assert torch.equal(rect, sym[:7])
    assert (gram_matmat.sym_launches, gram_matmat.rect_launches) == (0, 0)
    assert matvec.sym_matmat_plain_calls == 2  # the wrapper's and ours
    assert matvec.rect_matmat_plain_calls == 1


# -- the block CG against solve_ls_svm_multi ---------------------------------


def _solve_both(kernel_name, n_classes, scalars, *, max_iter=None, eps=EPS, seed=0):
    jkind, tkind = _kinds(kernel_name)
    X, labels, _, _ = classes(n_classes, seed=seed)
    Y = np.where(labels[:, None] == np.arange(n_classes)[None, :], 1.0, -1.0)
    n, d = X.shape
    gamma, coef0, cost = 1.0 / d, 0.0, 1.0
    max_iter = n if max_iter is None else max_iter
    ref = jcg.solve_ls_svm_multi(
        jnp.asarray(X[:-1]), jnp.asarray(X[-1]), jnp.asarray(Y[:-1]),
        jnp.asarray(Y[-1]), jnp.ones(n - 1), jnp.asarray(gamma),
        jnp.asarray(coef0), jnp.asarray(cost), jnp.asarray(eps),
        jnp.asarray(max_iter, jnp.int32), kind=jkind, degree=3, impl="xla",
        scalars=scalars,
    )
    got = tcg.solve_ls_svm_multi(
        torch.from_numpy(X[:-1]), torch.from_numpy(X[-1]),
        torch.from_numpy(Y[:-1]), torch.from_numpy(Y[-1]), gamma, coef0,
        cost, eps, max_iter, kind=tkind, degree=3, impl="torch",
        scalars=scalars,
    )
    return ref, got


@pytest.mark.parametrize("scalars", ["plain", "compensated"])
@pytest.mark.parametrize("n_classes", [3, 4])
@pytest.mark.parametrize("kernel_name", KERNELS)
def test_block_cg_matches_reference(kernel_name, n_classes, scalars):
    ref, got = _solve_both(kernel_name, n_classes, scalars, seed=STABLE_SEED[n_classes])
    assert got.iterations == int(ref.iterations)
    np.testing.assert_array_equal(
        got.iterations_per_class.numpy(), np.asarray(ref.iterations_per_class)
    )
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        got.alpha_last.numpy(), np.asarray(ref.alpha_last), rtol=0, atol=TOL
    )


def test_block_cg_freezes_converged_classes():
    """The classes converge at different iterations; each stops counting
    when it meets its own target and the slowest sets ``iterations``."""
    _, got = _solve_both("rbf", 4, "plain", seed=STABLE_SEED[4])
    per_class = got.iterations_per_class.numpy()
    assert len(set(per_class.tolist())) > 1
    assert got.iterations == per_class.max()
    assert np.all(got.delta.numpy() <= EPS * EPS * got.delta0.numpy())


def test_block_exact_residual_cadence():
    """Run to max_iter = 60 against an unreachable target: 1 + 60 + 1
    matmats (the initial residual, one per iteration, the exact residual at
    iteration 49), and the iterate equals the reference's."""
    # 100 features: the linear system needs more than 60 steps to converge
    X, labels, _, _ = classes(3, seed=5, d=100)
    Y = np.where(labels[:, None] == np.arange(3)[None, :], 1.0, -1.0)
    calls = []

    def counting_mm(X_, sq, V, gamma, coef0):
        calls.append(V.shape)
        return X_ @ (X_.T @ V)

    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    got = tcg.cg_ls_svm_multi_core(
        Xt[:-1], Xt[-1], Yt[:-1], Yt[-1], 0.01, 0.0, 1.0, 1e-30, 60,
        kind=TKind.LINEAR, degree=3, kernel_mm=counting_mm,
    )
    assert got.iterations == 60
    assert len(calls) == 1 + 60 + 1 and calls[0] == (199, 3)
    ref = jcg.solve_ls_svm_multi(
        jnp.asarray(X[:-1]), jnp.asarray(X[-1]), jnp.asarray(Y[:-1]),
        jnp.asarray(Y[-1]), jnp.ones(199), jnp.asarray(0.01), jnp.asarray(0.0),
        jnp.asarray(1.0), jnp.asarray(1e-30), jnp.asarray(60, jnp.int32),
        kind=JKind.LINEAR, degree=3, impl="xla",
    )
    ref_x = np.asarray(ref.x)
    np.testing.assert_allclose(
        got.x.numpy(), ref_x, rtol=0, atol=1e-8 * np.abs(ref_x).max()
    )


# -- CSVM, CLIs, carried models ---------------------------------------------


def _fit_both(kernel, n_classes=3, seed=STABLE_SEED[3]):
    Xtr, ytr, Xte, yte = classes(n_classes, seed=seed)
    j_svm = plssvm_tpu.CSVM(
        backend="xla", solver="cg_implicit", dtype=np.float64,
        kernel_type=kernel, cost=1.0,
    )
    t_svm = plssvm_tpu_torch.CSVM(
        backend="torch", device="cpu", dtype=np.float64, kernel_type=kernel,
        cost=1.0,
    )
    return (
        j_svm, j_svm.fit(plssvm_tpu.DataSet(Xtr, ytr), epsilon=EPS),
        plssvm_tpu.DataSet(Xte, yte),
        t_svm, t_svm.fit(plssvm_tpu_torch.DataSet(Xtr, ytr), epsilon=EPS),
        plssvm_tpu_torch.DataSet(Xte, yte),
    )


@pytest.mark.parametrize("kernel", KERNELS)
def test_fit_save_load_predict(kernel, tmp_path):
    j_svm, j_model, j_test, t_svm, t_model, t_test = _fit_both(kernel)
    assert t_model.n_iter == j_model.n_iter
    assert t_model.alpha.shape == j_model.alpha.shape == (200, 3)
    np.testing.assert_allclose(t_model.rho, j_model.rho, rtol=0, atol=TOL)
    path = os.path.join(tmp_path, "port.model")
    t_model.save(path)
    loaded = plssvm_tpu_torch.Model.load(path)
    assert loaded.classification == ClassificationType.OAA
    want = j_svm.predict_values(j_model, j_test)
    assert want.shape == (40, 3)
    for model in (t_model, loaded):
        np.testing.assert_allclose(
            t_svm.predict_values(model, t_test), want, rtol=0, atol=TOL
        )
        np.testing.assert_array_equal(
            t_svm.predict(model, t_test), j_svm.predict(j_model, j_test)
        )
        assert t_svm.score(model, t_test) == j_svm.score(j_model, j_test)
    assert t_svm.score(t_model) == j_svm.score(j_model)


@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_backend_takes_the_plain_versions_on_cpu(kernel):
    """backend="cuda" on CPU tensors runs the wrappers' plain route and
    gives the torch backend's model exactly."""
    Xtr, ytr, Xte, yte = classes(4, seed=2)
    train = plssvm_tpu_torch.DataSet(Xtr, ytr)
    test = plssvm_tpu_torch.DataSet(Xte, yte)
    kw = dict(dtype=np.float64, device="cpu", kernel_type=kernel)
    cuda_svm = plssvm_tpu_torch.CSVM(backend="cuda", **kw)
    torch_svm = plssvm_tpu_torch.CSVM(backend="torch", **kw)
    gram_matmat.reset_counts()
    a, b = cuda_svm.fit(train), torch_svm.fit(train)
    assert np.array_equal(a.rho, b.rho) and np.array_equal(a.alpha, b.alpha)
    assert np.array_equal(cuda_svm.predict_values(a, test), torch_svm.predict_values(b, test))
    assert (gram_matmat.sym_launches, gram_matmat.rect_launches) == (0, 0)


def test_fit_tracks_iterations_per_class():
    Xtr, ytr, _, _ = classes(3, seed=3)
    plssvm_tpu_torch.global_tracker.clear()
    svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="rbf")
    model = svm.fit(plssvm_tpu_torch.DataSet(Xtr, ytr), epsilon=EPS)
    entries = dict(plssvm_tpu_torch.global_tracker.entries()["cg"])
    assert entries["iterations"] == model.n_iter
    assert len(entries["iterations_per_class"]) == 3
    assert max(entries["iterations_per_class"]) == model.n_iter


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_model_from_numpy_predicts_like_the_reference(kernel):
    j_svm, j_model, j_test, t_svm, _, t_test = _fit_both(kernel, n_classes=4)
    carried = plssvm_tpu_torch.model_from_numpy(
        j_model.params, j_model.support_vectors, j_model.alpha, j_model.rho,
        j_model.data.labels, label_order=j_model.label_order,
        classification=j_model.classification,
    )
    assert carried.classification == ClassificationType.OAA
    np.testing.assert_allclose(
        t_svm.predict_values(carried, t_test),
        j_svm.predict_values(j_model, j_test), rtol=0, atol=TOL,
    )
    np.testing.assert_array_equal(
        t_svm.predict(carried, t_test), j_svm.predict(j_model, j_test)
    )


@pytest.mark.parametrize("kernel_flag", ["2", "1", "0"])
def test_cli_train_predict_against_reference(kernel_flag, tmp_path):
    Xtr, ytr, Xte, yte = classes(3, seed=STABLE_SEED[3])
    train_file = os.path.join(tmp_path, "train.libsvm")
    test_file = os.path.join(tmp_path, "test.libsvm")
    plssvm_tpu_torch.DataSet(Xtr, ytr).save(train_file)
    plssvm_tpu_torch.DataSet(Xte, yte).save(test_file)
    common = ["-t", kernel_flag, "-e", str(EPS), "--use_double_as_real_type", "-q"]
    files = {}
    for name, train_cli, predict_cli, backend, where in (
        ("j", j_train_cli, j_predict_cli, ["-b", "xla", "--solver", "cg_implicit"], []),
        ("t", t_train_cli, t_predict_cli, ["-b", "torch"], ["-p", "cpu"]),
    ):
        model = os.path.join(tmp_path, f"{name}.model")
        out = os.path.join(tmp_path, f"{name}.predict")
        assert train_cli.main(common + backend + where + [train_file, model]) == 0
        assert predict_cli.main(
            ["--use_double_as_real_type", "-q", "-b", backend[1], *where, test_file, model, out]
        ) == 0
        files[name] = (model, out)
    j_model = plssvm_tpu.Model.load(files["j"][0])
    t_model = plssvm_tpu_torch.Model.load(files["t"][0])
    assert t_model.alpha.shape == j_model.alpha.shape == (200, 3)
    np.testing.assert_allclose(t_model.rho, j_model.rho, rtol=0, atol=TOL)
    np.testing.assert_allclose(t_model.alpha, j_model.alpha, rtol=0, atol=TOL)
    with open(files["j"][1]) as fj, open(files["t"][1]) as ft:
        assert ft.read() == fj.read()


# -- one-vs-one model files (predict only) -----------------------------------


@pytest.mark.parametrize("kernel", ["rbf", "polynomial", "linear"])
def test_oao_model_file_predicts_like_the_reference(kernel, tmp_path):
    """A one-vs-one model trained and saved by plssvm_tpu (LIBSVM's
    multiclass layout) is scored by the port: C(C-1)/2 decision columns,
    voted labels."""
    Xtr, ytr, Xte, yte = classes(4, seed=7)
    j_svm = plssvm_tpu.CSVM(
        backend="xla", solver="cg_implicit", dtype=np.float64,
        kernel_type=kernel, cost=1.0,
    )
    j_model = j_svm.fit(plssvm_tpu.DataSet(Xtr, ytr), epsilon=EPS, classification="oao")
    path = os.path.join(tmp_path, "oao.model")
    j_model.save(path)
    j_loaded = plssvm_tpu.Model.load(path)
    t_loaded = plssvm_tpu_torch.Model.load(path)
    assert t_loaded.classification == ClassificationType.OAO
    assert t_loaded.alpha.shape == (200, 3)
    j_test = plssvm_tpu.DataSet(Xte, yte)
    t_test = plssvm_tpu_torch.DataSet(Xte, yte)
    t_svm = plssvm_tpu_torch.CSVM(backend="torch", device="cpu", dtype=np.float64)
    got = t_svm.predict_values(t_loaded, t_test)
    want = j_svm.predict_values(j_loaded, j_test)
    assert got.shape == want.shape == (40, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(
        t_svm.predict(t_loaded, t_test), j_svm.predict(j_loaded, j_test)
    )
    assert t_svm.score(t_loaded, t_test) == j_svm.score(j_loaded, j_test)
    # the trained model's fields carried across predict the same
    carried = plssvm_tpu_torch.model_from_numpy(
        j_model.params, j_model.support_vectors, j_model.alpha, j_model.rho,
        j_model.data.labels, label_order=j_model.label_order,
        classification=j_model.classification,
    )
    np.testing.assert_array_equal(
        t_svm.predict(carried, t_test), j_svm.predict(j_model, j_test)
    )


def test_oao_predict_cli_matches_reference(tmp_path):
    Xtr, ytr, Xte, yte = classes(4, seed=8)
    test_file = os.path.join(tmp_path, "test.libsvm")
    plssvm_tpu.DataSet(Xte, yte).save(test_file)
    j_svm = plssvm_tpu.CSVM(
        backend="xla", solver="cg_implicit", dtype=np.float64, kernel_type="rbf",
    )
    model = os.path.join(tmp_path, "oao.model")
    j_svm.fit(plssvm_tpu.DataSet(Xtr, ytr), epsilon=EPS, classification="oao").save(model)
    outs = []
    for name, cli, flags in (
        ("j", j_predict_cli, ["-b", "xla"]), ("t", t_predict_cli, ["-b", "torch", "-p", "cpu"]),
    ):
        out = os.path.join(tmp_path, f"{name}.predict")
        assert cli.main(["--use_double_as_real_type", "-q", *flags, test_file, model, out]) == 0
        with open(out) as fh:
            outs.append(fh.read())
    assert outs[1] == outs[0]
