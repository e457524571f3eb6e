"""LS-SVR regression of the port against plssvm_tpu's, on the CPU.

Regression is the binary LS-SVM solve on continuous targets
(``DataSet(regression=True)``): ``fit`` takes the binary branch with
``data.y``, ``predict`` returns the decision values, ``score`` is R^2 with
sklearn's rule for constant targets, and the model is LIBSVM's epsilon_svr
layout.  Each fit is held against ``plssvm_tpu.CSVM(backend="xla",
solver="cg_implicit", dtype=np.float64)`` on a seeded Friedman #1 set
(Friedman, Ann. Statist. 19(1), 1991: ``10 sin(pi x0 x1) + 20 (x2 -
0.5)^2 + 10 x3 + 5 x4`` plus unit noise, x uniform on [0, 1]^10, the
formula of sklearn's ``make_friedman1``).  Tolerances, float64 at epsilon
1e-10: the same iterations (on seeds where plssvm_tpu's count agrees with
its ring's, ROADMAP Queue 3 item 4); rho, alpha and the predicted values
within 1e-8 of max(1, their largest magnitude), as tests/test_torch_cg.py
scales them (LS-SVR's alphas and targets are O(10) here, C = 10); R^2
within 1e-10.  The CLIs (``-s epsilon_svr``, the
predict file's values, the MSE and squared correlation lines) are held
against plssvm_tpu's CLIs.
"""

import os

import numpy as np
import pytest

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu.cli import predict as j_predict_cli
from plssvm_tpu.cli import train as j_train_cli
from plssvm_tpu_torch.cli import predict as t_predict_cli
from plssvm_tpu_torch.cli import train as t_train_cli

EPS = 1e-10
TOL = 1e-8


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def friedman1(n, seed, d=10, noise=1.0):
    """Friedman #1: the first five of ``d`` uniform features carry the
    target, the rest are noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    y = (10.0 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20.0 * (X[:, 2] - 0.5) ** 2
         + 10.0 * X[:, 3] + 5.0 * X[:, 4] + noise * rng.normal(size=n))
    return X, y


def _close(got, want):
    """Within TOL of max(1, max|want|)."""
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))


def _both(kernel, seed=0, n=160, **svm_kw):
    """The port's and plssvm_tpu's fits of 120 rows, and their test sets of
    the other 40."""
    X, y = friedman1(n, seed)
    out = []
    for package, where in ((plssvm_tpu_torch, dict(device="cpu")),
                           (plssvm_tpu, dict(backend="xla", solver="cg_implicit"))):
        svm = package.CSVM(dtype=np.float64, kernel_type=kernel, cost=10.0, **where,
                           **svm_kw)
        train = package.DataSet(X[:120], y[:120], regression=True)
        test = package.DataSet(X[120:], y[120:], regression=True)
        out.append((svm, svm.fit(train, epsilon=EPS), train, test))
    return out


@pytest.mark.parametrize("kernel", ["rbf", "linear", "laplacian", "polynomial"])
def test_fit_predict_score_against_the_reference(kernel):
    (t_svm, t_model, _, t_test), (j_svm, j_model, _, j_test) = _both(
        kernel, seed={"rbf": 1}.get(kernel, 0))
    assert t_model.is_regression
    assert t_model.n_iter == j_model.n_iter
    _close(t_model.rho, j_model.rho)
    _close(t_model.alpha, j_model.alpha)
    got = t_svm.predict(t_model, t_test)
    assert got.dtype.kind == "f" and got.shape == (40,)
    np.testing.assert_array_equal(got, t_svm.predict_values(t_model, t_test))
    _close(got, j_svm.predict(j_model, j_test))
    assert abs(t_svm.score(t_model, t_test) - j_svm.score(j_model, j_test)) <= 1e-10
    assert abs(t_svm.score(t_model) - j_svm.score(j_model)) <= 1e-10


def test_score_is_r2_with_the_constant_target_rule():
    (t_svm, t_model, t_train, _), _ = _both("rbf", seed=1)
    values = t_svm.predict_values(t_model, t_train)
    targets = np.asarray(t_train.labels)
    r2 = 1.0 - np.sum((targets - values) ** 2) / np.sum((targets - targets.mean()) ** 2)
    assert abs(t_svm.score(t_model) - r2) <= 1e-12
    X = np.asarray(t_train.data)[:5]
    constant = plssvm_tpu_torch.DataSet(X, np.full(5, 2.0), regression=True)
    assert t_svm.score(t_model, constant) == 0.0
    model = t_svm.fit(constant, epsilon=EPS)
    if np.allclose(t_svm.predict_values(model, constant), 2.0, rtol=0, atol=0):
        assert t_svm.score(model, constant) == 1.0


def test_float32_fit_against_float64():
    """float32 with compensated scalars at epsilon 1e-6: R^2 within 1e-4
    of the float64 fit's."""
    X, y = friedman1(160, 0)
    scores = []
    for dtype in (np.float32, np.float64):
        svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=dtype, kernel_type="rbf", cost=10.0)
        train = plssvm_tpu_torch.DataSet(X[:120], y[:120], regression=True, dtype=dtype)
        test = plssvm_tpu_torch.DataSet(X[120:], y[120:], regression=True, dtype=dtype)
        scores.append(svm.score(svm.fit(train, epsilon=1e-6), test))
    assert abs(scores[0] - scores[1]) <= 1e-4
    assert scores[1] > 0.5


@pytest.mark.parametrize("extra", ["sample_weight", "warm", "jacobi"])
def test_solver_extras_against_the_reference(extra):
    """Weights, a warm start (no re-alignment for continuous targets) and
    Jacobi on LS-SVR, each against plssvm_tpu's fit (Jacobi on seed 2:
    on seed 0 plssvm_tpu's one-device and ring counts differ, 34 and 32)."""
    X, y = friedman1(160, 2 if extra == "jacobi" else 0)
    sw = np.random.default_rng(2).uniform(0.5, 2.0, 120)
    models = []
    for package, where in ((plssvm_tpu_torch, dict(device="cpu")),
                           (plssvm_tpu, dict(backend="xla", solver="cg_implicit"))):
        svm = package.CSVM(dtype=np.float64, kernel_type="rbf", cost=10.0, **where,
                           **(dict(preconditioner="jacobi") if extra == "jacobi" else {}))
        train = package.DataSet(X[:120], y[:120], regression=True)
        kw = {}
        if extra == "sample_weight":
            kw["sample_weight"] = sw
        elif extra == "warm":
            kw["initial_model"] = svm.fit(train, epsilon=1e-4)
        models.append(svm.fit(train, epsilon=EPS, **kw))
    got, want = models
    assert got.n_iter == want.n_iter
    _close(got.rho, want.rho)
    _close(got.alpha, want.alpha)


def test_model_file_round_trip(tmp_path):
    """The epsilon_svr model file: the same header lines as plssvm_tpu's,
    rho to the writer's digits, and a loaded model predicts the fitted
    one's values."""
    (t_svm, t_model, _, t_test), (_, j_model, _, _) = _both("rbf", seed=1)
    t_model.save(str(tmp_path / "t.model"))
    j_model.save(str(tmp_path / "j.model"))
    t_lines = [ln for ln in open(tmp_path / "t.model") if not ln.startswith("#")]
    j_lines = [ln for ln in open(tmp_path / "j.model") if not ln.startswith("#")]
    assert t_lines[0] == j_lines[0] == "svm_type epsilon_svr\n"
    header = t_lines.index("SV\n")
    assert [ln.split()[0] for ln in t_lines[:header + 1]] == [
        ln.split()[0] for ln in j_lines[:header + 1]]
    t_rho = [float(ln.split()[1]) for ln in t_lines if ln.startswith("rho ")]
    j_rho = [float(ln.split()[1]) for ln in j_lines if ln.startswith("rho ")]
    _close(t_rho[0], j_rho[0])
    loaded = plssvm_tpu_torch.Model.load(str(tmp_path / "t.model"))
    assert loaded.is_regression
    np.testing.assert_allclose(t_svm.predict(loaded, t_test), t_svm.predict(t_model, t_test),
                               rtol=0, atol=1e-8)


def test_one_class_models_still_raise(tmp_path):
    """One-class models are ported (ROADMAP Queue 1 item 7): a model marked
    one-class predicts its decision values as a binary model does and
    +1 / -1 by their sign (tests/test_torch_one_class.py holds one-class
    training against plssvm_tpu's)."""
    (t_svm, t_model, _, t_test), _ = _both("linear")
    values = t_svm.predict_values(t_model, t_test)
    t_model.is_regression = False
    t_model.is_one_class = True
    np.testing.assert_array_equal(t_svm.predict_values(t_model, t_test), values)
    np.testing.assert_array_equal(t_svm.predict(t_model, t_test), np.where(values > 0, 1, -1))


@pytest.mark.parametrize("svm_type", ["epsilon_svr", "svr"])
def test_cli_against_the_reference(svm_type, tmp_path, capsys):
    """``-s epsilon_svr`` / ``svr`` through both packages' CLIs in float64:
    rho and the predict files' values (written with 10 significant digits)
    within 1e-8 of their scale, the MSE and squared correlation lines within
    1e-6."""
    X, y = friedman1(160, 1)
    train_file, test_file = str(tmp_path / "train.libsvm"), str(tmp_path / "test.libsvm")
    plssvm_tpu_torch.DataSet(X[:120], y[:120], regression=True).save(train_file)
    plssvm_tpu_torch.DataSet(X[120:], y[120:], regression=True).save(test_file)
    common = ["-s", svm_type, "-t", "2", "-c", "10", "-e", str(EPS),
              "--use_double_as_real_type"]
    out = {}
    for name, train_cli, predict_cli, extra in (
            ("j", j_train_cli, j_predict_cli, ["-b", "xla", "--solver", "cg_implicit",
                                               "-p", "cpu"]),
            ("t", t_train_cli, t_predict_cli, ["-p", "cpu"])):
        model, pred = str(tmp_path / f"{name}.model"), str(tmp_path / f"{name}.predict")
        assert train_cli.main(common + ["-q"] + extra + [train_file, model]) == 0
        capsys.readouterr()
        assert predict_cli.main(["--use_double_as_real_type", "--verbosity", "libsvm"]
                                + extra[-2:]
                                + [test_file, model, pred]) == 0
        printed = capsys.readouterr().out
        rho = [ln for ln in open(model) if ln.startswith("rho ")][0].split()[1]
        metrics = [ln for ln in printed.splitlines() if "(regression)" in ln]
        out[name] = (float(rho), np.loadtxt(pred), metrics)
    assert "svm_type epsilon_svr" in open(tmp_path / "t.model").read()
    _close(out["t"][0], out["j"][0])
    _close(out["t"][1], out["j"][1])
    assert [m.split("=")[0] for m in out["t"][2]] == [
        "Mean squared error ", "Squared correlation coefficient "]
    for got, want in zip(out["t"][2], out["j"][2]):
        assert abs(float(got.split("=")[1].split()[0])
                   - float(want.split("=")[1].split()[0])) <= 1e-6


def test_cli_weight_refused_for_regression(tmp_path, capsys):
    """``--weight`` with a regression type fails with plssvm_tpu's message."""
    X, y = friedman1(40, 3)
    train_file = str(tmp_path / "train.libsvm")
    plssvm_tpu_torch.DataSet(X, y, regression=True).save(train_file)
    messages = []
    for cli, extra in ((j_train_cli, ["-b", "xla"]), (t_train_cli, [])):
        assert cli.main(["-s", "epsilon_svr", "--weight", "1=2", "-p", "cpu", "-q"] + extra
                        + [train_file, str(tmp_path / "m.model")]) == 1
        messages.append(capsys.readouterr().err.strip())
    assert messages[1] == messages[0] == \
        "--weight is only supported for classification training!"
    assert not os.path.exists(tmp_path / "m.model")
