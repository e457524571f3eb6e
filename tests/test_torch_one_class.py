"""One-class LS-SVM of the port against plssvm_tpu's, on the CPU.

The port's ``fit_one_class`` (plssvm_tpu_torch/one_class.py) solves
``(K + I/C) a = 1`` with ``solver/cg.py::ridge_cg_core`` on the
classifier's products and thresholds at the ``nu``-quantile of ``K a``.
Each fit is held against ``plssvm_tpu.fit_one_class`` on
``plssvm_tpu.CSVM(backend="xla", dtype=np.float64)`` with the same seeded
numpy inputs (200 x 8 unless a test says otherwise).  Tolerances, float64
at epsilon 1e-10: the same iterations, alpha within 1e-8 of its largest
magnitude and rho within 1e-8 relative (ROADMAP Queue 3 item 5's rule);
decision values of a model file within 1e-12.  The ring cases use the
kernels where plssvm_tpu's four-device count equals its one-device count
(the polynomial kernel takes 44 iterations there against 43 on one device
on this data).
"""

import os

import jax
import numpy as np
import pytest

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu_torch.cli import predict as t_predict_cli
from plssvm_tpu_torch.cli import train as t_train_cli
from plssvm_tpu_torch.exceptions import InvalidParameterError, NumericCheckError
from plssvm_tpu_torch.solver import checkpoint as tckpt

EPS = 1e-10
TOL = 1e-8
KERNELS = ["rbf", "polynomial", "laplacian", "chi_squared"]


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def _cloud(kernel="rbf", n=200, d=8, seed=0):
    X = np.random.default_rng(seed).normal(size=(n, d))
    return np.abs(X) if kernel == "chi_squared" else X


def _port(kernel, **kw):
    kw.setdefault("device", "cpu")
    return plssvm_tpu_torch.CSVM(dtype=np.float64, kernel_type=kernel, **kw)


def _reference(kernel, **kw):
    return plssvm_tpu.CSVM(backend="xla", dtype=np.float64, kernel_type=kernel, **kw)


def _assert_same_fit(got, want):
    assert got.is_one_class and not got.is_regression
    assert got.n_iter == want.n_iter
    alpha = np.asarray(want.alpha)
    np.testing.assert_allclose(got.alpha, alpha, rtol=0, atol=TOL * np.abs(alpha).max())
    assert got.rho == pytest.approx(want.rho, rel=TOL)


@pytest.mark.parametrize("solver", ["cg_implicit", "cg_explicit"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_fit_against_the_reference(kernel, solver):
    X = _cloud(kernel)
    got = plssvm_tpu_torch.fit_one_class(_port(kernel, solver=solver),
                                         plssvm_tpu_torch.DataSet(X), nu=0.1, epsilon=EPS)
    want = plssvm_tpu.fit_one_class(_reference(kernel, solver=solver),
                                    plssvm_tpu.DataSet(X), nu=0.1, epsilon=EPS)
    _assert_same_fit(got, want)
    tracked = dict(plssvm_tpu_torch.global_tracker.entries()["cg"])
    assert tracked["solver"] == solver


@pytest.mark.parametrize("kernel", KERNELS + ["linear"])
def test_explicit_against_implicit(kernel):
    """The stored K (kernel N's plain version for the distance kernels,
    the Gram build for the others) gives the implicit solve's fit."""
    X = _cloud(kernel, seed=1)
    fits = [plssvm_tpu_torch.fit_one_class(_port(kernel, solver=solver),
                                           plssvm_tpu_torch.DataSet(X), nu=0.2, epsilon=EPS)
            for solver in ("cg_implicit", "cg_explicit")]
    _assert_same_fit(fits[1], fits[0])


@pytest.mark.parametrize("kernel", ["rbf", "laplacian"])
def test_weighted_fit_against_a_dense_solve(kernel):
    """Suykens' weights: alpha solves ``(K + diag(1/(C s))) a = 1`` (numpy
    on the dense K of plssvm_tpu's kernel function), and equals
    plssvm_tpu's weighted fit."""
    X = _cloud(kernel, n=120, seed=2)
    weights = np.linspace(0.5, 3.0, len(X))
    cost, gamma = 2.0, 0.3
    got = plssvm_tpu_torch.fit_one_class(
        _port(kernel, cost=cost, gamma=gamma), plssvm_tpu_torch.DataSet(X), nu=0.1,
        epsilon=EPS, sample_weight=weights)
    from plssvm_tpu.kernel_functions import kernel_block

    K = np.asarray(kernel_block(X, X, np.sum(X * X, 1), np.sum(X * X, 1),
                                plssvm_tpu.KernelFunctionType.from_string(kernel), gamma,
                                0.0, 3))
    dense = np.linalg.solve(K + np.diag(1.0 / (cost * weights)), np.ones(len(X)))
    np.testing.assert_allclose(got.alpha, dense, rtol=0, atol=TOL * np.abs(dense).max())
    want = plssvm_tpu.fit_one_class(_reference(kernel, cost=cost, gamma=gamma),
                                    plssvm_tpu.DataSet(X), nu=0.1, epsilon=EPS,
                                    sample_weight=weights)
    _assert_same_fit(got, want)


def test_weights_are_checked():
    svm, data = _port("rbf"), plssvm_tpu_torch.DataSet(_cloud(n=30))
    with pytest.raises(InvalidParameterError, match="one entry per data point"):
        plssvm_tpu_torch.fit_one_class(svm, data, sample_weight=np.ones(29))
    with pytest.raises(InvalidParameterError, match="must all be positive"):
        plssvm_tpu_torch.fit_one_class(svm, data, sample_weight=np.zeros(30))


@pytest.mark.parametrize("devices", [None, ["cpu"] * 3])
def test_warm_start_from_the_solution_takes_no_iteration(devices):
    """A fit warm-started from a converged fit starts below its target
    (anchored to the cold start) and returns that fit's alpha; a rough fit
    refined to a tighter epsilon matches plssvm_tpu's warm refinement."""
    X = _cloud(seed=3)
    where = dict(device=None, devices=devices) if devices else {}
    svm = _port("rbf", **where)
    data = plssvm_tpu_torch.DataSet(X)
    done = plssvm_tpu_torch.fit_one_class(svm, data, nu=0.1, epsilon=EPS)
    again = plssvm_tpu_torch.fit_one_class(svm, data, nu=0.1, epsilon=EPS,
                                           initial_model=done)
    assert again.n_iter == 0
    np.testing.assert_array_equal(again.alpha, done.alpha)
    assert again.rho == done.rho
    j_svm = _reference("rbf")
    j_data = plssvm_tpu.DataSet(X)
    rough = [plssvm_tpu_torch.fit_one_class(svm, data, nu=0.1, epsilon=1e-3),
             plssvm_tpu.fit_one_class(j_svm, j_data, nu=0.1, epsilon=1e-3)]
    got = plssvm_tpu_torch.fit_one_class(svm, data, nu=0.1, epsilon=EPS,
                                         initial_model=rough[0])
    want = plssvm_tpu.fit_one_class(j_svm, j_data, nu=0.1, epsilon=EPS,
                                    initial_model=rough[1])
    _assert_same_fit(got, want)


def test_initial_model_is_checked(tmp_path):
    svm, data = _port("rbf"), plssvm_tpu_torch.DataSet(_cloud(n=30))
    other = plssvm_tpu_torch.fit_one_class(svm, plssvm_tpu_torch.DataSet(_cloud(n=31)))
    with pytest.raises(InvalidParameterError, match="support vectors"):
        plssvm_tpu_torch.fit_one_class(svm, data, initial_model=other)
    with pytest.raises(InvalidParameterError, match="checkpointing"):
        plssvm_tpu_torch.fit_one_class(svm, plssvm_tpu_torch.DataSet(_cloud(n=31)),
                                       initial_model=other,
                                       checkpoint_path=str(tmp_path / "c.ckpt"))


class _Interrupted(Exception):
    pass


@pytest.mark.parametrize("devices", [None, ["cpu"] * 4])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_checkpoint_resume(devices, dtype, tmp_path, monkeypatch):
    """A fit interrupted right after its save at iteration 8, then resumed
    from the file, equals the uninterrupted fit bit for bit; the file goes
    when the fit ends; float64 equals plssvm_tpu's checkpointed fit."""
    X = _cloud(seed=4)
    where = dict(device=None, devices=devices) if devices else {}
    svm = plssvm_tpu_torch.CSVM(dtype=dtype, kernel_type="rbf",
                                **(where or dict(device="cpu")))
    data = plssvm_tpu_torch.DataSet(X, dtype=dtype)
    eps = EPS if dtype == np.float64 else 1e-6
    plain = plssvm_tpu_torch.fit_one_class(svm, data, nu=0.1, epsilon=eps)
    assert plain.n_iter > 8
    path = str(tmp_path / "oc.ckpt")
    real_save = tckpt.save_checkpoint
    saved = []

    def save_then_stop(p, ckpt):
        real_save(p, ckpt)
        saved.append(ckpt.iteration)
        if ckpt.iteration >= 8:
            raise _Interrupted

    monkeypatch.setattr(tckpt, "save_checkpoint", save_then_stop)
    with pytest.raises(_Interrupted):
        plssvm_tpu_torch.fit_one_class(svm, data, nu=0.1, epsilon=eps, checkpoint_path=path,
                                       checkpoint_interval=4)
    monkeypatch.undo()
    assert saved == [4, 8] and os.path.isfile(path)
    resumed = plssvm_tpu_torch.fit_one_class(svm, data, nu=0.1, epsilon=eps,
                                             checkpoint_path=path, checkpoint_interval=4)
    assert not os.path.exists(path)
    assert resumed.n_iter == plain.n_iter
    np.testing.assert_array_equal(resumed.alpha, plain.alpha)
    assert resumed.rho == plain.rho
    if dtype == np.float64:
        want = plssvm_tpu.fit_one_class(_reference("rbf"), plssvm_tpu.DataSet(X), nu=0.1,
                                        epsilon=eps, checkpoint_path=str(tmp_path / "j.ckpt"),
                                        checkpoint_interval=4)
        _assert_same_fit(resumed, want)


def test_a_checkpoint_of_another_problem_is_not_resumed(tmp_path, monkeypatch):
    """The fingerprint binds the data, the parameters and the weights."""
    path = str(tmp_path / "oc.ckpt")
    svm = _port("rbf")
    X = _cloud(seed=5)
    real_save = tckpt.save_checkpoint

    def save_then_stop(p, ckpt):
        real_save(p, ckpt)
        raise _Interrupted

    monkeypatch.setattr(tckpt, "save_checkpoint", save_then_stop)
    with pytest.raises(_Interrupted):
        plssvm_tpu_torch.fit_one_class(svm, plssvm_tpu_torch.DataSet(X), epsilon=EPS,
                                       checkpoint_path=path, checkpoint_interval=3)
    monkeypatch.undo()
    other = plssvm_tpu_torch.DataSet(X, dtype=np.float64)
    weighted = plssvm_tpu_torch.fit_one_class(
        svm, other, epsilon=EPS, checkpoint_path=path, checkpoint_interval=3,
        sample_weight=np.full(len(X), 2.0))
    cold = plssvm_tpu_torch.fit_one_class(svm, other, epsilon=EPS,
                                          sample_weight=np.full(len(X), 2.0))
    np.testing.assert_array_equal(weighted.alpha, cold.alpha)


@pytest.mark.parametrize("solver", ["cg_implicit", "cg_explicit"])
@pytest.mark.parametrize("kernel", ["rbf", "laplacian", "chi_squared"])
def test_ring_against_the_reference(kernel, solver):
    """Four shards on one CPU (the ring, or the stored row blocks) against
    plssvm_tpu's sharded solve on four CPU devices, and the SV-sharded
    predict against plssvm_tpu's."""
    X = _cloud(kernel, seed=6)
    test = _cloud(kernel, n=50, seed=7)
    t_svm = plssvm_tpu_torch.CSVM(devices=["cpu"] * 4, dtype=np.float64, kernel_type=kernel,
                                  solver=solver)
    j_svm = _reference(kernel, solver=solver, devices=jax.devices("cpu")[:4])
    got = plssvm_tpu_torch.fit_one_class(t_svm, plssvm_tpu_torch.DataSet(X), nu=0.1,
                                         epsilon=EPS)
    want = plssvm_tpu.fit_one_class(j_svm, plssvm_tpu.DataSet(X), nu=0.1, epsilon=EPS)
    _assert_same_fit(got, want)
    np.testing.assert_allclose(t_svm.predict_values(got, plssvm_tpu_torch.DataSet(test)),
                               j_svm.predict_values(want, plssvm_tpu.DataSet(test)),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ring_against_one_device(dtype):
    """float64: the same iterations and alpha within 1e-10.  float32: the
    ring sums compensated partials per shard and one device takes the
    reference's plain dot, so a count may differ by one; alpha within
    1e-4 of its largest magnitude and the same training labels."""
    X = _cloud(seed=8)
    svms = [plssvm_tpu_torch.CSVM(dtype=dtype, kernel_type="rbf", **where)
            for where in (dict(device="cpu"), dict(devices=["cpu"] * 4))]
    data = plssvm_tpu_torch.DataSet(X, dtype=dtype)
    fits = [plssvm_tpu_torch.fit_one_class(svm, data, nu=0.1,
                                           epsilon=EPS if dtype == np.float64 else 1e-6)
            for svm in svms]
    if dtype == np.float64:
        assert fits[0].n_iter == fits[1].n_iter
    assert abs(fits[0].n_iter - fits[1].n_iter) <= 1
    tol = 1e-10 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(fits[1].alpha, fits[0].alpha, rtol=0,
                               atol=tol * np.abs(fits[0].alpha).max())
    np.testing.assert_array_equal(svms[1].predict(fits[1], data),
                                  svms[0].predict(fits[0], data))


def test_the_ring_goes_through_the_shards(monkeypatch):
    """With devices the solve's products are the ring's (one symmetric
    product per shard and product), not the one-device product."""
    from plssvm_tpu_torch.ops import matvec

    calls = []
    real = matvec.kernel_matvec_plain

    def counted(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(matvec, "kernel_matvec_plain", counted)
    model = plssvm_tpu_torch.fit_one_class(
        plssvm_tpu_torch.CSVM(devices=["cpu"] * 4, dtype=np.float64, kernel_type="rbf",
                              solver="cg_implicit"),
        plssvm_tpu_torch.DataSet(_cloud(seed=9)), epsilon=EPS)
    # the initial product is none (x0 = 0): one per iteration, every 50th
    # exact residual, and the scores' product, four shards each
    products = model.n_iter + model.n_iter // 50 + 1
    assert calls == [50] * (4 * products)


def test_predict_score_and_the_nu_share():
    """predict gives +1 / -1 (f > 0 is +1), score the accuracy against
    +1 / -1 labels, and a nu share of the training points is flagged."""
    X = _cloud(n=400, seed=10)
    svm = _port("rbf")
    data = plssvm_tpu_torch.DataSet(X)
    model = plssvm_tpu_torch.fit_one_class(svm, data, nu=0.1, epsilon=EPS)
    values = svm.predict_values(model, data)
    predicted = svm.predict(model, data)
    assert predicted.dtype == np.int64
    np.testing.assert_array_equal(predicted, np.where(values > 0, 1, -1))
    assert abs(np.mean(predicted == -1) - 0.1) <= 2.0 / len(X)
    labelled = plssvm_tpu_torch.DataSet(X, predicted)
    assert svm.score(model, labelled) == 1.0
    j_svm = _reference("rbf")
    want = plssvm_tpu.fit_one_class(j_svm, plssvm_tpu.DataSet(X), nu=0.1, epsilon=EPS)
    np.testing.assert_array_equal(predicted, j_svm.predict(want, plssvm_tpu.DataSet(X)))


@pytest.mark.parametrize("kernel", KERNELS)
def test_model_files_across_packages(kernel, tmp_path):
    """The port's writer, given plssvm_tpu's fit arrays, writes plssvm_tpu's
    bytes (after the timestamp line); each package loads the other's file
    as a one-class model; plssvm_tpu's file predicts the same values in
    both to 1e-12 and the same labels."""
    X = _cloud(kernel, n=80, seed=11)
    test = _cloud(kernel, n=40, seed=12)
    j_svm = _reference(kernel)
    want = plssvm_tpu.fit_one_class(j_svm, plssvm_tpu.DataSet(X), nu=0.15, epsilon=EPS)
    mirrored = plssvm_tpu_torch.fit_one_class(_port(kernel), plssvm_tpu_torch.DataSet(X),
                                              nu=0.15, epsilon=1e-2)
    mirrored.alpha, mirrored.rho = np.asarray(want.alpha), want.rho
    j_path, t_path = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    want.save(j_path)
    mirrored.save(t_path)
    with open(j_path, "rb") as fj, open(t_path, "rb") as ft:
        assert fj.read().split(b"\n", 1)[1] == ft.read().split(b"\n", 1)[1]
    loaded = plssvm_tpu_torch.Model.load(j_path)
    assert loaded.is_one_class and not loaded.is_regression
    assert plssvm_tpu.Model.load(t_path).is_one_class
    t_svm = _port(kernel)
    j_loaded = plssvm_tpu.Model.load(j_path)
    np.testing.assert_allclose(t_svm.predict_values(loaded, plssvm_tpu_torch.DataSet(test)),
                               j_svm.predict_values(j_loaded, plssvm_tpu.DataSet(test)),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(t_svm.predict(loaded, plssvm_tpu_torch.DataSet(test)),
                                  j_svm.predict(j_loaded, plssvm_tpu.DataSet(test)))


def test_validation_errors(tmp_path):
    svm, data = _port("rbf"), plssvm_tpu_torch.DataSet(_cloud(n=30))
    for nu in (0.0, 1.0):
        with pytest.raises(InvalidParameterError, match="nu must be in"):
            plssvm_tpu_torch.fit_one_class(svm, data, nu=nu)
    with pytest.raises(InvalidParameterError, match="epsilon"):
        plssvm_tpu_torch.fit_one_class(svm, data, epsilon=0.0)
    with pytest.raises(InvalidParameterError, match="max_iter"):
        plssvm_tpu_torch.fit_one_class(svm, data, max_iter=0)
    with pytest.raises(InvalidParameterError, match="checkpoint_interval"):
        plssvm_tpu_torch.fit_one_class(svm, data, checkpoint_path="x", checkpoint_interval=0)
    with pytest.raises(InvalidParameterError, match="non-negative"):
        plssvm_tpu_torch.fit_one_class(_port("chi_squared"), data)
    # the multi-process fit (ROADMAP Queue 1 item 10) keeps the rules
    path = str(tmp_path / "train.libsvm")
    data.save(path)
    for kwargs, match in ((dict(nu=1.0), "nu must be in"), (dict(epsilon=0.0), "epsilon"),
                          (dict(max_iter=0), "max_iter"),
                          (dict(checkpoint_path="x", checkpoint_interval=0),
                           "checkpoint_interval")):
        with pytest.raises(InvalidParameterError, match=match):
            plssvm_tpu_torch.fit_one_class_multihost(svm, path, **kwargs)
    with pytest.raises(InvalidParameterError, match="non-negative"):
        plssvm_tpu_torch.fit_one_class_multihost(_port("chi_squared"), path)


def test_debug_guard_names_the_non_finite_step():
    """The cold start's residual is b = 1 whatever the data, so a NaN in X
    shows at the first step size, with plssvm_tpu's message."""
    X = _cloud(n=30)
    X[3, 2] = np.nan
    with pytest.raises(NumericCheckError,
                       match="ridge-CG step size became non-finite at iteration 0"):
        plssvm_tpu_torch.fit_one_class(_port("rbf", debug=True),
                                       plssvm_tpu_torch.DataSet(X), epsilon=EPS)


def test_max_iter_caps_and_the_tracker():
    plssvm_tpu_torch.global_tracker.clear()
    model = plssvm_tpu_torch.fit_one_class(_port("rbf"), plssvm_tpu_torch.DataSet(_cloud()),
                                           nu=0.3, epsilon=EPS, max_iter=3)
    assert model.n_iter == 3
    entries = plssvm_tpu_torch.global_tracker.entries()
    assert ("iterations", 3) in entries["cg"] and ("max_iterations", 3) in entries["cg"]
    assert ("nu", 0.3) in entries["parameter"]


# ---------------------------------------------------------------------------
# the CLIs: -s one_class and one-class models in predict
# ---------------------------------------------------------------------------


def _write_cloud(tmp_path, seed=13, n=60):
    from plssvm_tpu.io.libsvm import write_libsvm_file

    path = str(tmp_path / "oc.libsvm")
    # one-class training files conventionally carry a single +1 label class
    write_libsvm_file(path, _cloud(n=n, d=4, seed=seed), np.ones(n, dtype=np.int64))
    return path


def test_cli_train_and_predict_against_the_reference(tmp_path, capsys):
    """``-s one_class -n 0.2`` through both packages' CLIs in float64: the
    model files' rho and alphas within 1e-8, the same predict files, and
    the port's accuracy line against the file's +1 labels."""
    from plssvm_tpu.cli import predict as j_predict_cli
    from plssvm_tpu.cli import train as j_train_cli

    train = _write_cloud(tmp_path)
    flags = ["--use_double_as_real_type", "-s", "one_class", "-n", "0.2", "-t", "2",
             "-g", "0.3", "-e", str(EPS)]
    files = {}
    for name, (train_cli, predict_cli, where) in {
            "t": (t_train_cli, t_predict_cli, ["-p", "cpu"]),
            "j": (j_train_cli, j_predict_cli, ["-b", "xla"])}.items():
        model, out = str(tmp_path / f"{name}.model"), str(tmp_path / f"{name}.predict")
        assert train_cli.main(where + ["-q"] + flags + [train, model]) == 0
        assert predict_cli.main(where + ["--verbosity", "libsvm", "--use_double_as_real_type",
                                         train, model, out]) == 0
        files[name] = (model, out)
    accuracy = [ln for ln in capsys.readouterr().out.splitlines() if "Accuracy" in ln]
    assert len(accuracy) == 2 and accuracy[0] == accuracy[1]
    assert "svm_type one_class" in open(files["t"][0]).read()
    got, want = (plssvm_tpu_torch.Model.load(files[k][0]) for k in "tj")
    assert got.is_one_class
    assert got.rho == pytest.approx(want.rho, rel=TOL)
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=0,
                               atol=TOL * np.abs(want.alpha).max())
    pred = np.loadtxt(files["t"][1], dtype=np.int64)
    np.testing.assert_array_equal(pred, np.loadtxt(files["j"][1], dtype=np.int64))
    assert set(np.unique(pred)) <= {-1, 1}
    assert abs(float(np.mean(pred == -1)) - 0.2) < 0.05


def test_cli_warm_start_and_checkpoint(tmp_path):
    """``--warm_start`` from a one-class model file and ``--checkpoint``
    compose with ``-s one_class``: the warm start from the converged file
    takes no iteration and the checkpointed fit writes the same model."""
    train = _write_cloud(tmp_path, seed=14)
    flags = ["-p", "cpu", "-q", "--use_double_as_real_type", "-s", "one_class", "-t", "2",
             "-e", str(EPS)]
    first, warm, ckpt = (str(tmp_path / f"{k}.model") for k in ("first", "warm", "ckpt"))
    assert t_train_cli.main(flags + [train, first]) == 0
    plssvm_tpu_torch.global_tracker.clear()
    assert t_train_cli.main(flags + ["--warm_start", first, train, warm]) == 0
    assert ("iterations", 0) in plssvm_tpu_torch.global_tracker.entries()["cg"]
    assert t_train_cli.main(flags + ["--checkpoint", str(tmp_path / "c.ckpt"),
                                     "--checkpoint_interval", "3", train, ckpt]) == 0
    a, b = (open(p).read().split("\n", 1)[1] for p in (first, ckpt))
    assert a == b


@pytest.mark.parametrize("flags,message", [
    (["-n", "1.5"], "nu must be in"),
    (["--weight", "1=2.0"], "--weight"),
    (["--probability"], "--probability"),
    (["--cross_validation", "3"], "--cross_validation"),
    (["--max_sv", "5", "--nystroem", "5"], "mutually exclusive"),
])
def test_cli_flag_conflicts(flags, message, tmp_path, capsys):
    """plssvm_tpu's refusals of tests/test_one_class.py, with its messages:
    each exits 1 before any fit and writes no model."""
    from plssvm_tpu.cli import train as j_train_cli

    train = _write_cloud(tmp_path, n=20)
    errors = []
    for cli, where in ((t_train_cli, ["-p", "cpu"]), (j_train_cli, ["-b", "xla"])):
        model = str(tmp_path / "oc.model")
        assert cli.main(where + ["-q", "-s", "one_class"] + flags + [train, model]) == 1
        assert not os.path.exists(model)
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert message in errors[0]
    assert errors[0] == errors[1]
