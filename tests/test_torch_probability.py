"""Probability calibration and cross-validation of the port against
plssvm_tpu's, on the CPU.

``plssvm_tpu_torch/probability.py`` is NumPy host code around the port's
``CSVM.fit`` and ``predict_values``; ``oao.pairwise_coupling`` is LIBSVM's
``multiclass_probability``.  The host functions are held to 1e-12 against
plssvm_tpu's on the same inputs (``fit_sigmoid``, ``sigmoid_probability``,
``pairwise_coupling``), the fold draws index for index; the fitted
pipelines (``cross_validate``, ``calibrate_model``,
``calibrate_svr_noise``, ``predict_probabilities``) against plssvm_tpu's
with ``CSVM(backend="xla", dtype=np.float64)`` at epsilon 1e-10: the same
fold predictions, probA / probB within 1e-6 relative, probabilities within
1e-7.  The CLIs' ``--probability`` and ``--cross_validation`` are held
against plssvm_tpu's CLIs.
"""

import os

import numpy as np
import pytest

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu import oao as j_oao
from plssvm_tpu import probability as j_prob
from plssvm_tpu.cli import predict as j_predict_cli
from plssvm_tpu.cli import train as j_train_cli
from plssvm_tpu_torch import oao as t_oao
from plssvm_tpu_torch import probability as t_prob
from plssvm_tpu_torch.cli import predict as t_predict_cli
from plssvm_tpu_torch.cli import train as t_train_cli

EPS = 1e-10
REL = 1e-6


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def _blobs(n_classes, n=120, d=5, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    X = rng.normal(size=(n, d)) + 1.2 * rng.normal(size=(n_classes, d))[y]
    return X, y


def _friedman(n=120, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 6))
    y = 10 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 10 * X[:, 3] + rng.normal(size=n)
    return X, y


def _pair(**kw):
    return (plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="rbf", **kw),
            plssvm_tpu.CSVM(backend="xla", dtype=np.float64, kernel_type="rbf", **kw))


# ---------------------------------------------------------------------------
# host functions on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_fit_sigmoid(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 400))
    f = rng.normal(size=n) * rng.uniform(0.1, 20.0)
    y = rng.random(n) < 1.0 / (1.0 + np.exp(-2.0 * f + rng.normal()))
    if seed == 5:
        y = f > 0  # separable: the line search ends the Newton loop
    got = t_prob.fit_sigmoid(f, y)
    want = j_prob.fit_sigmoid(f, y)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(t_prob.sigmoid_probability(f, *got),
                               j_prob.sigmoid_probability(f, *want), rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_classes", [2, 3, 4, 7])
def test_pairwise_coupling(n_classes):
    rng = np.random.default_rng(n_classes)
    r = rng.uniform(size=(50, t_oao.num_machines(n_classes)))
    r[0] = 0.0  # clipped to 1e-7
    r[1] = 1.0
    got = t_oao.pairwise_coupling(r, n_classes)
    np.testing.assert_allclose(got, j_oao.pairwise_coupling(r, n_classes), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_oao.pairwise_coupling(r, n_classes, max_iter=3, eps=1e-9),
                               j_oao.pairwise_coupling(r, n_classes, max_iter=3, eps=1e-9),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("random_state", [None, 0, 7, 12345])
@pytest.mark.parametrize("stratified", [True, False])
@pytest.mark.parametrize("n_folds", [2, 5, 200])
def test_fold_assignments(random_state, stratified, n_folds):
    """The same index arrays for a given ``random_state`` (folds capped at
    the point count)."""
    labels = np.random.default_rng(3).integers(0, 4, 150)
    got, got_n = t_prob._fold_assignments(labels, n_folds, random_state,
                                          stratified=stratified)
    want, want_n = j_prob._fold_assignments(labels, n_folds, random_state,
                                            stratified=stratified)
    assert got_n == want_n == min(n_folds, 150)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    seed = 0 if random_state is None else random_state
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(t_prob.stratified_folds(labels, 3, rng_t),
                                  j_prob.stratified_folds(labels, 3, rng_j))


def test_fold_assignments_refuse_one_fold():
    with pytest.raises(ValueError, match="at least 2"):
        t_prob._fold_assignments(np.arange(10), 1, None, stratified=True)


# ---------------------------------------------------------------------------
# the fitted pipelines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_classes,classification", [(2, "oaa"), (3, "oaa"), (3, "oao")])
def test_cross_validate(n_classes, classification):
    X, y = _blobs(n_classes, seed=n_classes)
    t_svm, j_svm = _pair()
    got = t_prob.cross_validate(t_svm, plssvm_tpu_torch.DataSet(X, y), n_folds=4,
                                random_state=5, epsilon=EPS, classification=classification)
    want = j_prob.cross_validate(j_svm, plssvm_tpu.DataSet(X, y), n_folds=4,
                                 random_state=5, epsilon=EPS, classification=classification)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    assert got["accuracy"] == want["accuracy"]


def test_cross_validate_regression():
    X, y = _friedman(seed=1)
    t_svm, j_svm = _pair(cost=10.0)
    got = t_prob.cross_validate(t_svm, plssvm_tpu_torch.DataSet(X, y, regression=True),
                                n_folds=5, epsilon=EPS)
    want = j_prob.cross_validate(j_svm, plssvm_tpu.DataSet(X, y, regression=True),
                                 n_folds=5, epsilon=EPS)
    np.testing.assert_allclose(got["predictions"], want["predictions"], rtol=0, atol=1e-8)
    assert got["mse"] == pytest.approx(want["mse"], rel=1e-8)
    assert got["scc"] == pytest.approx(want["scc"], rel=1e-8)


def test_cross_validate_weights_and_a_singleton_class():
    """Sample weights reach every fold's fit; a fold whose training split
    lost a class predicts the majority label, with plssvm_tpu's warning."""
    X, _ = _blobs(2, seed=9)
    y = np.zeros(len(X), dtype=np.int64)
    y[0] = 7  # a singleton class: its fold's training split has one class
    weights = np.linspace(0.5, 2.0, len(y))
    t_svm, j_svm = _pair()
    with pytest.warns(UserWarning, match="singleton class"):
        got = t_prob.cross_validate(t_svm, plssvm_tpu_torch.DataSet(X, y), n_folds=3,
                                    epsilon=EPS, sample_weight=weights)
    with pytest.warns(UserWarning):
        want = j_prob.cross_validate(j_svm, plssvm_tpu.DataSet(X, y), n_folds=3,
                                     epsilon=EPS, sample_weight=weights)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])


def _calibrated(n_classes, classification, seed):
    X, y = _blobs(n_classes, seed=seed)
    out = []
    for package, svm in zip((plssvm_tpu_torch, plssvm_tpu), _pair()):
        data = package.DataSet(X, y)
        model = svm.fit(data, epsilon=EPS, classification=classification)
        prob = (t_prob if package is plssvm_tpu_torch else j_prob).calibrate_model(
            svm, model, data, n_folds=5, random_state=seed, epsilon=EPS)
        out.append((svm, model, prob, X))
    return out


@pytest.mark.parametrize("n_classes,classification", [(2, "oaa"), (4, "oaa"), (4, "oao")])
def test_calibrate_model(n_classes, classification):
    """probA / probB within 1e-6 relative (one per binary, class or pair
    machine), stored on the model; the probabilities of new points within
    1e-8, each row summing to 1."""
    (t_svm, t_model, got, X), (j_svm, j_model, want, _) = _calibrated(
        n_classes, classification, seed=10 + n_classes)
    machines = {2: 1}.get(n_classes, n_classes if classification == "oaa"
                          else n_classes * (n_classes - 1) // 2)
    assert got[0].shape == (machines,) and t_model.prob_a is got[0]
    np.testing.assert_allclose(got[0], want[0], rtol=REL)
    np.testing.assert_allclose(got[1], want[1], rtol=REL, atol=1e-9)
    new = _blobs(n_classes, n=40, seed=99)[0]
    # the sigmoids agree to ~1e-8 relative here; the probabilities to
    # 1.4e-8 (measured on these seeds)
    p_got = t_prob.predict_probabilities(
        t_model, t_svm.predict_values(t_model, plssvm_tpu_torch.DataSet(new)))
    p_want = j_prob.predict_probabilities(
        j_model, j_svm.predict_values(j_model, plssvm_tpu.DataSet(new)))
    np.testing.assert_allclose(p_got, p_want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(p_got.sum(axis=1), 1.0, rtol=0, atol=1e-12)


@pytest.mark.parametrize("oao_batch,devices", [
    ("batched", None), ("sequential", None), ("batched", ["cpu"] * 3)])
def test_oao_calibration_strategies(oao_batch, devices):
    """A batched one-vs-one fit cross-validates batched too (each fold's
    machines one pairs solve, on one device or split over three), a
    sequential one fits each pair's folds on their own; both give
    plssvm_tpu's probA / probB, weighted, at a capped iteration count."""
    from plssvm_tpu_torch.ops import pairs

    X, y = _blobs(4, seed=17)
    weights = np.linspace(0.5, 2.0, len(y))
    where = dict(device="cpu") if devices is None else dict(devices=devices)
    t_svm = plssvm_tpu_torch.CSVM(dtype=np.float64, kernel_type="rbf", oao_batch=oao_batch,
                                  **where)
    j_svm = _pair()[1]
    out = []
    for package, svm, prob in ((plssvm_tpu_torch, t_svm, t_prob), (plssvm_tpu, j_svm, j_prob)):
        data = package.DataSet(X, y)
        model = svm.fit(data, epsilon=EPS, classification="oao", sample_weight=weights)
        pairs.reset_counts()
        out.append(prob.calibrate_model(svm, model, data, n_folds=4, random_state=3,
                                        epsilon=EPS, max_iter=40, sample_weight=weights))
        if package is plssvm_tpu_torch:
            assert (pairs.plain_calls > 0) == (oao_batch == "batched")
    (got_a, got_b), (want_a, want_b) = out
    np.testing.assert_allclose(got_a, want_a, rtol=REL)
    np.testing.assert_allclose(got_b, want_b, rtol=REL, atol=1e-9)


def test_calibrated_model_files(tmp_path):
    """The probA / probB header lines round-trip, and a calibrated model
    file loaded in each package gives the same probabilities."""
    (t_svm, t_model, _, X), (j_svm, j_model, _, _) = _calibrated(3, "oao", seed=21)
    t_path, j_path = str(tmp_path / "t.model"), str(tmp_path / "j.model")
    t_model.save(t_path)
    j_model.save(j_path)
    t_lines = [ln for ln in open(t_path) if ln.startswith(("probA", "probB"))]
    j_lines = [ln for ln in open(j_path) if ln.startswith(("probA", "probB"))]
    assert len(t_lines) == len(j_lines) == 2
    for t_ln, j_ln in zip(t_lines, j_lines):
        np.testing.assert_allclose(np.asarray(t_ln.split()[1:], float),
                                   np.asarray(j_ln.split()[1:], float), rtol=REL)
    loaded = plssvm_tpu_torch.Model.load(j_path)
    got = t_prob.predict_probabilities(
        loaded, t_svm.predict_values(loaded, plssvm_tpu_torch.DataSet(X)))
    j_loaded = plssvm_tpu.Model.load(j_path)
    want = j_prob.predict_probabilities(
        j_loaded, j_svm.predict_values(j_loaded, plssvm_tpu.DataSet(X)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_calibrate_svr_noise():
    X, y = _friedman(seed=2)
    out = []
    for package, svm, prob in zip((plssvm_tpu_torch, plssvm_tpu), _pair(cost=10.0),
                                  (t_prob, j_prob)):
        data = package.DataSet(X, y, regression=True)
        model = svm.fit(data, epsilon=EPS)
        sigma = prob.calibrate_model(svm, model, data, epsilon=EPS)
        out.append((model, sigma))
    (t_model, got), (j_model, want) = out
    assert t_model.prob_b is None and got[1] is None
    np.testing.assert_allclose(got[0], want[0], rtol=1e-8)
    with pytest.raises(ValueError, match="Laplace noise scale"):
        t_prob.predict_probabilities(t_model, np.zeros(3))


def test_uncalibrated_models_refuse_probabilities():
    t_svm, _ = _pair()
    X, y = _blobs(2)
    model = t_svm.fit(plssvm_tpu_torch.DataSet(X, y), epsilon=1e-3)
    with pytest.raises(ValueError, match="no probability calibration"):
        t_prob.predict_probabilities(model, np.zeros(3))


def test_singleton_class_calibrates_on_training_values():
    X, y = _blobs(3, seed=4)
    y[5] = 9
    t_svm, j_svm = _pair()
    got = want = None
    for package, svm, prob in ((plssvm_tpu_torch, t_svm, t_prob),
                               (plssvm_tpu, j_svm, j_prob)):
        data = package.DataSet(X, y)
        model = svm.fit(data, epsilon=EPS)
        with pytest.warns(UserWarning, match="fewer than 2 samples"):
            result = prob.calibrate_model(svm, model, data, epsilon=EPS)
        got, want = (result, want) if package is plssvm_tpu_torch else (got, result)
    np.testing.assert_allclose(got[0], want[0], rtol=REL)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _write(tmp_path, X, y, name, regression=False):
    path = str(tmp_path / f"{name}.libsvm")
    plssvm_tpu_torch.DataSet(X, y, regression=regression).save(path)
    return path


def _both_clis(tmp_path, train, flags, predict_flags=()):
    """Train and predict ``train`` through both packages' CLIs in float64;
    returns {"t"/"j": (train rc, predict rc, model path, predict path)}."""
    out = {}
    for name, (train_cli, predict_cli, where) in {
            "t": (t_train_cli, t_predict_cli, ["-p", "cpu"]),
            "j": (j_train_cli, j_predict_cli, ["-b", "xla"])}.items():
        model, pred = str(tmp_path / f"{name}.model"), str(tmp_path / f"{name}.predict")
        common = where + ["-q", "--use_double_as_real_type"]
        rc = train_cli.main(common + ["-e", str(EPS)] + flags + [train, model])
        rc_p = predict_cli.main(common + list(predict_flags) + [train, model, pred])
        out[name] = (rc, rc_p, model, pred)
    return out


@pytest.mark.parametrize("n_classes,flags", [
    (2, []), (3, []), (3, ["--classification", "oao"])])
def test_cli_probability(n_classes, flags, tmp_path):
    """``--probability`` in train and predict: svm-predict's ``-b 1``
    layout (the labels header, each point's label and probabilities),
    within 1e-8 of plssvm_tpu's file, each row summing to 1."""
    X, y = _blobs(n_classes, seed=30 + n_classes)
    train = _write(tmp_path, X, y, "train")
    out = _both_clis(tmp_path, train, ["--probability", "-t", "2"] + flags,
                     ["--probability"])
    assert [out[k][:2] for k in "tj"] == [(0, 0), (0, 0)]
    t_lines, j_lines = (open(out[k][3]).read().splitlines() for k in "tj")
    assert t_lines[0] == j_lines[0] and t_lines[0].startswith("labels ")
    got = np.asarray([ln.split() for ln in t_lines[1:]], dtype=float)
    want = np.asarray([ln.split() for ln in j_lines[1:]], dtype=float)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got[:, 1:].sum(axis=1), 1.0, rtol=0, atol=1e-8)
    assert "probA" in open(out["t"][2]).read()


def test_cli_probability_regression(tmp_path, capsys):
    """``-s epsilon_svr --probability``: the lone probA line (the Laplace
    noise scale), the predict file's values and the noise line of
    ``--probability`` as plssvm_tpu prints them."""
    X, y = _friedman(seed=3)
    train = _write(tmp_path, X, y, "svr", regression=True)
    out = {}
    for name, (train_cli, predict_cli, where) in {
            "t": (t_train_cli, t_predict_cli, ["-p", "cpu"]),
            "j": (j_train_cli, j_predict_cli, ["-b", "xla"])}.items():
        model, pred = str(tmp_path / f"{name}.model"), str(tmp_path / f"{name}.predict")
        assert train_cli.main(where + ["-q", "--use_double_as_real_type", "-s", "epsilon_svr",
                                       "-c", "10", "--probability", "-e", str(EPS),
                                       train, model]) == 0
        capsys.readouterr()
        assert predict_cli.main(where + ["--verbosity", "libsvm", "--use_double_as_real_type",
                                         "--probability", train, model, pred]) == 0
        noise = [ln for ln in capsys.readouterr().out.splitlines() if "sigma=" in ln]
        out[name] = (model, np.loadtxt(pred), float(noise[0].split("sigma=")[1]))
    assert out["t"][2] == pytest.approx(out["j"][2], rel=1e-8)
    np.testing.assert_allclose(out["t"][1], out["j"][1], rtol=0, atol=1e-7)
    prob = [ln for ln in open(out["t"][0]) if ln.startswith(("probA", "probB"))]
    assert len(prob) == 1 and prob[0].startswith("probA")


def test_cli_probability_refusals(tmp_path, capsys):
    """Predict ``--probability`` with an uncalibrated model, and with
    ``--multihost``, exits 1 with plssvm_tpu's messages."""
    X, y = _blobs(2, seed=40)
    train = _write(tmp_path, X, y, "train")
    model = str(tmp_path / "plain.model")
    assert t_train_cli.main(["-p", "cpu", "-q", train, model]) == 0
    errors = []
    for cli, where in ((t_predict_cli, ["-p", "cpu"]), (j_predict_cli, ["-b", "xla"])):
        for extra in ([], ["--multihost"]):
            assert cli.main(where + ["-q", "--probability"] + extra
                            + [train, model, str(tmp_path / "out")]) == 1
            errors.append(capsys.readouterr().err.strip())
    assert errors[:2] == errors[2:]
    assert "does not support probability" in errors[0]


@pytest.mark.parametrize("flags", [[], ["--classification", "oao"], ["-s", "epsilon_svr"]])
def test_cli_cross_validation(flags, tmp_path, capsys):
    """``--cross_validation 4`` prints plssvm_tpu's line (the accuracy, or
    the MSE and squared correlation coefficient) and writes no model."""
    regression = "-s" in flags
    X, y = _friedman(seed=5) if regression else _blobs(3, seed=50)
    train = _write(tmp_path, X, y, "cv", regression=regression)
    lines = []
    for cli, where in ((t_train_cli, ["-p", "cpu"]), (j_train_cli, ["-b", "xla"])):
        model = str(tmp_path / "cv.model")
        assert cli.main(where + ["--verbosity", "libsvm", "--use_double_as_real_type",
                                 "-e", str(EPS), "--cross_validation", "4"] + flags
                        + [train, model]) == 0
        assert not os.path.exists(model)
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("Cross Validation")])
    got, want = lines
    assert len(got) == (2 if regression else 1)
    if regression:
        for g, w in zip(got, want):
            assert float(g.split("=")[1]) == pytest.approx(float(w.split("=")[1]), rel=1e-8)
    else:
        assert got == want


@pytest.mark.parametrize("flags,message", [
    (["--cross_validation", "1"], "n must >= 2"),
    (["--cross_validation", "3", "--probability"], "--probability"),
    (["--cross_validation", "3", "--checkpoint", "c.ckpt"], "--checkpoint"),
    (["--cross_validation", "3", "--multihost"], "--multihost"),
    (["--probability", "--multihost"], "--multihost"),
])
def test_cli_flag_conflicts(flags, message, tmp_path, capsys):
    """plssvm_tpu's refusals of ``--cross_validation`` and
    ``--probability`` combinations, with its messages."""
    X, y = _blobs(2, seed=60)
    train = _write(tmp_path, X, y, "train")
    errors = []
    for cli, where in ((t_train_cli, ["-p", "cpu"]), (j_train_cli, ["-b", "xla"])):
        assert cli.main(where + ["-q"] + flags + [train, str(tmp_path / "m")]) == 1
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert message in errors[0] and errors[0] == errors[1]
