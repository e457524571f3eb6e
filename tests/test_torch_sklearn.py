"""The sklearn facades of the port (SVC, SVR, OneClassSVM) against
plssvm_tpu's, on the CPU.

``plssvm_tpu_torch/sklearn.py`` is plssvm_tpu/sklearn.py over the port's
CSVM, with one more parameter, ``device`` (here always ``"cpu"``).  Each
estimator is fitted on the same seeded numpy data as plssvm_tpu's (200 x
8 blobs unless a test says otherwise; plssvm_tpu's facade runs its XLA
backend on the CPU, float64 both).  Tolerances: at ``tol=1e-10`` decision
values, ``dual_coef_`` and ``intercept_`` within 1e-5 (absolute, values of
order 1): the CG solve stops at a residual of 1e-10 of the right-hand side,
and on these sets two float64 solves' decision values differ by up to
3e-6 (the polynomial kernel, whose counts sit 0-6 iterations apart, so
``n_iter_`` is compared only for the direct solves, where it is 0; the
CSVM-level tests hold the counts on seed tables); the Nystroem fits, a
direct solve, within 1e-8; predictions, ``support_`` and the class
attributes equal; probA_ / probB_ within 1e-6 relative (the Platt
fit's own stop rule); ``ovr_from_ovo`` bit for bit.  The parameter plumbing (names, defaults,
error messages) is held to plssvm_tpu's exactly.  Tests that need sklearn
itself (``clone``, ``GridSearchCV``) skip where it is missing, as on the
card's machine; the facade never imports it.
"""

import numpy as np
import pytest
import torch

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu import oao as j_oao
from plssvm_tpu_torch import oao as t_oao
from plssvm_tpu_torch.sklearn import SVC, SVR, OneClassSVM

from conftest import make_blobs

TOL = 1e-5
DIRECT_TOL = 1e-8
REL = 1e-6
FACADES = {"SVC": (SVC, plssvm_tpu.SVC), "SVR": (SVR, plssvm_tpu.SVR),
           "OneClassSVM": (OneClassSVM, plssvm_tpu.OneClassSVM)}


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


@pytest.fixture
def blobs():
    return make_blobs(200, 8, seed=7)


def _both(name, **kw):
    port, ref = FACADES[name]
    return port(device="cpu", **kw), ref(**kw)


def _fit_both(name, X, y=None, sample_weight=None, **kw):
    got, want = _both(name, **kw)
    args = (X,) if y is None else (X, y)
    got.fit(*args, sample_weight=sample_weight)
    want.fit(*args, sample_weight=sample_weight)
    return got, want


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=tol)


def _multiclass(n_classes=4, n=160, d=5, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    X = rng.normal(size=(n, d)) + 2.0 * rng.normal(size=(n_classes, d))[y]
    return X, y


# ---------------------------------------------------------------------------
# the parameter plumbing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FACADES))
def test_default_get_params(name):
    """plssvm_tpu's defaults plus ``device``."""
    got, want = _both(name)
    params = got.get_params()
    assert params.pop("device") == "cpu"
    assert params == want.get_params()


def test_constructor_param_mapping():
    clf = SVC(kernel="poly", degree=4, gamma=0.5, coef0=1.5, C=3.0, max_iter=100,
              device="cpu")
    params = clf.get_params()
    assert params["kernel"] == "poly"
    assert str(clf._svm.get_params().kernel_type.value) == "polynomial"
    assert (params["degree"], params["gamma"], params["coef0"], params["C"],
            params["max_iter"]) == (4, 0.5, 1.5, 3.0, 100)
    assert clf.set_params(C=5.0) is clf
    assert clf.get_params()["C"] == 5.0
    assert clf._svm.params.cost.value == 5.0


@pytest.mark.parametrize("name,param", [
    ("SVC", "shrinking"), ("SVC", "cache_size"), ("SVC", "break_ties"),
    ("SVR", "epsilon"), ("SVR", "nu"), ("SVR", "shrinking"), ("SVR", "cache_size"),
    ("OneClassSVM", "shrinking"), ("OneClassSVM", "cache_size"),
    ("SVC", "foobar"), ("SVR", "foobar"), ("OneClassSVM", "foobar"),
    ("SVC", "decision_function_shape"), ("SVC", "class_weight"),
])
def test_refused_params(name, param):
    """The same AttributeError, with the same message, as plssvm_tpu."""
    value = {"decision_function_shape": "bogus", "class_weight": "equal"}.get(param, 1)
    messages = []
    for cls, kw in zip(FACADES[name], ({"device": "cpu"}, {})):
        with pytest.raises(AttributeError) as info:
            cls(**{param: value}, **kw)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_device():
    """``device`` takes the CSVM to that device and keeps its parameters;
    None is CSVM's automatic, which raises where there is no CUDA device
    (never a silent CPU)."""
    clf = SVC(kernel="rbf", C=3.0, device="cpu")
    assert clf._svm.device == torch.device("cpu")
    svm = clf._svm
    clf.set_params(device="cpu")
    assert clf._svm is svm
    if not torch.cuda.is_available():
        with pytest.raises(plssvm_tpu_torch.UnsupportedBackendError, match="device='cpu'"):
            SVC()
        with pytest.raises(plssvm_tpu_torch.UnsupportedBackendError):
            clf.set_params(device=None)


def test_set_params_gamma_auto_and_scale_reset():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 4))
    y = np.where(X[:, 0] > 0, 1, -1)
    clf = SVC(gamma=2.5, device="cpu")
    clf.set_params(gamma="auto")
    clf.fit(X, y)
    assert clf._svm.params.resolved_gamma(4) == pytest.approx(0.25)
    clf2 = SVC(gamma="scale", device="cpu").fit(X, y)
    clf2.set_params(gamma="auto")
    clf2.fit(X, y)
    assert clf2._svm.params.resolved_gamma(4) == pytest.approx(0.25)


def test_clone_keeps_every_parameter():
    sklearn_base = pytest.importorskip("sklearn.base")
    clf = SVC(kernel="rbf", max_sv=16, device="cpu")
    cloned = sklearn_base.clone(clf)
    assert cloned.get_params() == clf.get_params()
    assert cloned._svm.device == torch.device("cpu")
    assert sklearn_base.clone(SVR(n_landmarks=12, device="cpu")).get_params()["n_landmarks"] == 12


# ---------------------------------------------------------------------------
# SVC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["linear", "rbf", "poly", "laplacian"])
def test_svc_against_plssvm_tpu(blobs, kernel):
    X, y = blobs
    got, want = _fit_both("SVC", X, y, kernel=kernel, C=2.0, tol=1e-10)
    _close(got.decision_function(X), want.decision_function(X))
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    assert got.score(X, y) == want.score(X, y) >= 0.9
    _close(got.dual_coef_, want.dual_coef_)
    _close(got.intercept_, want.intercept_)
    for attr in ("classes_", "support_", "n_support_", "class_weight_"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert (got.fit_status_, got.n_features_in_, got.shape_fit_) == (
        want.fit_status_, want.n_features_in_, want.shape_fit_)
    np.testing.assert_array_equal(got.support_vectors_, want.support_vectors_)
    if kernel == "linear":
        _close(got.coef_, want.coef_)
        _close(X @ got.coef_[0] + got.intercept_[0], got.decision_function(X))
    else:
        with pytest.raises(AttributeError, match="linear"):
            got.coef_


def test_svc_weights(blobs):
    """sample_weight and class_weight ("balanced", a dict) give
    plssvm_tpu's fits; weighted score is sklearn's weighted accuracy."""
    X, y = blobs
    keep = np.concatenate([np.flatnonzero(y == -1)[:20], np.flatnonzero(y == 1)])
    Xi, yi = X[keep], y[keep]
    sw = np.linspace(0.5, 2.0, len(yi))
    for kw in (dict(class_weight="balanced"), dict(class_weight={-1: 4.0, 1: 1.0}), {}):
        got, want = _fit_both("SVC", Xi, yi, sample_weight=sw, kernel="rbf", tol=1e-10, **kw)
        _close(got.dual_coef_, want.dual_coef_)
        _close(got.class_weight_, want.class_weight_, 0)
        assert got.score(Xi, yi, sample_weight=sw) == want.score(Xi, yi, sample_weight=sw)


def test_svc_zero_weights_keep_the_callers_rows():
    rng = np.random.default_rng(80)
    X = rng.normal(size=(40, 4))
    y = np.where(X[:, 0] > 0, 1, -1)
    sw = np.ones(40)
    sw[[0, 7, 20]] = 0.0
    for kw in ({}, dict(n_landmarks=10, random_state=0)):
        got, want = _fit_both("SVC", X, y, sample_weight=sw, kernel="rbf", C=2.0, **kw)
        np.testing.assert_array_equal(got.support_, want.support_)
        assert not {0, 7, 20} & set(got.support_)
        assert got.shape_fit_ == (40, 4)
        np.testing.assert_allclose(X[got.support_], got.support_vectors_)
    with pytest.raises(ValueError, match="zero weight"):
        SVC(device="cpu").fit(X, y, sample_weight=np.zeros(40))


def test_svc_not_fitted_and_without_probability(blobs):
    X, y = blobs
    clf = SVC(device="cpu")
    for call in (lambda: clf.predict(X), lambda: clf.score(X, y), lambda: clf.classes_):
        with pytest.raises(AttributeError, match="not fitted"):
            call()
    clf.fit(X, y)
    for call in (lambda: clf.predict_proba(X), lambda: clf.predict_log_proba(X)):
        with pytest.raises(AttributeError, match="probability"):
            call()
    for attr in ("probA_", "probB_"):
        with pytest.raises(AttributeError):
            getattr(clf, attr)
    with pytest.raises(AttributeError, match="one-vs-one"):
        SVC(decision_function_shape="ovo", device="cpu").fit(*_multiclass()).decision_function(X[:, :5])


def test_svc_string_labels_and_gamma_scale(blobs):
    X, _ = make_blobs(60, 4, seed=9)
    y = np.asarray(["cat"] * 30 + ["dog"] * 30, dtype=object)
    got, want = _fit_both("SVC", X, y, kernel="linear")
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    X, y = blobs
    got, want = _fit_both("SVC", X, y, kernel="rbf", gamma="scale", tol=1e-10)
    assert got.get_params()["gamma"] == "scale"
    assert got._svm.get_params().gamma.value == pytest.approx(1.0 / (X.shape[1] * X.var()))
    _close(got.dual_coef_, want.dual_coef_)


@pytest.mark.parametrize("classification,shape", [("oaa", "ovr"), ("oao", "ovr"),
                                                  ("oao", "ovo")])
def test_svc_multiclass(classification, shape):
    """One-vs-all and one-vs-one (batched on the CPU's plain pairs product)
    with both decision_function shapes; n_iter_ per machine."""
    X, y = _multiclass()
    got, want = _fit_both("SVC", X, y, kernel="rbf", tol=1e-10,
                          classification=classification, decision_function_shape=shape)
    _close(got.decision_function(X), want.decision_function(X))
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    assert np.shape(got.n_iter_) == np.shape(want.n_iter_)
    _close(got.dual_coef_, want.dual_coef_)


@pytest.mark.parametrize("n_classes,classification", [(2, "oaa"), (4, "oaa"), (4, "oao")])
def test_svc_probability(n_classes, classification):
    X, y = _multiclass(n_classes, n=120)
    if n_classes == 2:
        y = np.where(y == 1, 1, -1)
    got, want = _fit_both("SVC", X, y, kernel="rbf", tol=1e-10, probability=True,
                          random_state=0, classification=classification)
    np.testing.assert_allclose(got.probA_, want.probA_, rtol=REL)
    np.testing.assert_allclose(got.probB_, want.probB_, rtol=REL, atol=1e-9)
    proba = got.predict_proba(X)
    np.testing.assert_allclose(proba, want.predict_proba(X), rtol=0, atol=1e-6)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-9)
    np.testing.assert_allclose(got.predict_log_proba(X), np.log(proba))


@pytest.mark.parametrize("compact", [dict(max_sv=24), dict(n_landmarks=32, random_state=0)])
def test_svc_compact(blobs, compact):
    X, y = blobs
    got, want = _fit_both("SVC", X, y, kernel="rbf", C=2.0, tol=1e-10, **compact)
    assert got.support_vectors_.shape[0] == 24 if "max_sv" in compact else 32
    np.testing.assert_array_equal(got.support_, want.support_)
    np.testing.assert_allclose(X[got.support_], got.support_vectors_)
    _close(got.decision_function(X), want.decision_function(X))
    np.testing.assert_array_equal(got.n_support_, want.n_support_)
    if "n_landmarks" in compact:
        np.testing.assert_array_equal(got.n_iter_, [0])
        _close(got.decision_function(X), want.decision_function(X), DIRECT_TOL)
    assert got.score(X, y) >= 0.9


@pytest.mark.parametrize("compact", [dict(max_sv=40), dict(n_landmarks=32)])
def test_svc_compact_probability(compact):
    """probability=True calibrates on compact folds: plssvm_tpu's sigmoid."""
    X, y = make_blobs(120, 6, seed=7)
    got, want = _fit_both("SVC", X, y, kernel="rbf", C=2.0, tol=1e-10, probability=True,
                          random_state=0, **compact)
    np.testing.assert_allclose(got.probA_, want.probA_, rtol=REL)
    np.testing.assert_allclose(got.probB_, want.probB_, rtol=REL, atol=1e-9)


def test_svc_compact_tiny_folds_and_conflicts(blobs):
    rng = np.random.default_rng(81)
    X8 = rng.normal(size=(8, 3))
    y8 = np.array([1, -1, 1, -1, 1, -1, 1, -1])
    got, want = _fit_both("SVC", X8, y8, kernel="rbf", C=2.0, max_sv=4, probability=True)
    np.testing.assert_allclose(got.predict_proba(X8).sum(axis=1), 1.0, atol=1e-9)
    np.testing.assert_allclose(got.probA_, want.probA_, rtol=REL)
    X, y = blobs
    for kw, match in ((dict(max_sv=8, n_landmarks=8), "mutually exclusive"),
                      (dict(n_landmarks=8, classification="oao"), "compact-model")):
        with pytest.raises(AttributeError, match=match):
            SVC(device="cpu", **kw).fit(X, np.where(y > 0, y, 2 + (np.arange(len(y)) % 2)))


def test_gridsearchcv_sweeps_compact_sizes(blobs):
    model_selection = pytest.importorskip("sklearn.model_selection")
    X, y = blobs
    gs = model_selection.GridSearchCV(
        SVC(kernel="rbf", C=2.0, random_state=0, device="cpu"), {"n_landmarks": [8, 32]},
        cv=2, n_jobs=1)
    gs.fit(X, y)
    assert gs.best_score_ >= 0.85
    assert gs.best_params_["n_landmarks"] in (8, 32)


def test_ovr_from_ovo_is_plssvm_tpus():
    """Bit for bit, with exact zeros (sklearn's tie rule: 0 votes i)."""
    rng = np.random.default_rng(5)
    for C in (3, 4, 6):
        values = rng.normal(size=(50, C * (C - 1) // 2))
        values[rng.random(values.shape) < 0.2] = 0.0
        got = t_oao.ovr_from_ovo(values, C)
        np.testing.assert_array_equal(got, j_oao.ovr_from_ovo(values, C))
    np.testing.assert_array_equal(t_oao.ovr_from_ovo(np.zeros((1, 3)), 3)[0] >= [2, 1, 0],
                                  [True, True, True])


# ---------------------------------------------------------------------------
# SVR and OneClassSVM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compact", [{}, dict(max_sv=30), dict(n_landmarks=24, random_state=0)])
def test_svr(compact):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(120, 4))
    y = X @ rng.normal(size=4) + 0.05 * rng.normal(size=120)
    sw = rng.uniform(0.5, 2.0, 120)
    got, want = _fit_both("SVR", X, y, kernel="rbf", gamma=0.3, C=10.0, tol=1e-10, **compact)
    _close(got.predict(X), want.predict(X))
    assert got.score(X, y) == pytest.approx(want.score(X, y), abs=TOL)
    assert got.score(X, y, sample_weight=sw) == pytest.approx(
        want.score(X, y, sample_weight=sw), abs=TOL)
    np.testing.assert_array_equal(got.support_, want.support_)
    if "n_landmarks" in compact:
        np.testing.assert_array_equal(got.n_iter_, want.n_iter_)
        _close(got.predict(X), want.predict(X), DIRECT_TOL)
    _close(got.dual_coef_, want.dual_coef_)
    _close(got.intercept_, want.intercept_)
    assert got.score(X, y) >= 0.8
    with pytest.raises(AttributeError, match="linear"):
        got.coef_
    with pytest.raises(AttributeError, match="mutually exclusive"):
        SVR(max_sv=8, n_landmarks=8, device="cpu").fit(X, y)


@pytest.mark.parametrize("compact", [{}, dict(max_sv=40), dict(n_landmarks=24, random_state=1)])
def test_one_class_svm(compact):
    rng = np.random.default_rng(12)
    X = rng.normal(size=(150, 4))
    points = np.vstack([rng.normal(size=(20, 4)), 4.0 * rng.normal(size=(20, 4))])
    got, want = _fit_both("OneClassSVM", X, nu=0.1, tol=1e-10, **compact)
    _close(got.decision_function(points), want.decision_function(points))
    np.testing.assert_array_equal(got.predict(points), want.predict(points))
    _close(got.score_samples(points), want.score_samples(points))
    assert got.offset_ == pytest.approx(want.offset_, abs=TOL)
    np.testing.assert_array_equal(got.support_, want.support_)
    if "n_landmarks" in compact:
        assert got.n_iter_ == want.n_iter_ == 0
        _close(got.decision_function(points), want.decision_function(points), DIRECT_TOL)
    assert abs(np.mean(got.predict(X) == -1) - 0.1) <= 1.0 / 150
    np.testing.assert_array_equal(OneClassSVM(nu=0.1, device="cpu", **compact).fit_predict(X),
                                  got.predict(X))
