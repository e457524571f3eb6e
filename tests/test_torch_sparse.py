"""Compact models of the port against plssvm_tpu's, on the CPU.

``plssvm_tpu_torch/sparse.py`` ports ``plssvm_tpu/sparse.py`` without its
multi-host fit: Suykens pruning (``pruned_fit``, ``pruned_fit_one_class``)
on the port's ``CSVM.fit`` / ``fit_one_class``, and the fixed-size Nystroem
fits (``nystroem_fit``, ``nystroem_fit_one_class``, and the windowed
``*_from_file`` fits) whose row-block reduction runs on the port's kernel
blocks.  Every case feeds the same seeded numpy inputs to both packages,
plssvm_tpu with ``CSVM(backend="xla", dtype=np.float64)``, at n <= 600, d
<= 16.  Tolerances:

- the host rules (landmark draws, the class floor, K_mm^{-1/2}) are exact:
  the same indices, and ``_kmm_inv_sqrt`` on the same matrix bit for bit;
- Nystroem fits on the same landmarks, float64: alpha within 1e-8 of its
  largest magnitude and rho within 1e-8 (absolute, |rho| <= 10 here) where
  cond(K_mm) < 1e6, which every case here keeps;
- pruned fits at epsilon 1e-10: the same kept indices and iterations,
  alpha within 1e-6 of its largest magnitude (CG stops at a residual of
  1e-10 of the right-hand side, which fixes alpha to about cond(K + I/C)
  times that; the LS-SVR case differs by 3e-8);
- model files: the same text up to the numbers of alpha and rho (the
  support vectors' features byte for byte), those within the tolerances
  above;
- the streamed fits against the in-memory fits on the same landmarks
  within 1e-10 (the row blocks sum in another order); in float32 their
  decision values within 1e-4 of the largest |f| (FLOAT32_STREAM_TOL: the
  float32 normal equations' sums in another order read 1.5e-6 at 600 x 10
  and 5e-6 to 7e-6 at 4000 x 50, m = 256, on a CPU; the card's
  ``chip_smoke.py`` compact phase holds its streamed fits to the same).
"""

import os

import jax
import numpy as np
import pytest

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu import sparse as j_sparse
from plssvm_tpu.cli import train as j_train_cli
from plssvm_tpu_torch import sparse as t_sparse
from plssvm_tpu_torch.cli import train as t_train_cli
from plssvm_tpu_torch.exceptions import InvalidParameterError
from plssvm_tpu_torch.native import loader as t_loader

EPS = 1e-10
TOL = 1e-8
PRUNED_TOL = 1e-6
FLOAT32_STREAM_TOL = 1e-4


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def _classes(n_classes, n=240, d=6, seed=0, kind="rbf"):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    X = rng.normal(size=(n, d)) + 1.5 * rng.normal(size=(n_classes, d))[y]
    if kind == "chi_squared":
        X = np.abs(X)
    if n_classes == 2:
        y = np.where(y == 1, 1, -1)
    return X, y


def _regression(n=200, d=4, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    return X, np.sin(X[:, 0]) + 0.1 * X[:, 1] + 0.05 * rng.normal(size=n)


def _data(pkg, X, y, regression=False):
    return pkg.DataSet(X, y, dtype=np.float64, regression=regression)


def _pair(devices=None, **kw):
    port = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64,
                                 devices=None if devices is None else ["cpu"] * devices, **kw)
    ref = plssvm_tpu.CSVM(backend="xla", dtype=np.float64,
                          devices=None if devices is None else jax.devices("cpu")[:devices],
                          **kw)
    return port, ref


def _assert_same_model(got, want, tol=TOL):
    alpha = np.asarray(want.alpha, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got.alpha, dtype=np.float64), alpha, rtol=0,
                               atol=tol * np.abs(alpha).max())
    np.testing.assert_allclose(np.asarray(got.rho, dtype=np.float64),
                               np.asarray(want.rho, dtype=np.float64), rtol=0, atol=tol)
    np.testing.assert_array_equal(got.support_vectors, want.support_vectors)
    assert got.is_regression == want.is_regression
    assert got.is_one_class == want.is_one_class
    assert got.n_iter == want.n_iter or got.n_iter == 0 == want.n_iter


def _model_lines(path):
    """(text lines without numbers of alpha and rho, those numbers)."""
    text, numbers = [], []
    for line in open(path).read().splitlines()[1:]:  # [0]: the time stamp
        if line.startswith("rho"):
            numbers += [float(v) for v in line.split()[1:]]
            text.append("rho")
        elif ":" in line:
            head, _, rest = line.partition(" ")
            while ":" not in head:
                numbers.append(float(head))
                head, _, rest = rest.partition(" ")
            text.append(head + " " + rest)
        else:
            text.append(line)
    return text, np.asarray(numbers)


def _assert_same_file(got_path, want_path, tol=TOL):
    got_text, got_numbers = _model_lines(got_path)
    want_text, want_numbers = _model_lines(want_path)
    assert got_text == want_text
    np.testing.assert_allclose(got_numbers, want_numbers, rtol=0,
                               atol=tol * max(1.0, np.abs(want_numbers).max()))


# ---------------------------------------------------------------------------
# host rules: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 3, 4, 5, 7, 30, 103])
@pytest.mark.parametrize("labels", ["none", "binary", "imbalanced", "strings"])
def test_landmarks_are_plssvm_tpus(labels, m):
    """``_stratified_landmarks`` draws plssvm_tpu's indices (exactly m,
    every class kept) from the same seed."""
    rng = np.random.default_rng(4)
    n = 103
    lab = {"none": None, "binary": rng.integers(0, 2, n),
           "imbalanced": np.concatenate([np.zeros(100, int), [1, 2, 3]]),
           "strings": np.asarray(["cat", "dog", "emu"])[rng.integers(0, 3, n)]}[labels]
    if lab is not None and m < np.unique(lab).size:
        for pkg in (t_sparse, j_sparse):
            with pytest.raises(pkg.InvalidParameterError, match="number of classes"):
                pkg._stratified_landmarks(lab, n, m, np.random.default_rng(9))
        return
    got = t_sparse._stratified_landmarks(lab, n, m, np.random.default_rng(9))
    want = j_sparse._stratified_landmarks(lab, n, m, np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (m,)
    if lab is not None:
        assert np.unique(lab[got]).size == np.unique(lab).size


@pytest.mark.parametrize("regression", [False, True])
def test_select_landmarks_is_plssvm_tpus(regression):
    X, y = _regression() if regression else _classes(3)
    got = t_sparse._select_landmarks(_data(plssvm_tpu_torch, X, y, regression), 17, 5)
    want = j_sparse._select_landmarks(_data(plssvm_tpu, X, y, regression), 17, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_classes", [False, True])
def test_keep_with_class_floor(seed, with_classes):
    rng = np.random.default_rng(seed)
    magnitude = rng.exponential(size=40)
    class_idx = rng.integers(0, 4, 40) if with_classes else None
    if with_classes:
        magnitude[class_idx == 3] *= 1e-6  # class 3 would drop out of a plain top-k
    for k in (4, 9, 39):
        got = t_sparse._keep_with_class_floor(magnitude, k, class_idx)
        want = j_sparse._keep_with_class_floor(magnitude, k, class_idx)
        np.testing.assert_array_equal(got, want)
        if with_classes:
            assert np.unique(class_idx[got]).size == np.unique(class_idx).size


@pytest.mark.parametrize("rcond", [1e-10, 1e-2])
def test_kmm_inv_sqrt(rcond):
    rng = np.random.default_rng(2)
    B = rng.normal(size=(12, 5))
    K = B @ B.T + 1e-3 * np.eye(12)  # rank 5 plus a small ridge
    np.testing.assert_array_equal(t_sparse._kmm_inv_sqrt(K, rcond),
                                  j_sparse._kmm_inv_sqrt(K, rcond))


# ---------------------------------------------------------------------------
# Nystroem fits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "polynomial", "rbf", "laplacian", "chi_squared"])
@pytest.mark.parametrize("task", ["binary", "oaa", "regression"])
def test_nystroem_fit(kind, task, tmp_path):
    """Same landmarks, the same model within TOL, and the same model file
    up to the last bits of alpha and rho; n = 240 in row blocks of 64."""
    if task == "regression":
        X, y = _regression()
        if kind == "chi_squared":
            X = np.abs(X)
    else:
        X, y = _classes(2 if task == "binary" else 3, kind=kind)
    regression = task == "regression"
    extra = dict(degree=2, coef0=1.0, gamma=0.2) if kind == "polynomial" else {}
    port, ref = _pair(kernel_type=kind, cost=2.0, **extra)
    got, got_idx = plssvm_tpu_torch.nystroem_fit(
        port, _data(plssvm_tpu_torch, X, y, regression), n_landmarks=30, random_state=1,
        row_block=64, return_indices=True)
    want, want_idx = plssvm_tpu.nystroem_fit(
        ref, _data(plssvm_tpu, X, y, regression), n_landmarks=30, random_state=1,
        row_block=64, return_indices=True)
    np.testing.assert_array_equal(got_idx, want_idx)
    _assert_same_model(got, want)
    assert str(got.classification) == str(want.classification)
    got.save(str(tmp_path / "got.model"))
    want.save(str(tmp_path / "want.model"))
    _assert_same_file(tmp_path / "got.model", tmp_path / "want.model")


def test_nystroem_weighted_and_explicit_landmarks():
    X, y = _classes(3, seed=3)
    s = np.random.default_rng(3).uniform(0.5, 2.0, X.shape[0])
    landmarks = np.arange(0, 240, 6)
    port, ref = _pair(kernel_type="rbf", cost=4.0, gamma=0.3)
    got = plssvm_tpu_torch.nystroem_fit(port, _data(plssvm_tpu_torch, X, y),
                                        landmarks=landmarks, sample_weight=s)
    want = plssvm_tpu.nystroem_fit(ref, _data(plssvm_tpu, X, y), landmarks=landmarks,
                                   sample_weight=s)
    _assert_same_model(got, want)
    np.testing.assert_allclose(port.predict_values(got, _data(plssvm_tpu_torch, X, y)),
                               ref.predict_values(want, _data(plssvm_tpu, X, y)),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("kind,shards", [("rbf", 4), ("laplacian", 3), ("polynomial", 8)])
def test_nystroem_sharded(kind, shards):
    """``devices`` reduces each shard's rows on its own device (here
    repeated CPU entries) and sums the partials: plssvm_tpu's sharded fit on
    as many CPU devices."""
    X, y = _classes(3, n=200, d=7, seed=30)
    s = np.random.default_rng(31).uniform(0.5, 2.0, 200)
    extra = dict(degree=2, coef0=1.0, gamma=0.3) if kind == "polynomial" else {}
    port, ref = _pair(devices=shards, kernel_type=kind, **extra)
    got = plssvm_tpu_torch.nystroem_fit(port, _data(plssvm_tpu_torch, X, y), n_landmarks=36,
                                        sample_weight=s, row_block=16)
    want = plssvm_tpu.nystroem_fit(ref, _data(plssvm_tpu, X, y), n_landmarks=36,
                                   sample_weight=s, row_block=16)
    _assert_same_model(got, want)
    single = plssvm_tpu_torch.nystroem_fit(
        plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type=kind, **extra),
        _data(plssvm_tpu_torch, X, y), n_landmarks=36, sample_weight=s, row_block=16)
    _assert_same_model(got, single, tol=1e-10)


def test_nystroem_counts_the_plain_blocks(monkeypatch):
    """The distance kinds build K_mm once and one block of K(X, Z) per row
    block through kernel N's wrappers' plain version on the CPU."""
    from plssvm_tpu_torch.ops import kernel_matrix

    X, y = _classes(2, n=200, kind="chi_squared")
    kernel_matrix.reset_counts()
    port = plssvm_tpu_torch.CSVM(device="cpu", backend="cuda", dtype=np.float64,
                                 kernel_type="chi_squared")
    plssvm_tpu_torch.nystroem_fit(port, _data(plssvm_tpu_torch, X, y), n_landmarks=20,
                                  row_block=64)
    assert kernel_matrix.plain_calls == 1 + 4
    assert kernel_matrix.sym_launches == kernel_matrix.rect_launches == 0


def test_nystroem_validation(tmp_path):
    X, y = _classes(2, n=30, d=3)
    svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64)
    ds = _data(plssvm_tpu_torch, X, y)
    for kwargs, match in (
        ({}, "n_landmarks or explicit"),
        (dict(n_landmarks=0), "must be in"),
        (dict(landmarks=[0, 99]), "within"),
        (dict(landmarks=[0, 0, 3]), "unique"),
        (dict(n_landmarks=8, sample_weight=np.zeros(30)), "must all be positive"),
        (dict(landmarks=np.flatnonzero(y == y[0])[:5]), "lost a class"),
    ):
        with pytest.raises(InvalidParameterError, match=match):
            plssvm_tpu_torch.nystroem_fit(svm, ds, **kwargs)
    with pytest.raises(InvalidParameterError, match="No labels"):
        plssvm_tpu_torch.nystroem_fit(svm, plssvm_tpu_torch.DataSet(X), n_landmarks=4)
    with pytest.raises(InvalidParameterError, match="non-negative"):
        plssvm_tpu_torch.nystroem_fit(
            plssvm_tpu_torch.CSVM(device="cpu", kernel_type="chi_squared"), ds, n_landmarks=4)
    # the multi-process fit (ROADMAP Queue 1 item 10) keeps the rules
    path = str(tmp_path / "train.libsvm")
    ds.save(path)
    for kwargs, match in ((dict(n_landmarks=0), "must be in"),
                          (dict(n_landmarks=8, sample_weight=np.zeros(30)),
                           "must all be positive")):
        with pytest.raises(InvalidParameterError, match=match):
            plssvm_tpu_torch.nystroem_fit_multihost(svm, path, **kwargs)


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task,kind", [("binary", "rbf"), ("oaa", "rbf"),
                                       ("regression", "rbf"), ("binary", "laplacian"),
                                       ("weighted", "polynomial")])
def test_pruned_fit(task, kind):
    """At epsilon 1e-10 every round keeps the same rows and the refits
    agree (each warm-started from the survivors' alpha)."""
    if task == "regression":
        # seed 2: plssvm_tpu's iterations on seeds 1 and 3 sit on the stop
        # threshold (18 or 20, 20 or 19 against the port)
        X, y = _regression(n=120, seed=2)
    else:
        X, y = _classes(4 if task == "oaa" else 2, n=120, seed=8)
    regression = task == "regression"
    s = np.random.default_rng(12).uniform(0.5, 2.0, X.shape[0]) if task == "weighted" else None
    extra = dict(degree=2, coef0=1.0, gamma=0.2) if kind == "polynomial" else {}
    port, ref = _pair(kernel_type=kind, cost=2.0, **extra)
    got, got_idx = plssvm_tpu_torch.pruned_fit(
        port, _data(plssvm_tpu_torch, X, y, regression), n_sv=50, epsilon=EPS,
        sample_weight=s, prune_rate=0.4, return_indices=True)
    want, want_idx = plssvm_tpu.pruned_fit(
        ref, _data(plssvm_tpu, X, y, regression), n_sv=50, epsilon=EPS, sample_weight=s,
        prune_rate=0.4, return_indices=True)
    np.testing.assert_array_equal(got_idx, want_idx)
    assert got.num_support_vectors == 50
    _assert_same_model(got, want, tol=PRUNED_TOL)


def test_pruned_fit_validation():
    X, y = _classes(2, n=30, d=3)
    svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64)
    ds = _data(plssvm_tpu_torch, X, y)
    for kwargs, match in ((dict(n_sv=0), "n_sv must be in"), (dict(n_sv=30), "n_sv must be in"),
                          (dict(n_sv=10, prune_rate=1.5), "prune_rate"),
                          (dict(n_sv=1), "number of classes")):
        with pytest.raises(InvalidParameterError, match=match):
            plssvm_tpu_torch.pruned_fit(svm, ds, **kwargs)
    # regression has no class floor
    model = plssvm_tpu_torch.pruned_fit(svm, _data(plssvm_tpu_torch, X, X @ np.ones(3), True),
                                        n_sv=1)
    assert model.num_support_vectors == 1


# ---------------------------------------------------------------------------
# one-class compact models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rbf", "laplacian"])
def test_one_class_compact(kind):
    # seed 9: on seeds 7 and 8 the RBF refit's count sits on the stop
    # threshold (one iteration apart, alpha within 4e-10)
    X = np.random.default_rng(9).normal(size=(120, 5))
    s = np.random.default_rng(8).uniform(0.5, 2.0, 120)
    port, ref = _pair(kernel_type=kind, gamma=0.2)
    got, got_idx = plssvm_tpu_torch.nystroem_fit_one_class(
        port, plssvm_tpu_torch.DataSet(X), n_landmarks=24, nu=0.1, random_state=3,
        sample_weight=s, row_block=48, return_indices=True)
    want, want_idx = plssvm_tpu.nystroem_fit_one_class(
        ref, plssvm_tpu.DataSet(X), n_landmarks=24, nu=0.1, random_state=3, sample_weight=s,
        row_block=48, return_indices=True)
    np.testing.assert_array_equal(got_idx, want_idx)
    _assert_same_model(got, want)
    got, got_idx = plssvm_tpu_torch.pruned_fit_one_class(
        port, plssvm_tpu_torch.DataSet(X), n_sv=40, nu=0.1, epsilon=EPS, prune_rate=0.5,
        return_indices=True)
    want, want_idx = plssvm_tpu.pruned_fit_one_class(
        ref, plssvm_tpu.DataSet(X), n_sv=40, nu=0.1, epsilon=EPS, prune_rate=0.5,
        return_indices=True)
    np.testing.assert_array_equal(got_idx, want_idx)
    _assert_same_model(got, want)
    with pytest.raises(InvalidParameterError, match="nu must be in"):
        plssvm_tpu_torch.nystroem_fit_one_class(port, plssvm_tpu_torch.DataSet(X),
                                                n_landmarks=4, nu=1.0)


# ---------------------------------------------------------------------------
# windowed file ingest
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(31)
    n, d = 600, 10
    lab = rng.integers(0, 3, n)
    X = 3.0 * rng.normal(size=(3, d))[lab] + rng.normal(size=(n, d))
    root = tmp_path_factory.mktemp("stream")
    paths = {}
    for name, rows, target in (("classes", n, lab), ("small", 120, lab),
                               ("regression", n, X @ rng.normal(size=d))):
        paths[name] = str(root / f"{name}.libsvm")
        plssvm_tpu_torch.DataSet(X[:rows], target[:rows],
                                 regression=name == "regression").save(paths[name])
    return paths


@pytest.mark.parametrize("regression", [False, True])
def test_streamed_fit(files, regression):
    """The windowed fit draws plssvm_tpu's landmarks from the file, equals
    the port's in-memory fit on them and plssvm_tpu's streamed fit."""
    path = files["regression" if regression else "classes"]
    port, ref = _pair(kernel_type="rbf", gamma=0.1, cost=10.0)
    got, idx = plssvm_tpu_torch.nystroem_fit_from_file(
        port, path, n_landmarks=48, regression=regression, random_state=2, row_block=128,
        return_indices=True)
    want, want_idx = plssvm_tpu.nystroem_fit_from_file(
        ref, path, n_landmarks=48, regression=regression, random_state=2, row_block=128,
        return_indices=True)
    np.testing.assert_array_equal(idx, want_idx)
    _assert_same_model(got, want)
    kw = dict(label_type=float, regression=True) if regression else {}
    in_memory = plssvm_tpu_torch.nystroem_fit(
        port, plssvm_tpu_torch.DataSet(path, dtype=np.float64, **kw), landmarks=idx)
    _assert_same_model(got, in_memory, tol=1e-10)


def test_streamed_one_class(files):
    port, ref = _pair(kernel_type="rbf", gamma=0.1)
    got, idx = plssvm_tpu_torch.nystroem_fit_one_class_from_file(
        port, files["classes"], n_landmarks=32, nu=0.05, row_block=100, return_indices=True)
    want, want_idx = plssvm_tpu.nystroem_fit_one_class_from_file(
        ref, files["classes"], n_landmarks=32, nu=0.05, row_block=100, return_indices=True)
    np.testing.assert_array_equal(idx, want_idx)
    _assert_same_model(got, want)
    X = plssvm_tpu_torch.DataSet(files["classes"], dtype=np.float64).data
    in_memory = plssvm_tpu_torch.nystroem_fit_one_class(
        port, plssvm_tpu_torch.DataSet(X), landmarks=idx, nu=0.05)
    _assert_same_model(got, in_memory, tol=1e-10)


@pytest.mark.parametrize("one_class", [False, True])
def test_streamed_fit_float32(files, one_class):
    """float32: the streamed fit's decision values against the in-memory
    fit's on the same landmarks within FLOAT32_STREAM_TOL of max|f|."""
    port = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float32, kernel_type="rbf", gamma=0.1)
    data = plssvm_tpu_torch.DataSet(files["classes"], dtype=np.float32)
    if one_class:
        got, idx = plssvm_tpu_torch.nystroem_fit_one_class_from_file(
            port, files["classes"], n_landmarks=64, nu=0.05, return_indices=True)
        want = plssvm_tpu_torch.nystroem_fit_one_class(
            port, plssvm_tpu_torch.DataSet(data.data), landmarks=idx, nu=0.05, row_block=200)
    else:
        got, idx = plssvm_tpu_torch.nystroem_fit_from_file(
            port, files["classes"], n_landmarks=64, return_indices=True)
        want = plssvm_tpu_torch.nystroem_fit(port, data, landmarks=idx, row_block=200)
    f_got = port.predict_values(got, data)
    f_want = port.predict_values(want, data)
    assert np.max(np.abs(f_got - f_want)) <= FLOAT32_STREAM_TOL * np.max(np.abs(f_want))


def test_streamed_fit_falls_back_without_the_parser(files, monkeypatch):
    """Without the native parser the in-memory fit runs on the same draw."""
    port = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="rbf")
    want, idx = plssvm_tpu_torch.nystroem_fit_from_file(
        port, files["classes"], n_landmarks=20, return_indices=True)
    monkeypatch.setattr(t_loader, "_lib", None)
    monkeypatch.setattr(t_loader, "_lib_failed", True)
    t_loader.reset_counts()
    got, got_idx = plssvm_tpu_torch.nystroem_fit_from_file(
        port, files["classes"], n_landmarks=20, return_indices=True)
    assert t_loader.native_parses == 0
    np.testing.assert_array_equal(got_idx, idx)
    _assert_same_model(got, want, tol=1e-10)


# ---------------------------------------------------------------------------
# calibration and cross-validation of compact models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compact,n_classes", [(dict(n_landmarks=24), 2),
                                               (dict(n_landmarks=24), 3),
                                               (dict(max_sv=40), 2)])
def test_compact_calibration(compact, n_classes):
    """``calibrate_model(fit_fn=compact_fold_fit_fn(...))``: every fold
    trains the compact model, and (A, B) are plssvm_tpu's within 1e-6
    relative."""
    X, y = _classes(n_classes, n=80, seed=5)
    port, ref = _pair(kernel_type="rbf", cost=2.0)
    models = []
    for pkg, svm in ((plssvm_tpu_torch, port), (plssvm_tpu, ref)):
        sparse = t_sparse if pkg is plssvm_tpu_torch else j_sparse
        data = _data(pkg, X, y)
        model = (pkg.nystroem_fit(svm, data, n_landmarks=24) if "n_landmarks" in compact
                 else pkg.pruned_fit(svm, data, n_sv=40, epsilon=EPS))
        pkg.calibrate_model(svm, model, data, epsilon=EPS, random_state=0,
                            fit_fn=sparse.compact_fold_fit_fn(svm, epsilon=EPS, **compact))
        models.append(model)
    got, want = models
    np.testing.assert_allclose(got.prob_a, want.prob_a, rtol=1e-6)
    np.testing.assert_allclose(got.prob_b, want.prob_b, rtol=1e-6, atol=1e-9)


def test_compact_cross_validation_and_tiny_folds():
    X, y = _classes(2, n=120, seed=6)
    port, ref = _pair(kernel_type="rbf")
    got = plssvm_tpu_torch.cross_validate(
        port, _data(plssvm_tpu_torch, X, y), n_folds=3,
        fit_fn=t_sparse.compact_fold_fit_fn(port, n_landmarks=16, random_state=0))
    want = plssvm_tpu.probability.cross_validate(
        ref, _data(plssvm_tpu, X, y), n_folds=3,
        fit_fn=j_sparse.compact_fold_fit_fn(ref, n_landmarks=16, random_state=0))
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    # a fold of one point a class cannot be pruned: the exact fold fit
    rows = [np.flatnonzero(y == -1)[0], np.flatnonzero(y == 1)[0]]
    fit_fn = t_sparse.compact_fold_fit_fn(port, max_sv=4, epsilon=EPS)
    model = fit_fn(_data(plssvm_tpu_torch, X[rows], y[rows]), None)
    assert model.num_support_vectors == 2 and model.n_iter >= 1


# ---------------------------------------------------------------------------
# plssvm-torch-train --max_sv / --nystroem / --streaming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--max_sv", "60", "-e", "1e-10"], ["--nystroem", "32"], ["--nystroem", "32", "--streaming"],
    ["-s", "one_class", "--nystroem", "32"], ["-s", "one_class", "--nystroem", "32", "--streaming"],
    ["-s", "one_class", "--max_sv", "60", "-e", "1e-10"], ["-s", "epsilon_svr", "--nystroem", "24"],
])
def test_cli(files, flags, tmp_path):
    """The model file of each compact flag equals plssvm_tpu's CLI's up to
    the last bits of alpha and rho (float64, the RBF kernel)."""
    path = files["regression" if "epsilon_svr" in flags
                 else "small" if "--max_sv" in flags else "classes"]
    common = ["-t", "2", "-g", "0.1", "--use_double_as_real_type", "-q"]
    got, want = str(tmp_path / "got.model"), str(tmp_path / "want.model")
    assert t_train_cli.main(flags + common + ["-p", "cpu", path, got]) == 0
    assert j_train_cli.main(flags + common + ["-b", "xla", path, want]) == 0
    _assert_same_file(got, want)


@pytest.mark.parametrize("flags,message", [
    (["--max_sv", "8", "--nystroem", "8"], "mutually exclusive"),
    (["--max_sv", "8", "--classification", "oao"], "one-vs-all"),
    (["--nystroem", "0"], "at least 1"),
    (["--max_sv", "8", "--checkpoint", "ckpt"], "--max_sv is not supported together with --checkpoint"),
    (["--nystroem", "8", "--warm_start", "w.model"], "--nystroem is not supported together with --warm_start"),
    (["--max_sv", "8", "--multihost"], "--max_sv is not supported together with --multihost"),
    (["-s", "one_class", "--nystroem", "8", "--multihost"],
     "--nystroem is not supported together with --multihost"),
    (["--streaming"], "--streaming requires --nystroem"),
    (["--nystroem", "8", "--streaming", "--probability"], "--streaming is not supported together with --probability"),
    (["--nystroem", "8", "--streaming", "--weight", "1=2"], "--streaming is not supported together with --weight"),
    (["--nystroem", "8", "--streaming", "--cross_validation", "3"],
     "--streaming is not supported together with --cross_validation"),
    (["--nystroem", "8", "--streaming", "--multihost"], "--streaming is not supported together with --multihost"),
    (["--max_sv", "2"], "must be at least the number of classes (3)"),
])
def test_cli_conflicts(files, flags, message, tmp_path, capsys):
    """plssvm_tpu's messages, in its order; no model is written."""
    model = str(tmp_path / "x.model")
    for main, where in ((t_train_cli.main, ["-p", "cpu"]), (j_train_cli.main, ["-b", "xla"])):
        assert main(flags + where + ["-q", files["classes"], model]) == 1
        assert message in capsys.readouterr().err
        assert not os.path.exists(model)


def test_cli_nystroem_multihost_is_not_ported(files, tmp_path, capsys):
    """--nystroem composes with --multihost (ROADMAP Queue 1 item 10,
    ``nystroem_fit_multihost``), as in plssvm_tpu: at one process the model
    file equals plssvm_tpu's CLI's up to the last bits of alpha and rho."""
    common = ["--nystroem", "8", "--multihost", "-t", "2", "-g", "0.1",
              "--use_double_as_real_type", "-q"]
    got, want = str(tmp_path / "got.model"), str(tmp_path / "want.model")
    assert t_train_cli.main(common + ["-p", "cpu", files["classes"], got]) == 0
    assert j_train_cli.main(common + ["-b", "xla", files["classes"], want]) == 0
    assert "total_sv 8" in open(got).read()
    _assert_same_file(got, want)


@pytest.mark.parametrize("flags", [["--max_sv", "90"], ["--nystroem", "24"]])
def test_cli_compact_probability_and_cross_validation(files, flags, tmp_path, capsys):
    """--probability and --cross_validation fold with the compact fit: the
    header's probA / probB and the CV accuracy are plssvm_tpu's."""
    common = ["-t", "2", "-g", "0.1", "--use_double_as_real_type", "-e", "1e-10"]
    got, want = str(tmp_path / "got.model"), str(tmp_path / "want.model")
    assert t_train_cli.main(flags + common + ["--probability", "-q", "-p", "cpu",
                                              files["small"], got]) == 0
    assert j_train_cli.main(flags + common + ["--probability", "-q", "-b", "xla",
                                              files["small"], want]) == 0
    probs = []
    for path in (got, want):
        lines = {ln.split()[0]: ln.split()[1:] for ln in open(path) if ln.startswith("prob")}
        probs.append(np.asarray(lines["probA"] + lines["probB"], dtype=np.float64))
    np.testing.assert_allclose(probs[0], probs[1], rtol=1e-6, atol=1e-9)
    capsys.readouterr()
    accuracy = []
    for main, where in ((t_train_cli.main, ["-p", "cpu"]), (j_train_cli.main, ["-b", "xla"])):
        assert main(flags + common + ["--cross_validation", "3", "--verbosity", "libsvm"]
                    + where + [files["small"]]) == 0
        accuracy.append([ln for ln in capsys.readouterr().out.splitlines()
                         if "Cross Validation Accuracy" in ln])
    assert accuracy[0] == accuracy[1] and len(accuracy[0]) == 1
