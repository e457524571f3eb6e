"""The port end to end against plssvm_tpu, in float64 on the CPU.

``fit`` -> ``save`` -> load -> ``predict`` / ``score`` against
``plssvm_tpu.CSVM(backend="xla", solver="cg_implicit", dtype=np.float64)``
on a seeded set scaled to [-1, 1], for RBF, polynomial and linear; the same
through both packages' CLIs; and ``model_from_numpy`` carrying a plssvm_tpu
model across.  Without a CUDA device, ``target="automatic"`` (the default)
and the CLIs without ``-p cpu`` refuse to run rather than take the CPU.  Tolerances: the same labels, rho within 1e-8, decision
values within 1e-8.

epsilon is 1e-10: a CG stopped early (epsilon 1e-3) lands on an iterate
that rounding noise moves by up to 1e-2 in rho on this set — a 1e-15
relative change of the inputs moves plssvm_tpu's own rho that far — so only
near-converged solves can be compared at 1e-8.
"""

import os

import numpy as np
import pytest
import torch

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu.cli import predict as j_predict_cli
from plssvm_tpu.cli import train as j_train_cli
from plssvm_tpu_torch.cli import predict as t_predict_cli
from plssvm_tpu_torch.cli import train as t_train_cli

EPS = 1e-10
TOL = 1e-8
KERNELS = ["rbf", "polynomial", "linear"]


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def blobs(seed=0, n=240, d=10, shift=0.4):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < 0.5, -1, 1)
    X = rng.normal(size=(n, d)) + shift * y[:, None]
    return X[:200], y[:200], X[200:], y[200:]


def _fit_both(kernel):
    Xtr, ytr, Xte, yte = blobs()
    j_train = plssvm_tpu.DataSet(Xtr, ytr, scaling=(-1.0, 1.0))
    t_train = plssvm_tpu_torch.DataSet(Xtr, ytr, scaling=(-1.0, 1.0))
    j_test = plssvm_tpu.DataSet(Xte, yte, scaling=j_train.scaling_factors)
    t_test = plssvm_tpu_torch.DataSet(Xte, yte, scaling=t_train.scaling_factors)
    j_svm = plssvm_tpu.CSVM(
        backend="xla", solver="cg_implicit", dtype=np.float64,
        kernel_type=kernel, cost=1.0,
    )
    t_svm = plssvm_tpu_torch.CSVM(
        backend="torch", device="cpu", dtype=np.float64, kernel_type=kernel,
        cost=1.0,
    )
    return (
        j_svm, j_svm.fit(j_train, epsilon=EPS), j_test,
        t_svm, t_svm.fit(t_train, epsilon=EPS), t_test,
    )


@pytest.mark.parametrize("kernel", KERNELS)
def test_fit_save_load_predict(kernel, tmp_path):
    j_svm, j_model, j_test, t_svm, t_model, t_test = _fit_both(kernel)
    assert t_model.n_iter == j_model.n_iter
    assert abs(t_model.rho - j_model.rho) <= TOL
    path = os.path.join(tmp_path, "port.model")
    t_model.save(path)
    loaded = plssvm_tpu_torch.Model.load(path)
    assert loaded.params.equivalent(t_model.params)
    np.testing.assert_allclose(
        t_svm.predict_values(loaded, t_test),
        j_svm.predict_values(j_model, j_test), rtol=0, atol=TOL,
    )
    np.testing.assert_array_equal(
        t_svm.predict(loaded, t_test), j_svm.predict(j_model, j_test)
    )
    assert t_svm.score(loaded, t_test) == j_svm.score(j_model, j_test)
    assert t_svm.score(t_model) == j_svm.score(j_model)


@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_backend_takes_the_plain_versions_on_cpu(kernel):
    """backend="cuda" on CPU tensors runs the wrappers' plain route and
    gives the torch backend's model exactly."""
    Xtr, ytr, Xte, yte = blobs(seed=1)
    train = plssvm_tpu_torch.DataSet(Xtr, ytr, scaling=(-1.0, 1.0))
    test = plssvm_tpu_torch.DataSet(Xte, yte, scaling=train.scaling_factors)
    kw = dict(dtype=np.float64, device="cpu", kernel_type=kernel)
    cuda_svm = plssvm_tpu_torch.CSVM(backend="cuda", **kw)
    torch_svm = plssvm_tpu_torch.CSVM(backend="torch", **kw)
    a, b = cuda_svm.fit(train), torch_svm.fit(train)
    assert a.rho == b.rho and np.array_equal(a.alpha, b.alpha)
    assert np.array_equal(cuda_svm.predict_values(a, test), torch_svm.predict_values(b, test))


def test_model_from_numpy_predicts_like_the_reference():
    j_svm, j_model, j_test, t_svm, _, t_test = _fit_both("rbf")
    carried = plssvm_tpu_torch.model_from_numpy(
        j_model.params, j_model.support_vectors, j_model.alpha, j_model.rho,
        j_model.data.labels,
    )
    np.testing.assert_allclose(
        t_svm.predict_values(carried, t_test),
        j_svm.predict_values(j_model, j_test), rtol=0, atol=TOL,
    )
    np.testing.assert_array_equal(
        t_svm.predict(carried, t_test), j_svm.predict(j_model, j_test)
    )
    assert carried.params.gamma.value == j_model.params.gamma.value
    assert not carried.params.gamma.is_default()


@pytest.mark.parametrize("kernel_flag", ["2", "1", "0"])
def test_cli_train_predict_against_reference(kernel_flag, tmp_path):
    Xtr, ytr, Xte, yte = blobs(seed=2)
    train_file = os.path.join(tmp_path, "train.libsvm")
    test_file = os.path.join(tmp_path, "test.libsvm")
    plssvm_tpu_torch.DataSet(Xtr, ytr, scaling=(-1.0, 1.0)).save(train_file)
    plssvm_tpu_torch.DataSet(Xte, yte, scaling=(-1.0, 1.0)).save(test_file)
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
    assert abs(t_model.rho - j_model.rho) <= TOL
    np.testing.assert_allclose(t_model.alpha, j_model.alpha, rtol=0, atol=TOL)
    with open(files["j"][1]) as fj, open(files["t"][1]) as ft:
        assert ft.read() == fj.read()


class TestNotPorted:
    """What the port does not carry yet raises NotImplementedError naming
    the ROADMAP item, and never falls through to something else."""

    def _data(self, n_classes=2):
        rng = np.random.default_rng(3)
        X = rng.normal(size=(30, 4))
        return plssvm_tpu_torch.DataSet(X, np.arange(30) % n_classes)

    def test_multiclass_data(self):
        """One-vs-all multiclass is ported; one-vs-one training is not."""
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item 6"):
            plssvm_tpu_torch.CSVM(device="cpu").fit(self._data(3), classification="oao")

    @pytest.mark.parametrize("kernel", ["laplacian", "chi_squared"])
    def test_distance_kernels(self, kernel):
        """The distance kernels are ported (ROADMAP Queue 1, item 5): fit
        returns plssvm_tpu's model."""
        data = self._data()
        X = np.abs(data.data)  # chi-squared's domain
        labels = np.asarray(data.labels)
        t_svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type=kernel)
        j_svm = plssvm_tpu.CSVM(
            backend="xla", solver="cg_implicit", dtype=np.float64, kernel_type=kernel,
        )
        got = t_svm.fit(plssvm_tpu_torch.DataSet(X, labels), epsilon=EPS)
        want = j_svm.fit(plssvm_tpu.DataSet(X, labels), epsilon=EPS)
        assert got.n_iter == want.n_iter
        assert abs(got.rho - want.rho) <= TOL
        np.testing.assert_allclose(got.alpha, want.alpha, rtol=0, atol=TOL)

    @pytest.mark.parametrize(
        "kwargs,item",
        [
            (dict(solver="cg_explicit"), "item 3"),
            (dict(preconditioner="jacobi"), "item 4"),
            (dict(backend="cuda", gram_precision="bf16"), "Queue 4"),
        ],
    )
    def test_options(self, kwargs, item):
        with pytest.raises(NotImplementedError, match=item):
            plssvm_tpu_torch.CSVM(device="cpu", **kwargs)

    @pytest.mark.parametrize("fit_kwargs", [dict(sample_weight=np.ones(30)), dict(initial_model="m")])
    def test_fit_extras(self, fit_kwargs):
        with pytest.raises(NotImplementedError, match="item 4"):
            plssvm_tpu_torch.CSVM(device="cpu").fit(self._data(), **fit_kwargs)

    def test_automatic_solver_is_implicit(self):
        assert plssvm_tpu_torch.CSVM(device="cpu").solver == "cg_implicit"

    @pytest.mark.parametrize(
        "flags",
        [["--multihost"], ["--cross_validation", "3"], ["--classification", "oao"],
         ["--nystroem", "5"], ["--max_sv", "5"], ["--checkpoint", "c.ckpt"],
         ["--warm_start", "m.model"], ["--debug"], ["-s", "epsilon_svr"]],
    )
    def test_cli_rejects(self, flags, tmp_path, capsys):
        train_file = os.path.join(tmp_path, "train.libsvm")
        self._data().save(train_file)
        model = os.path.join(tmp_path, "out.model")
        assert t_train_cli.main(flags + ["-q", train_file, model]) == 1
        assert "not ported yet (ROADMAP" in capsys.readouterr().err
        assert not os.path.exists(model)


class TestAutomaticNeverMeansTheCpu:
    """Without a CUDA device, ``automatic`` raises instead of running on the
    CPU; the CPU runs only when asked for (target / device "cpu", -p cpu).
    CUDA is made absent here, whatever the machine has."""

    @pytest.fixture(autouse=True)
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    @pytest.mark.parametrize("kwargs", [{}, dict(target="automatic"),
                                        dict(backend="torch"), dict(target="gpu")])
    def test_csvm_refuses(self, kwargs):
        with pytest.raises(plssvm_tpu_torch.UnsupportedBackendError,
                           match="target='cpu' or device='cpu' \\(CLI: -p cpu\\)"):
            plssvm_tpu_torch.CSVM(**kwargs)

    @pytest.mark.parametrize("kwargs", [dict(target="cpu"), dict(device="cpu"),
                                        dict(target="automatic", device="cpu")])
    def test_csvm_on_the_cpu_when_asked(self, kwargs):
        svm = plssvm_tpu_torch.CSVM(**kwargs)
        assert svm.device == torch.device("cpu")
        assert str(svm.backend) == "torch"

    @pytest.mark.parametrize("where", [[], ["-p", "automatic"], ["-p", "cpu"]])
    def test_clis(self, where, tmp_path, capsys):
        Xtr, ytr, Xte, yte = blobs(seed=4)
        train_file = os.path.join(tmp_path, "train.libsvm")
        test_file = os.path.join(tmp_path, "test.libsvm")
        plssvm_tpu_torch.DataSet(Xtr, ytr).save(train_file)
        plssvm_tpu_torch.DataSet(Xte, yte).save(test_file)
        model = os.path.join(tmp_path, "port.model")
        out = os.path.join(tmp_path, "port.predict")
        rc = t_train_cli.main(["-q", *where, train_file, model])
        if where != ["-p", "cpu"]:
            assert rc == 1 and not os.path.exists(model)
            assert "CUDA is not available" in capsys.readouterr().err
            # a model file from elsewhere: predict refuses the same way
            plssvm_tpu_torch.CSVM(device="cpu").fit(
                plssvm_tpu_torch.DataSet(train_file)).save(model)
        else:
            assert rc == 0
        rc = t_predict_cli.main(["-q", *where, test_file, model, out])
        if where != ["-p", "cpu"]:
            assert rc == 1 and not os.path.exists(out)
            assert "-p cpu" in capsys.readouterr().err
        else:
            assert rc == 0 and os.path.getsize(out) > 0
