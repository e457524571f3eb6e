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
        """One-vs-all and one-vs-one multiclass are ported (ROADMAP Queue 1,
        item 6): ``classification="oao"`` fits plssvm_tpu's one-vs-one model
        (tests/test_torch_oao.py holds every strategy and layout)."""
        data = self._data(3)
        labels = np.asarray(data.labels)
        got = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64).fit(
            data, classification="oao", epsilon=EPS)
        want = plssvm_tpu.CSVM(backend="xla", dtype=np.float64).fit(
            plssvm_tpu.DataSet(np.asarray(data.data), labels), classification="oao",
            epsilon=EPS)
        assert got.classification == plssvm_tpu_torch.ClassificationType.OAO
        assert np.asarray(got.alpha).shape == (30, 2)
        np.testing.assert_allclose(np.asarray(got.rho), np.asarray(want.rho), rtol=0, atol=TOL)
        np.testing.assert_allclose(np.asarray(got.alpha), np.asarray(want.alpha), rtol=0,
                                   atol=TOL)

    @pytest.mark.parametrize("kernel", ["laplacian", "chi_squared"])
    def test_distance_kernels(self, kernel):
        """The distance kernels are ported (ROADMAP Queue 1, item 5): fit
        returns plssvm_tpu's model."""
        data = self._data()
        X = np.abs(data.data)  # chi-squared's domain
        labels = np.asarray(data.labels)
        t_svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type=kernel,
                                      solver="cg_implicit")
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
        ],
    )
    def test_options(self, kwargs, item):
        """The explicit solver, item 3, and the Jacobi preconditioner, item
        4's option, are ported: each fits as plssvm_tpu's does (with
        ``solver="cg_explicit"`` on both sides for item 3;
        tests/test_torch_explicit.py and tests/test_torch_solver_extras.py
        hold every layout)."""
        got, want = self._fit_both(kwargs, {})
        assert got.n_iter == want.n_iter
        np.testing.assert_allclose(got.alpha, want.alpha, rtol=0, atol=TOL)

    def test_gram_precision_bf16(self):
        """gram_precision="bf16" is ported (ROADMAP Queue 2 row a): on CPU
        tensors the cuda backend's wrappers take the plain versions at the
        bf16 tier, in training and predict, and the model predicts the f32
        model's labels."""
        from plssvm_tpu_torch.ops import matvec

        Xtr, ytr, Xte, yte = blobs(seed=4)
        train = plssvm_tpu_torch.DataSet(Xtr, ytr, scaling=(-1.0, 1.0))
        test = plssvm_tpu_torch.DataSet(Xte, yte, scaling=train.scaling_factors)
        models = {}
        for tier in ("f32", "bf16"):
            svm = plssvm_tpu_torch.CSVM(backend="cuda", device="cpu", gram_precision=tier,
                                        kernel_type="rbf", cost=1.0)
            models[tier] = (svm, svm.fit(train, epsilon=1e-6))
        svm, model = models["bf16"]
        assert svm.gram_precision == "bf16"
        assert model.rho != models["f32"][1].rho
        sv = torch.as_tensor(model.support_vectors, dtype=torch.float32)
        P = torch.as_tensor(np.asarray(test.data), dtype=torch.float32)
        want = matvec.kernel_matvec_rect_plain(
            P, sv, (P * P).sum(-1), (sv * sv).sum(-1),
            torch.as_tensor(model.alpha, dtype=torch.float32),
            kind=plssvm_tpu_torch.KernelFunctionType.RBF, gamma=0.1, coef0=0.0,
            degree=3, precision="bf16",
        ).numpy() - model.rho
        np.testing.assert_allclose(svm.predict_values(model, test), want, rtol=0, atol=1e-5)
        f32_svm, f32_model = models["f32"]
        agree = np.mean(svm.predict(model, test) == f32_svm.predict(f32_model, test))
        assert agree >= 0.95

    def _fit_both(self, svm_kwargs, fit_kwargs):
        """The port's and plssvm_tpu's fits of ``blobs(seed=4)`` scaled to
        [-1, 1] (float64, epsilon 1e-10; a set where plssvm_tpu's iteration
        counts agree across its row blocks for each extra);
        ``initial_model="warm"`` warm-starts each from its own 1e-4 fit."""
        X, labels, _, _ = blobs(seed=4)
        models = []
        for package, where in ((plssvm_tpu_torch, dict(device="cpu", solver="cg_implicit")),
                               (plssvm_tpu, dict(backend="xla", solver="cg_implicit"))):
            svm = package.CSVM(dtype=np.float64, kernel_type="rbf",
                               **{**where, **svm_kwargs})
            train = package.DataSet(X, labels, scaling=(-1.0, 1.0))
            kw = dict(fit_kwargs)
            if kw.get("initial_model") == "warm":
                kw["initial_model"] = svm.fit(train, epsilon=1e-4)
            models.append(svm.fit(train, epsilon=EPS, **kw))
        return models

    @pytest.mark.parametrize("fit_kwargs", [dict(sample_weight=np.random.default_rng(5).uniform(0.5, 2.0, 200)),
                                            dict(initial_model="warm")])
    def test_fit_extras(self, fit_kwargs):
        """Item 4's fit arguments are ported: the fit matches plssvm_tpu's."""
        got, want = self._fit_both({}, fit_kwargs)
        assert got.n_iter == want.n_iter
        assert abs(got.rho - want.rho) <= TOL
        np.testing.assert_allclose(got.alpha, want.alpha, rtol=0, atol=TOL)

    def test_automatic_solver_is_implicit(self):
        """``automatic`` resolves per fit: a Gram kernel at few features
        takes the implicit solver on the CPU, as plssvm_tpu's XLA backend
        does, and the CSVM keeps the caller's choice."""
        svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="rbf")
        assert svm.solver == "automatic"
        plssvm_tpu_torch.global_tracker.clear()
        svm.fit(self._data(), epsilon=1e-3)
        assert ("solver", "cg_implicit") in plssvm_tpu_torch.global_tracker.entries()["cg"]

    @pytest.mark.parametrize(
        "flags",
        [["--multihost"], ["--nystroem", "5", "--multihost"], ["--profile", "trace"]],
    )
    def test_cli_rejects(self, flags, tmp_path, capsys):
        """No flag is refused any more: ``--profile DIR`` (ROADMAP item 11)
        writes a torch.profiler trace of the fit, a Chrome trace JSON with
        events, and the model the run without it writes, byte for byte
        below the header's creation-time comment;
        ``--multihost`` (item 10), also with ``--nystroem``, trains the file
        in a single process (the ring of processes:
        tests/test_torch_multiprocess.py) and writes the model the run
        without ``--multihost`` writes."""
        import json

        train_file = os.path.join(tmp_path, "train.libsvm")
        self._data().save(train_file)
        model = os.path.join(tmp_path, "out.model")
        if "--multihost" not in flags:
            trace_dir = os.path.join(tmp_path, "trace")
            flags = [trace_dir if f == "trace" else f for f in flags]
            assert t_train_cli.main(flags + ["-p", "cpu", "-q", train_file, model]) == 0
            assert "not ported" not in capsys.readouterr().err
            (trace,) = os.listdir(trace_dir)
            assert trace.endswith(".pt.trace.json")
            with open(os.path.join(trace_dir, trace), encoding="utf-8") as f:
                events = json.load(f)["traceEvents"]
            assert any(e.get("ph") == "X" for e in events)
            alone = os.path.join(tmp_path, "alone.model")
            assert t_train_cli.main(["-p", "cpu", "-q", train_file, alone]) == 0
            with open(model, "rb") as a, open(alone, "rb") as b:
                assert a.readline().startswith(b"# This model file has been created at")
                b.readline()
                assert a.read() == b.read()
            return
        assert t_train_cli.main(flags + ["-p", "cpu", "-q", train_file, model]) == 0
        alone = os.path.join(tmp_path, "alone.model")
        rest = [f for f in flags if f != "--multihost"]
        assert t_train_cli.main(rest + ["-p", "cpu", "-q", train_file, alone]) == 0
        got, want = plssvm_tpu_torch.Model.load(model), plssvm_tpu_torch.Model.load(alone)
        assert got.num_support_vectors == want.num_support_vectors
        np.testing.assert_allclose(got.alpha, want.alpha, rtol=0,
                                   atol=1e-4 * np.max(np.abs(want.alpha)))

    @pytest.mark.parametrize("flags,header", [
        (["--classification", "oao"], "nr_class 3"),
        (["-s", "epsilon_svr"], "svm_type epsilon_svr"),
        (["-s", "one_class"], "svm_type one_class"),
        (["--probability"], "probA"),
        (["--cross_validation", "3"], None),
        (["--max_sv", "5"], "total_sv 5"),
        (["--nystroem", "5"], "total_sv 5"),
        (["--nystroem", "5", "--streaming"], "total_sv 5"),
    ])
    def test_cli_ported(self, flags, header, tmp_path):
        """``--classification oao`` (item 6), ``-s epsilon_svr``, ``-s
        one_class``, ``--probability`` and ``--cross_validation`` (item 7),
        ``--max_sv``, ``--nystroem`` and ``--streaming`` (item 9) are
        ported: the CLI writes the model, or for cross-validation none
        (tests/test_torch_oao.py, test_torch_regression.py,
        test_torch_one_class.py, test_torch_probability.py and
        test_torch_sparse.py hold them against plssvm_tpu's CLI)."""
        train_file = os.path.join(tmp_path, "train.libsvm")
        self._data(3).save(train_file)
        model = os.path.join(tmp_path, "out.model")
        assert t_train_cli.main(flags + ["-p", "cpu", "-q", train_file, model]) == 0
        if header is None:
            assert not os.path.exists(model)
        else:
            assert header in open(model).read()


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
