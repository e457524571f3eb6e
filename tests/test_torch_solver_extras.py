"""The solver extras of the port against plssvm_tpu's, on the CPU.

Warm start (``initial_model``), sample weights, the Jacobi preconditioner,
CG-state checkpoint/resume and the ``debug`` guards, for binary and
one-vs-all fits, on one device and on the ring of four CPU shards
(``devices=["cpu"] * 4``), each held against
``plssvm_tpu.CSVM(backend="xla", solver="cg_implicit")`` on one device, on
the same seeded set scaled to [-1, 1].  Tolerances as in
tests/test_torch_cg.py:

- float64 at epsilon 1e-10: the same iteration count, alpha within 1e-8 of
  max|alpha|;
- float32 (compensated scalars) at epsilon 1e-6: iterations within 2,
  alpha within 1e-3 of max|alpha|.

From the start vector x = 1 the first CG residual is ~1e8 times the final
one, and plssvm_tpu's own iteration count moves by one with its row block
on some sets.  ``SEED`` gives, per class count, a set where plssvm_tpu's
counts agree across its row blocks and its ring for every extra, so the
comparison measures the port and not that noise.  The CLI flags (``--weight``, ``--warm_start``,
``--checkpoint``, ``--debug``) are held against plssvm_tpu's CLI, messages
included.
"""

import os

import numpy as np
import pytest
import torch

import plssvm_tpu
import plssvm_tpu_torch
import plssvm_tpu.solver.cg as jcg
import plssvm_tpu_torch.solver.cg as tcg
import plssvm_tpu_torch.solver.checkpoint as tckpt
from plssvm_tpu.cli import train as j_train_cli
from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu_torch.cli import train as t_train_cli
from plssvm_tpu_torch.exceptions import InvalidParameterError, NumericCheckError
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind

SEED = {2: 4, 3: 0}
#: the same for the CLIs' file, whose values are the set's rounded to the
#: writer's 11 significant digits
CLI_SEED = 6
TOLS = {np.float64: (1e-10, 0, 1e-8), np.float32: (1e-6, 2, 1e-3)}
LAYOUTS = [(2, None), (3, None), (2, 4), (3, 4)]
LAYOUT_IDS = ["binary", "oaa", "binary-ring", "oaa-ring"]
DTYPES = [np.float64, np.float32]


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def _data(n_classes, n=200, d=10, seed=None):
    rng = np.random.default_rng(SEED[n_classes] if seed is None else seed)
    if n_classes == 2:
        y = np.where(rng.random(n + 40) < 0.5, -1, 1)
        X = rng.normal(size=(n + 40, d)) + 0.4 * y[:, None]
    else:
        y = rng.integers(0, n_classes, n + 40)
        X = rng.normal(size=(n + 40, d)) + rng.normal(size=(n_classes, d))[y]
    return X[:n], y[:n]


def _pair(n_classes, shards, dtype, **kw):
    """(plssvm_tpu CSVM, its DataSet, port CSVM, its DataSet).  The port
    runs on ``shards`` CPU shards (None: one device); plssvm_tpu on one
    device, the function its ring computes too (its ring's counts agree on
    ``SEED``'s sets, and its compile would cost most of this file's time)."""
    X, y = _data(n_classes)
    t_where = dict(device="cpu") if shards is None else dict(devices=["cpu"] * shards)
    j_svm = plssvm_tpu.CSVM(backend="xla", solver="cg_implicit", dtype=dtype,
                            kernel_type="rbf", cost=1.0, **kw)
    t_svm = plssvm_tpu_torch.CSVM(backend="torch", dtype=dtype, kernel_type="rbf",
                                  cost=1.0, **t_where, **kw)
    return (j_svm, plssvm_tpu.DataSet(X, y, scaling=(-1.0, 1.0)),
            t_svm, plssvm_tpu_torch.DataSet(X, y, scaling=(-1.0, 1.0)))


def _assert_close(got, want, dtype):
    _, it_tol, alpha_tol = TOLS[dtype]
    assert abs(got.n_iter - want.n_iter) <= it_tol, (got.n_iter, want.n_iter)
    a = np.asarray(want.alpha, dtype=np.float64)
    scale = np.max(np.abs(a))
    np.testing.assert_allclose(np.asarray(got.alpha, dtype=np.float64), a,
                               rtol=0, atol=alpha_tol * scale)
    np.testing.assert_allclose(np.asarray(got.rho, dtype=np.float64),
                               np.asarray(want.rho, dtype=np.float64),
                               rtol=0, atol=alpha_tol * max(scale, 1.0))


def _weights(n=200):
    return np.random.default_rng(5).uniform(0.5, 2.0, n)


layouts = pytest.mark.parametrize("n_classes,shards", LAYOUTS, ids=LAYOUT_IDS)
dtypes = pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])


@layouts
@dtypes
def test_warm_start(n_classes, shards, dtype):
    """A warm fit from each package's own 1e-4 model to epsilon: the stop
    target anchored to the cold start, fewer iterations than cold."""
    eps = TOLS[dtype][0]
    j_svm, j_data, t_svm, t_data = _pair(n_classes, shards, dtype)
    got = t_svm.fit(t_data, epsilon=eps, initial_model=t_svm.fit(t_data, epsilon=1e-4))
    want = j_svm.fit(j_data, epsilon=eps, initial_model=j_svm.fit(j_data, epsilon=1e-4))
    _assert_close(got, want, dtype)
    assert got.n_iter < t_svm.fit(t_data, epsilon=eps).n_iter


@layouts
@dtypes
def test_sample_weight(n_classes, shards, dtype):
    eps = TOLS[dtype][0]
    j_svm, j_data, t_svm, t_data = _pair(n_classes, shards, dtype)
    got = t_svm.fit(t_data, epsilon=eps, sample_weight=_weights())
    want = j_svm.fit(j_data, epsilon=eps, sample_weight=_weights())
    _assert_close(got, want, dtype)


@layouts
@dtypes
def test_jacobi(n_classes, shards, dtype):
    eps = TOLS[dtype][0]
    j_svm, j_data, t_svm, t_data = _pair(n_classes, shards, dtype,
                                         preconditioner="jacobi")
    _assert_close(t_svm.fit(t_data, epsilon=eps), j_svm.fit(j_data, epsilon=eps), dtype)


class _Interrupted(Exception):
    pass


@layouts
@dtypes
def test_checkpoint_resume(n_classes, shards, dtype, tmp_path, monkeypatch):
    """A fit interrupted right after its save at iteration 8, then resumed
    from the file, equals the uninterrupted fit bit for bit, and both
    packages' checkpointed fits agree; the file goes when the fit ends."""
    eps = TOLS[dtype][0]
    j_svm, j_data, t_svm, t_data = _pair(n_classes, shards, dtype)
    plain = t_svm.fit(t_data, epsilon=eps)
    assert plain.n_iter > 8
    path = os.path.join(tmp_path, "cg.ckpt")
    name = "save_multi_checkpoint" if n_classes > 2 else "save_checkpoint"
    real_save = getattr(tckpt, name)
    saved = []

    def save_then_stop(p, ckpt):
        real_save(p, ckpt)
        saved.append(ckpt.iteration)
        if ckpt.iteration >= 8:
            raise _Interrupted

    monkeypatch.setattr(tckpt, name, save_then_stop)
    with pytest.raises(_Interrupted):
        t_svm.fit(t_data, epsilon=eps, checkpoint_path=path, checkpoint_interval=4)
    monkeypatch.undo()
    assert saved == [4, 8] and os.path.isfile(path)
    resumed = t_svm.fit(t_data, epsilon=eps, checkpoint_path=path, checkpoint_interval=4)
    assert not os.path.exists(path)
    assert resumed.n_iter == plain.n_iter
    np.testing.assert_array_equal(resumed.alpha, plain.alpha)
    np.testing.assert_array_equal(resumed.rho, plain.rho)
    want = j_svm.fit(j_data, epsilon=eps, checkpoint_path=os.path.join(tmp_path, "j.ckpt"),
                     checkpoint_interval=4)
    _assert_close(resumed, want, dtype)


def _nan_data(n_classes, module):
    X, y = _data(n_classes)
    X = X.copy()
    X[3, 1] = np.nan
    return module.DataSet(X, y)


@layouts
def test_debug_initial_residual(n_classes, shards):
    """A NaN feature: with debug the port raises plssvm_tpu's message;
    without, both packages stop at once, "converged"."""
    j_svm, _, t_svm, _ = _pair(n_classes, shards, np.float64, debug=True)
    with pytest.raises(Exception) as j_err:
        j_svm.fit(_nan_data(n_classes, plssvm_tpu))
    with pytest.raises(NumericCheckError) as t_err:
        t_svm.fit(_nan_data(n_classes, plssvm_tpu_torch))
    assert str(j_err.value) == f"{t_err.value} (`check` failed)"
    quiet_j, _, quiet_t, _ = _pair(n_classes, shards, np.float64)
    assert quiet_t.fit(_nan_data(n_classes, plssvm_tpu_torch)).n_iter == 0
    assert quiet_j.fit(_nan_data(n_classes, plssvm_tpu)).n_iter == 0


def _solver_inputs(n_classes):
    X, y = _data(n_classes)
    data = plssvm_tpu_torch.DataSet(X, y, scaling=(-1.0, 1.0))
    X = np.asarray(data.data)
    if n_classes > 2:
        Y = data.mapper.oaa_targets(data.labels).astype(np.float64)
    else:
        Y = np.asarray(data.y, dtype=np.float64)
    return X, Y


@pytest.mark.parametrize("n_classes", [2, 3], ids=["binary", "oaa"])
@pytest.mark.parametrize("poison", ["d", "x"])
def test_debug_in_the_loop(n_classes, poison):
    """A resumed state with a NaN in the search direction (the step size
    goes first) or in the iterate (the residual stays finite for one step
    only where the every-50th recompute is far): the port's message is
    plssvm_tpu's, iteration and d.Ad filled in."""
    import jax.numpy as jnp

    X, Y = _solver_inputs(n_classes)
    dept = X.shape[0] - 1
    rng = np.random.default_rng(1)
    x0, r0, d0 = (rng.normal(size=Y[:dept].shape) for _ in range(3))
    (d0 if poison == "d" else x0).flat[5] = np.nan
    delta = np.sum(r0 * r0, axis=0)
    multi = n_classes > 2
    args = (X[:dept], X[-1], Y[:dept], Y[-1])
    scalars = (0.1, 0.0, 1.0, 1e-10, 20)
    state = (x0, r0, d0, delta, delta * 1e6, 7)
    j_state = tuple(jnp.asarray(a) for a in state[:5]) + (jnp.asarray(7),)
    t_state = tuple(torch.tensor(a) for a in state[:5]) + (7,)
    if multi:
        j_state += (jnp.zeros(n_classes, jnp.int32),)
        t_state += (torch.zeros(n_classes, dtype=torch.int64),)
    j_args = tuple(jnp.asarray(a) for a in args) + (jnp.ones(dept),) + tuple(
        jnp.asarray(s) for s in scalars)
    j_solve = jcg.solve_ls_svm_multi_resume if multi else jcg.solve_ls_svm_resume
    with pytest.raises(Exception) as j_err:
        jcg.solve_checked(j_solve, *j_args, *j_state, kind=JKind.RBF, degree=3)
    t_solve = tcg.solve_ls_svm_multi if multi else tcg.solve_ls_svm
    t_args = tuple(torch.tensor(a) for a in args[:3]) + (
        torch.tensor(args[3]) if multi else float(args[3]),)
    with pytest.raises(NumericCheckError) as t_err:
        t_solve(*t_args, *scalars, kind=TKind.RBF, degree=3, init_state=t_state,
                debug=True)
    assert "at iteration 7" in str(t_err.value)
    assert str(j_err.value) == f"{t_err.value} (`check` failed)"


@pytest.mark.parametrize("case", ["weight_shape", "weight_sign", "warm_and_checkpoint",
                                  "warm_classes", "interval"])
def test_fit_extras_validation(case, tmp_path):
    """The same InvalidParameterError messages as plssvm_tpu's fit."""
    j_svm, j_data, t_svm, t_data = _pair(2, None, np.float64)
    mc_j, mc_jd, mc_t, mc_td = _pair(3, None, np.float64)
    path = os.path.join(tmp_path, "cg.ckpt")
    kwargs = {
        "weight_shape": lambda m: dict(sample_weight=np.ones(7)),
        "weight_sign": lambda m: dict(sample_weight=-np.ones(200)),
        "warm_and_checkpoint": lambda m: dict(initial_model=m, checkpoint_path=path),
        "warm_classes": lambda m: dict(initial_model=m),
        "interval": lambda m: dict(checkpoint_path=path, checkpoint_interval=0),
    }[case]
    errors = []
    for svm, data, mc_svm, mc_data in ((j_svm, j_data, mc_j, mc_jd),
                                       (t_svm, t_data, mc_t, mc_td)):
        model = svm.fit(data, epsilon=1e-3)
        target = (mc_svm, mc_data) if case == "warm_classes" else (svm, data)
        with pytest.raises(Exception) as err:
            target[0].fit(target[1], **kwargs(model))
        errors.append(err)
    assert isinstance(errors[1].value, InvalidParameterError)
    assert str(errors[1].value) == str(errors[0].value)


def _files(tmp_path, n_classes=3, nan=False, seed=None):
    X, y = _data(n_classes, seed=seed)
    X = X.copy()
    if nan:
        X[3, 1] = np.nan
    path = os.path.join(tmp_path, "train.libsvm")
    plssvm_tpu_torch.DataSet(X, y, scaling=(-1.0, 1.0)).save(path)
    return path


def _run_both(flags, train_file, tmp_path, capsys):
    """Both train CLIs with ``flags``: [(rc, stderr, model path)] for
    plssvm_tpu then the port."""
    out = []
    for name, cli, backend in (("j", j_train_cli, ["-b", "xla", "--solver", "cg_implicit"]),
                               ("t", t_train_cli, ["-b", "torch", "-p", "cpu"])):
        model = os.path.join(tmp_path, f"{name}.model")
        rc = cli.main(["-q", "--use_double_as_real_type", *backend,
                       *[f.replace("{who}", name) for f in flags], train_file, model])
        out.append((rc, capsys.readouterr().err, model))
    return out


@pytest.mark.parametrize("spec", ["1", "1=x", "1=0", "1=-2.5", "7=2"])
def test_cli_weight_messages(spec, tmp_path, capsys):
    """plssvm_tpu's --weight checks and messages; an unknown label warns."""
    (j_rc, j_err, _), (t_rc, t_err, t_model) = _run_both(
        ["--weight", spec, "-e", "1e-3"], _files(tmp_path), tmp_path, capsys)
    assert t_rc == j_rc
    assert t_err == j_err
    assert (t_rc == 0) == os.path.exists(t_model)


@pytest.mark.parametrize("flags", [
    ["--weight", "1=2", "--weight=-1=0.5"],
    ["--warm_start", "{who}.warm.model"],
    ["--checkpoint", "{who}.ckpt", "--checkpoint_interval", "3"],
    ["--debug"],
    ["--preconditioner", "jacobi"],
], ids=["weight", "warm_start", "checkpoint", "debug", "jacobi"])
def test_cli_extras_against_reference(flags, tmp_path, capsys, monkeypatch):
    """Each flag through both CLIs on a binary file: the port's model
    matches plssvm_tpu's (float64, epsilon 1e-10)."""
    monkeypatch.chdir(tmp_path)
    train_file = _files(tmp_path, n_classes=2, seed=CLI_SEED)
    if flags[0] == "--warm_start":
        # each package's own 1e-4 model file: class-grouped support vectors,
        # realigned to the file's rows by the warm start
        for name, cli, backend in (("j", j_train_cli, ["-b", "xla"]),
                                   ("t", t_train_cli, ["-b", "torch", "-p", "cpu"])):
            assert cli.main(["-q", "--use_double_as_real_type", *backend, "-e", "1e-4",
                             train_file, f"{name}.warm.model"]) == 0
    (j_rc, _, j_model), (t_rc, _, t_model) = _run_both(
        flags + ["-e", "1e-10"], train_file, tmp_path, capsys)
    assert j_rc == t_rc == 0
    j = plssvm_tpu.Model.load(j_model)
    t = plssvm_tpu_torch.Model.load(t_model)
    np.testing.assert_allclose(np.asarray(t.rho), np.asarray(j.rho), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t.alpha, j.alpha, rtol=0,
                               atol=1e-8 * np.max(np.abs(j.alpha)))
    assert not os.path.exists("t.ckpt")


def test_cli_debug_message(tmp_path, capsys):
    """--debug on a file with a NaN feature: rc 1 and plssvm_tpu's line."""
    (j_rc, j_err, _), (t_rc, t_err, t_model) = _run_both(
        ["--debug"], _files(tmp_path, n_classes=2, nan=True), tmp_path, capsys)
    assert j_rc == t_rc == 1
    assert not os.path.exists(t_model)
    assert t_err.startswith("numeric check failed: initial CG residual")
    assert j_err == t_err.rstrip("\n") + " (`check` failed)\n"


def test_fingerprint_of_a_tensor_matches_numpy():
    X, y = _data(2)
    f_np = tckpt.problem_fingerprint(X, y, "params", 1e-3)
    assert f_np == tckpt.problem_fingerprint(torch.tensor(X), torch.tensor(y), "params", 1e-3)
    assert f_np != tckpt.problem_fingerprint(X, y, "params", 1e-4)


def test_checkpoint_files_use_the_reference_keys(tmp_path):
    """A port checkpoint loads in plssvm_tpu and back: the same .npz keys."""
    from plssvm_tpu.solver import checkpoint as jckpt

    path = os.path.join(tmp_path, "c.ckpt")
    ckpt = tckpt.MultiCGCheckpoint(x=np.ones((5, 3)), r=np.zeros((5, 3)), d=np.ones((5, 3)),
                                   delta=np.arange(3.0), delta0=np.ones(3), iteration=4,
                                   itpc=np.asarray([4, 3, 4]), fingerprint="f")
    tckpt.save_multi_checkpoint(path, ckpt)
    loaded = jckpt.load_multi_checkpoint(path, "f")
    np.testing.assert_array_equal(loaded.itpc, ckpt.itpc)
    assert jckpt.load_checkpoint(path, "f") is None
    jckpt.save_checkpoint(path, jckpt.CGCheckpoint(
        x=np.ones(5), r=np.ones(5), d=np.ones(5), delta=0.5, delta0=2.0,
        iteration=3, fingerprint="f"))
    assert tckpt.load_checkpoint(path, "f").iteration == 3
