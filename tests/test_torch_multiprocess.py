"""The port's multi-process fits and predict across real processes.

``plssvm_tpu_torch.tools.multihost_rehearsal.launch`` starts W = 2 and W =
3 gloo processes on the CPU (one thread each; torchrun's environment), each
parsing its window of the same files and running one list of tasks:
binary, one-vs-all and LS-SVR fits, a weighted and a warm-started fit, the
explicit solver (laplacian), one-class and Nystroem fits, in float32 and
float64; predict; a checkpointed fit interrupted after its first save and
resumed; the training and predict CLIs with ``--multihost``.  Each result
is held

(i) bit for bit against the single-process ring over as many shards,
    ``CSVM(device="cpu", devices=["cpu"] * W)``, run here on one thread:
    the same shards, the same order of the ring's steps, the same
    summation trees;
(ii) against plssvm_tpu on one device, float64 at epsilon 1e-10: the same
    iteration count, alpha within 1e-8 of max|alpha|, rho within 1e-8 (the
    repo's float64 rule, tests/test_torch_solver_extras.py).

Each rank records its window of the file (disjoint, covering every row),
the rows of X and of each CG vector it held while it solved (its window's),
the files it wrote (only rank 0 writes), and that it never imported
``jax``.
"""

import os

import numpy as np
import pytest
import torch

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu_torch.parallel.sharded import shard_bounds
from plssvm_tpu_torch.tools import multihost_rehearsal as rehearsal

N = 62          # rows of every training file: n - 1 = 61 splits unevenly
D = 6
EPS = {"float64": 1e-10, "float32": 1e-6}
DTYPES = ["float32", "float64"]
NU = 0.2
LANDMARKS, ROW_BLOCK = 12, 8
CHECKPOINT_INTERVAL = 4
#: the modes run in both types, with their kind of task
MODES = ["binary", "oaa", "svr", "weighted", "laplacian_explicit", "one_class", "nystroem"]


@pytest.fixture(scope="module")
def one_thread():
    """The in-process goldens on one thread, as each rank runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiprocess")
    rng = np.random.default_rng(5)
    y = np.where(rng.random(N + 20) < 0.5, -1, 1)
    X = rng.normal(size=(N + 20, D)) + 0.5 * y[:, None]
    classes = rng.integers(0, 3, N)
    Xc = rng.normal(size=(N, D)) + rng.normal(size=(3, D))[classes]
    paths = {name: str(tmp / f"{name}.libsvm") for name in ("binary", "classes", "svr", "test")}
    plssvm_tpu_torch.DataSet(X[:N], y[:N]).save(paths["binary"])
    plssvm_tpu_torch.DataSet(X[N:], y[N:]).save(paths["test"])
    plssvm_tpu_torch.DataSet(Xc, classes).save(paths["classes"])
    plssvm_tpu_torch.DataSet(X[:N], np.tanh(X[:N, 0] + X[:N, 1]),
                             regression=True).save(paths["svr"])
    poisoned = X[:N].copy()
    poisoned[N - 3, 1] = np.nan  # in the last rank's window
    paths["poisoned"] = str(tmp / "poisoned.libsvm")
    plssvm_tpu_torch.DataSet(poisoned, y[:N]).save(paths["poisoned"])
    paths["weights"] = np.linspace(0.5, 2.0, N).tolist()
    paths["tmp"] = str(tmp)
    return paths


def _mode(mode, dtype, files):
    """(task of the rehearsal, the in-process golden's fit on W shards)."""
    csvm = dict(device="cpu", dtype=dtype, kernel_type="rbf")
    fit = dict(epsilon=EPS[dtype])
    file = files["binary"]
    op = "fit"
    if mode == "oaa":
        file = files["classes"]
    elif mode == "svr":
        file = files["svr"]
        fit["regression"] = True
    elif mode == "weighted":
        fit["sample_weight"] = files["weights"]
    elif mode == "laplacian_explicit":
        csvm.update(kernel_type="laplacian", solver="cg_explicit")
    elif mode == "one_class":
        op, fit = "one_class", dict(nu=NU, epsilon=EPS[dtype])
    elif mode == "nystroem":
        op, file = "nystroem", files["classes"]
        fit = dict(n_landmarks=LANDMARKS, row_block=ROW_BLOCK)
    return dict(name=f"{mode}_{dtype}", op=op, file=file, csvm=csvm, fit=fit)


def _tasks(files):
    tasks = [_mode(mode, dtype, files) for dtype in DTYPES for mode in MODES]
    tmp = files["tmp"]
    base = dict(op="fit", file=files["binary"],
                csvm=dict(device="cpu", dtype="float64", kernel_type="rbf"))
    tasks += [
        dict(base, name="saved", fit=dict(epsilon=1e-4), save=os.path.join(tmp, "saved.model")),
        dict(base, name="warm", fit=dict(epsilon=1e-10),
             warm_start=os.path.join(tmp, "saved.model")),
        dict(name="predict", op="predict", file=files["test"],
             model=os.path.join(tmp, "saved.model"), csvm=dict(device="cpu", dtype="float64")),
        # a fit's barriers: the builds', the checkpoint read's, then one
        # after each save: the third stops every rank after the first save
        dict(base, name="interrupted", interrupt_at_barrier=3,
             fit=dict(epsilon=1e-10, checkpoint_path=os.path.join(tmp, "fit.ckpt"),
                      checkpoint_interval=CHECKPOINT_INTERVAL)),
        dict(base, name="resumed",
             fit=dict(epsilon=1e-10, checkpoint_path=os.path.join(tmp, "fit.ckpt"),
                      checkpoint_interval=CHECKPOINT_INTERVAL)),
        dict(base, name="debug", file=files["poisoned"], expect_error=True,
             csvm=dict(base["csvm"], debug=True), fit=dict(epsilon=1e-10)),
        dict(name="cli_train", op="cli_train",
             argv=["--multihost", "-p", "cpu", "-t", "2", "-e", "1e-10", "-q",
                   "--use_double_as_real_type", files["binary"], os.path.join(tmp, "cli.model")]),
        dict(name="cli_predict", op="cli_predict",
             argv=["--multihost", "-p", "cpu", "-q", "--use_double_as_real_type",
                   files["test"], os.path.join(tmp, "cli.model"), os.path.join(tmp, "cli.out")]),
    ]
    return tasks


@pytest.fixture(scope="module", params=[2, 3], ids=["W2", "W3"])
def run(request, files, one_thread):
    """The rehearsal at W ranks: (W, per-rank records, output directory)."""
    world = request.param
    tmp = os.path.join(files["tmp"], f"W{world}")
    for stale in ("fit.ckpt", "saved.model", "cli.model", "cli.out"):
        path = os.path.join(files["tmp"], stale)
        if os.path.exists(path):
            os.remove(path)
    records = rehearsal.launch({"tasks": _tasks(files)}, world, tmp, timeout=240)
    cli_out = open(os.path.join(files["tmp"], "cli.out")).read()
    return world, records, tmp, cli_out


def _task(record, name):
    return next(t for t in record["tasks"] if t["name"] == name)


def _golden(mode, dtype, files, devices):
    """The in-process fit of a mode on ``devices`` (a list: the ring)."""
    task = _mode(mode, dtype, files)
    svm = plssvm_tpu_torch.CSVM(devices=devices, device=devices[0] if devices else "cpu",
                                **{k: v for k, v in task["csvm"].items() if k != "device"})
    fit = dict(task["fit"])
    regression = fit.pop("regression", False)
    data = plssvm_tpu_torch.DataSet(task["file"], dtype=dtype, regression=regression)
    if task["op"] == "one_class":
        return plssvm_tpu_torch.fit_one_class(svm, data, **fit)
    if task["op"] == "nystroem":
        return plssvm_tpu_torch.nystroem_fit(svm, data, **fit)
    if "sample_weight" in fit:
        fit["sample_weight"] = np.asarray(fit["sample_weight"])
    return svm.fit(data, **fit)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_bit_for_bit_the_single_process_ring(run, files, mode, dtype):
    """(i): every rank's model is the in-process ring's of W shards, bit
    for bit, and the ranks ran the same iterations."""
    world, records, tmp, _ = run
    want = _golden(mode, dtype, files, ["cpu"] * world)
    for rank in range(world):
        got = rehearsal.load_arrays(tmp, f"{mode}_{dtype}", rank)
        assert np.array_equal(got["alpha"], np.asarray(want.alpha)), (mode, dtype, rank)
        assert np.array_equal(got["rho"], np.asarray(want.rho, dtype=np.float64))
        assert _task(records[rank], f"{mode}_{dtype}")["n_iter"] == want.n_iter


def _reference(mode, files):
    """plssvm_tpu's float64 fit of a mode on one device."""
    task = _mode(mode, "float64", files)
    kind = task["csvm"]["kernel_type"]
    solver = task["csvm"].get("solver", "cg_implicit")
    svm = plssvm_tpu.CSVM(backend="xla", solver=solver, dtype=np.float64, kernel_type=kind)
    fit = dict(task["fit"])
    regression = fit.pop("regression", False)
    data = plssvm_tpu.DataSet(task["file"], dtype=np.float64, regression=regression)
    if task["op"] == "one_class":
        return plssvm_tpu.fit_one_class(svm, data, **fit)
    if task["op"] == "nystroem":
        return plssvm_tpu.nystroem_fit(svm, data, **fit)
    if "sample_weight" in fit:
        fit["sample_weight"] = np.asarray(fit["sample_weight"])
    return svm.fit(data, **fit)


@pytest.mark.parametrize("mode", MODES)
def test_against_plssvm_tpu(run, files, mode):
    """(ii): the float64 models against plssvm_tpu's on one device."""
    world, records, tmp, _ = run
    want = _reference(mode, files)
    got = rehearsal.load_arrays(tmp, f"{mode}_float64", 0)
    scale = float(np.max(np.abs(np.asarray(want.alpha))))
    np.testing.assert_allclose(got["alpha"], np.asarray(want.alpha), rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(got["rho"], np.asarray(want.rho, dtype=np.float64), rtol=0,
                               atol=1e-8)
    assert _task(records[0], f"{mode}_float64")["n_iter"] == want.n_iter


def test_windows_cover_every_row_once_and_no_rank_holds_more(run):
    """Each solve's windows are ``shard_bounds`` of the solved rows over
    the ranks: disjoint and covering; X and the CG vectors x, r, d of every
    rank hold its window's rows and no more."""
    world, records, _, _ = run
    for mode in ("binary", "oaa", "laplacian_explicit", "one_class"):
        rows = N if mode == "one_class" else N - 1
        windows = [tuple(_task(rec, f"{mode}_float64")["window"]) for rec in records]
        assert windows == shard_bounds(rows, world)
        for rec, (lo, hi) in zip(records, windows):
            held = _task(rec, f"{mode}_float64")["rows"]
            assert held == {"X": hi - lo, "x": hi - lo, "r": hi - lo, "d": hi - lo}
    # the Nystroem reduction: the padded row split of the single-process one
    windows = [tuple(_task(rec, "nystroem_float64")["window"]) for rec in records]
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in windows])
    assert np.array_equal(covered, np.arange(N))


def test_no_rank_imports_jax(run):
    _, records, _, _ = run
    assert [(r["jax_imported"], r["plssvm_tpu_imported"]) for r in records] == \
        [(False, False)] * len(records)


def test_predict_gathers_every_window(run, files):
    """Every rank returns the whole prediction vector: the single-process
    predict of the saved model."""
    world, records, tmp, _ = run
    svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64)
    want = svm.predict(plssvm_tpu_torch.Model.load(os.path.join(files["tmp"], "saved.model")),
                       plssvm_tpu_torch.DataSet(files["test"]))
    for rank in range(world):
        assert np.array_equal(rehearsal.load_arrays(tmp, "predict", rank)["predictions"], want)


def test_warm_start_from_the_saved_model(run, files):
    """The warm fit from rank 0's saved model: the in-process ring's warm
    fit bit for bit."""
    world, _, tmp, _ = run
    svm = plssvm_tpu_torch.CSVM(device="cpu", devices=["cpu"] * world, dtype=np.float64,
                                kernel_type="rbf")
    data = plssvm_tpu_torch.DataSet(files["binary"], dtype=np.float64)
    start = plssvm_tpu_torch.Model.load(os.path.join(files["tmp"], "saved.model"),
                                        dtype=np.float64)
    want = svm.fit(data, epsilon=1e-10, initial_model=start)
    got = rehearsal.load_arrays(tmp, "warm", world - 1)
    assert np.array_equal(got["alpha"], want.alpha)


def test_checkpoint_gating_and_resume(run, files):
    """The interrupted fit left rank 0's checkpoint alone (no other rank
    wrote one); the resumed fit read it on every rank and ends at the
    uninterrupted in-process ring's model, bit for bit; then the file is
    gone."""
    world, records, tmp, _ = run
    ckpt = os.path.join(files["tmp"], "fit.ckpt")
    for rank, rec in enumerate(records):
        interrupted = _task(rec, "interrupted")
        assert interrupted.get("interrupted") is True
        assert interrupted["writes"] == ([["checkpoint", ckpt]] if rank == 0 else [])
    svm = plssvm_tpu_torch.CSVM(device="cpu", devices=["cpu"] * world, dtype=np.float64,
                                kernel_type="rbf")
    want = svm.fit(plssvm_tpu_torch.DataSet(files["binary"], dtype=np.float64), epsilon=1e-10)
    for rank in range(world):
        got = rehearsal.load_arrays(tmp, "resumed", rank)
        assert np.array_equal(got["alpha"], want.alpha)
        assert np.array_equal(got["rho"], np.asarray(want.rho))
    assert not os.path.exists(ckpt)


def test_cli_single_writer(run, files):
    """``plssvm-torch-train --multihost`` and ``plssvm-torch-predict
    --multihost``: every rank returns 0, only rank 0 writes the model, and
    the predictions are the single-process CLI's."""
    from plssvm_tpu_torch.cli import predict as t_predict_cli

    world, records, _, cli_out = run
    model = os.path.join(files["tmp"], "cli.model")
    for rank, rec in enumerate(records):
        assert _task(rec, "cli_train")["rc"] == 0 and _task(rec, "cli_predict")["rc"] == 0
        assert _task(rec, "cli_train")["writes"] == ([["model", model]] if rank == 0 else [])
    out = os.path.join(files["tmp"], f"single{world}.out")
    assert t_predict_cli.main(["-p", "cpu", "-q", "--use_double_as_real_type", files["test"],
                               model, out]) == 0
    assert open(out).read() == cli_out


def test_debug_guard_raises_on_every_rank(run, files):
    """A non-finite value in the last rank's window: the ``debug`` guard's
    verdict is every rank's (``agree``), so all raise plssvm_tpu's message
    together and none is left in a collective; the single-process ring
    raises the same."""
    world, records, _, _ = run
    errors = {_task(rec, "debug").get("error") for rec in records}
    assert len(errors) == 1
    error = errors.pop()
    assert error.startswith("NumericCheckError: ") and "non-finite" in error
    svm = plssvm_tpu_torch.CSVM(device="cpu", devices=["cpu"] * world, dtype=np.float64,
                                kernel_type="rbf", debug=True)
    with pytest.raises(plssvm_tpu_torch.NumericCheckError) as raised:
        svm.fit(plssvm_tpu_torch.DataSet(files["poisoned"], dtype=np.float64), epsilon=1e-10)
    assert error == f"NumericCheckError: {raised.value}"
