"""The port's multi-process module in one process, against plssvm_tpu.

plssvm_tpu's multihost path runs here at ``jax.process_count() == 1`` over
its eight virtual CPU devices; the port's at a world of one process (no
process group).  Held here:

- the launch detection from the environment only (torchrun's
  ``WORLD_SIZE``; no SLURM or MPI guesses), the rank's device, and that a
  plain run brings up no process group;
- the row windows of any row count over any world (disjoint, covering,
  ``shard_bounds``), ``parse_libsvm_rows_for_host`` against the whole
  parse and against plssvm_tpu's, the checkpoint fingerprint against
  plssvm_tpu's;
- ``fit_multihost`` against ``plssvm_tpu.CSVM(backend="xla").fit_multihost``
  on the same file, float64 at epsilon 1e-10 (the same iterations, alpha
  within 1e-8 of max|alpha|, rho within 1e-8): binary RBF, one-vs-all,
  LS-SVR, weighted, ARFF, warm-started and checkpointed (interrupted after
  a save, resumed); the one-class, Nystroem and predict counterparts alike.

The seed keeps plssvm_tpu's iteration counts off their stop thresholds
(ROADMAP Queue 3 item 5: its count moves with its row block on some sets).
Real processes: tests/test_torch_multiprocess.py.
"""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import plssvm_tpu
import plssvm_tpu_torch
import plssvm_tpu_torch.solver.checkpoint as t_ckpt
from plssvm_tpu.parallel import multihost as j_mh
from plssvm_tpu.parallel.sharded import make_row_mesh
from plssvm_tpu_torch.exceptions import InvalidParameterError
from plssvm_tpu_torch.parallel import multihost as t_mh
from plssvm_tpu_torch.parallel.sharded import shard_bounds

SEED = 7
N, D = 70, 6
EPS = 1e-10


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


@pytest.fixture
def eight_devices(monkeypatch):
    """plssvm_tpu's global mesh: the eight virtual CPU devices."""
    monkeypatch.setattr(j_mh, "global_row_mesh",
                        lambda: make_row_mesh(jax.devices("cpu")[:8]))


# ---------------------------------------------------------------------------
# launch detection
# ---------------------------------------------------------------------------

LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "SLURM_NTASKS", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE",
               "JAX_COORDINATOR_ADDRESS", t_mh.RANK_DEVICE_ENV, t_mh.BACKEND_ENV)


@pytest.mark.parametrize("env,launch", [
    ({}, False),
    ({"WORLD_SIZE": "4", "RANK": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"},
     True),
    ({"WORLD_SIZE": "2"}, True),
    ({"WORLD_SIZE": "1", "RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}, False),
    ({"RANK": "3"}, False),
    ({"SLURM_NTASKS": "4", "SLURM_JOB_ID": "12345"}, False),
    ({"OMPI_COMM_WORLD_SIZE": "4"}, False),
    ({"JAX_COORDINATOR_ADDRESS": "host0:1234"}, False),
    ({"WORLD_SIZE": "four"}, False),
], ids=["plain", "torchrun", "world-size", "one-process", "rank-alone", "slurm", "mpi",
        "jax-coordinator", "unparsable"])
def test_launch_detection_reads_torchrun_only(monkeypatch, env, launch):
    """A launch of several processes is torchrun's ``WORLD_SIZE`` above 1,
    and nothing else: N independent fits under one SLURM or MPI job are not
    fused (plssvm_tpu's rule, tests/test_multihost.py), and the JAX
    package's coordinator variables are not the port's."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert t_mh._multi_process_env() is launch


def test_a_plain_run_brings_up_no_group(monkeypatch):
    import torch.distributed as dist

    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    t_mh.initialize_distributed()
    assert not dist.is_initialized()
    group = t_mh.RankGroup("cpu")
    assert (group.rank, group.world, group.up, group.staged) == (0, 1, False, False)
    t = torch.arange(5.0)
    assert group.all_gather(t)[0] is t
    assert torch.equal(group.all_gather_rows(t, [(0, 5)]), t)
    assert group.agree(True) and not group.agree(False)


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({t_mh.RANK_DEVICE_ENV: "cpu"}, "cpu"),
    ({t_mh.RANK_DEVICE_ENV: "cuda:0", "LOCAL_RANK": "3"}, "cuda:0"),
])
def test_rank_device(monkeypatch, env, want):
    """The rank's device: the argument, else the variable, else
    ``cuda:LOCAL_RANK`` (None here, where there is no CUDA)."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    if torch.cuda.is_available():
        pytest.skip("the default names the CUDA device where there is one")
    got = t_mh.rank_device()
    assert (None if got is None else str(got)) == want
    assert str(t_mh.rank_device("cpu")) == "cpu"


# ---------------------------------------------------------------------------
# windows and fingerprints
# ---------------------------------------------------------------------------


def _group(rank, world):
    return SimpleNamespace(rank=rank, world=world)


@pytest.mark.parametrize("rows,world", [(7, 1), (7, 2), (7, 3), (61, 4), (64, 4), (5, 5)])
def test_host_row_range_is_the_rings_shard(rows, world):
    """Every row once, in rank order, the first ``rows % world`` windows
    one row longer: ``shard_bounds``, the single-process ring's shards."""
    windows = [t_mh.host_row_range(rows, _group(r, world)) for r in range(world)]
    assert windows == shard_bounds(rows, world)
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in windows])
    assert np.array_equal(covered, np.arange(rows))
    with pytest.raises(InvalidParameterError, match="at least one row a process"):
        t_mh.host_row_range(world - 1, _group(0, world))


@pytest.mark.parametrize("world", [1, 2, 3, 4, 9])
def test_parse_rows_for_host_non_divisible(tmp_path, world):
    """Each rank's rows of a 7-row file: its window of the whole parse
    (ranks past the rows get none); at one process plssvm_tpu's."""
    rng = np.random.default_rng(1)
    X, y = rng.normal(size=(7, 3)), np.arange(7) % 2
    path = str(tmp_path / "seven.libsvm")
    plssvm_tpu_torch.DataSet(X, y).save(path)
    whole = plssvm_tpu_torch.DataSet(path, dtype=np.float64)
    parts = [t_mh.parse_libsvm_rows_for_host(path, group=_group(r, world))
             for r in range(world)]
    assert all(p[2:] == (7, 3) for p in parts)
    np.testing.assert_array_equal(np.vstack([p[0] for p in parts]), whole.data)
    assert [lab for p in parts for lab in p[1]] == [str(v) for v in y]
    if world == 1:
        j_X, j_labels, n, d = j_mh.parse_libsvm_rows_for_host(path)
        np.testing.assert_array_equal(parts[0][0], j_X)
        assert (list(parts[0][1]), parts[0][2:]) == (list(j_labels), (n, d))


def test_fingerprint_is_plssvm_tpus():
    """The same global metadata hashes to plssvm_tpu's fingerprint (the
    port passes its solved rows where plssvm_tpu passes its padded ones)."""
    rng = np.random.default_rng(2)
    args = (101, 7, "params", 1e-3, rng.normal(size=7), rng.normal(size=(101, 3)), 100)
    assert t_mh._multihost_fingerprint(*args) == j_mh._multihost_fingerprint(*args)
    assert t_mh._multihost_fingerprint(*args[:-1], 99) != t_mh._multihost_fingerprint(*args)


# ---------------------------------------------------------------------------
# fit_multihost against plssvm_tpu's
# ---------------------------------------------------------------------------


def _write(tmp_path, kind, suffix=".libsvm"):
    rng = np.random.default_rng(SEED)
    if kind == "classes":
        y = rng.integers(0, 3, N)
        X = rng.normal(size=(N, D)) + rng.normal(size=(3, D))[y]
    else:
        y = np.where(rng.random(N) < 0.5, -1, 1)
        X = rng.normal(size=(N, D)) + 0.5 * y[:, None]
        if kind == "svr":
            y = np.tanh(X[:, 0] - X[:, 2])
    path = str(tmp_path / f"{kind}{suffix}")
    plssvm_tpu_torch.DataSet(X, y, regression=kind == "svr").save(path)
    return path


def _pair(**params):
    return (plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="rbf", **params),
            plssvm_tpu.CSVM(backend="xla", solver="cg_implicit", dtype=np.float64,
                            kernel_type="rbf", **params))


def _close(got, want, iterations=True):
    if iterations:
        assert got.n_iter == want.n_iter
    scale = float(np.max(np.abs(np.asarray(want.alpha))))
    np.testing.assert_allclose(np.asarray(got.alpha), np.asarray(want.alpha), rtol=0,
                               atol=1e-8 * scale)
    np.testing.assert_allclose(np.asarray(got.rho), np.asarray(want.rho), rtol=0, atol=1e-8)


@pytest.mark.parametrize("case", ["binary", "oaa", "svr", "weighted", "arff"])
def test_fit_multihost_against_plssvm_tpu(tmp_path, eight_devices, case):
    kind = {"oaa": "classes", "svr": "svr"}.get(case, "binary")
    path = _write(tmp_path, kind, ".arff" if case == "arff" else ".libsvm")
    kw = dict(epsilon=EPS)
    if case == "svr":
        kw["regression"] = True
    if case == "weighted":
        kw["sample_weight"] = np.linspace(0.5, 2.0, N)
    t_svm, j_svm = _pair()
    plssvm_tpu_torch.global_tracker.clear()
    got, want = t_svm.fit_multihost(path, **kw), j_svm.fit_multihost(path, **kw)
    _close(got, want)
    held = dict(plssvm_tpu_torch.global_tracker.entries()["multihost"])
    assert held["window"] == [0, N - 1]
    assert [held[f"rows_{v}"] for v in "Xxrd"] == [N - 1] * 4


def test_fit_multihost_warm_start(tmp_path, eight_devices):
    """A warm start from a model file (class-grouped rows, re-aligned)
    ends where plssvm_tpu's does."""
    path = _write(tmp_path, "classes")
    t_svm, j_svm = _pair()
    saved = str(tmp_path / "start.model")
    t_svm.fit_multihost(path, epsilon=1e-3).save(saved)
    got = t_svm.fit_multihost(path, epsilon=EPS,
                              initial_model=plssvm_tpu_torch.Model.load(saved))
    want = j_svm.fit_multihost(path, epsilon=EPS, initial_model=plssvm_tpu.Model.load(saved))
    _close(got, want)


def test_fit_multihost_checkpoint_resume(tmp_path, eight_devices, monkeypatch):
    """A checkpointed fit interrupted after its first save resumes to the
    uninterrupted fit's model bit for bit, and to plssvm_tpu's
    checkpointed fit; the file goes when the fit ends."""
    path = _write(tmp_path, "binary")
    ckpt = str(tmp_path / "fit.ckpt")
    t_svm, j_svm = _pair()
    save = t_ckpt.save_checkpoint

    def save_then_stop(*args):
        save(*args)
        raise KeyboardInterrupt

    monkeypatch.setattr(t_ckpt, "save_checkpoint", save_then_stop)
    with pytest.raises(KeyboardInterrupt):
        t_svm.fit_multihost(path, epsilon=EPS, checkpoint_path=ckpt, checkpoint_interval=3)
    assert os.path.isfile(ckpt)
    monkeypatch.setattr(t_ckpt, "save_checkpoint", save)
    resumed = t_svm.fit_multihost(path, epsilon=EPS, checkpoint_path=ckpt,
                                  checkpoint_interval=3)
    assert not os.path.exists(ckpt)
    plain = t_svm.fit_multihost(path, epsilon=EPS)
    assert np.array_equal(resumed.alpha, plain.alpha) and resumed.rho == plain.rho
    want = j_svm.fit_multihost(path, epsilon=EPS, checkpoint_path=str(tmp_path / "j.ckpt"),
                               checkpoint_interval=3)
    _close(resumed, want)


def test_one_class_nystroem_and_predict_multihost(tmp_path, eight_devices):
    """The one-class and Nystroem fits and the windowed predict at one
    process against plssvm_tpu's multihost counterparts."""
    path = _write(tmp_path, "classes")
    t_svm, j_svm = _pair()
    _close(plssvm_tpu_torch.fit_one_class_multihost(t_svm, path, nu=0.2, epsilon=EPS),
           plssvm_tpu.fit_one_class_multihost(j_svm, path, nu=0.2, epsilon=EPS))
    got, t_idx = plssvm_tpu_torch.nystroem_fit_multihost(t_svm, path, n_landmarks=12,
                                                         return_indices=True)
    want, j_idx = plssvm_tpu.nystroem_fit_multihost(j_svm, path, n_landmarks=12,
                                                    return_indices=True)
    assert np.array_equal(t_idx, j_idx)
    _close(got, want, iterations=False)
    model = plssvm_tpu_torch.Model.load(_saved(t_svm, path, tmp_path))
    t_pred, t_labels, n = t_mh.predict_multihost(t_svm, model, path)
    j_pred, j_labels, j_n = j_mh.predict_multihost(
        j_svm, plssvm_tpu.Model.load(str(tmp_path / "m.model")), path)
    assert np.array_equal(t_pred, j_pred) and (n, list(t_labels)) == (j_n, list(j_labels))


def _saved(svm, path, tmp_path):
    out = str(tmp_path / "m.model")
    svm.fit_multihost(path, epsilon=1e-6).save(out)
    return out


def test_refusals(tmp_path):
    """What plssvm_tpu refuses, with its messages; and a CSVM with several
    devices, since a rank holds one shard."""
    path = _write(tmp_path, "binary")
    svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64)
    for kw, match in ((dict(classification="oao"), "not supported on the multi-host"),
                      (dict(epsilon=0.0), "epsilon"), (dict(max_iter=0), "max_iter"),
                      (dict(checkpoint_path="x", checkpoint_interval=0), "checkpoint_interval"),
                      (dict(checkpoint_path="x", initial_model=object()), "initial_model")):
        with pytest.raises(InvalidParameterError, match=match):
            svm.fit_multihost(path, **kw)
    with pytest.raises(InvalidParameterError, match="one shard a process"):
        plssvm_tpu_torch.CSVM(devices=["cpu"] * 2).fit_multihost(path)
    chi2 = plssvm_tpu_torch.CSVM(device="cpu", kernel_type="chi_squared")
    with pytest.raises(InvalidParameterError, match="non-negative"):
        chi2.fit_multihost(path)


@pytest.mark.parametrize("kind,solver", [("laplacian", "automatic"), ("rbf", "automatic"),
                                         ("laplacian", "cg_explicit")])
def test_explicit_choice_at_one_process_is_the_csvms(kind, solver):
    """At one process the solver choice over the ranks is the CSVM's own
    (the budget on the CPU is plssvm_tpu's 6 GiB)."""
    svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type=kind,
                                solver=solver)
    group = t_mh.RankGroup("cpu")
    got = t_mh.use_explicit_solver(svm, group, shard_bounds(99, 1), 10,
                                   svm.params.kernel_type.value)
    assert got == svm._use_explicit_solver(99, 10, svm.params.kernel_type.value)


class _TwoRanks:
    """Rank 0 of two whose table of gathered values repeats rank 0's, on
    one device or (``apart``) on two."""

    rank, world = 0, 2

    def __init__(self, apart):
        self.apart = apart

    def host_values(self, values):
        other = list(values)
        if self.apart:
            other[0] += 1.0  # another device's identity
        return np.array([list(values), other], dtype=np.float64)


@pytest.mark.parametrize("apart", [False, True], ids=["one-device", "two-devices"])
def test_explicit_budget_counts_the_ranks_sharing_a_device(monkeypatch, apart):
    """Two ranks on one device hold both row blocks there: a budget that
    one rank's block and its build's column block fit, but not two,
    refuses the forced explicit fit on every rank and takes the implicit
    one for ``automatic``; on two devices each holds its own."""
    bounds = shard_bounds(99, 2)
    one = 50 * 99 * 8 + 50 * 50 * 8
    monkeypatch.setenv("PLSSVM_TPU_TORCH_EXPLICIT_BUDGET", str(one + 8))
    for solver in ("cg_explicit", "automatic"):
        svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="laplacian",
                                    solver=solver)
        kind = svm.params.kernel_type.value
        if apart:
            assert t_mh.use_explicit_solver(svm, _TwoRanks(apart), bounds, 10, kind)
        elif solver == "cg_explicit":
            with pytest.raises(InvalidParameterError, match="over 2 device"):
                t_mh.use_explicit_solver(svm, _TwoRanks(apart), bounds, 10, kind)
        else:
            assert not t_mh.use_explicit_solver(svm, _TwoRanks(apart), bounds, 10, kind)
