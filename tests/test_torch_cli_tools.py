"""plssvm-torch-scale and plssvm-torch-generate-data against plssvm_tpu's
plssvm-scale and plssvm-generate-data, on the CPU.

The same arguments and seed must give the same files byte for byte: the
scaled data set (LIBSVM or ARFF, to a file or to standard output), the
saved scaling factors, a data set scaled with restored factors, and the
generated data sets.  The port's files go through its native writer.
"""

import os

import numpy as np
import pytest

import plssvm_tpu_torch
from plssvm_tpu.cli import generate_data as j_generate
from plssvm_tpu.cli import scale as j_scale
from plssvm_tpu_torch.cli import generate_data as t_generate
from plssvm_tpu_torch.cli import scale as t_scale
from plssvm_tpu_torch.native import loader as t_loader


def _train_file(tmp_path, n_classes=2, name="train.libsvm"):
    rng = np.random.default_rng(7)
    y = rng.integers(0, n_classes, 60)
    X = rng.normal(size=(60, 5)) * [1.0, 10.0, 0.1, 3.0, 1e3] + y[:, None]
    X[rng.random(X.shape) < 0.2] = 0.0
    path = os.path.join(tmp_path, name)
    plssvm_tpu_torch.DataSet(X, y * 2 - 1 if n_classes == 2 else y).save(path)
    return path


def _both(main_j, main_t, args, tmp_path, capsys):
    """Run both CLIs with ``args``, where ``{who}`` names each one's
    files; returns [(rc, stdout, stderr)] for plssvm_tpu then the port."""
    out = []
    for who, main in (("j", main_j), ("t", main_t)):
        rc = main([a.replace("{who}", os.path.join(tmp_path, who)) for a in args])
        captured = capsys.readouterr()
        out.append((rc, captured.out, captured.err))
    return out


def _same_files(tmp_path, *suffixes):
    for suffix in suffixes:
        with open(os.path.join(tmp_path, "j" + suffix), "rb") as fj, \
                open(os.path.join(tmp_path, "t" + suffix), "rb") as ft:
            assert ft.read() == fj.read(), suffix


@pytest.mark.parametrize("flags", [[], ["-l", "0", "-u", "1"], ["-l", "-2.5", "-u", "7"],
                                   ["-f", "arff"]], ids=["default", "unit", "wide", "arff"])
def test_scale_to_a_file(flags, tmp_path, capsys):
    train = _train_file(tmp_path)
    t_loader.reset_counts()
    results = _both(j_scale.main, t_scale.main,
                    ["-q", *flags, "-s", "{who}.factors", train, "{who}.scaled"],
                    tmp_path, capsys)
    assert [r[0] for r in results] == [0, 0]
    assert (t_loader.native_parses, t_loader.native_writes) == (1, 1)
    _same_files(tmp_path, ".scaled", ".factors")


def test_scale_restores_factors(tmp_path, capsys):
    train = _train_file(tmp_path)
    test = _train_file(tmp_path, name="test.libsvm")
    assert j_scale.main(["-q", "-l", "0", "-u", "1", "-s", os.path.join(tmp_path, "f"),
                         train, os.path.join(tmp_path, "s")]) == 0
    results = _both(j_scale.main, t_scale.main,
                    ["-q", "-r", os.path.join(tmp_path, "f"), test, "{who}.restored"],
                    tmp_path, capsys)
    assert [r[0] for r in results] == [0, 0]
    _same_files(tmp_path, ".restored")


@pytest.mark.parametrize("fmt", ["libsvm", "arff"])
def test_scale_to_stdout(fmt, tmp_path, capsys):
    train = _train_file(tmp_path, n_classes=3)
    (j_rc, j_out, _), (t_rc, t_out, _) = _both(
        j_scale.main, t_scale.main, ["-q", "-f", fmt, train], tmp_path, capsys)
    assert j_rc == t_rc == 0
    assert t_out == j_out and t_out


@pytest.mark.parametrize("flags", [["-s", "a", "-r", "b"], ["-l", "1", "-u", "1"]],
                         ids=["save_and_restore", "empty_range"])
def test_scale_refusals(flags, tmp_path, capsys):
    train = _train_file(tmp_path)
    (j_rc, _, j_err), (t_rc, _, t_err) = _both(
        j_scale.main, t_scale.main, ["-q", *flags, train], tmp_path, capsys)
    assert j_rc == t_rc == 1
    assert t_err == j_err


@pytest.mark.parametrize("args", [
    ["-n", "50", "-d", "4", "--seed", "3"],
    ["-n", "64", "-d", "7", "--classes", "4", "--seed", "11"],
    ["-n", "40", "-d", "3", "--problem", "planes", "-f", "arff"],
    ["-n", "40", "-d", "5", "--problem", "gaussian", "--classes", "3"],
    ["-n", "30", "-d", "6", "--problem", "regression", "--seed", "2"],
], ids=["blobs", "blobs_4_classes", "planes_arff", "gaussian", "regression"])
def test_generate_data(args, tmp_path, capsys):
    results = _both(j_generate.main, t_generate.main, ["-o", "{who}.data", *args],
                    tmp_path, capsys)
    assert [r[0] for r in results] == [0, 0]
    _same_files(tmp_path, ".data")


def test_generate_data_without_sklearn(tmp_path, monkeypatch):
    """Where sklearn is missing (as on a card's machine) both packages take
    the NumPy blobs generator and still agree."""
    import builtins

    real_import = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    for who, main in (("j", j_generate.main), ("t", t_generate.main)):
        assert main(["-o", os.path.join(tmp_path, who + ".data"), "-n", "45", "-d", "6",
                     "--classes", "3", "--seed", "9"]) == 0
    _same_files(tmp_path, ".data")
