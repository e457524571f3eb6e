"""The port's host-side file IO against plssvm_tpu's, on every file under
tests/data/.

Valid files must parse to identical arrays and labels and be written back
as identical bytes; invalid files must raise the same exception class with
the same message.  A model file written by either package loads in the
other.  The port's parsers are copies of plssvm_tpu's NumPy/Python paths;
plssvm_tpu may take its native C++ parser, whose messages are the same by
contract.
"""

import glob
import os
import re

import numpy as np
import pytest

import plssvm_tpu
import plssvm_tpu.io.arff as j_arff
import plssvm_tpu.io.libsvm as j_libsvm
import plssvm_tpu.io.model_file as j_model
import plssvm_tpu.io.scaling_file as j_scaling
import plssvm_tpu_torch
import plssvm_tpu_torch.io.arff as t_arff
import plssvm_tpu_torch.io.libsvm as t_libsvm
import plssvm_tpu_torch.io.model_file as t_model
import plssvm_tpu_torch.io.scaling_file as t_scaling

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FILES = sorted(
    os.path.relpath(p, DATA_DIR)
    for p in glob.glob(os.path.join(DATA_DIR, "**", "*"), recursive=True)
    if os.path.isfile(p)
)

PARSERS = {
    "libsvm": (j_libsvm.parse_libsvm_file, t_libsvm.parse_libsvm_file),
    "arff": (j_arff.parse_arff_file, t_arff.parse_arff_file),
    "model": (j_model.parse_model_file, t_model.parse_model_file),
    "scaling": (j_scaling.parse_scaling_factors, t_scaling.parse_scaling_factors),
}


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")


def _outcome(parse, path):
    try:
        return "ok", parse(path)
    except Exception as exc:  # compared by class name and message
        return "raised", (type(exc).__name__, str(exc))


def _assert_same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    elif isinstance(a, (tuple, list)) and not hasattr(a, "kernel_type"):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif hasattr(a, "kernel_type"):  # Parameter of either package
        for name in ("kernel_type", "degree", "gamma", "coef0", "cost"):
            fa, fb = getattr(a, name), getattr(b, name)
            assert int(fa.value) == int(fb.value) if name == "kernel_type" else fa.value == fb.value
            assert fa.is_default() == fb.is_default()
    else:
        assert a == b


def test_every_data_file_is_covered():
    assert len(FILES) >= 70
    assert {f.split(os.sep)[0] for f in FILES} == set(PARSERS)


@pytest.mark.parametrize("rel", FILES)
def test_parse_identical(rel):
    j_parse, t_parse = PARSERS[rel.split(os.sep)[0]]
    path = os.path.join(DATA_DIR, rel)
    j_kind, j_val = _outcome(j_parse, path)
    t_kind, t_val = _outcome(t_parse, path)
    if os.sep + "invalid" + os.sep in rel:
        assert j_kind == "raised"
    assert t_kind == j_kind
    _assert_same(j_val, t_val)


def _valid(kind):
    """The files of one kind that plssvm_tpu parses without error."""
    parse = PARSERS[kind][0]
    return [
        f for f in FILES
        if f.startswith(kind + os.sep)
        and _outcome(parse, os.path.join(DATA_DIR, f))[0] == "ok"
    ]


def _written_bytes(write, tmp_path, name, *args):
    path = os.path.join(tmp_path, name)
    write(path, *args)
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("rel", _valid("libsvm") + _valid("arff"))
def test_data_files_written_identically(rel, tmp_path):
    path = os.path.join(DATA_DIR, rel)
    X, labels = j_libsvm.parse_libsvm_file(path) if rel.startswith("libsvm") else j_arff.parse_arff_file(path)
    for j_write, t_write in (
        (j_libsvm.write_libsvm_file, t_libsvm.write_libsvm_file),
        (j_arff.write_arff_file, t_arff.write_arff_file),
    ):
        want = _written_bytes(j_write, tmp_path, "j", X, labels)
        got = _written_bytes(t_write, tmp_path, "t", X, labels)
        assert got == want


@pytest.mark.parametrize("rel", _valid("scaling"))
def test_scaling_files_written_identically(rel, tmp_path):
    interval, factors = j_scaling.parse_scaling_factors(os.path.join(DATA_DIR, rel))
    want = _written_bytes(j_scaling.write_scaling_factors, tmp_path, "j", interval, factors)
    got = _written_bytes(t_scaling.write_scaling_factors, tmp_path, "t", interval, factors)
    assert got == want


@pytest.mark.parametrize("rel", _valid("model"))
def test_model_files_round_trip_across_packages(rel, tmp_path):
    path = os.path.join(DATA_DIR, rel)
    j_model_obj = plssvm_tpu.Model.load(path)
    t_model_obj = plssvm_tpu_torch.Model.load(path)
    j_path, t_path = os.path.join(tmp_path, "j.model"), os.path.join(tmp_path, "t.model")
    j_model_obj.save(j_path)
    t_model_obj.save(t_path)
    # the first line is a creation timestamp
    with open(j_path, "rb") as fj, open(t_path, "rb") as ft:
        assert fj.read().split(b"\n", 1)[1] == ft.read().split(b"\n", 1)[1]
    # each package loads the other's file
    for loaded, original in (
        (plssvm_tpu.Model.load(t_path), t_model_obj),
        (plssvm_tpu_torch.Model.load(j_path), j_model_obj),
    ):
        assert np.array_equal(loaded.alpha, original.alpha)
        assert np.array_equal(loaded.support_vectors, original.support_vectors)
        assert np.array_equal(loaded.data.labels, original.data.labels)
        assert loaded.rho == original.rho
        assert loaded.label_order == original.label_order


@pytest.mark.parametrize("rel", _valid("libsvm") + _valid("arff"))
def test_data_set_with_scaling_identical(rel):
    path = os.path.join(DATA_DIR, rel)
    try:
        j_ds = plssvm_tpu.DataSet(path, scaling=(-1.0, 1.0))
    except plssvm_tpu.PLSSVMError as exc:
        with pytest.raises(plssvm_tpu_torch.PLSSVMError, match=re.escape(str(exc))):
            plssvm_tpu_torch.DataSet(path, scaling=(-1.0, 1.0))
        return
    t_ds = plssvm_tpu_torch.DataSet(path, scaling=(-1.0, 1.0))
    assert np.array_equal(j_ds.data, t_ds.data)
    assert np.array_equal(j_ds.scaling_factors.factors, t_ds.scaling_factors.factors)
    if j_ds.has_labels():
        assert np.array_equal(j_ds.labels, t_ds.labels)
        assert np.array_equal(j_ds.y, t_ds.y)
