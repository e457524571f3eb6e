"""The port's native parser and writer (plssvm_tpu_torch/native) against its
NumPy paths and against plssvm_tpu's I/O, on the CPU.

The library is built here with the machine's g++ into
plssvm_tpu_torch/_build/native/.  Every parse must give the same arrays
and labels through the port's native path, its NumPy path and
plssvm_tpu's parser; every writer the same bytes; every file of the
invalid corpora under tests/data/{libsvm,arff,model}/invalid/ the same
exception type and message.  The two packages' opt-out variables and
build directories are independent.
"""

import glob
import os

import numpy as np
import pytest

import plssvm_tpu.exceptions as j_exc
import plssvm_tpu.io.arff as j_arff
import plssvm_tpu.io.file_reader as j_file_reader
import plssvm_tpu.io.libsvm as j_libsvm
import plssvm_tpu.io.model_file as j_model_file
import plssvm_tpu.native.loader as j_loader
import plssvm_tpu.parameter as j_parameter
import plssvm_tpu_torch.exceptions as t_exc
import plssvm_tpu_torch.io.arff as t_arff
import plssvm_tpu_torch.io.libsvm as t_libsvm
import plssvm_tpu_torch.io.model_file as t_model_file
import plssvm_tpu_torch.native as t_native
import plssvm_tpu_torch.native.loader as t_loader
import plssvm_tpu_torch.parameter as t_parameter

pytestmark = pytest.mark.skipif(
    not t_native.native_available(), reason="no C++ toolchain for the native library"
)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])


@pytest.fixture
def numpy_path(monkeypatch):
    """Within the test, the port's I/O takes its NumPy paths (the native
    entry points answer 'unavailable', as with PLSSVM_TPU_TORCH_NO_NATIVE)."""
    def off():
        for name in ("parse_libsvm_native", "parse_model_svs_native",
                     "parse_arff_data_native"):
            monkeypatch.setattr(t_native, name, lambda *a, **k: None)
        for name in ("write_libsvm_native", "write_model_native", "write_arff_native"):
            monkeypatch.setattr(t_native, name, lambda *a, **k: False)
    return off


def _three_ways(parse, j_parse, path, numpy_path, monkeypatch, **kw):
    """(port native, port NumPy, plssvm_tpu) results of parsing ``path``;
    the native one must have gone through the library."""
    t_loader.reset_counts()
    native = parse(path, **kw)
    assert t_loader.native_parses == 1
    reference = j_parse(path, **kw)
    numpy_path()
    plain = parse(path, **kw)
    monkeypatch.undo()
    return native, plain, reference


def _assert_same(*results):
    first = results[0]
    for other in results[1:]:
        assert len(other) == len(first)
        for a, b in zip(first, other):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def _random_libsvm(path, n=300, d=40, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * 10.0 ** rng.integers(-8, 8, size=(n, d))
    X[rng.random((n, d)) < 0.6] = 0.0
    y = np.where(rng.random(n) < 0.5, "-1", "1") if labels else None
    j_libsvm.write_libsvm_file(path, X, y)


# -- LIBSVM data -------------------------------------------------------------


@DTYPES
@pytest.mark.parametrize("name", ["6x3.libsvm", "6x3_sparse.libsvm",
                                  "6x3_string_labels.libsvm", "3x2_without_label.libsvm",
                                  "random", "random_unlabeled"])
def test_libsvm_parse(name, dtype, tmp_path, numpy_path, monkeypatch):
    if name.startswith("random"):
        path = os.path.join(tmp_path, "r.libsvm")
        _random_libsvm(path, labels=name == "random")
    else:
        path = os.path.join(DATA, "libsvm", name)
    _assert_same(*_three_ways(t_libsvm.parse_libsvm_file, j_libsvm.parse_libsvm_file,
                              path, numpy_path, monkeypatch, dtype=dtype))


def _same_error(parse, j_parse, path, numpy_path, monkeypatch):
    with pytest.raises(t_exc.PLSSVMError) as native:
        parse(path)
    with pytest.raises(j_exc.PLSSVMError) as reference:
        j_parse(path)
    numpy_path()
    with pytest.raises(t_exc.PLSSVMError) as plain:
        parse(path)
    monkeypatch.undo()
    assert type(native.value).__name__ == type(reference.value).__name__
    assert type(plain.value) is type(native.value)
    assert str(native.value) == str(plain.value) == str(reference.value)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(DATA, "libsvm", "invalid", "*"))),
                         ids=os.path.basename)
def test_libsvm_invalid_corpus(path, numpy_path, monkeypatch):
    _same_error(t_libsvm.parse_libsvm_file, j_libsvm.parse_libsvm_file, path,
                numpy_path, monkeypatch)


@pytest.mark.parametrize("index", ["²", "٥", "-5", "1_5", "+3", "0x2", " 2", "3e0"],
                         ids=["superscript", "arabic_indic", "negative", "underscore",
                              "plus", "hex", "space", "exponent"])
def test_index_rule(index, tmp_path, numpy_path, monkeypatch):
    """An index is one optional '+' and ASCII digits, in every path: a
    Unicode digit that str.isdigit() accepts is refused as the C++
    from_chars refuses it, and so is a '-', which plssvm_tpu's native
    parser reads as a signed index (its Python path, the rule's statement,
    refuses it: held against that path)."""
    path = os.path.join(tmp_path, "i.libsvm")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(f"1 1:0.5 {index}:1.5\n-1 1:2.5\n")

    def j_rule(p, **kw):
        return j_libsvm.parse_libsvm_lines(j_file_reader.read_lines(p, comment="#"), **kw)

    try:
        want = j_rule(path)
    except j_exc.PLSSVMError:
        _same_error(t_libsvm.parse_libsvm_file, j_rule, path, numpy_path, monkeypatch)
        return
    native, plain, _ = _three_ways(t_libsvm.parse_libsvm_file, j_rule, path, numpy_path,
                                   monkeypatch)
    _assert_same(native, plain, want)


@pytest.mark.parametrize("labels", ["int", "str", "none"])
def test_libsvm_write(labels, tmp_path, numpy_path, monkeypatch):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(40, 9)) * 10.0 ** rng.integers(-12, 12, size=(40, 9))
    X[rng.random(X.shape) < 0.4] = 0.0
    X[0, :3] = [-0.0, 1e300, 5e-324]
    y = {"int": np.arange(40) % 3 - 1, "str": np.asarray(["a", "bb"] * 20),
         "none": None}[labels]
    paths = [os.path.join(tmp_path, f"{k}.libsvm") for k in ("native", "plain", "ref")]
    t_loader.reset_counts()
    t_libsvm.write_libsvm_file(paths[0], X, y)
    assert t_loader.native_writes == 1
    j_libsvm.write_libsvm_file(paths[2], X, y)
    numpy_path()
    t_libsvm.write_libsvm_file(paths[1], X, y)
    contents = [open(p, "rb").read() for p in paths]
    assert contents[0] == contents[1] == contents[2]


# -- ARFF --------------------------------------------------------------------

_ARFF = {
    "dense_sparse": ("@RELATION t\n@ATTRIBUTE f0 NUMERIC\n@ATTRIBUTE f1 NUMERIC\n"
                     "@ATTRIBUTE f2 NUMERIC\n@ATTRIBUTE class {A,B}\n@DATA\n"
                     "1.0,2.5,-3.0,A\n{0 4.0, 3 B}\n{1 -1.5, 2 2.0, 3 A}\n"
                     "% mid-data comment\n0.0,0.0,1.0,B\n"),
    "unlabeled": ("@RELATION t\n@ATTRIBUTE f0 NUMERIC\n@ATTRIBUTE f1 NUMERIC\n"
                  "@ATTRIBUTE f2 NUMERIC\n@DATA\n1.0,2.0,3.0\n{1 5.0}\n"),
    "class_in_the_middle": ("@RELATION r\n@ATTRIBUTE a NUMERIC\n@ATTRIBUTE class {x,y}\n"
                            "@ATTRIBUTE b NUMERIC\n@DATA\n1.0,x,2.0\n{0 3.0, 1 y, 2 4.0}\n"),
    "label_outside_the_header": ("@RELATION r\n@ATTRIBUTE a NUMERIC\n@ATTRIBUTE class {x,y}\n"
                                 "@DATA\n1.0,x\n2.0,z\n"),
}


@DTYPES
@pytest.mark.parametrize("name", ["6x3.arff", "6x3_sparse.arff", *sorted(_ARFF)])
def test_arff_parse(name, dtype, tmp_path, numpy_path, monkeypatch):
    if name in _ARFF:
        path = os.path.join(tmp_path, "t.arff")
        with open(path, "w") as fh:
            fh.write(_ARFF[name])
    else:
        path = os.path.join(DATA, "arff", name)
    if name == "label_outside_the_header":
        # the native parse runs, finds a label the header lacks and hands
        # the file to the Python path for the reference's message
        _same_error(t_arff.parse_arff_file, j_arff.parse_arff_file, path, numpy_path,
                    monkeypatch)
        return
    _assert_same(*_three_ways(t_arff.parse_arff_file, j_arff.parse_arff_file, path,
                              numpy_path, monkeypatch, dtype=dtype))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(DATA, "arff", "invalid", "*"))),
                         ids=os.path.basename)
def test_arff_invalid_corpus(path, numpy_path, monkeypatch):
    _same_error(t_arff.parse_arff_file, j_arff.parse_arff_file, path, numpy_path,
                monkeypatch)


@pytest.mark.parametrize("labelled", [True, False], ids=["labels", "no_labels"])
def test_arff_write(labelled, tmp_path, numpy_path, monkeypatch):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(40, 6))
    y = np.asarray(["A" if i % 2 == 0 else "B" for i in range(40)]) if labelled else None
    paths = [os.path.join(tmp_path, f"{k}.arff") for k in ("native", "plain", "ref")]
    t_loader.reset_counts()
    t_arff.write_arff_file(paths[0], X, y)
    assert t_loader.native_writes == 1
    j_arff.write_arff_file(paths[2], X, y)
    numpy_path()
    t_arff.write_arff_file(paths[1], X, y)
    contents = [open(p, "rb").read() for p in paths]
    assert contents[0] == contents[1] == contents[2]


# -- model files -------------------------------------------------------------


def _model_arrays(layout, dtype, seed=0, n=60, d=7):
    """(alpha, rho, labels, different_labels) of a ``layout`` model with
    repr edge cases among the alphas."""
    rng = np.random.default_rng(seed)
    classes = {"binary": 2, "oaa": 3, "oao": 4}[layout]
    columns = {"binary": None, "oaa": 3, "oao": 3}[layout]
    alpha = rng.normal(size=n if columns is None else (n, columns)).astype(dtype)
    flat = alpha.reshape(-1)
    flat[:9] = [1.0, -0.0, 1e16, 1e-5, 1e-4, 9999999999999998.0, np.inf, -np.inf, np.nan]
    labels = np.asarray([str(i % classes) for i in range(n)])
    if layout == "binary":
        labels = np.where(labels == "0", "1", "-1")
        return alpha, -0.75, labels, ["1", "-1"]
    n_rho = classes if layout == "oaa" else classes * (classes - 1) // 2
    return alpha, rng.normal(size=n_rho), labels, [str(c) for c in range(classes)]


def _write_models(layout, dtype, tmp_path, numpy_path):
    """The same model written by the port's native writer, its NumPy
    writer and plssvm_tpu's; returns the three paths."""
    rng = np.random.default_rng(3)
    alpha, rho, labels, diff = _model_arrays(layout, dtype)
    sv = rng.normal(size=(len(labels), 7)).astype(dtype)
    sv[rng.random(sv.shape) < 0.3] = 0.0
    paths = [os.path.join(tmp_path, f"{k}.model") for k in ("native", "plain", "ref")]
    kw = dict(kernel_type="polynomial", degree=2, gamma=0.1, coef0=1.5)
    t_loader.reset_counts()
    t_model_file.write_model_file(paths[0], t_parameter.Parameter(**kw), rho, alpha, sv,
                                  labels, diff)
    assert t_loader.native_writes == 1
    j_model_file.write_model_file(paths[2], j_parameter.Parameter(**kw), rho, alpha, sv,
                                  labels, diff)
    numpy_path()
    t_model_file.write_model_file(paths[1], t_parameter.Parameter(**kw), rho, alpha, sv,
                                  labels, diff)
    return paths


LAYOUTS = pytest.mark.parametrize("layout", ["binary", "oaa", "oao"])


@DTYPES
@LAYOUTS
def test_model_write(layout, dtype, tmp_path, numpy_path, monkeypatch):
    """Byte for byte, but for the creation-time comment on the first line."""
    paths = _write_models(layout, dtype, tmp_path, numpy_path)
    contents = [open(p, "rb").read().split(b"\n", 1)[1] for p in paths]
    assert contents[0] == contents[1] == contents[2]


@DTYPES
@LAYOUTS
def test_model_parse(layout, dtype, tmp_path, numpy_path, monkeypatch):
    path = _write_models(layout, np.float64, tmp_path, numpy_path)[2]
    monkeypatch.undo()
    native, plain, reference = _three_ways(t_model_file.parse_model_file,
                                           j_model_file.parse_model_file, path,
                                           numpy_path, monkeypatch, dtype=dtype)
    for got in (native, plain):
        params, rho, sv, alpha, labels, prob, svm_type = got
        assert params.kernel_type.value == reference[0].kernel_type.value
        assert params.degree.value == reference[0].degree.value
        assert params.gamma.value == reference[0].gamma.value
        _assert_same((rho, sv, alpha, labels, prob, svm_type), reference[1:])


def test_model_fixture(numpy_path, monkeypatch):
    path = os.path.join(DATA, "model", "6x3_linear.libsvm.model")
    native, plain, reference = _three_ways(t_model_file.parse_model_file,
                                           j_model_file.parse_model_file, path,
                                           numpy_path, monkeypatch)
    _assert_same(native[1:], plain[1:], reference[1:])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(DATA, "model", "invalid", "*"))),
                         ids=os.path.basename)
def test_model_invalid_corpus(path, numpy_path, monkeypatch):
    _same_error(t_model_file.parse_model_file, j_model_file.parse_model_file, path,
                numpy_path, monkeypatch)


# -- the two packages' libraries ---------------------------------------------


@pytest.fixture
def fresh_loaders(monkeypatch):
    """Both loaders as before their first use; restored afterwards."""
    for loader in (t_loader, j_loader):
        monkeypatch.setattr(loader, "_lib", None)
        monkeypatch.setattr(loader, "_lib_failed", False)
    for var in ("PLSSVM_TPU_NO_NATIVE", "PLSSVM_TPU_TORCH_NO_NATIVE",
                "PLSSVM_TPU_NATIVE_CACHE_DIR", "PLSSVM_TPU_TORCH_NATIVE_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("opt_out", ["PLSSVM_TPU_NO_NATIVE", "PLSSVM_TPU_TORCH_NO_NATIVE"])
def test_each_opt_out_leaves_the_other_package_alone(opt_out, fresh_loaders):
    fresh_loaders.setenv(opt_out, "1")
    port_off = opt_out == "PLSSVM_TPU_TORCH_NO_NATIVE"
    assert t_loader.native_available() is not port_off
    assert j_loader.native_available() is port_off


def test_each_package_builds_into_its_own_directory(fresh_loaders, tmp_path):
    package = os.path.dirname(os.path.dirname(os.path.abspath(t_loader.__file__)))
    assert t_loader._cache_dir() == os.path.join(package, "_build", "native")
    fresh_loaders.setenv("PLSSVM_TPU_NATIVE_CACHE_DIR", str(tmp_path / "reference"))
    assert t_loader._cache_dir() == os.path.join(package, "_build", "native")
    fresh_loaders.setenv("PLSSVM_TPU_TORCH_NATIVE_CACHE_DIR", str(tmp_path / "port"))
    assert t_loader._cache_dir() == str(tmp_path / "port")
    assert j_loader._cache_dir() == str(tmp_path / "reference")
    assert t_loader.native_available()
    built = os.listdir(tmp_path / "port")
    assert len(built) == 1 and built[0].startswith("libsvm_parser_")
    assert not (tmp_path / "reference").exists()


def test_opt_out_takes_the_numpy_path(fresh_loaders, tmp_path):
    fresh_loaders.setenv("PLSSVM_TPU_TORCH_NO_NATIVE", "1")
    path = os.path.join(tmp_path, "r.libsvm")
    _random_libsvm(path)
    t_loader.reset_counts()
    X, labels = t_libsvm.parse_libsvm_file(path)
    t_libsvm.write_libsvm_file(os.path.join(tmp_path, "w.libsvm"), X, labels)
    assert (t_loader.native_parses, t_loader.native_writes) == (0, 0)
    want = j_libsvm.parse_libsvm_file(path)
    np.testing.assert_array_equal(X, want[0])
    assert labels == want[1]
