"""The explicit solver (``solver="cg_explicit"``) of the port against
plssvm_tpu's, in float64 on the CPU.

The mirror of tests/test_explicit.py: the kernel matrix's build against
``plssvm_tpu.solver.explicit.build_kernel_matrix`` for every kernel and at
the bf16 tier's storage; binary and one-vs-all fits, Jacobi, sample
weights and warm start against ``plssvm_tpu.CSVM(backend="xla",
solver="cg_explicit", dtype=np.float64)``; checkpoint segments bit for bit
the uninterrupted explicit fit; ``automatic``'s selection against
plssvm_tpu's ``_use_explicit_solver`` over kind x d x dtype x tier x
budget; the forced over-budget refusal; the ring (``["cpu"] * 4``)
against one device and against plssvm_tpu's four CPU devices, and the
budget per physical device; the kernel matrix cached across C; and
``plssvm-torch-train --solver cg_explicit`` against plssvm_tpu's CLI.
Kernel N's plain version (ops/kernel_matrix.py) is held against a float64
golden on ragged shapes; the kernel itself runs only on the card
(tests/test_torch_cuda.py).

Tolerances: the build to 1e-12 (float64; the same formulas in the same
order, the Gram product's sums in another order), the bf16 storage to one
bf16 rounding (2^-8 relative) plus 1e-6; fits at epsilon 1e-10 with the
same iteration count, rho within 1e-8 and alpha within 1e-8 (as
tests/test_torch_csvm.py; plssvm_tpu pads K to 128 rows and sums its
products in another order, and CG carries that rounding).  The fits keep to
sets where plssvm_tpu's own explicit and implicit fits agree on the
iteration count (ROADMAP Queue 3 item 4).
"""

import ctypes
import os
import re
import types
import weakref

import jax
import numpy as np
import pytest
import torch

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu.cli import train as j_train_cli
from plssvm_tpu.solver.explicit import build_kernel_matrix as j_build
from plssvm_tpu_torch import csvm as t_csvm
from plssvm_tpu_torch.cli import train as t_train_cli
from plssvm_tpu_torch.exceptions import InvalidParameterError
from plssvm_tpu_torch.ops import _build, kernel_matrix
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind
from plssvm_tpu_torch.solver import explicit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-10
TOL = 1e-8
BUILD_TOL = 1e-12
ALL_KERNELS = ["linear", "polynomial", "rbf", "sigmoid", "laplacian", "chi_squared"]
#: kernels whose fits on ``_data`` plssvm_tpu's explicit and implicit
#: solves agree on (the iteration count and rho to 1e-8)
FIT_KERNELS = ["rbf", "polynomial", "laplacian", "chi_squared", "linear"]
#: per extra and class count, a seed of ``_data`` where plssvm_tpu's
#: explicit and implicit fits take the same iterations (on seeds 4-11 each
#: extra has one or two where they differ by one or two)
EXTRAS_SEED = {("jacobi", 2): 5, ("jacobi", 3): 7, ("weight", 2): 4, ("weight", 3): 9,
               ("warm", 2): 4, ("warm", 3): 9}


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def _data(kernel="rbf", n_classes=2, seed=4, n=200, d=10):
    """Seeded blobs scaled to [-1, 1] ([0, 1] for chi-squared)."""
    rng = np.random.default_rng(seed)
    if n_classes == 2:
        y = np.where(rng.random(n) < 0.5, -1, 1)
        X = rng.normal(size=(n, d)) + 0.4 * y[:, None]
    else:
        y = rng.integers(0, n_classes, n)
        X = rng.normal(size=(n, d)) + rng.normal(size=(n_classes, d))[y]
    scaling = (0.0, 1.0) if kernel == "chi_squared" else (-1.0, 1.0)
    return X, y, scaling


def _datasets(kernel, n_classes=2, seed=4):
    X, y, scaling = _data(kernel, n_classes, seed)
    return (plssvm_tpu_torch.DataSet(X, y, scaling=scaling),
            plssvm_tpu.DataSet(X, y, scaling=scaling))


def _fit_both(kernel, n_classes=2, svm_kwargs=None, fit_kwargs=None, seed=4,
              t_where=None):
    """The port's and plssvm_tpu's explicit fits of ``_data``;
    ``initial_model="warm"`` warm-starts each from its own 1e-4 fit."""
    t_train, j_train = _datasets(kernel, n_classes, seed)
    models = []
    for package, train, where in (
            (plssvm_tpu_torch, t_train, t_where or dict(device="cpu")),
            (plssvm_tpu, j_train, dict(backend="xla"))):
        svm = package.CSVM(dtype=np.float64, kernel_type=kernel, solver="cg_explicit",
                           **where, **(svm_kwargs or {}))
        kw = dict(fit_kwargs or {})
        if kw.get("initial_model") == "warm":
            kw["initial_model"] = svm.fit(train, epsilon=1e-4)
        models.append(svm.fit(train, epsilon=EPS, **kw))
    return models


def _assert_same_fit(got, want, tol=TOL):
    assert got.n_iter == want.n_iter
    assert np.abs(np.asarray(got.rho) - np.asarray(want.rho)).max() <= tol
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=0, atol=tol)


# -- the build --------------------------------------------------------------


def _build_inputs(kernel, m=17, d=5, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, d))
    return np.abs(X) if kernel == "chi_squared" else X


class TestBuildKernelMatrix:
    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    @pytest.mark.parametrize("kernel", ALL_KERNELS)
    def test_matches_the_reference_build(self, kernel, impl):
        """float64, both backends (on CPU tensors "cuda" takes the plain
        versions): plssvm_tpu's matrix to 1e-12."""
        X = _build_inputs(kernel)
        kind = TKind.from_string(kernel)
        got = explicit.build_kernel_matrix(torch.as_tensor(X), 0.3, 0.5, kind=kind,
                                           degree=2, impl=impl)
        want = np.asarray(j_build(jax.numpy.asarray(X), jax.numpy.float64(0.3),
                                  jax.numpy.float64(0.5),
                                  kind=plssvm_tpu.KernelFunctionType.from_string(kernel),
                                  degree=2))
        assert got.shape == (17, 17) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=BUILD_TOL, atol=1e-14)

    @pytest.mark.parametrize("kernel", ["polynomial", "rbf", "sigmoid", "laplacian",
                                        "chi_squared"])
    def test_bf16_storage(self, kernel):
        """"bf16" stores K in bfloat16 (float32 X, ``impl="torch"``, which
        keeps full-precision operands as plssvm_tpu's XLA build does): within
        one bf16 rounding of plssvm_tpu's bf16 matrix."""
        X = _build_inputs(kernel, m=32, d=4, seed=3).astype(np.float32)
        kind = TKind.from_string(kernel)
        got = explicit.build_kernel_matrix(torch.as_tensor(X), 0.5, 0.5, kind=kind,
                                           degree=2, precision="bf16", impl="torch")
        want = j_build(jax.numpy.asarray(X), jax.numpy.float32(0.5), jax.numpy.float32(0.5),
                       kind=plssvm_tpu.KernelFunctionType.from_string(kernel), degree=2,
                       precision="bf16")
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
        want = np.asarray(want.astype(jax.numpy.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=1e-6)

    @pytest.mark.parametrize("kernel", ["polynomial", "rbf", "sigmoid"])
    def test_bf16_tier_operands(self, kernel):
        """The cuda backend's "bf16" tier on CPU tensors (the plain version
        at the tier): the Gram product of bf16-rounded X with the unrounded
        squared norms, stored in bfloat16; held against a float64 golden of
        the same, to one bf16 rounding."""
        X = _build_inputs(kernel, m=40, d=6, seed=5).astype(np.float32)
        kind = TKind.from_string(kernel)
        got = explicit.build_kernel_matrix(torch.as_tensor(X), 0.5, 0.5, kind=kind,
                                           degree=2, precision="bf16", impl="cuda")
        Xr = torch.as_tensor(X).to(torch.bfloat16).double()
        sq = torch.as_tensor(X).double().pow(2).sum(-1)
        gram = Xr @ Xr.T
        if kind == TKind.RBF:
            golden = torch.exp(-0.5 * (sq[:, None] + sq[None, :] - 2 * gram))
        elif kind == TKind.POLYNOMIAL:
            golden = (0.5 * gram + 0.5) ** 2
        else:
            golden = torch.tanh(0.5 * gram + 0.5)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.double().numpy(), golden.numpy(),
                                   rtol=2.0 ** -8, atol=1e-6)

    @pytest.mark.parametrize("precision", ["f32", "highest", "bf16"])
    def test_the_tf32_flag_is_restored(self, precision):
        """The Gram build and the product switch TF32 only inside their
        block: the global flag is the caller's after both."""
        X = torch.as_tensor(_build_inputs("rbf", m=20, d=3).astype(np.float32))
        previous = torch.backends.cuda.matmul.allow_tf32
        try:
            for flag in (True, False):
                torch.backends.cuda.matmul.allow_tf32 = flag
                K = explicit.build_kernel_matrix(X, 0.5, 0.0, kind=TKind.RBF, degree=3,
                                                 precision=precision)
                explicit.explicit_product(K, X[:, 0], torch.float32)
                assert torch.backends.cuda.matmul.allow_tf32 is flag
        finally:
            torch.backends.cuda.matmul.allow_tf32 = previous

    def test_gram_build_in_row_blocks(self, monkeypatch):
        """A build of several row blocks equals the build in one."""
        X = torch.as_tensor(_build_inputs("rbf", m=50, d=7))
        whole = explicit.build_kernel_matrix(X, 0.2, 0.0, kind=TKind.RBF, degree=3)
        monkeypatch.setattr(explicit, "BUILD_BLOCK_BYTES", 7 * 50 * 8)
        assert explicit._rows_per_block(50, 8) == 7
        blocked = explicit.build_kernel_matrix(X, 0.2, 0.0, kind=TKind.RBF, degree=3)
        torch.testing.assert_close(blocked, whole, rtol=0, atol=1e-15)


# -- kernel N's plain version and its entry points ---------------------------


def _distance_golden(A, B, kind, gamma):
    diff = A[:, None, :] - B[None, :, :]
    if kind == TKind.LAPLACIAN:
        dist = np.abs(diff).sum(-1)
    else:
        den = A[:, None, :] + B[None, :, :]
        dist = np.divide(diff * diff, den, out=np.zeros_like(den), where=den != 0).sum(-1)
    return np.exp(-gamma * dist)


class TestKernelN:
    @pytest.mark.parametrize("shape", [(1, 1, 3), (70, 131, 5), (300, 257, 33)])
    @pytest.mark.parametrize("kernel", ["laplacian", "chi_squared"])
    def test_plain_against_a_golden(self, kernel, shape):
        """The plain version, several of its row blocks and ragged shapes
        included, against numpy in float64 (zero-rich rows: chi-squared's
        0/0 terms); the symmetric build is exactly symmetric with a unit
        diagonal."""
        mr, mc, d = shape
        rng = np.random.default_rng(mr + mc + d)
        Xr, Xc = rng.random((mr, d)), rng.random((mc, d))
        Xr[Xr < 0.4] = 0.0
        Xc[Xc < 0.4] = 0.0
        kind = TKind.from_string(kernel)
        gamma = 1.0 / d
        rect = kernel_matrix.kernel_matrix_rect(torch.as_tensor(Xr), torch.as_tensor(Xc),
                                                kind=kind, gamma=gamma)
        np.testing.assert_allclose(rect.numpy(), _distance_golden(Xr, Xc, kind, gamma),
                                   rtol=1e-13, atol=0)
        sym = kernel_matrix.kernel_matrix_sym(torch.as_tensor(Xr), kind=kind, gamma=gamma)
        assert torch.equal(sym, sym.T)
        assert torch.equal(sym.diagonal(), torch.ones(mr, dtype=torch.float64))
        np.testing.assert_allclose(sym.numpy(), _distance_golden(Xr, Xr, kind, gamma),
                                   rtol=1e-13, atol=0)

    def test_cpu_tensors_take_the_plain_version(self):
        X = torch.rand(20, 4, dtype=torch.float64)
        kernel_matrix.reset_counts()
        kernel_matrix.kernel_matrix_sym(X, kind=TKind.LAPLACIAN, gamma=0.5)
        kernel_matrix.kernel_matrix_rect(X, X[:5], kind=TKind.CHI_SQUARED, gamma=0.5,
                                         out_dtype=torch.bfloat16)
        assert (kernel_matrix.sym_launches, kernel_matrix.rect_launches,
                kernel_matrix.plain_calls) == (0, 0, 2)

    def test_storage_types(self):
        X = torch.rand(9, 3, dtype=torch.float32)
        assert kernel_matrix.kernel_matrix_sym(
            X, kind=TKind.LAPLACIAN, gamma=0.5, out_dtype=torch.bfloat16).dtype == torch.bfloat16
        with pytest.raises(TypeError, match="bfloat16"):
            kernel_matrix.kernel_matrix_sym(X, kind=TKind.LAPLACIAN, gamma=0.5,
                                            out_dtype=torch.float64)
        with pytest.raises(ValueError, match="laplacian or chi_squared"):
            kernel_matrix.kernel_matrix_sym(X, kind=TKind.RBF, gamma=0.5)

    @pytest.mark.parametrize("name", [
        "plssvm_kernel_matrix_sym_f32", "plssvm_kernel_matrix_sym_f64",
        "plssvm_kernel_matrix_rect_f32", "plssvm_kernel_matrix_rect_f64",
    ])
    def test_entry_points_argtypes_match_the_source(self, monkeypatch, name):
        """What _build.load() declares for kernel N's entry points is their C
        signature, parameter by parameter: a 32-bit size would cut m^2 past
        INT32_MAX silently."""
        c_types = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
                   "float": ctypes.c_float, "double": ctypes.c_double}
        source = open(os.path.join(REPO, "plssvm_tpu_torch", "csrc",
                                   "kernel_matrix.cu")).read()
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', source).group(1)
        want = [ctypes.c_void_p if "*" in p else c_types[p.split()[-2]]
                for p in (" ".join(q.split()) for q in params.split(","))]

        class FakeLibrary:
            def __getattr__(self, attr):
                fn = types.SimpleNamespace()
                setattr(self, attr, fn)
                return fn

        monkeypatch.setattr(_build, "_lib", None)
        monkeypatch.setattr(_build, "build", lambda: (None, 0.0))
        monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLibrary())
        lib = _build.load()
        assert getattr(lib, name).argtypes == want
        assert getattr(lib, name).restype is ctypes.c_int

    def test_kernel_resources_names_kernel_n(self, tmp_path, monkeypatch):
        library = tmp_path / "lib.so"
        (tmp_path / "lib.so.ptxas.txt").write_text(
            "ptxas info    : Compiling entry function "
            "'_ZN12_GLOBAL__N_124kernel_matrix_sym_kernelIffLi5EEEvPKT_PT0_llS2_' "
            "for 'sm_90a'\n"
            "ptxas info    : Used 56 registers, 8320 bytes smem, 400 bytes cmem[0]\n"
            "ptxas info    : Compiling entry function "
            "'_ZN12_GLOBAL__N_125kernel_matrix_rect_kernelId13__nv_bfloat16Li4EEEvPKT_S4_"
            "PT0_lllS2_' for 'sm_90a'\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 90 registers, 16640 bytes smem, 408 bytes cmem[0]\n",
            encoding="utf-8")
        monkeypatch.setattr(_build, "library_path", lambda: library)
        resources = _build.kernel_resources()
        assert resources["kernel_matrix_rect f64 laplacian bf16"] == {
            "spill_bytes": 0, "registers": 90, "smem_bytes": 16640}
        assert resources["kernel_matrix_sym f32 chi_squared"]["registers"] == 56


# -- the product ------------------------------------------------------------


class TestExplicitProduct:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("columns", [0, 3])
    def test_bf16_matrix_sums_in_the_solve_type(self, dtype, columns, monkeypatch):
        """A bfloat16 K contracts v rounded to bfloat16 with sums in the
        solve's type, never rounded to bfloat16 (row blocks of 5 rows)."""
        monkeypatch.setattr(explicit, "BUILD_BLOCK_BYTES", 5 * 23 * 8)
        gen = torch.Generator().manual_seed(3)
        K = torch.rand(23, 23, generator=gen, dtype=torch.float64).to(torch.bfloat16)
        V = torch.randn((23, columns) if columns else (23,), generator=gen,
                        dtype=torch.float64).to(dtype)
        got = explicit.explicit_product(K, V, dtype)
        golden = K.double() @ V.to(torch.bfloat16).double()
        assert got.dtype == dtype and got.shape == V.shape
        tol = 1e-5 if dtype == torch.float32 else 1e-13
        torch.testing.assert_close(got.double(), golden, rtol=tol, atol=tol)

    @pytest.mark.parametrize("m", [1, 7, 8, 23])
    @pytest.mark.parametrize("columns", [0, 3])
    @pytest.mark.parametrize("symmetric", [False, True])
    def test_float32_matrix_in_slices(self, m, columns, symmetric, monkeypatch):
        """A float32 K is contracted PRODUCT_COLUMNS columns at a time, or,
        symmetric, PRODUCT_ROWS rows at a time (here 4, so 1-6 slices, the
        last one ragged), the partials summed in float32: the product of K
        as it is, against float64, contiguous and of V's shape."""
        monkeypatch.setattr(explicit, "PRODUCT_ROWS", 4)
        monkeypatch.setattr(explicit, "PRODUCT_COLUMNS", 4)
        gen = torch.Generator().manual_seed(m)
        K = torch.rand(m, m, generator=gen)
        if symmetric:
            K = (K + K.T) / 2
        V = torch.randn((m, columns) if columns else (m,), generator=gen)
        got = explicit.explicit_product(K, V, torch.float32, symmetric=symmetric)
        golden = K.double() @ V.double()
        assert got.dtype == torch.float32 and got.shape == V.shape and got.is_contiguous()
        torch.testing.assert_close(got.double(), golden, rtol=1e-6, atol=1e-6)

    def test_rectangular_block_in_column_slices(self, monkeypatch):
        """A ring's row block K_p (rows < columns) in column slices."""
        monkeypatch.setattr(explicit, "PRODUCT_COLUMNS", 4)
        gen = torch.Generator().manual_seed(9)
        K = torch.rand(5, 13, generator=gen)
        V = torch.randn(13, 3, generator=gen)
        got = explicit.explicit_product(K, V, torch.float32)
        torch.testing.assert_close(got.double(), K.double() @ V.double(), rtol=1e-6,
                                   atol=1e-6)

    def test_stored_matrix_in_its_type(self):
        K = torch.rand(11, 11, dtype=torch.float64)
        v = torch.rand(11, dtype=torch.float64)
        assert torch.equal(explicit.explicit_product(K, v, torch.float64), K @ v)


# -- fits against plssvm_tpu's explicit fits --------------------------------


class TestExplicitSolveParity:
    @pytest.mark.parametrize("kernel", FIT_KERNELS)
    def test_binary(self, kernel):
        _assert_same_fit(*_fit_both(kernel))

    @pytest.mark.parametrize("kernel", ["rbf", "laplacian", "chi_squared"])
    def test_one_vs_all(self, kernel):
        got, want = _fit_both(kernel, n_classes=3, seed=7)
        _assert_same_fit(got, want)

    @pytest.mark.parametrize("backend", ["cuda", "torch"])
    def test_both_backends(self, backend):
        """The cuda backend on CPU tensors (kernel N's plain version) and the
        torch backend give the same explicit fit."""
        got, want = _fit_both("laplacian", t_where=dict(device="cpu", backend=backend))
        _assert_same_fit(got, want)

    def test_matches_the_implicit_fit(self):
        """On the port itself: explicit and implicit fits of one set agree."""
        train, _ = _datasets("rbf")
        fits = [plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, solver=s).fit(
            train, epsilon=EPS) for s in ("cg_explicit", "cg_implicit")]
        _assert_same_fit(*fits)

    @pytest.mark.parametrize("n_classes", [2, 3])
    def test_jacobi(self, n_classes):
        got, want = _fit_both("rbf", n_classes, dict(preconditioner="jacobi"),
                              seed=EXTRAS_SEED[("jacobi", n_classes)])
        _assert_same_fit(got, want)

    @pytest.mark.parametrize("n_classes", [2, 3])
    def test_sample_weight(self, n_classes):
        weights = np.random.default_rng(5).uniform(0.5, 2.0, 200)
        got, want = _fit_both("rbf", n_classes, fit_kwargs=dict(sample_weight=weights),
                              seed=EXTRAS_SEED[("weight", n_classes)])
        _assert_same_fit(got, want)

    @pytest.mark.parametrize("n_classes", [2, 3])
    def test_warm_start(self, n_classes):
        got, want = _fit_both("rbf", n_classes, fit_kwargs=dict(initial_model="warm"),
                              seed=EXTRAS_SEED[("warm", n_classes)])
        _assert_same_fit(got, want)

    @pytest.mark.parametrize("n_classes", [2, 3])
    def test_checkpoint_segments_bit_identical(self, n_classes, tmp_path):
        """A fit in segments of 3 iterations equals the uninterrupted
        explicit fit bit for bit, and builds K once."""
        train, _ = _datasets("laplacian", n_classes, seed=4 if n_classes == 2 else 7)
        svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="laplacian",
                                    solver="cg_explicit")
        plain = svm.fit(train, epsilon=EPS)
        train._k_cache = None
        plssvm_tpu_torch.global_tracker.clear()
        segmented = svm.fit(train, epsilon=EPS, checkpoint_path=str(tmp_path / "cg.ckpt"),
                            checkpoint_interval=3)
        builds = [v for n, v in plssvm_tpu_torch.global_tracker.entries()["cg"]
                  if n == "kernel_matrix_build_time"]
        assert len(builds) == 1 and builds[0] > 0.0
        assert segmented.n_iter == plain.n_iter
        assert np.array_equal(segmented.alpha, plain.alpha)
        assert np.array_equal(np.asarray(segmented.rho), np.asarray(plain.rho))


# -- the selection -----------------------------------------------------------


def _resolve_both(kernel, d, dtype, tier, dept=255):
    """(port, plssvm_tpu) resolutions of ``automatic`` on one CPU device.
    dept = 255 pads to 256 rows in plssvm_tpu, so the two count K within 1 %
    of each other; the budgets of the test sit far from either."""
    kind = TKind.from_string(kernel)
    t_svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=dtype, gram_precision=tier,
                                  kernel_type=kernel)
    j_svm = plssvm_tpu.CSVM(backend="xla", dtype=dtype, gram_precision=tier,
                            kernel_type=kernel)
    return (t_svm._use_explicit_solver(dept, d, kind, 1),
            j_svm._use_explicit_solver(dept, d, plssvm_tpu.KernelFunctionType.from_string(
                kernel), 1))


class TestSolverSelection:
    @pytest.mark.parametrize("budget", [None, "1000", str(1 << 40)])
    @pytest.mark.parametrize("kernel", ALL_KERNELS)
    def test_automatic_rules(self, kernel, budget, monkeypatch):
        """``automatic`` resolves on the CPU as plssvm_tpu's XLA backend
        does, over d x dtype x tier, under the default budget (6 GiB), one
        that nothing fits and one that everything fits (both packages' env
        overrides set alike)."""
        for env in ("PLSSVM_TPU_TORCH_EXPLICIT_BUDGET", "PLSSVM_TPU_EXPLICIT_BUDGET"):
            if budget is None:
                monkeypatch.delenv(env, raising=False)
            else:
                monkeypatch.setenv(env, budget)
        for d in (8, 255, 256, 511, 512, 1024):
            for dtype in (np.float32, np.float64):
                for tier in ("f32", "bf16", "highest"):
                    got, want = _resolve_both(kernel, d, dtype, tier)
                    assert got == want, (d, dtype, tier)

    @pytest.mark.parametrize("cached", [0, 3 << 30])
    def test_the_cuda_budget_counts_what_is_held(self, cached, monkeypatch):
        """On a CUDA device the budget is the card's memory less the live
        tensors there, other than the matrix cached on the fit's data set
        (reused or freed by the fit), less X, the CG vectors, the build's
        workspace and the context's reserve.  The card is faked."""
        monkeypatch.delenv("PLSSVM_TPU_TORCH_EXPLICIT_BUDGET", raising=False)
        total, held = 80 << 30, 20 << 30
        dev = torch.device("cuda", 0)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device: types.SimpleNamespace(total_memory=total))
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: held)
        train, _ = _datasets("rbf")
        if cached:
            fake_k = types.SimpleNamespace(device=dev, numel=lambda: cached // 4,
                                           element_size=lambda: 4)
            train._k_cache = (("a key",), fake_k)
        svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float32)
        dept, d, columns = 1000, 10, 3
        want = (total - held + cached - (dept + 1) * d * 4 - t_csvm.CG_VECTORS * dept * columns * 4
                - explicit.BUILD_WORKSPACE_BYTES - t_csvm.CUDA_CONTEXT_BYTES)
        assert svm._explicit_budget(dev, dept, d, columns, train) == want

    def test_the_cpu_budget_is_the_reference_default(self, monkeypatch):
        monkeypatch.delenv("PLSSVM_TPU_TORCH_EXPLICIT_BUDGET", raising=False)
        svm = plssvm_tpu_torch.CSVM(device="cpu")
        assert svm._explicit_budget(torch.device("cpu"), 100, 10, 1) == 6 << 30

    @pytest.mark.parametrize("tier,itemsize", [("f32", 8), ("highest", 8), ("bf16", 2)])
    def test_matrix_bytes(self, tier, itemsize):
        svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, gram_precision=tier)
        assert svm._explicit_k_bytes(300, 300) == 300 * 300 * itemsize

    def test_forced_over_budget_raises(self, monkeypatch):
        monkeypatch.setenv("PLSSVM_TPU_TORCH_EXPLICIT_BUDGET", "1000")
        monkeypatch.setenv("PLSSVM_TPU_EXPLICIT_BUDGET", "1000")
        train, j_train = _datasets("rbf")
        with pytest.raises(InvalidParameterError, match="over the 1000-byte budget"):
            plssvm_tpu_torch.CSVM(device="cpu", solver="cg_explicit").fit(train)
        with pytest.raises(plssvm_tpu.exceptions.InvalidParameterError, match="budget"):
            plssvm_tpu.CSVM(backend="xla", solver="cg_explicit").fit(j_train)

    def test_automatic_over_budget_is_implicit(self, monkeypatch):
        monkeypatch.setenv("PLSSVM_TPU_TORCH_EXPLICIT_BUDGET", "1000")
        train, _ = _datasets("laplacian")
        plssvm_tpu_torch.global_tracker.clear()
        plssvm_tpu_torch.CSVM(device="cpu", kernel_type="laplacian").fit(train)
        assert ("solver", "cg_implicit") in plssvm_tpu_torch.global_tracker.entries()["cg"]

    @pytest.mark.parametrize("solver,kernel,resolved", [
        ("automatic", "laplacian", "cg_explicit"), ("automatic", "rbf", "cg_implicit"),
        ("cg_explicit", "linear", "cg_explicit"), ("cg_implicit", "chi_squared",
                                                   "cg_implicit"),
    ])
    def test_the_choice_is_kept_and_resolved_per_fit(self, solver, kernel, resolved):
        """``solver`` keeps the caller's choice; each fit records the solver
        it resolved to, and the explicit one its build time."""
        train, _ = _datasets(kernel)
        svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type=kernel,
                                    solver=solver)
        plssvm_tpu_torch.global_tracker.clear()
        svm.fit(train, epsilon=1e-3)
        assert svm.solver == solver
        entries = dict(plssvm_tpu_torch.global_tracker.entries()["cg"])
        assert entries["solver"] == resolved
        assert ("kernel_matrix_build_time" in entries) == (resolved == "cg_explicit")

    def test_gram_crossover_on_cuda_is_this_card_s(self):
        """On a CUDA device the Gram crossover comes from the table measured
        on the card, by tier, float64 at every tier."""
        svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64)
        svm.device = torch.device("cuda", 0)
        assert svm._gram_crossover() == t_csvm.GRAM_CROSSOVER_CUDA["f64"][0]
        svm = plssvm_tpu_torch.CSVM(device="cpu", gram_precision="bf16")
        svm.device = torch.device("cuda", 0)
        assert svm._gram_crossover(10) == t_csvm.GRAM_CROSSOVER_CUDA["bf16"][1]
        assert svm._gram_crossover(1) == t_csvm.GRAM_CROSSOVER_CUDA["bf16"][0]

    @pytest.mark.parametrize("tier", ["f32", "bf16", "highest", "f64"])
    def test_gram_rule_on_cuda_by_class_count(self, tier, monkeypatch):
        """``automatic`` on a CUDA device takes the explicit solver for an
        RBF fit from the tier's crossover on (never where it is None): the
        binary one for one right-hand side, the one-vs-all one for 3, 4 or
        10 (the device is faked, the budget set past any K)."""
        monkeypatch.setenv("PLSSVM_TPU_TORCH_EXPLICIT_BUDGET", str(1 << 50))
        dtype = np.float64 if tier == "f64" else np.float32
        svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=dtype, kernel_type="rbf",
                                    gram_precision="f32" if tier == "f64" else tier)
        svm.device = torch.device("cuda", 0)
        for columns in (1, 3, 4, 10):
            crossover = t_csvm.GRAM_CROSSOVER_CUDA[tier][0 if columns == 1 else 1]
            for d in (16, 64, 128, 256, 512, 1024, 4096):
                want = crossover is not None and d >= crossover
                assert svm._use_explicit_solver(1000, d, TKind.RBF, 1, columns) is want


# -- the ring ----------------------------------------------------------------


class TestRing:
    @pytest.mark.parametrize("kernel,n_classes", [("rbf", 2), ("laplacian", 2),
                                                  ("chi_squared", 3)])
    def test_against_the_reference_ring_and_one_device(self, kernel, n_classes):
        """Four shards on one CPU against plssvm_tpu's explicit fit on four
        CPU devices and against the port's one-device explicit fit."""
        seed = 4 if n_classes == 2 else 7
        t_train, j_train = _datasets(kernel, n_classes, seed)
        ring = plssvm_tpu_torch.CSVM(devices=["cpu"] * 4, dtype=np.float64, kernel_type=kernel,
                                     solver="cg_explicit")
        one = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type=kernel,
                                    solver="cg_explicit")
        j_svm = plssvm_tpu.CSVM(backend="xla", dtype=np.float64, kernel_type=kernel,
                                solver="cg_explicit", devices=jax.devices("cpu")[:4])
        got = ring.fit(t_train, epsilon=EPS)
        assert len(t_train._k_cache[1]) == 4
        _assert_same_fit(got, j_svm.fit(j_train, epsilon=EPS))
        _assert_same_fit(got, one.fit(plssvm_tpu_torch.DataSet(*_data(kernel, n_classes, seed)[:2],
                                                               scaling=_data(kernel)[2]),
                                      epsilon=EPS))

    def test_the_budget_is_per_physical_device(self, monkeypatch):
        """Four shards on one CPU hold all of K there: a budget between a
        quarter of K and K refuses the forced explicit fit (plssvm_tpu, on four
        devices, counts a quarter) and takes the implicit one for
        ``automatic``; two CPUs named apart would hold half each."""
        train, _ = _datasets("laplacian")
        k_bytes = 199 * 199 * 8
        monkeypatch.setenv("PLSSVM_TPU_TORCH_EXPLICIT_BUDGET", str(k_bytes // 2))
        forced = plssvm_tpu_torch.CSVM(devices=["cpu"] * 4, dtype=np.float64,
                                       kernel_type="laplacian", solver="cg_explicit")
        with pytest.raises(InvalidParameterError, match=f"needs {k_bytes} bytes per device"):
            forced.fit(train)
        svm = plssvm_tpu_torch.CSVM(devices=["cpu"] * 4, dtype=np.float64,
                                    kernel_type="laplacian")
        assert not svm._use_explicit_solver(199, 10, TKind.LAPLACIAN, 4)
        per_device = svm._explicit_bytes_per_device(199, 4)
        assert per_device == {torch.device("cpu"): k_bytes}

    def test_row_blocks_of_the_ring(self):
        """The ring's row blocks K_p = k(X_p, X) are the rows of the whole
        matrix, and the product concatenates their products."""
        from plssvm_tpu_torch.parallel import sharded

        X = torch.as_tensor(_build_inputs("chi_squared", m=29, d=4))
        whole = explicit.build_kernel_matrix(X, 0.3, 0.0, kind=TKind.CHI_SQUARED, degree=3)
        blocks = sharded.build_sharded_kernel_matrix(X, ["cpu"] * 3, 0.3, 0.0,
                                                     kind=TKind.CHI_SQUARED, degree=3)
        assert [b.shape for b in blocks] == [(10, 29), (10, 29), (9, 29)]
        torch.testing.assert_close(torch.cat(blocks), whole, rtol=0, atol=0)
        v = torch.rand(29, dtype=torch.float64)
        product = sharded._explicit_sharded_product(blocks)
        torch.testing.assert_close(product(X, None, v, 0.3, 0.0), whole @ v,
                                   rtol=1e-15, atol=1e-14)


# -- the kernel-matrix cache ---------------------------------------------------


class TestCache:
    def test_reused_across_c(self):
        """A second fit with another C takes K from the data set's cache
        (build time 0.0) and equals a fit from a fresh data set."""
        train, _ = _datasets("chi_squared")
        svm = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="chi_squared")
        svm.fit(train, epsilon=EPS)
        cached = train._k_cache[1]
        svm.set_params(cost=3.0)
        plssvm_tpu_torch.global_tracker.clear()
        again = svm.fit(train, epsilon=EPS)
        assert dict(plssvm_tpu_torch.global_tracker.entries()["cg"])[
            "kernel_matrix_build_time"] == 0.0
        assert train._k_cache[1] is cached
        fresh = svm.fit(_datasets("chi_squared")[0], epsilon=EPS)
        assert again.n_iter == fresh.n_iter
        assert np.array_equal(again.alpha, fresh.alpha)

    @pytest.mark.parametrize("change", [dict(gamma=0.5), dict(gram_precision="bf16"),
                                        dict(dtype=np.float32), dict(backend="cuda")])
    def test_key_holds_what_k_depends_on(self, change):
        train, _ = _datasets("rbf")
        base = dict(device="cpu", dtype=np.float64, kernel_type="rbf", solver="cg_explicit",
                    backend="torch")
        plssvm_tpu_torch.CSVM(**base).fit(train, epsilon=1e-3)
        first = train._k_cache
        plssvm_tpu_torch.CSVM(**{**base, **change}).fit(train, epsilon=1e-3)
        assert train._k_cache[0] != first[0]

    @pytest.mark.parametrize("kernel", ["rbf", "laplacian"])
    def test_previous_matrix_freed_before_the_build(self, kernel, monkeypatch):
        """A fit with another key (a sweep over gamma) drops the cached
        matrix before it builds the next, so that the two never live at
        once: the old K is gone when ``build_kernel_matrix`` is entered."""
        train, _ = _datasets(kernel)
        base = dict(device="cpu", dtype=np.float64, kernel_type=kernel, solver="cg_explicit")
        plssvm_tpu_torch.CSVM(**base).fit(train, epsilon=1e-3)
        old = weakref.ref(train._k_cache[1])
        seen = []

        def build(*args, **kwargs):
            seen.append(old())
            return explicit.build_kernel_matrix(*args, **kwargs)

        monkeypatch.setattr(t_csvm, "build_kernel_matrix", build)
        plssvm_tpu_torch.CSVM(gamma=0.5, **base).fit(train, epsilon=1e-3)
        assert seen == [None]
        assert train._k_cache[0][1] == 0.5


# -- the CLI -----------------------------------------------------------------


@pytest.mark.parametrize("kernel_flag", ["2", "4"])
def test_cli_against_the_reference(kernel_flag, tmp_path):
    """``plssvm-torch-train --solver cg_explicit`` against plssvm_tpu's
    ``plssvm-train -b xla --solver cg_explicit``: the same model to 1e-8."""
    X, y, scaling = _data()
    train_file = os.path.join(tmp_path, "train.libsvm")
    plssvm_tpu_torch.DataSet(X, y, scaling=scaling).save(train_file)
    common = ["-t", kernel_flag, "-e", str(EPS), "--use_double_as_real_type", "-q",
              "--solver", "cg_explicit"]
    j_model_file = os.path.join(tmp_path, "j.model")
    t_model_file = os.path.join(tmp_path, "t.model")
    assert j_train_cli.main(common + ["-b", "xla", train_file, j_model_file]) == 0
    plssvm_tpu_torch.global_tracker.clear()
    assert t_train_cli.main(common + ["-b", "torch", "-p", "cpu", train_file,
                                      t_model_file]) == 0
    assert ("solver", "cg_explicit") in plssvm_tpu_torch.global_tracker.entries()["cg"]
    j_model = plssvm_tpu.Model.load(j_model_file)
    t_model = plssvm_tpu_torch.Model.load(t_model_file)
    assert abs(t_model.rho - j_model.rho) <= TOL
    np.testing.assert_allclose(t_model.alpha, j_model.alpha, rtol=0, atol=TOL)


def test_bench_kernel_matrix_on_the_cpu(capsys):
    """The kernel-N tool on the CPU: one line per cell at a hundredth of the
    rows, the plain version against itself (rel_err 0), K symmetric;
    without a GPU and without ``--cpu`` it refuses to run."""
    import json

    from plssvm_tpu_torch.tools import bench_kernel_matrix

    assert bench_kernel_matrix.main(["--cpu", "--repeats", "1"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["kind"], r["m"], r["d"]) for r in rows] == [
        (kind, m // 100, d) for kind, m, d in bench_kernel_matrix.CELLS]
    assert all(r["rel_err"] == 0.0 and r["symmetric"] and r["ms"] > 0 for r in rows)
    if not torch.cuda.is_available():
        assert bench_kernel_matrix.main([]) == 1
