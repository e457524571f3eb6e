"""The CUDA kernels (A, B: Gram matvecs; C, D: Gram block matmats; E-H:
laplacian / chi-squared matvecs and block matmats; I: the banded laplacian
matvec; and ``kernel_matvec``, K6's one launch of kernel A) against their
plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  They import
neither jax nor plssvm_tpu, so they run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to max|plain|: float32 1e-4, float64 1e-10 (the
kernels sum in another order than cuBLAS, with atomics).  The chi-squared
kernels are also held per entry of K (``test_chi_squared_per_entry``).
"""

import pytest
import torch

from plssvm_tpu_torch.exceptions import NotPortedError
from plssvm_tpu_torch.ops import banded, distance, gram_matmat, gram_matvec, matvec
from plssvm_tpu_torch.ops.entry_check import chi2_gamma, entry_cases, entry_errors
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind

COEF0 = {"polynomial": 1.0, "rbf": 0.0, "sigmoid": -0.5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels build and run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("m,d", [(1037, 203), (300, 1280), (129, 3), (1, 5)])
def test_kernels_against_plain(cuda_device, name, dtype, tol, m, d):
    """Kernels A and B on ragged shapes, a single row included."""
    tkind = getattr(TKind, name.upper())
    g = torch.Generator().manual_seed(38)
    X = (torch.randn(m, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    P = (torch.randn(m // 2 + 1, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    v = torch.randn(m, generator=g, dtype=dtype).to(cuda_device)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3)
    before = gram_matvec.sym_launches, gram_matvec.rect_launches
    got = gram_matvec.gram_matvec_sym(X, sq, v, **kw)
    want = matvec.kernel_matvec_plain(X, sq, v, **kw)
    assert (got - want).abs().max() <= tol * want.abs().max()
    got = gram_matvec.gram_matvec_rect(P, X, sq_p, sq, v, **kw)
    want = matvec.kernel_matvec_rect_plain(P, X, sq_p, sq, v, **kw)
    assert (got - want).abs().max() <= tol * want.abs().max()
    assert (gram_matvec.sym_launches, gram_matvec.rect_launches) == (
        before[0] + 1, before[1] + 1
    )


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 1, 2, 4, -1])
def test_polynomial_degrees(cuda_device, degree):
    g = torch.Generator().manual_seed(39)
    X = torch.randn(200, 17, generator=g, dtype=torch.float64).to(cuda_device)
    v = torch.randn(200, generator=g, dtype=torch.float64).to(cuda_device)
    sq = (X * X).sum(-1)
    kw = dict(kind=TKind.POLYNOMIAL, gamma=0.05, coef0=2.0, degree=degree)
    got = gram_matvec.gram_matvec_sym(X, sq, v, **kw)
    want = matvec.kernel_matvec_plain(X, sq, v, **kw)
    assert (got - want).abs().max() <= 1e-10 * want.abs().max()


@pytest.mark.cuda
def test_wrapper_checks_operands(cuda_device):
    X = torch.randn(10, 3, device=cuda_device)
    sq = (X * X).sum(-1)
    kw = dict(kind=TKind.RBF, gamma=0.1, coef0=0.0, degree=3)
    with pytest.raises(TypeError):
        gram_matvec.gram_matvec_sym(X.half(), sq.half(), sq.half(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        gram_matvec.gram_matvec_sym(X.T.contiguous().T, sq, sq, **kw)
    with pytest.raises(ValueError, match="shape"):
        gram_matvec.gram_matvec_sym(X, sq[:5], sq, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        gram_matvec.gram_matvec_sym(X, sq.cpu(), sq, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("n_classes", [1, 3, 10, 37])
@pytest.mark.parametrize("m,d", [(1037, 203), (300, 1280), (129, 3), (1, 5)])
def test_matmat_kernels_against_plain(cuda_device, name, dtype, tol, n_classes, m, d):
    """Kernels C and D on ragged shapes, a single row included, for class
    counts below, at and across the kernels' 8-class staging chunk."""
    tkind = getattr(TKind, name.upper())
    g = torch.Generator().manual_seed(40)
    X = (torch.randn(m, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    P = (torch.randn(m // 2 + 1, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    V = torch.randn(m, n_classes, generator=g, dtype=dtype).to(cuda_device)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3)
    before = gram_matmat.sym_launches, gram_matmat.rect_launches
    got = gram_matmat.gram_matmat_sym(X, sq, V, **kw)
    want = matvec.kernel_matmat_plain(X, sq, V, **kw)
    assert got.shape == (m, n_classes)
    assert (got - want).abs().max() <= tol * want.abs().max()
    got = gram_matmat.gram_matmat_rect(P, X, sq_p, sq, V, **kw)
    want = matvec.kernel_matmat_rect_plain(P, X, sq_p, sq, V, **kw)
    assert got.shape == (P.shape[0], n_classes)
    assert (got - want).abs().max() <= tol * want.abs().max()
    assert (gram_matmat.sym_launches, gram_matmat.rect_launches) == (
        before[0] + 1, before[1] + 1
    )


@pytest.mark.cuda
def test_matmat_one_class_equals_matvec(cuda_device):
    """With C = 1, kernel C is kernel A's walk: the same values up to the
    atomics' summation order."""
    g = torch.Generator().manual_seed(41)
    X = torch.randn(777, 64, generator=g, dtype=torch.float64).to(cuda_device)
    v = torch.randn(777, generator=g, dtype=torch.float64).to(cuda_device)
    sq = (X * X).sum(-1)
    kw = dict(kind=TKind.RBF, gamma=1.0 / 64, coef0=0.0, degree=3)
    mat = gram_matmat.gram_matmat_sym(X, sq, v[:, None].contiguous(), **kw)[:, 0]
    vec = gram_matvec.gram_matvec_sym(X, sq, v, **kw)
    assert (mat - vec).abs().max() <= 1e-12 * vec.abs().max()


@pytest.mark.cuda
def test_matmat_wrapper_checks_operands(cuda_device):
    X = torch.randn(10, 3, device=cuda_device)
    sq = (X * X).sum(-1)
    V = torch.randn(10, 4, device=cuda_device)
    kw = dict(kind=TKind.RBF, gamma=0.1, coef0=0.0, degree=3)
    with pytest.raises(ValueError, match="shape"):
        gram_matmat.gram_matmat_sym(X, sq, V[:, 0].contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        gram_matmat.gram_matmat_sym(X, sq, V.T.contiguous().T, **kw)
    with pytest.raises(TypeError):
        gram_matmat.gram_matmat_rect(X, X, sq, sq, V.double(), **kw)
    with pytest.raises(ValueError, match="on cpu"):
        gram_matmat.gram_matmat_sym(X, sq, V.cpu(), **kw)


def _histograms(m, d, gen, dtype, device):
    """Non-negative rows with about a third of the entries 0, and one
    all-zero row: chi-squared's 0/0 rule is on the path."""
    X = torch.rand(m, d, generator=gen, dtype=torch.float64)
    X[X < 0.33] = 0.0
    X[m // 2] = 0.0
    return X.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("name", ["laplacian", "chi_squared"])
@pytest.mark.parametrize("n_classes", [1, 3, 10, 37])
@pytest.mark.parametrize("m,d", [(1037, 203), (300, 1280), (129, 3), (1, 1)])
def test_distance_kernels_against_plain(cuda_device, name, dtype, tol, n_classes, m, d):
    """Kernels E-H on ragged shapes, a single row included, and C across
    the 8-class staging chunk."""
    kind = getattr(TKind, name.upper())
    g = torch.Generator().manual_seed(42)
    X = _histograms(m, d, g, dtype, cuda_device)
    P = _histograms(m // 2 + 1, d, g, dtype, cuda_device)
    V = torch.randn(m, n_classes, generator=g, dtype=dtype).to(cuda_device)
    v = V[:, 0].contiguous()
    kw = dict(kind=kind, gamma=1.0 / d)
    before = (distance.matvec_sym_launches, distance.matvec_rect_launches,
              distance.matmat_sym_launches, distance.matmat_rect_launches)
    for kernel, plain, args in (
        (distance.distance_matvec_sym, matvec.distance_matvec_plain, (X, v)),
        (distance.distance_matvec_rect, matvec.distance_matvec_rect_plain, (P, X, v)),
        (distance.distance_matmat_sym, matvec.distance_matmat_plain, (X, V)),
        (distance.distance_matmat_rect, matvec.distance_matmat_rect_plain, (P, X, V)),
    ):
        got, want = kernel(*args, **kw), plain(*args, **kw)
        assert got.shape == want.shape
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= tol * want.abs().max()
    after = (distance.matvec_sym_launches, distance.matvec_rect_launches,
             distance.matmat_sym_launches, distance.matmat_rect_launches)
    assert after == tuple(b + 1 for b in before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [3, 203, 784])
@pytest.mark.parametrize("case", ["zero-rich", "1e-18", "1e12", "subnormal"])
def test_chi_squared_per_entry(cuda_device, case, d, dtype):
    """Each entry of the chi-squared K from kernels E-H, one-hot right-hand
    sides picking columns of K, against the plain version in float64 on
    the same values.  float32 (the SFU reciprocal): the worst relative
    error at most 4x the float32 plain version's own (exact IEEE division)
    and under 1e-4; float64 (IEEE division) within 1e-12.  Rows with a
    third of the entries 0, one all-0 row and one single non-zero, as they
    are, scaled by 1e-18 and 1e12, and with float32-subnormal entries."""
    g = torch.Generator().manual_seed(46)
    _, X, columns = next(c for c in entry_cases(d, g) if c[0] == case)
    X = X.to(cuda_device, dtype)
    gamma = chi2_gamma(X, columns)
    for kernel, points, one_column in (
        (distance.distance_matvec_sym, None, True),
        (distance.distance_matvec_rect, X, True),
        (distance.distance_matmat_sym, None, False),
        (distance.distance_matmat_rect, X, False),
    ):
        got, plain = entry_errors(kernel, X, columns, gamma, points=points,
                                  one_column=one_column)
        if dtype == torch.float64:
            assert got <= 1e-12, (kernel.__name__, got)
        else:
            assert got <= min(4 * plain, 1e-4), (kernel.__name__, got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["laplacian", "chi_squared"])
def test_distance_matmat_one_class_equals_matvec(cuda_device, name):
    """With C = 1, kernel G gives kernel E's values up to the atomics'
    summation order."""
    g = torch.Generator().manual_seed(43)
    X = _histograms(777, 64, g, torch.float64, cuda_device)
    v = torch.randn(777, generator=g, dtype=torch.float64).to(cuda_device)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / 64)
    mat = distance.distance_matmat_sym(X, v[:, None].contiguous(), **kw)[:, 0]
    vec = distance.distance_matvec_sym(X, v, **kw)
    assert (mat - vec).abs().max() <= 1e-12 * vec.abs().max()


@pytest.mark.cuda
def test_distance_wrappers_check_operands(cuda_device):
    X = torch.rand(10, 3, device=cuda_device)
    V = torch.randn(10, 4, device=cuda_device)
    kw = dict(kind=TKind.CHI_SQUARED, gamma=0.1)
    with pytest.raises(ValueError, match="laplacian or chi_squared"):
        distance.distance_matvec_sym(X, V[:, 0].contiguous(), kind=TKind.RBF, gamma=0.1)
    with pytest.raises(ValueError, match="distance kernel"):
        gram_matvec.gram_matvec_sym(X, X[:, 0].contiguous(), V[:, 0].contiguous(),
                                    kind=TKind.LAPLACIAN, gamma=0.1, coef0=0.0, degree=3)
    with pytest.raises(ValueError, match="shape"):
        distance.distance_matmat_sym(X, V[:, 0].contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        distance.distance_matmat_sym(X, V.T.contiguous().T, **kw)
    with pytest.raises(TypeError):
        distance.distance_matmat_rect(X, X, V.double(), **kw)
    with pytest.raises(ValueError, match="on cpu"):
        distance.distance_matvec_rect(X, X, V[:, 0].cpu(), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("m,d", [(1, 1), (1, 3), (127, 3), (129, 203), (300, 1),
                                 (384, 16), (1037, 203)])
def test_banded_against_plain(cuda_device, m, d, symmetric, dtype, tol):
    """Kernel I on ragged shapes, a single row included: each half against
    the plain version, and the halves against kernel E on the rows."""
    g = torch.Generator().manual_seed(44)
    X = torch.rand(m, d, generator=g, dtype=torch.float64).to(cuda_device, dtype)
    v = torch.randn(m, generator=g, dtype=torch.float64).to(cuda_device, dtype)
    XT = X.T.contiguous()
    before = banded.launches
    out_r, out_c = banded.banded_matvec(XT, v, 1.0 / d, symmetric=symmetric)
    assert banded.launches == before + 1
    want_r, want_c = matvec.banded_matvec_plain(XT, v, 1.0 / d, symmetric=symmetric)
    for got, want in ((out_r, want_r), (out_c, want_c)):
        assert got.shape == (m,) and torch.isfinite(got).all()
        assert (got - want).abs().max() <= tol * want.abs().max()
    e = distance.distance_matvec_sym(X, v, kind=TKind.LAPLACIAN, gamma=1.0 / d)
    halves = [out_r + out_c] if symmetric else [out_r, out_c]
    for got in halves:
        assert (got - e).abs().max() <= tol * e.abs().max()


@pytest.mark.cuda
def test_banded_wrapper_checks_operands(cuda_device):
    XT = torch.rand(3, 10, device=cuda_device)
    v = torch.randn(10, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        banded.banded_matvec(XT.T.contiguous().T, v, 0.1)
    with pytest.raises(ValueError, match="shape"):
        banded.banded_matvec(XT, v[:5], 0.1)
    with pytest.raises(TypeError):
        banded.banded_matvec(XT, v.double(), 0.1)
    with pytest.raises(ValueError, match="on cpu"):
        banded.banded_matvec(XT, v.cpu(), 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "highest"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matvec_is_kernel_a(cuda_device, precision, dtype):
    """K6's port is one launch of kernel A: bit for bit on one tile (m <=
    64, each row sum one atomic, so no summation order to vary), within
    the atomics' rounding on many."""
    g = torch.Generator().manual_seed(45)
    kw = dict(kind=TKind.RBF, gamma=1.0 / 37, coef0=0.0, degree=3)
    for m, d, tol in ((64, 37, 0.0), (1037, 203, 1e-6 if dtype == torch.float32 else 1e-13)):
        X = torch.randn(m, d, generator=g, dtype=torch.float64).to(cuda_device, dtype)
        v = torch.randn(m, generator=g, dtype=torch.float64).to(cuda_device, dtype)
        sq = (X * X).sum(-1)
        before = gram_matvec.sym_launches, gram_matvec.kernel_matvec_launches
        got = gram_matvec.kernel_matvec(X, sq, v, precision=precision, **kw)
        assert (gram_matvec.sym_launches, gram_matvec.kernel_matvec_launches) == (
            before[0] + 1, before[1] + 1
        )
        want = gram_matvec.gram_matvec_sym(X, sq, v, **kw)
        assert (got - want).abs().max() <= tol * want.abs().max()
    with pytest.raises(NotPortedError, match="Queue 4"):
        gram_matvec.kernel_matvec(X, sq, v, precision="bf16", **kw)
