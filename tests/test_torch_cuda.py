"""The CUDA kernels (A, B: Gram matvecs; C, D: Gram block matmats) against
their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  They import
neither jax nor plssvm_tpu, so they run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to max|plain|: float32 1e-4, float64 1e-10 (the
kernels sum in another order than cuBLAS, with atomics).
"""

import pytest
import torch

from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec
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
