"""The CUDA kernels (A, B: Gram matvecs; C, D: Gram block matmats; E-H:
laplacian / chi-squared matvecs and block matmats; I: the banded laplacian
matvec; and ``kernel_matvec``, K6's one launch of kernel A) against their
plain PyTorch versions, on the card: A-D on the FFMA tile at "highest",
in float64 A and C on the symmetric DMMA tile and B and D on the rect one
(tests/test_torch_dmma.py holds them on more shapes), and on the
tensor-core tiles at
"f32" (TF32) and "bf16" (A and C on the symmetric one, B and D on the
rectangular one).

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  They import
neither jax nor plssvm_tpu, so they run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to max|plain|: float32 1e-4, float64 1e-10 (the
kernels sum in another order than cuBLAS, with atomics).  The tensor-core
tiles' "f32" tier is held at 1e-4 against the plain version on the same
TF32-rounded operands (``round_to_tf32``), their "bf16" tier against the
plain version at "bf16"; and the "f32" tier against full float32 within
the first-order bound of TF32's unit roundoff 2^-11 (``_tf32_tier_bound``).
The chi-squared kernels are also held per entry of K
(``test_chi_squared_per_entry``).  Kernels J-M (the ring's dual walks,
csrc/dual.cu; J and K at "f32" and "bf16" on the dual tensor-core tile of
csrc/gram_tc.cuh and in float64 on the dual DMMA tile of csrc/gram_dmma.cu)
are held, both outputs, against their plain versions on
the tier's operands at the same tolerances, and the row-sharded ring on
one card (P = 3 and 4 shards on ``cuda:0``) against the single-device
product at the same tier.
"""

import pytest
import torch

from plssvm_tpu_torch.ops import banded, distance, gram_matmat, gram_matvec, matvec
from plssvm_tpu_torch.ops.entry_check import (
    chi2_f64_in_range, chi2_gamma, entry_cases, entry_errors,
)
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
    """Kernels A and B at "highest" on ragged shapes, a single row
    included: on the FFMA tile, except in float64 on the DMMA tiles."""
    tkind = getattr(TKind, name.upper())
    g = torch.Generator().manual_seed(38)
    X = (torch.randn(m, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    P = (torch.randn(m // 2 + 1, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    v = torch.randn(m, generator=g, dtype=dtype).to(cuda_device)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3,
              precision="highest")
    dmma = dtype == torch.float64
    before = (gram_matvec.sym_launches, gram_matvec.sym_dmma_launches,
              gram_matvec.rect_launches, gram_matvec.rect_dmma_launches)
    got = gram_matvec.gram_matvec_sym(X, sq, v, **kw)
    want = matvec.kernel_matvec_plain(X, sq, v, **kw)
    assert (got - want).abs().max() <= tol * want.abs().max()
    got = gram_matvec.gram_matvec_rect(P, X, sq_p, sq, v, **kw)
    want = matvec.kernel_matvec_rect_plain(P, X, sq_p, sq, v, **kw)
    assert (got - want).abs().max() <= tol * want.abs().max()
    assert (gram_matvec.sym_launches, gram_matvec.sym_dmma_launches,
            gram_matvec.rect_launches, gram_matvec.rect_dmma_launches) == (
        before[0] + (not dmma), before[1] + dmma, before[2] + (not dmma), before[3] + dmma
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
    """Kernels C and D at "highest" on ragged shapes, a single row
    included, for class counts below, at and across the kernels' 8-class
    staging chunk: on the FFMA tile, except in float64 on the DMMA
    tiles."""
    tkind = getattr(TKind, name.upper())
    g = torch.Generator().manual_seed(40)
    X = (torch.randn(m, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    P = (torch.randn(m // 2 + 1, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    V = torch.randn(m, n_classes, generator=g, dtype=dtype).to(cuda_device)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3,
              precision="highest")
    dmma = dtype == torch.float64
    before = (gram_matmat.sym_launches, gram_matmat.sym_dmma_launches,
              gram_matmat.rect_launches, gram_matmat.rect_dmma_launches)
    got = gram_matmat.gram_matmat_sym(X, sq, V, **kw)
    want = matvec.kernel_matmat_plain(X, sq, V, **kw)
    assert got.shape == (m, n_classes)
    assert (got - want).abs().max() <= tol * want.abs().max()
    got = gram_matmat.gram_matmat_rect(P, X, sq_p, sq, V, **kw)
    want = matvec.kernel_matmat_rect_plain(P, X, sq_p, sq, V, **kw)
    assert got.shape == (P.shape[0], n_classes)
    assert (got - want).abs().max() <= tol * want.abs().max()
    assert (gram_matmat.sym_launches, gram_matmat.sym_dmma_launches,
            gram_matmat.rect_launches, gram_matmat.rect_dmma_launches) == (
        before[0] + (not dmma), before[1] + dmma, before[2] + (not dmma), before[3] + dmma
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


#: the per-entry cases of both types, and those of float64 alone, outside
#: the range of the divide-free float64 quotient (entry_check.entry_cases)
ENTRY_CASES = ["zero-rich", "1e-18", "1e12", "subnormal"]
OUT_OF_RANGE_CASES = ["1e-200", "1e200", "mixed"]


def _dual_entry_kernels():
    """Kernels L and M as per-entry kernels of K(P, S): K(P, S) @ V as the
    rows output of the walk over (P, S) and as the columns output of the
    walk over (S, P), each with the other right-hand side 0."""
    kernels = []
    for fn in (distance.distance_matvec_dual, distance.distance_matmat_dual):
        def zeros(rows, V):
            return torch.zeros((rows,) + V.shape[1:], dtype=V.dtype, device=V.device)

        kernels += [
            (lambda P, S, V, fn=fn, **kw: fn(P, S, V, zeros(P.shape[0], V), **kw)[0],
             fn is distance.distance_matvec_dual),
            (lambda P, S, V, fn=fn, **kw: fn(S, P, zeros(P.shape[0], V), V, **kw)[1],
             fn is distance.distance_matvec_dual),
        ]
    return kernels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,case", [(torch.float32, c) for c in ENTRY_CASES]
                         + [(torch.float64, c) for c in ENTRY_CASES + OUT_OF_RANGE_CASES])
@pytest.mark.parametrize("d", [3, 203, 784])
def test_chi_squared_per_entry(cuda_device, case, d, dtype):
    """Each entry of the chi-squared K from kernels E-H, L and M (both
    outputs), one-hot right-hand sides picking columns of K, against a
    reference on the same values.  float32 (the SFU reciprocal), against
    the plain version in float64: the worst relative error at most 4x the
    float32 plain version's own (exact IEEE division) and under 1e-4.
    float64, against the same function in long double: at most 2x the
    float64 plain version's own error, and within 1e-12 on the cases whose
    values all take the divide-free quotient.  Rows with a third of the
    entries 0, one all-0 row and one single non-zero, as they are, scaled
    by 1e-18 and 1e12, and with float32-subnormal entries; in float64 also
    scaled by 1e-200 and 1e200 and with every second feature chunk scaled
    by 1e-200, where chunks take the IEEE divide."""
    g = torch.Generator().manual_seed(46)
    cases = entry_cases(d, g, out_of_range=dtype == torch.float64)
    _, X, columns = next(c for c in cases if c[0] == case)
    X = X.to(cuda_device, dtype)
    in_range = dtype == torch.float64 and chi2_f64_in_range(X)
    assert in_range == (dtype == torch.float64 and case in ENTRY_CASES)
    gamma = chi2_gamma(X, columns)
    for kernel, rect, one_column in [
        (distance.distance_matvec_sym, False, True),
        (distance.distance_matvec_rect, True, True),
        (distance.distance_matmat_sym, False, False),
        (distance.distance_matmat_rect, True, False),
    ] + [(k, True, one) for k, one in _dual_entry_kernels()]:
        got, plain = entry_errors(kernel, X, columns, gamma, points=X if rect else None,
                                  one_column=one_column)
        name = getattr(kernel, "__name__", "dual")
        if dtype == torch.float64:
            assert got <= 2 * plain, (name, got, plain)
            assert got <= 1e-12 or not in_range, (name, got)
        else:
            assert got <= min(4 * plain, 1e-4), (name, got, plain)


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
@pytest.mark.parametrize("precision", ["f32", "bf16", "highest"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matvec_is_kernel_a(cuda_device, precision, dtype):
    """K6's port is one launch of kernel A at the same tier: "highest" the
    FFMA tile, "f32" and "bf16" the tensor-core tile, every tier in float64
    the DMMA tile; bit for bit on one tile (m <= 64: each row sum one
    atomic, so no summation order to vary), within the atomics' rounding on
    many."""
    g = torch.Generator().manual_seed(45)
    kw = dict(kind=TKind.RBF, gamma=1.0 / 37, coef0=0.0, degree=3)
    for m, d, tol in ((64, 37, 0.0), (1037, 203, 1e-6 if dtype == torch.float32 else 1e-13)):
        X = torch.randn(m, d, generator=g, dtype=torch.float64).to(cuda_device, dtype)
        v = torch.randn(m, generator=g, dtype=torch.float64).to(cuda_device, dtype)
        sq = (X * X).sum(-1)
        before = (gram_matvec.sym_launches, gram_matvec.sym_tc_launches,
                  gram_matvec.sym_dmma_launches, gram_matvec.kernel_matvec_launches)
        got = gram_matvec.kernel_matvec(X, sq, v, precision=precision, **kw)
        tc = dtype == torch.float32 and precision != "highest"
        dmma = dtype == torch.float64
        assert (gram_matvec.sym_launches, gram_matvec.sym_tc_launches,
                gram_matvec.sym_dmma_launches, gram_matvec.kernel_matvec_launches) == (
            before[0] + (not tc and not dmma), before[1] + tc, before[2] + dmma,
            before[3] + 1)
        want = gram_matvec.gram_matvec_sym(X, sq, v, precision=precision, **kw)
        assert (got - want).abs().max() <= tol * want.abs().max()


# -- the tensor-core tile (kernels A and C at "f32" and "bf16") ---------------

TC_SHAPES = [(m, d) for m in (1, 63, 64, 65, 129, 1037, 8192)
             for d in (3, 5, 37, 203, 512, 1280)]


def _tier_oracle(plain, *args, tier, **kw):
    """The plain version on the tier's exact operands: the operand matrices
    (X, or P and S: the arguments before the first vector) TF32-rounded
    with the float32 operands' norms for "f32", bf16-rounded for "bf16"."""
    if tier == "f32":
        n = next(i for i, a in enumerate(args) if a.ndim == 1)
        args = [matvec.round_to_tf32(a) if i < n else a for i, a in enumerate(args)]
    return plain(*args, precision=tier, **kw)


def _tc_operands(m, d, n_classes, seed, device):
    g = torch.Generator().manual_seed(seed)
    X = (torch.randn(m, d, generator=g, dtype=torch.float64) * 0.3).to(device, torch.float32)
    shape = (m,) if n_classes is None else (m, n_classes)
    rhs = torch.randn(*shape, generator=g, dtype=torch.float64).to(device, torch.float32)
    return X, (X * X).sum(-1), rhs


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("m,d", TC_SHAPES)
def test_tensor_core_matvec_against_tier_oracle(cuda_device, m, d, name, tier):
    """Kernel A on the tensor-core tile on ragged rows and features (the
    TMA boxes' zero fill), at 1e-4 of max|oracle|: only the f32
    accumulation order differs from the oracle."""
    X, sq, v = _tc_operands(m, d, None, 47, cuda_device)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d,
              coef0=COEF0[name], degree=3)
    before = gram_matvec.sym_launches, gram_matvec.sym_tc_launches
    got = gram_matvec.gram_matvec_sym(X, sq, v, precision=tier, **kw)
    assert (gram_matvec.sym_launches, gram_matvec.sym_tc_launches) == (
        before[0], before[1] + 1)
    want = _tier_oracle(matvec.kernel_matvec_plain, X, sq, v, tier=tier, **kw)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("n_classes", [1, 3, 10, 37])
@pytest.mark.parametrize("m,d", [(1, 5), (65, 3), (129, 37), (1037, 203), (300, 1280)])
def test_tensor_core_matmat_against_tier_oracle(cuda_device, m, d, n_classes, name, tier):
    """Kernels C and D on the tensor-core tiles, for class counts below, at
    and across the 8-class staging chunk."""
    X, sq, V = _tc_operands(m, d, n_classes, 48, cuda_device)
    P = X[: m // 2 + 1].flip(0).contiguous()
    sq_p = (P * P).sum(-1)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d,
              coef0=COEF0[name], degree=3)
    before = (gram_matmat.sym_launches, gram_matmat.sym_tc_launches,
              gram_matmat.rect_launches, gram_matmat.rect_tc_launches)
    got = gram_matmat.gram_matmat_sym(X, sq, V, precision=tier, **kw)
    want = _tier_oracle(matvec.kernel_matmat_plain, X, sq, V, tier=tier, **kw)
    assert got.shape == (m, n_classes) and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    got = gram_matmat.gram_matmat_rect(P, X, sq_p, sq, V, precision=tier, **kw)
    want = _tier_oracle(matvec.kernel_matmat_rect_plain, P, X, sq_p, sq, V, tier=tier, **kw)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert (gram_matmat.sym_launches, gram_matmat.sym_tc_launches,
            gram_matmat.rect_launches, gram_matmat.rect_tc_launches) == (
        before[0], before[1] + 1, before[2], before[3] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("m,d", [(1037, 203), (300, 1280), (129, 3), (1, 5)])
def test_bf16_rect_against_plain(cuda_device, m, d, name):
    """Kernel B at "bf16": the rectangular tensor-core tile on bf16
    operands, against the plain version at "bf16"; no FFMA launch."""
    X, sq, v = _tc_operands(m, d, None, 49, cuda_device)
    P = X[: m // 2 + 1].flip(0).contiguous()
    sq_p = (P * P).sum(-1)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d,
              coef0=COEF0[name], degree=3, precision="bf16")
    before = gram_matvec.rect_launches, gram_matvec.rect_tc_launches
    got = gram_matvec.gram_matvec_rect(P, X, sq_p, sq, v, **kw)
    assert (gram_matvec.rect_launches, gram_matvec.rect_tc_launches) == (
        before[0], before[1] + 1)
    want = matvec.kernel_matvec_rect_plain(P, X, sq_p, sq, v, **kw)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def _tf32_tier_bound(P, sq_p, X, sq, V, kind, gamma, coef0):
    """First-order bound of |K_tf32(P, X) @ V - K(P, X) @ V| per output:
    each operand rounds to nearest with relative error <= u = 2^-11, so a
    Gram entry moves by at most (2u + u^2) sum_k |p_ik| |x_jk| <= 2.01 u
    (|P| |X|^T)_ij, and K_ij by at most the largest |dk/dg| on [g - E,
    g + E] times E."""
    u = 2.0 ** -11
    Pd, Xd = P.double(), X.double()
    G = Pd @ Xd.T
    E = 2.01 * u * (Pd.abs() @ Xd.abs().T)
    if kind == TKind.RBF:
        K = torch.exp(-gamma * (sq_p.double()[:, None] + sq.double()[None, :] - 2 * G))
        dk = 2 * gamma * K * torch.exp(2 * gamma * E)  # its largest on the interval
    elif kind == TKind.POLYNOMIAL:
        # the largest |dk/dg| over [g - E, g + E]: (gamma g + coef0)^2 is
        # largest at an end of the interval
        dk = 3 * gamma * torch.maximum((gamma * (G + E) + coef0) ** 2,
                                       (gamma * (G - E) + coef0) ** 2)
    else:
        dk = torch.full_like(G, gamma)  # |tanh'| <= 1
    Vd = V.double().abs()
    return (dk * E) @ Vd


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("m,d,n_classes", [(1037, 203, None), (500, 784, 10)])
def test_tf32_tier_against_full_float32(cuda_device, m, d, n_classes, name):
    """The "f32" tier against the full-float32 plain version, within the
    first-order TF32 bound (``_tf32_tier_bound``) plus 1e-4 of max|plain|
    for the accumulation order."""
    X, sq, rhs = _tc_operands(m, d, n_classes, 50, cuda_device)
    kind = getattr(TKind, name.upper())
    kw = dict(kind=kind, gamma=1.0 / d, coef0=COEF0[name], degree=3)
    if n_classes is None:
        got = gram_matvec.gram_matvec_sym(X, sq, rhs, precision="f32", **kw)
        want = matvec.kernel_matvec_plain(X, sq, rhs, **kw)
    else:
        got = gram_matmat.gram_matmat_sym(X, sq, rhs, precision="f32", **kw)
        want = matvec.kernel_matmat_plain(X, sq, rhs, **kw)
    bound = _tf32_tier_bound(X, sq, X, sq, rhs, kind, 1.0 / d, COEF0[name])
    if n_classes is None:
        bound = bound.reshape(-1)
    err = (got.double() - want.double()).abs()
    assert (err <= bound + 1e-4 * want.abs().max()).all()
    assert (got - want).abs().max() > 0  # TF32 is not full float32


# -- the rectangular tensor-core tile (kernels B and D at "f32" and "bf16") --

RECT_SIZES = [(1, 1), (1, 1037), (65, 129), (129, 65), (777, 1037), (1037, 777), (1037, 1)]


def _rect_operands(n_p, n_s, d, n_classes, seed, device):
    g = torch.Generator().manual_seed(seed)
    P = (torch.randn(n_p, d, generator=g, dtype=torch.float64) * 0.3).to(device, torch.float32)
    S = (torch.randn(n_s, d, generator=g, dtype=torch.float64) * 0.3).to(device, torch.float32)
    shape = (n_s,) if n_classes is None else (n_s, n_classes)
    A = torch.randn(*shape, generator=g, dtype=torch.float64).to(device, torch.float32)
    return P, S, (P * P).sum(-1), (S * S).sum(-1), A


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("n_classes", [None, 1, 3, 10, 37])
@pytest.mark.parametrize("d", [3, 5, 37, 203, 1280])
@pytest.mark.parametrize("n_p,n_s", RECT_SIZES)
def test_tensor_core_rect_against_tier_oracle(cuda_device, n_p, n_s, d, n_classes, tier):
    """Kernel B (n_classes None) and D on the rectangular tensor-core tile
    on ragged points, support vectors and features (the TMA boxes' zero
    fill), poly / RBF / sigmoid, at 1e-4 of max|oracle|; launched on the
    tile, never on the FFMA tile."""
    P, S, sq_p, sq_s, A = _rect_operands(n_p, n_s, d, n_classes, 52, cuda_device)
    module, rect, plain = ((gram_matvec, gram_matvec.gram_matvec_rect,
                            matvec.kernel_matvec_rect_plain) if n_classes is None else
                           (gram_matmat, gram_matmat.gram_matmat_rect,
                            matvec.kernel_matmat_rect_plain))
    for name in COEF0:
        kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d,
                  coef0=COEF0[name], degree=3)
        before = module.rect_launches, module.rect_tc_launches
        got = rect(P, S, sq_p, sq_s, A, precision=tier, **kw)
        assert (module.rect_launches, module.rect_tc_launches) == (before[0], before[1] + 1)
        want = _tier_oracle(plain, P, S, sq_p, sq_s, A, tier=tier, **kw)
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert (got - want).abs().max() <= 1e-4 * want.abs().max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("n_classes", [None, 10, 17, 37])
def test_rect_runs_against_tier_oracle(cuda_device, n_classes, tier):
    """Kernels B and D over 17 x 133 tiles (2100 points, 17000 SVs): on a
    132-SM H100 the tile walks runs of 2 column tiles and a last run of 1,
    and the row tiles make a full group of 16 and a group of one; classes
    past the 16 whose row sums a run keeps take direct atomics.  Against
    the tier oracle at 1e-4 of max|oracle|."""
    P, S, sq_p, sq_s, A = _rect_operands(2100, 17000, 37, n_classes, 53, cuda_device)
    kw = dict(kind=TKind.RBF, gamma=1.0 / 37, coef0=0.0, degree=3)
    rect, plain = ((gram_matvec.gram_matvec_rect, matvec.kernel_matvec_rect_plain)
                   if n_classes is None else
                   (gram_matmat.gram_matmat_rect, matvec.kernel_matmat_rect_plain))
    got = rect(P, S, sq_p, sq_s, A, precision=tier, **kw)
    want = _tier_oracle(plain, P, S, sq_p, sq_s, A, tier=tier, **kw)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("n_p,n_s,d,n_classes", [(300, 1037, 203, None), (500, 900, 784, 10)])
def test_tf32_rect_against_full_float32(cuda_device, n_p, n_s, d, n_classes, name):
    """Kernels B and D at "f32" against the full-float32 plain version,
    within the first-order TF32 bound plus 1e-4 of max|plain| for the
    accumulation order."""
    P, S, sq_p, sq_s, A = _rect_operands(n_p, n_s, d, n_classes, 54, cuda_device)
    kind = getattr(TKind, name.upper())
    kw = dict(kind=kind, gamma=1.0 / d, coef0=COEF0[name], degree=3)
    if n_classes is None:
        got = gram_matvec.gram_matvec_rect(P, S, sq_p, sq_s, A, precision="f32", **kw)
        want = matvec.kernel_matvec_rect_plain(P, S, sq_p, sq_s, A, **kw)
    else:
        got = gram_matmat.gram_matmat_rect(P, S, sq_p, sq_s, A, precision="f32", **kw)
        want = matvec.kernel_matmat_rect_plain(P, S, sq_p, sq_s, A, **kw)
    bound = _tf32_tier_bound(P, sq_p, S, sq_s, A, kind, 1.0 / d, COEF0[name])
    if n_classes is None:
        bound = bound.reshape(-1)
    err = (got.double() - want.double()).abs()
    assert (err <= bound + 1e-4 * want.abs().max()).all()
    assert (got - want).abs().max() > 0  # TF32 is not full float32


@pytest.mark.cuda
def test_rect_wrappers_refuse_what_they_do_not_take(cuda_device):
    """The tensor-core path of kernels B and D checks shapes and types as
    the FFMA path does."""
    P, S, sq_p, sq_s, A = _rect_operands(10, 12, 3, 4, 55, cuda_device)
    kw = dict(kind=TKind.RBF, gamma=0.1, coef0=0.0, degree=3, precision="f32")
    with pytest.raises(ValueError, match="shape"):
        gram_matmat.gram_matmat_rect(P, S[:, :2].contiguous(), sq_p, sq_s, A, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        gram_matvec.gram_matvec_rect(P, S, sq_p, sq_s, A[:, 0], **kw)
    with pytest.raises(ValueError, match="on cpu"):
        gram_matvec.gram_matvec_rect(P, S, sq_p, sq_s.cpu(), A[:, 0].contiguous(), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("n_labels", [2, 4])
def test_solve_and_predict_take_the_tier_kernels(cuda_device, tier, n_labels):
    """A float32 CUDA fit at "f32" / "bf16" runs every kernel product on the
    tensor-core tile, and its predict goes through kernel B or D on the
    rectangular one (none on the FFMA tile or the plain versions)."""
    import numpy as np

    import plssvm_tpu_torch as port

    rng = np.random.default_rng(51)
    y = rng.integers(0, n_labels, 400)
    X = rng.normal(size=(400, 12)) + rng.normal(size=(n_labels, 12))[y]
    data = port.DataSet(X, y, dtype=np.float32)
    svm = port.CSVM(backend="cuda", device="cuda", kernel_type="rbf",
                    gram_precision=tier)
    gram_matvec.reset_counts()
    gram_matmat.reset_counts()
    model = svm.fit(data, epsilon=1e-6)
    accuracy = svm.score(model, data)
    tc = gram_matvec.sym_tc_launches if n_labels == 2 else gram_matmat.sym_tc_launches
    rect = gram_matvec.rect_tc_launches if n_labels == 2 else gram_matmat.rect_tc_launches
    assert tc == 1 + model.n_iter + model.n_iter // 50
    assert rect >= 1
    assert gram_matvec.sym_launches == gram_matmat.sym_launches == 0
    assert gram_matvec.rect_launches == gram_matmat.rect_launches == 0
    assert (matvec.sym_plain_calls + matvec.rect_plain_calls
            + matvec.sym_matmat_plain_calls + matvec.rect_matmat_plain_calls) == 0
    assert accuracy > 0.8


#: ragged blocks: d not a multiple of 4 or 8 (TMA pads the tensor-core
#: tile's operand copies), mr or mc under one 128-row tile, more column
#: tiles than a run of the tensor-core tile takes (kTcMaxRun = 8), and
#: enough tiles for runs of 2 with a short last run (2100 x 17000)
DUAL_SHAPES = [(1, 1, 5), (65, 129, 3), (300, 77, 203), (1037, 513, 37), (129, 300, 1280),
               (130, 1100, 13), (2100, 17000, 37)]


def _dual_case(mr, mc, d, n_classes, dtype, seed, device, non_negative=False):
    g = torch.Generator().manual_seed(seed)
    make = ((lambda *s: torch.rand(*s, generator=g, dtype=torch.float64)) if non_negative
            else (lambda *s: torch.randn(*s, generator=g, dtype=torch.float64) * 0.3))
    Xr, Xc = make(mr, d), make(mc, d)
    if non_negative:
        Xr[Xr < 0.3] = 0.0
        Xc[Xc < 0.3] = 0.0
    tail = () if n_classes is None else (n_classes,)
    v_c = torch.randn(mc, *tail, generator=g, dtype=torch.float64)
    v_r = torch.randn(mr, *tail, generator=g, dtype=torch.float64)
    return [t.to(device, dtype) for t in (Xr, Xc, v_c, v_r)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision,dtype,tol", [
    ("highest", torch.float64, 1e-10), ("highest", torch.float32, 1e-4),
    ("f32", torch.float32, 1e-4), ("bf16", torch.float32, 1e-4),
])
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("n_classes", [None, 1, 3, 10, 37])
@pytest.mark.parametrize("mr,mc,d", DUAL_SHAPES)
def test_gram_dual_against_plain(cuda_device, mr, mc, d, n_classes, name, precision, dtype, tol):
    """Kernels J (v (m,)) and K (V (m, C)) on ragged mr != mc blocks, both
    outputs, against the plain version on the tier's operands; one launch,
    on the dual tensor-core tile (dual_tc_launches) at "f32" and "bf16" on
    float32, on the FFMA tile (dual_launches) at "highest" on float32, on
    the dual DMMA tile (dual_dmma_launches) in float64."""
    Xr, Xc, v_c, v_r = _dual_case(mr, mc, d, n_classes, dtype, 52, cuda_device)
    sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d, coef0=COEF0[name],
              degree=3, precision=precision)
    module, plain = ((gram_matvec, matvec.kernel_matvec_dual_plain) if n_classes is None
                     else (gram_matmat, matvec.kernel_matmat_dual_plain))
    kernel = gram_matvec.gram_matvec_dual if n_classes is None else gram_matmat.gram_matmat_dual
    before = module.dual_launches, module.dual_tc_launches, module.dual_dmma_launches
    got = kernel(Xr, Xc, sq_r, sq_c, v_c, v_r, **kw)
    tc = precision != "highest" and dtype == torch.float32
    dmma = dtype == torch.float64
    assert (module.dual_launches, module.dual_tc_launches, module.dual_dmma_launches) == (
        before[0] + (not tc and not dmma), before[1] + tc, before[2] + dmma)
    if precision == "f32" and dtype == torch.float32:
        want = plain(matvec.round_to_tf32(Xr), matvec.round_to_tf32(Xc), sq_r, sq_c, v_c,
                     v_r, **kw)
    else:
        want = plain(Xr, Xc, sq_r, sq_c, v_c, v_r, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert (g - w).abs().max() <= tol * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("name", ["laplacian", "chi_squared"])
@pytest.mark.parametrize("n_classes", [None, 1, 3, 10, 37])
@pytest.mark.parametrize("mr,mc,d", DUAL_SHAPES)
def test_distance_dual_against_plain(cuda_device, mr, mc, d, n_classes, name, dtype, tol):
    """Kernels L and M on ragged blocks of zero-rich rows, both outputs."""
    Xr, Xc, v_c, v_r = _dual_case(mr, mc, d, n_classes, dtype, 53, cuda_device, True)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d)
    if n_classes is None:
        kernel, plain, counter = (distance.distance_matvec_dual,
                                  matvec.distance_matvec_dual_plain, "matvec_dual_launches")
    else:
        kernel, plain, counter = (distance.distance_matmat_dual,
                                  matvec.distance_matmat_dual_plain, "matmat_dual_launches")
    before = getattr(distance, counter)
    got = kernel(Xr, Xc, v_c, v_r, **kw)
    assert getattr(distance, counter) == before + 1
    for g, w in zip(got, plain(Xr, Xc, v_c, v_r, **kw)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert (g - w).abs().max() <= tol * w.abs().max()


@pytest.mark.cuda
def test_dual_wrappers_check_operands(cuda_device):
    Xr, Xc, v_c, v_r = _dual_case(20, 30, 4, None, torch.float32, 54, cuda_device)
    sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
    kw = dict(kind=TKind.RBF, gamma=0.25, coef0=0.0, degree=3)
    with pytest.raises(ValueError, match="shape"):
        gram_matvec.gram_matvec_dual(Xr, Xc, sq_r, sq_c, v_r, v_r, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        gram_matvec.gram_matvec_dual(Xr, Xc, sq_r, sq_c.cpu(), v_c, v_r, **kw)
    with pytest.raises(ValueError, match="distance kernel"):
        gram_matvec.gram_matvec_dual(Xr, Xc, sq_r, sq_c, v_c, v_r, **dict(
            kw, kind=TKind.LAPLACIAN))
    with pytest.raises(ValueError, match="laplacian or chi_squared"):
        distance.distance_matvec_dual(Xr, Xc, v_c, v_r, kind=TKind.RBF, gamma=0.25)
    with pytest.raises(TypeError):
        distance.distance_matmat_dual(Xr.half(), Xc.half(), v_c[:, None].half(),
                                      v_r[:, None].half(), kind=TKind.LAPLACIAN, gamma=0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [3, 4])
@pytest.mark.parametrize("name,n_classes,precision,dtype", [
    ("rbf", None, "highest", torch.float64), ("rbf", 3, "highest", torch.float64),
    ("laplacian", None, "highest", torch.float64), ("chi_squared", 10, "highest", torch.float64),
    ("rbf", None, "f32", torch.float32), ("sigmoid", 3, "f32", torch.float32),
    ("polynomial", 10, "bf16", torch.float32),
])
def test_ring_on_one_card(cuda_device, P, name, n_classes, precision, dtype):
    """The symmetric ring over P shards on cuda:0 against the single-device
    product at the same tier, and its launches: per shard one symmetric
    launch, floor((P - 1) / 2) dual and, for even P, one rows-only launch,
    in float64 the symmetric, dual and rows-only ones on the DMMA tiles
    (Gram kinds), in float32 at "f32" and "bf16"
    on the tensor-core tiles (sym_tc, dual_tc, rect_tc), none on another
    tile.  Float64 within 1e-10 of max|single|, float32 within 1e-4 (the
    same tier's products summed in another order)."""
    from plssvm_tpu_torch.parallel import sharded

    distance_kind = name in ("laplacian", "chi_squared")
    X, _, _, v = _dual_case(1001, 1, 23, n_classes, dtype, 55, cuda_device, distance_kind)
    sq = (X * X).sum(-1)
    tkind = getattr(TKind, name.upper())
    gamma, coef0 = 1.0 / 23, COEF0.get(name, 0.0)
    bounds = sharded.shard_bounds(1001, P)
    devices = [cuda_device] * P
    for module in (gram_matvec, gram_matmat, distance):
        module.reset_counts()
    outs = (sharded.ring_kernel_matvec if n_classes is None else sharded.ring_kernel_matmat)(
        sharded.shard_rows(X, bounds, devices),
        None if distance_kind else sharded.shard_rows(sq, bounds, devices),
        sharded.shard_rows(v, bounds, devices), gamma, coef0, kind=tkind, degree=3,
        impl="cuda", precision=precision)
    if distance_kind:
        single = (distance.distance_matvec_sym if n_classes is None
                  else distance.distance_matmat_sym)(X, v, kind=tkind, gamma=1.0 / 23)
        module = distance
        sym, dual, rect = (("matvec_sym_launches", "matvec_dual_launches", "matvec_rect_launches")
                           if n_classes is None else
                           ("matmat_sym_launches", "matmat_dual_launches", "matmat_rect_launches"))
    else:
        module = gram_matvec if n_classes is None else gram_matmat
        single = (module.gram_matvec_sym if n_classes is None else module.gram_matmat_sym)(
            X, sq, v, kind=tkind, gamma=gamma, coef0=coef0, degree=3, precision=precision)
        tiles = ("sym_launches", "dual_launches", "rect_launches")
        cores = ("sym_tc_launches", "dual_tc_launches", "rect_tc_launches")
        (sym, dual, rect), other = ((cores, tiles) if dtype == torch.float32 else
                                    (("sym_dmma_launches", "dual_dmma_launches",
                                      "rect_dmma_launches"), tiles + cores))
        assert sum(getattr(module, c) for c in other) == 0
    got = torch.cat(outs)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert torch.isfinite(got).all()
    assert (got - single).abs().max() <= tol * single.abs().max()
    counts = [getattr(module, c) for c in (sym, dual, rect)]
    # the single-device product above added one symmetric launch
    assert counts == [P + 1, P * ((P - 1) // 2), P if P % 2 == 0 else 0]
