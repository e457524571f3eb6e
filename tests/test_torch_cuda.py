"""The CUDA kernels (A, B: Gram matvecs; C, D: Gram block matmats; E-H:
laplacian / chi-squared matvecs and block matmats; I: the banded laplacian
matvec; and ``kernel_matvec``, K6's one launch of kernel A) against their
plain PyTorch versions, on the card: A-D on the tensor-core tiles at
"highest" (three TF32 passes over the split operand), "f32" (TF32) and
"bf16" (A and C on the symmetric one, B and D on the rectangular one), on
their FFMA tiles (``gram_matvec.gram_ffma``, on no wrapper's path), and in
float64 A and C on the symmetric DMMA tile and B and D on the rect one
(tests/test_torch_dmma.py holds them on more shapes).

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  They import
neither jax nor plssvm_tpu, so they run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to max|plain|: float32 1e-4, float64 1e-10 (the
kernels sum in another order than cuBLAS, in slots across blocks).  The tensor-core
tiles' "f32" tier is held at 1e-4 against the plain version on the same
TF32-rounded operands (``round_to_tf32``), their "bf16" tier against the
plain version at "bf16", their "highest" tier against the full-float32
plain version and the split oracle (``split_kernel_product``); the "f32"
tier against full float32 within the first-order bound of TF32's unit
roundoff 2^-11 (``_tf32_tier_bound``).  The one-pass tiers give, on a
one-block tile, the bits they gave before the split tier was added
(``ONE_PASS_DIGESTS``).
The chi-squared kernels are also held per entry of K
(``test_chi_squared_per_entry``).  Kernels J-M (the ring's dual walks,
csrc/dual.cu; J and K at "f32" and "bf16", and K at "highest" in three
TF32 passes, on the dual tensor-core tile of csrc/gram_tc.cuh and in
float64 on the dual DMMA tile of csrc/gram_dmma.cu) are held, both
outputs, against their plain versions on the tier's operands at the same
tolerances (K at "highest" also at the ring's block shapes), J and K at
"f32" / "bf16" to the bits they gave before the split tier
(``DUAL_ONE_PASS_DIGESTS``), and the row-sharded ring on one card (P = 3
and 4 shards on ``cuda:0``) against the single-device product at the same
tier.  Kernel N's symmetric walk is held to its rect walk of X against
itself, bit for bit.  Kernel O (the batched one-vs-one product:
csrc/pairs_tc.cu's tensor-core walks for the Gram kinds at "f32" / "bf16"
and in float64, csrc/pairs.cu's FFMA triangle walk else) is held against
its plain version on the tier's operands at the same tolerances, and each
machine alone against itself inside a stack, bit for bit.
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
    included: on the tensor-core tiles in three TF32 passes, in float64 on
    the DMMA tiles; in float32 their FFMA tiles (``gram_ffma``) too."""
    tkind = getattr(TKind, name.upper())
    g = torch.Generator().manual_seed(38)
    X = (torch.randn(m, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    P = (torch.randn(m // 2 + 1, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    v = torch.randn(m, generator=g, dtype=dtype).to(cuda_device)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3,
              precision="highest")
    dmma = dtype == torch.float64
    counters = ("sym_launches", "sym_tc_launches", "sym_dmma_launches",
                "rect_launches", "rect_tc_launches", "rect_dmma_launches")
    before = [getattr(gram_matvec, c) for c in counters]
    want_sym = matvec.kernel_matvec_plain(X, sq, v, **kw)
    want_rect = matvec.kernel_matvec_rect_plain(P, X, sq_p, sq, v, **kw)
    got = gram_matvec.gram_matvec_sym(X, sq, v, **kw)
    assert (got - want_sym).abs().max() <= tol * want_sym.abs().max()
    got = gram_matvec.gram_matvec_rect(P, X, sq_p, sq, v, **kw)
    assert (got - want_rect).abs().max() <= tol * want_rect.abs().max()
    assert [getattr(gram_matvec, c) - b for c, b in zip(counters, before)] == [
        0, not dmma, dmma, 0, not dmma, dmma]
    if dmma:
        return
    del kw["precision"]
    got = gram_matvec.gram_ffma("matvec_sym", (X,), (sq,), v, **kw)
    assert (got - want_sym).abs().max() <= tol * want_sym.abs().max()
    got = gram_matvec.gram_ffma("matvec_rect", (P, X), (sq_p, sq), v, **kw)
    assert (got - want_rect).abs().max() <= tol * want_rect.abs().max()
    assert [getattr(gram_matvec, c) - b for c, b in zip(counters, before)] == [
        1, 1, 0, 1, 1, 0]


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
    staging chunk: on the tensor-core tiles in three TF32 passes, in
    float64 on the DMMA tiles; in float32 their FFMA tiles (``gram_ffma``)
    too."""
    tkind = getattr(TKind, name.upper())
    g = torch.Generator().manual_seed(40)
    X = (torch.randn(m, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    P = (torch.randn(m // 2 + 1, d, generator=g, dtype=dtype) * 0.3).to(cuda_device)
    V = torch.randn(m, n_classes, generator=g, dtype=dtype).to(cuda_device)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3,
              precision="highest")
    dmma = dtype == torch.float64
    counters = ("sym_launches", "sym_tc_launches", "sym_dmma_launches",
                "rect_launches", "rect_tc_launches", "rect_dmma_launches")
    before = [getattr(gram_matmat, c) for c in counters]
    want_sym = matvec.kernel_matmat_plain(X, sq, V, **kw)
    want_rect = matvec.kernel_matmat_rect_plain(P, X, sq_p, sq, V, **kw)
    got = gram_matmat.gram_matmat_sym(X, sq, V, **kw)
    assert got.shape == (m, n_classes)
    assert (got - want_sym).abs().max() <= tol * want_sym.abs().max()
    got = gram_matmat.gram_matmat_rect(P, X, sq_p, sq, V, **kw)
    assert got.shape == (P.shape[0], n_classes)
    assert (got - want_rect).abs().max() <= tol * want_rect.abs().max()
    assert [getattr(gram_matmat, c) - b for c, b in zip(counters, before)] == [
        0, not dmma, dmma, 0, not dmma, dmma]
    if dmma:
        return
    del kw["precision"]
    got = gram_matvec.gram_ffma("matmat_sym", (X,), (sq,), V, **kw)
    assert (got - want_sym).abs().max() <= tol * want_sym.abs().max()
    got = gram_matvec.gram_ffma("matmat_rect", (P, X), (sq_p, sq), V, **kw)
    assert (got - want_rect).abs().max() <= tol * want_rect.abs().max()
    assert [getattr(gram_matmat, c) - b for c, b in zip(counters, before)] == [
        1, 1, 0, 1, 1, 0]


@pytest.mark.cuda
def test_matmat_one_class_equals_matvec(cuda_device):
    """With C = 1, kernel C is kernel A's walk: the same values up to the
    summation order."""
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
    """With C = 1, kernel G gives kernel E's values up to the summation
    order."""
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
    """K6's port is one launch of kernel A at the same tier: every tier the
    tensor-core tile in float32 ("highest" in three TF32 passes), the DMMA
    tile in float64; bit for bit on one tile (m <= 64: each row sum one
    slot, so no summation order to vary), within the sums' rounding on
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
        dmma = dtype == torch.float64
        assert (gram_matvec.sym_launches, gram_matvec.sym_tc_launches,
                gram_matvec.sym_dmma_launches, gram_matvec.kernel_matvec_launches) == (
            before[0], before[1] + (not dmma), before[2] + dmma, before[3] + 1)
        want = gram_matvec.gram_matvec_sym(X, sq, v, precision=precision, **kw)
        assert (got - want).abs().max() <= tol * want.abs().max()


# -- the tensor-core tile (kernels A and C at every tier) ---------------------

TC_SHAPES = [(m, d) for m in (1, 63, 64, 65, 129, 1037, 8192)
             for d in (3, 5, 37, 203, 512, 1280)]


def _tier_oracle(plain, *args, tier, **kw):
    """The plain version on the tier's exact operands: the operand matrices
    (X, or P and S: the arguments before the first vector) TF32-rounded
    with the float32 operands' norms for "f32", bf16-rounded for "bf16";
    at "highest" the full-float32 plain version, which the split tier is
    held to at the FFMA tile's tolerance."""
    if tier == "f32":
        n = next(i for i, a in enumerate(args) if a.ndim == 1)
        args = [matvec.round_to_tf32(a) if i < n else a for i, a in enumerate(args)]
    return plain(*args, precision=tier, **kw)


def _split_oracle(*args, **kw):
    """``split_kernel_product`` on (X, sq, V) or (P, S, sq_p, sq_s, A): the
    "highest" tier's three passes summed in float32 by cuBLAS."""
    if len(args) == 3:
        args = (args[0], args[0], args[1], args[1], args[2])
    return matvec.split_kernel_product(*args, **kw)


def _tc_operands(m, d, n_classes, seed, device):
    g = torch.Generator().manual_seed(seed)
    X = (torch.randn(m, d, generator=g, dtype=torch.float64) * 0.3).to(device, torch.float32)
    shape = (m,) if n_classes is None else (m, n_classes)
    rhs = torch.randn(*shape, generator=g, dtype=torch.float64).to(device, torch.float32)
    return X, (X * X).sum(-1), rhs


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["f32", "bf16", "highest"])
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("m,d", TC_SHAPES)
def test_tensor_core_matvec_against_tier_oracle(cuda_device, m, d, name, tier):
    """Kernel A on the tensor-core tile on ragged rows and features (the
    TMA boxes' zero fill), at 1e-4 of max|oracle|: only the f32
    accumulation order differs from the oracle ("highest": also from the
    split oracle)."""
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
    if tier == "highest":
        split = _split_oracle(X, sq, v, **kw)
        assert (got - split).abs().max() <= 1e-4 * split.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["f32", "bf16", "highest"])
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
@pytest.mark.parametrize("tier", ["f32", "bf16", "highest"])
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
        if tier == "highest":
            split = _split_oracle(P, S, sq_p, sq_s, A, **kw)
            assert (got - split).abs().max() <= 1e-4 * split.abs().max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["f32", "bf16", "highest"])
@pytest.mark.parametrize("n_classes", [None, 10, 17, 37])
def test_rect_runs_against_tier_oracle(cuda_device, n_classes, tier):
    """Kernels B and D over 17 x 133 tiles (2100 points, 17000 SVs): on a
    132-SM H100 the tile walks runs of 2 column tiles and a last run of 1,
    and the row tiles make a full group of 16 and a group of one; classes
    past the 16 whose row sums a run keeps add to their slot per tile.  Against
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
@pytest.mark.parametrize("tier", ["f32", "bf16", "highest"])
@pytest.mark.parametrize("n_labels", [2, 4])
def test_solve_and_predict_take_the_tier_kernels(cuda_device, tier, n_labels):
    """A float32 CUDA fit at any tier runs every kernel product on the
    tensor-core tile ("highest" in three TF32 passes), and its predict goes
    through kernel B or D on the rectangular one (none on the FFMA tile or
    the plain versions)."""
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


# -- the split tier ("highest") and the one-pass tiers' bits ------------------

#: one-block tiles of the sym tile (m <= 128: one diagonal tile, each row
#: and class one slot added to zeros) and of the rect tile (n_p, n_s <= 128:
#: one tile, one run): shapes whose outputs are the kernel's bits, with no
#: summation order between blocks; (m, d, classes), d over several boxes
ONE_BLOCK_SHAPES = [(128, 203, None), (100, 37, 3), (77, 512, 10)]
#: the first 16 hex digits of the sha256 of the "f32" and "bf16" tiers'
#: outputs on ONE_BLOCK_SHAPES (``_one_pass_outputs``), as the tiles gave
#: them before the split tier shared their code, recorded on an NVIDIA
#: H100 80GB HBM3 from the tree before it
ONE_PASS_DIGESTS = {
    "f32 polynomial 128x203 C=None sym": "274666ae5ff8f37b",
    "f32 polynomial 128x203 C=None rect": "2f5b0e223c0c4ab4",
    "f32 polynomial 100x37 C=3 sym": "f11c22d1def3f9f2",
    "f32 polynomial 100x37 C=3 rect": "c504ef633cea8953",
    "f32 polynomial 77x512 C=10 sym": "eb6ebb02d0a0ce3e",
    "f32 polynomial 77x512 C=10 rect": "3cb6bf391235a0ed",
    "f32 rbf 128x203 C=None sym": "e6624ef992d914e9",
    "f32 rbf 128x203 C=None rect": "087710af7fac398d",
    "f32 rbf 100x37 C=3 sym": "ad4ec06d592b488f",
    "f32 rbf 100x37 C=3 rect": "e8acc98b56b9c47e",
    "f32 rbf 77x512 C=10 sym": "5e99a1e52a952b39",
    "f32 rbf 77x512 C=10 rect": "39ec747e64160315",
    "f32 sigmoid 128x203 C=None sym": "2718d82ff2147226",
    "f32 sigmoid 128x203 C=None rect": "f492977cbd86f536",
    "f32 sigmoid 100x37 C=3 sym": "4ade653e75c6f38c",
    "f32 sigmoid 100x37 C=3 rect": "4b0ef47af7e45549",
    "f32 sigmoid 77x512 C=10 sym": "214cb90f2fed5e44",
    "f32 sigmoid 77x512 C=10 rect": "eedfa47c211620fe",
    "bf16 polynomial 128x203 C=None sym": "9d1297d980736e41",
    "bf16 polynomial 128x203 C=None rect": "91a9777bb37c5aba",
    "bf16 polynomial 100x37 C=3 sym": "3ddf80c699aa0f7b",
    "bf16 polynomial 100x37 C=3 rect": "8096f978810285f8",
    "bf16 polynomial 77x512 C=10 sym": "5682dd21f47b91a1",
    "bf16 polynomial 77x512 C=10 rect": "13e0c8eaff45d3c2",
    "bf16 rbf 128x203 C=None sym": "71bb833603abe01d",
    "bf16 rbf 128x203 C=None rect": "7e93a30e2c13dea6",
    "bf16 rbf 100x37 C=3 sym": "0d590cf1440e051c",
    "bf16 rbf 100x37 C=3 rect": "cb744429e254d5a2",
    "bf16 rbf 77x512 C=10 sym": "1b1c2915faa2c0dd",
    "bf16 rbf 77x512 C=10 rect": "b08934f341aaeba9",
    "bf16 sigmoid 128x203 C=None sym": "00ff7068d6517449",
    "bf16 sigmoid 128x203 C=None rect": "ee1ef13849a06924",
    "bf16 sigmoid 100x37 C=3 sym": "fc7855e2ecb2792e",
    "bf16 sigmoid 100x37 C=3 rect": "222227602a35fc88",
    "bf16 sigmoid 77x512 C=10 sym": "6e4c78b608d4aae7",
    "bf16 sigmoid 77x512 C=10 rect": "81feaf916d3c8719",
}


def _one_pass_outputs(device):
    """{(tier, kind, m, d, classes, walk): sha256 prefix} of the sym and
    rect tiles' outputs at "f32" and "bf16" on seeded ONE_BLOCK_SHAPES
    operands (norms computed on the host)."""
    import hashlib

    out = {}
    for tier in ("f32", "bf16"):
        for name in COEF0:
            g = torch.Generator().manual_seed(56)
            for m, d, classes in ONE_BLOCK_SHAPES:
                X = (torch.randn(m, d, generator=g, dtype=torch.float64) * 0.3).float()
                shape = (m,) if classes is None else (m, classes)
                V = torch.randn(*shape, generator=g, dtype=torch.float64).float()
                P = X[: m // 2 + 1].flip(0).contiguous()
                sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
                X, V, P, sq, sq_p = (t.to(device) for t in (X, V, P, sq, sq_p))
                kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d,
                          coef0=COEF0[name], degree=3, precision=tier)
                module = gram_matvec if classes is None else gram_matmat
                op = "matvec" if classes is None else "matmat"
                for walk, got in (
                        ("sym", getattr(module, f"gram_{op}_sym")(X, sq, V, **kw)),
                        ("rect", getattr(module, f"gram_{op}_rect")(P, X, sq_p, sq, V, **kw))):
                    digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
                    out[f"{tier} {name} {m}x{d} C={classes} {walk}"] = digest
    return out


@pytest.mark.cuda
def test_one_pass_tiers_give_the_bits_they_gave_before(cuda_device):
    """The "f32" and "bf16" launches of the sym and rect tiles, which share
    their code with the split tier, give the bits they gave before it, on
    one-block tiles (twice, so the bits are the kernel's own)."""
    first = _one_pass_outputs(cuda_device)
    assert _one_pass_outputs(cuda_device) == first
    assert first == ONE_PASS_DIGESTS


#: one-block dual tiles (mr, mc <= 128: one slot per output entry and
#: class, so the bits are the kernel's own): (mr, mc, d, classes)
DUAL_ONE_BLOCK_SHAPES = [(128, 100, 203, None), (100, 77, 37, 3), (77, 128, 512, 10)]
#: the first 16 hex digits of the sha256 of kernel J's / K's two outputs on
#: the dual tensor-core tile at "f32" and "bf16" on DUAL_ONE_BLOCK_SHAPES
#: (``_dual_one_pass_outputs``), as the tile gave them before the split
#: tier shared its code, recorded on an NVIDIA H100 80GB HBM3 from the tree
#: before it
DUAL_ONE_PASS_DIGESTS = {
    "f32 polynomial 128x100x203 C=None": "ba79e753d2d6ac70",
    "f32 polynomial 100x77x37 C=3": "14e1eaf0e05632d1",
    "f32 polynomial 77x128x512 C=10": "687e8179ae94267f",
    "f32 rbf 128x100x203 C=None": "7fb67b522ff9aac5",
    "f32 rbf 100x77x37 C=3": "fef2247a671744cc",
    "f32 rbf 77x128x512 C=10": "8ad7b6033a3b8718",
    "f32 sigmoid 128x100x203 C=None": "c37155274862698c",
    "f32 sigmoid 100x77x37 C=3": "ebce8570c735f7a5",
    "f32 sigmoid 77x128x512 C=10": "b413001e6652559e",
    "bf16 polynomial 128x100x203 C=None": "eb79d642dfcd69b6",
    "bf16 polynomial 100x77x37 C=3": "1d588f906847530b",
    "bf16 polynomial 77x128x512 C=10": "237b4f37ab9d14ea",
    "bf16 rbf 128x100x203 C=None": "70cc26fc8f3be219",
    "bf16 rbf 100x77x37 C=3": "6176cf62ccc03e9f",
    "bf16 rbf 77x128x512 C=10": "43883aa76f2c1605",
    "bf16 sigmoid 128x100x203 C=None": "b11512b229b78052",
    "bf16 sigmoid 100x77x37 C=3": "263510f9952e6e38",
    "bf16 sigmoid 77x128x512 C=10": "8aee921308182072",
}


def _dual_one_pass_outputs(device):
    """{(tier, kind, mr x mc x d, classes): sha256 prefix} of kernels J and
    K on the dual tile at "f32" and "bf16" on seeded DUAL_ONE_BLOCK_SHAPES
    operands (norms computed on the host), both outputs."""
    import hashlib

    out = {}
    for tier in ("f32", "bf16"):
        for name in COEF0:
            g = torch.Generator().manual_seed(61)
            for mr, mc, d, classes in DUAL_ONE_BLOCK_SHAPES:
                Xr = (torch.randn(mr, d, generator=g, dtype=torch.float64) * 0.3).float()
                Xc = (torch.randn(mc, d, generator=g, dtype=torch.float64) * 0.3).float()
                tail = () if classes is None else (classes,)
                V_c = torch.randn(mc, *tail, generator=g, dtype=torch.float64).float()
                V_r = torch.randn(mr, *tail, generator=g, dtype=torch.float64).float()
                sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
                args = [t.to(device) for t in (Xr, Xc, sq_r, sq_c, V_c, V_r)]
                kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d,
                          coef0=COEF0[name], degree=3, precision=tier)
                fn = (gram_matvec.gram_matvec_dual if classes is None
                      else gram_matmat.gram_matmat_dual)
                out_r, out_c = fn(*args, **kw)
                digest = hashlib.sha256(out_r.cpu().numpy().tobytes()
                                        + out_c.cpu().numpy().tobytes())
                out[f"{tier} {name} {mr}x{mc}x{d} C={classes}"] = digest.hexdigest()[:16]
    return out


@pytest.mark.cuda
def test_dual_one_pass_tiers_give_the_bits_they_gave_before(cuda_device):
    """J and K at "f32" and "bf16" on the dual tile, which shares its code
    with K's split tier, give the bits they gave before it, on one-block
    tiles (twice, so the bits are the kernel's own)."""
    first = _dual_one_pass_outputs(cuda_device)
    assert _dual_one_pass_outputs(cuda_device) == first
    assert first == DUAL_ONE_PASS_DIGESTS


@pytest.mark.cuda
@pytest.mark.parametrize("n_classes", [None, 3])
def test_split_tile_with_a_zero_lo_is_the_tf32_tile(cuda_device, n_classes):
    """The split tile's first pass is the TF32 tile's product: on a stack
    [tf32(X); 0] kernels A-D give the "f32" tier's bits (each later pass
    adds zero products), on one-block tiles."""
    X, sq, V = _tc_operands(128, 203, n_classes, 57, cuda_device)
    P = X[:65].flip(0).contiguous()
    sq_p = (P * P).sum(-1)
    kw = dict(kind=TKind.RBF, gamma=1.0 / 203, coef0=0.0, degree=3)
    lib = gram_matvec._build.load()
    classes = () if n_classes is None else (n_classes,)
    op = "matvec" if n_classes is None else "matmat"
    zero_lo = torch.stack([gram_matvec.tier_operand(X, "f32"),
                           torch.zeros(128, 204, device=cuda_device)])
    out = torch.zeros_like(V)
    gram_matvec.launch_sym_tc(lib, op, X, sq, V, out, classes, kw["kind"], 1.0 / 203,
                              0.0, 3, "highest", zero_lo)
    module = gram_matvec if n_classes is None else gram_matmat
    sym = getattr(module, f"gram_{op}_sym")
    assert torch.equal(out, sym(X, sq, V, precision="f32", **kw))
    assert not torch.equal(out, sym(X, sq, V, precision="highest", **kw))


@pytest.mark.cuda
def test_split_operand_made_once_is_the_one_made_per_call(cuda_device):
    """Kernels A and C on a solve's split stack (``tier_operand`` made once)
    give what they give on the stack they make per call, bit for bit on one
    tile; an operand of another tier or shape is refused."""
    for n_classes in (None, 10):
        X, sq, V = _tc_operands(100, 37, n_classes, 58, cuda_device)
        kw = dict(kind=TKind.RBF, gamma=1.0 / 37, coef0=0.0, degree=3, precision="highest")
        sym = gram_matvec.gram_matvec_sym if n_classes is None else gram_matmat.gram_matmat_sym
        op = gram_matvec.tier_operand(X, "highest")
        assert op.shape == (2, 100, 40)
        assert torch.equal(sym(X, sq, V, operand=op, **kw), sym(X, sq, V, **kw))
        with pytest.raises(ValueError, match="operand copy"):
            sym(X, sq, V, operand=gram_matvec.tier_operand(X, "f32"), **kw)


@pytest.mark.cuda
def test_split_tile_raises_on_a_failed_launch(cuda_device):
    """No fallback: a split stack that TMA refuses (a view 4 bytes past a
    16-byte boundary) makes the launch fail, and the wrapper raises and
    counts nothing."""
    from plssvm_tpu_torch.exceptions import KernelLaunchError

    X, sq, v = _tc_operands(100, 37, None, 59, cuda_device)
    buf = torch.zeros(2 * 100 * 40 + 1, device=cuda_device)
    op = buf[1:].view(2, 100, 40)
    op.copy_(gram_matvec.tier_operand(X, "highest"))
    before = gram_matvec.sym_tc_launches, gram_matvec.sym_launches
    with pytest.raises(KernelLaunchError, match="highest"):
        gram_matvec.gram_matvec_sym(X, sq, v, kind=TKind.RBF, gamma=0.1, coef0=0.0,
                                    degree=3, precision="highest", operand=op)
    assert (gram_matvec.sym_tc_launches, gram_matvec.sym_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_classes", [None, 10])
def test_split_tier_is_as_close_to_float64_as_the_ffma_tile(cuda_device, n_classes):
    """The split tier against the float64 plain version: within 4x the
    FFMA tile's own error (the dropped lo lo^T is 2^-22 of a product where
    float32 rounds to 2^-24, both under the d-term accumulation), at
    MNIST's width."""
    X, sq, V = _tc_operands(1037, 784, n_classes, 60, cuda_device)
    kw = dict(kind=TKind.RBF, gamma=1.0 / 784, coef0=0.0, degree=3)
    plain = matvec.kernel_matvec_plain if n_classes is None else matvec.kernel_matmat_plain
    want = plain(X.double(), sq.double(), V.double(), **kw)
    sym = gram_matvec.gram_matvec_sym if n_classes is None else gram_matmat.gram_matmat_sym
    split = (sym(X, sq, V, precision="highest", **kw).double() - want).abs().max()
    ffma = gram_matvec.gram_ffma("matvec_sym" if n_classes is None else "matmat_sym",
                                 (X,), (sq,), V, **kw)
    assert split <= 4 * (ffma.double() - want).abs().max()


#: ragged blocks: d not a multiple of 4 or 8 (TMA pads the tensor-core
#: tile's operand copies), mr or mc under one 128-row tile, more column
#: tiles than a run of the tensor-core tile takes (kTcMaxRun = 8), and
#: enough tiles for runs of 2 with a short last run (2100 x 17000)
DUAL_SHAPES = [(1, 1, 5), (65, 129, 3), (300, 77, 203), (1037, 513, 37), (129, 300, 1280),
               (130, 1100, 13), (2100, 17000, 37)]
#: the edges of the matvec walk's persistent grid (J at "highest", L;
#: csrc/dual.cu): exactly one row tile of 128 rows and one step of 8
#: strips, and of 64 (chi-squared, float64 laplacian strips of 8 columns);
#: one tile plus one row, plus one column; d = 1, 15, 16, 17 and 784 (one
#: chunk of 16 features, one more or one less); fewer units than the
#: card's SMs; more than one wave of blocks; mr != mc both ways
WALK_SHAPES = [(128, 128, 16), (64, 64, 16), (129, 128, 17), (128, 129, 15), (65, 64, 1),
               (300, 200, 16), (2500, 2100, 17), (300, 2500, 784)]


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
@pytest.mark.parametrize("mr,mc,d", DUAL_SHAPES + WALK_SHAPES)
def test_gram_dual_against_plain(cuda_device, mr, mc, d, n_classes, name, precision, dtype, tol):
    """Kernels J (v (m,)) and K (V (m, C)) on ragged mr != mc blocks, both
    outputs, against the plain version on the tier's operands; one launch,
    on the dual tensor-core tile (dual_tc_launches) at "f32" and "bf16" on
    float32 and for K at "highest" too (three TF32 passes, against the
    full-float32 plain version), J at "highest" on its matvec walk
    (dual_launches), on the dual DMMA tile (dual_dmma_launches) in
    float64."""
    Xr, Xc, v_c, v_r = _dual_case(mr, mc, d, n_classes, dtype, 52, cuda_device)
    sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d, coef0=COEF0[name],
              degree=3, precision=precision)
    module, plain = ((gram_matvec, matvec.kernel_matvec_dual_plain) if n_classes is None
                     else (gram_matmat, matvec.kernel_matmat_dual_plain))
    kernel = gram_matvec.gram_matvec_dual if n_classes is None else gram_matmat.gram_matmat_dual
    before = module.dual_launches, module.dual_tc_launches, module.dual_dmma_launches
    got = kernel(Xr, Xc, sq_r, sq_c, v_c, v_r, **kw)
    tc = (precision != "highest" or n_classes is not None) and dtype == torch.float32
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
@pytest.mark.parametrize("mr,mc,d", DUAL_SHAPES + WALK_SHAPES)
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
@pytest.mark.parametrize("name,dtype,tol", [
    ("laplacian", torch.float32, 1e-4), ("laplacian", torch.float64, 1e-10),
    ("chi_squared", torch.float32, 1e-4), ("chi_squared", torch.float64, 1e-10),
    ("rbf", torch.float32, 1e-4),
])
@pytest.mark.parametrize("mr,mc,d", [(300, 200, 15), (129, 2100, 203)])
def test_dual_walk_on_unaligned_views(cuda_device, mr, mc, d, name, dtype, tol):
    """The matvec walk (L; J at "highest", float32 only: float64 J takes the
    dual DMMA tile) on row views one row into their storage with d odd, so
    that no row of Xr or Xc starts on a 16-byte boundary, both outputs
    against the plain version."""
    Xr, Xc, v_c, v_r = _dual_case(mr + 1, mc + 1, d, None, dtype, 55, cuda_device, True)
    Xr, Xc, v_c, v_r = Xr[1:], Xc[1:], v_c[1:], v_r[1:]
    assert Xr.is_contiguous() and Xr.data_ptr() % 16 and Xc.data_ptr() % 16
    if name == "rbf":
        sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
        kw = dict(kind=TKind.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
        before = gram_matvec.dual_launches
        got = gram_matvec.gram_matvec_dual(Xr, Xc, sq_r, sq_c, v_c, v_r, precision="highest",
                                           **kw)
        assert gram_matvec.dual_launches == before + 1
        want = matvec.kernel_matvec_dual_plain(Xr, Xc, sq_r, sq_c, v_c, v_r,
                                               precision="highest", **kw)
    else:
        kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d)
        before = distance.matvec_dual_launches
        got = distance.distance_matvec_dual(Xr, Xc, v_c, v_r, **kw)
        assert distance.matvec_dual_launches == before + 1
        want = matvec.distance_matvec_dual_plain(Xr, Xc, v_c, v_r, **kw)
    for g, w in zip(got, want):
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
    ("rbf", None, "highest", torch.float32), ("rbf", 10, "highest", torch.float32),
])
def test_ring_on_one_card(cuda_device, P, name, n_classes, precision, dtype):
    """The symmetric ring over P shards on cuda:0 against the single-device
    product at the same tier, and its launches: per shard one symmetric
    launch, floor((P - 1) / 2) dual and, for even P, one rows-only launch,
    in float64 the symmetric, dual and rows-only ones on the DMMA tiles
    (Gram kinds), in float32 on the tensor-core tiles (sym_tc, dual_tc,
    rect_tc; at "highest" three TF32 passes, but J on its matvec walk,
    dual_launches), none on another tile (K's FFMA tile included).
    Float64 within 1e-10 of max|single|, float32 within 1e-4 (the same
    tier's products summed in another order; J's walk at "highest" in full
    float32)."""
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
        if dtype == torch.float32 and precision == "highest" and n_classes is None:
            dual, other = "dual_launches", ("sym_launches", "dual_tc_launches",
                                            "rect_launches")
        assert sum(getattr(module, c) for c in other) == 0
    got = torch.cat(outs)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert torch.isfinite(got).all()
    assert (got - single).abs().max() <= tol * single.abs().max()
    counts = [getattr(module, c) for c in (sym, dual, rect)]
    # the single-device product above added one symmetric launch
    assert counts == [P + 1, P * ((P - 1) // 2), P if P % 2 == 0 else 0]


#: the ring's blocks and odd neighbours of them, where kernel K at
#: "highest" runs on the split dual tile: MNIST width's 15000^2 x 784,
#: config 3 width's 12500^2 x 500 with odd sides, a block of odd sides whose
#: d leaves a part of a 32-feature box
SPLIT_DUAL_SHAPES = [(15000, 15000, 784), (12501, 12499, 499), (2101, 1337, 785)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_classes", [1, 3, 10])
@pytest.mark.parametrize("mr,mc,d", SPLIT_DUAL_SHAPES)
def test_split_dual_tile_against_full_float32(cuda_device, mr, mc, d, n_classes):
    """Kernel K at "highest" (the split dual tile, three TF32 passes) at the
    ring's shapes against the full-float32 plain version, both outputs
    within 1e-4 of max|plain| (the split tiles' gate; its error is about
    2^-22 relative per Gram entry); one launch on ``dual_tc_launches``,
    none on the FFMA tile's counter.  K's FFMA tile (``gram_ffma``, on no
    wrapper's path since, chip_smoke.py's before-time) within the same."""
    Xr, Xc, v_c, v_r = _dual_case(mr, mc, d, n_classes, torch.float32, 59, cuda_device)
    sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
    kw = dict(kind=TKind.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
    gram_matmat.reset_counts()
    got = gram_matmat.gram_matmat_dual(Xr, Xc, sq_r, sq_c, v_c, v_r, precision="highest",
                                       **kw)
    assert (gram_matmat.dual_tc_launches, gram_matmat.dual_launches) == (1, 0)
    want = matvec.kernel_matmat_dual_plain(Xr, Xc, sq_r, sq_c, v_c, v_r, **kw)
    ffma = gram_matvec.gram_ffma("matmat_dual", (Xr, Xc), (sq_r, sq_c), (v_c, v_r), **kw)
    assert gram_matmat.dual_launches == 1
    for g, w, f in zip(got, want, ffma):
        assert g.shape == w.shape == f.shape and torch.isfinite(g).all()
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
        assert (f - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.mark.cuda
def test_split_dual_tile_on_the_ring_operands_made_once(cuda_device):
    """Kernel K at "highest" on a pair of split stacks made once (as the
    ring makes each shard's once per solve) gives what it gives on the
    stacks it makes per call, bit for bit on one tile; a stack of another
    tier is refused."""
    Xr, Xc, v_c, v_r = _dual_case(100, 77, 37, 3, torch.float32, 60, cuda_device)
    sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
    kw = dict(kind=TKind.RBF, gamma=1.0 / 37, coef0=0.0, degree=3, precision="highest")
    pair = (gram_matvec.tier_operand(Xr, "highest"), gram_matvec.tier_operand(Xc, "highest"))
    once = gram_matmat.gram_matmat_dual(Xr, Xc, sq_r, sq_c, v_c, v_r, operand=pair, **kw)
    per_call = gram_matmat.gram_matmat_dual(Xr, Xc, sq_r, sq_c, v_c, v_r, **kw)
    assert all(torch.equal(a, b) for a, b in zip(once, per_call))
    with pytest.raises(ValueError, match="operand copy"):
        gram_matmat.gram_matmat_dual(Xr, Xc, sq_r, sq_c, v_c, v_r, **kw, operand=(
            gram_matvec.tier_operand(Xr, "f32"), pair[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "highest"])
def test_ring_operands_made_once_give_the_per_call_bits(cuda_device, precision):
    """The ring with its shards' operand copies made once
    (``sharded.shard_operands``) gives the ring's bits with copies made per
    call, on blocks of one tile each: the same
    copies, only made earlier."""
    from plssvm_tpu_torch.parallel import sharded

    X, _, _, V = _dual_case(300, 1, 37, 3, torch.float32, 62, cuda_device)
    sq = (X * X).sum(-1)
    bounds = sharded.shard_bounds(300, 3)
    devices = [cuda_device] * 3
    X_shards = sharded.shard_rows(X, bounds, devices)
    sq_shards = sharded.shard_rows(sq, bounds, devices)
    V_shards = sharded.shard_rows(V, bounds, devices)
    operands = sharded.shard_operands(X_shards, TKind.RBF, "cuda", precision)
    assert operands is not None and len(operands) == 3
    kw = dict(kind=TKind.RBF, degree=3, impl="cuda", precision=precision)
    once = sharded.ring_kernel_matmat(X_shards, sq_shards, V_shards, 1.0 / 37, 0.0,
                                      operands=operands, **kw)
    per_call = sharded.ring_kernel_matmat(X_shards, sq_shards, V_shards, 1.0 / 37, 0.0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(once, per_call))


# -- kernel N and the explicit solver (csrc/kernel_matrix.cu) ----------------


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["laplacian", "chi_squared"])
@pytest.mark.parametrize("m,d", [(1, 3), (63, 5), (65, 17), (129, 33), (257, 200), (1000, 784)])
def test_kernel_matrix_sym_is_the_rect_walk_bit_for_bit(cuda_device, name, dtype, out_dtype,
                                                        m, d):
    """Kernel N's symmetric walk, whose off-diagonal tiles are stored
    through shared memory transposed, gives bit for bit what its rect walk
    (each tile stored as it is) computes for X against itself, and an
    exactly symmetric K, on m not a multiple of the tile edge (64 or 128)
    and on multiples of it."""
    from plssvm_tpu_torch.ops import kernel_matrix

    X, _, _, _ = _dual_case(m, 1, d, None, dtype, 63, cuda_device, non_negative=True)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d, out_dtype=out_dtype)
    sym = kernel_matrix.kernel_matrix_sym(X, **kw)
    assert torch.equal(sym, kernel_matrix.kernel_matrix_rect(X, X, **kw))
    assert torch.equal(sym, sym.T)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("name", ["laplacian", "chi_squared"])
@pytest.mark.parametrize("mr,mc,d", [(1, 1, 1), (70, 131, 17), (300, 257, 203),
                                     (1037, 129, 784)])
def test_kernel_matrix_against_plain(cuda_device, name, dtype, tol, out_dtype, mr, mc, d):
    """Kernel N's symmetric and rectangular walks on zero-rich rows against
    the plain version: K in its type within the type's tolerance (K <= 1),
    in bfloat16 within one bf16 rounding (2^-8); the symmetric K exactly
    symmetric with a unit diagonal; one launch each."""
    from plssvm_tpu_torch.ops import kernel_matrix

    tkind = getattr(TKind, name.upper())
    g = torch.Generator().manual_seed(mr + mc + d)
    X = torch.rand(mr, d, generator=g, dtype=torch.float64)
    Y = torch.rand(mc, d, generator=g, dtype=torch.float64)
    X[X < 0.33] = 0.0
    Y[Y < 0.33] = 0.0
    X, Y = X.to(cuda_device, dtype), Y.to(cuda_device, dtype)
    kw = dict(kind=tkind, gamma=1.0 / d, out_dtype=out_dtype)
    kernel_matrix.reset_counts()
    sym = kernel_matrix.kernel_matrix_sym(X, **kw)
    rect = kernel_matrix.kernel_matrix_rect(X, Y, **kw)
    limit = tol if out_dtype is None else 2.0 ** -8
    for got, want in ((sym, kernel_matrix.kernel_matrix_sym_plain(X, **kw)),
                      (rect, kernel_matrix.kernel_matrix_rect_plain(X, Y, **kw))):
        assert got.dtype == want.dtype and torch.isfinite(got.double()).all()
        assert (got.double() - want.double()).abs().max() <= limit
    assert torch.equal(sym, sym.T) and bool((sym.diagonal() == 1).all())
    assert (kernel_matrix.sym_launches, kernel_matrix.rect_launches) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ENTRY_CASES)
@pytest.mark.parametrize("d", [3, 203, 784])
def test_kernel_matrix_chi_squared_per_entry(cuda_device, case, d):
    """Float32 chi-squared per entry of K (``entry_errors``, one-hot
    columns of the stored K): within 4x the float32 plain version's own
    error against float64, and 1e-4, as kernels E-H."""
    from plssvm_tpu_torch.ops import kernel_matrix

    gen = torch.Generator().manual_seed(d)
    _, X, columns = next(c for c in entry_cases(d, gen) if c[0] == case)
    X = X.to(cuda_device, torch.float32)
    gamma = chi2_gamma(X, columns)
    K = kernel_matrix.kernel_matrix_sym(X, kind=TKind.CHI_SQUARED, gamma=gamma)
    got, plain = entry_errors(lambda _X, V, **kw: K @ V, X, columns, gamma)
    assert got <= min(4 * plain, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("columns", [0, 10])
def test_explicit_product_of_a_bf16_matrix(cuda_device, dtype, columns):
    """A bfloat16 K times v rounded to bfloat16, summed in the solve's type
    (float32: ``torch.mm(..., out_dtype=torch.float32)``), against float64."""
    from plssvm_tpu_torch.solver import explicit

    g = torch.Generator().manual_seed(5)
    K = torch.rand(3001, 3001, generator=g, dtype=torch.float64).to(cuda_device, torch.bfloat16)
    V = torch.randn((3001, columns) if columns else (3001,), generator=g,
                    dtype=torch.float64).to(cuda_device, dtype)
    got = explicit.explicit_product(K, V, dtype)
    want = K.double() @ V.to(torch.bfloat16).double()
    assert got.dtype == dtype and got.shape == V.shape
    assert (got.double() - want).abs().max() <= (1e-4 if dtype == torch.float32 else 1e-12) * \
        want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("columns", [0, 3, 10])
@pytest.mark.parametrize("symmetric", [False, True])
def test_explicit_product_of_a_float32_matrix(cuda_device, columns, symmetric):
    """A float32 K of 30001 rows (positive entries, as a distance kernel's)
    times v, contracted in slices of PRODUCT_COLUMNS columns or, symmetric,
    PRODUCT_ROWS rows: within 1e-6 of float64 in the Frobenius norm, where
    one cuBLAS call over all 30001 columns sums each output in one float32
    chain."""
    from plssvm_tpu_torch.solver import explicit

    g = torch.Generator(device=cuda_device).manual_seed(6)
    K = torch.rand(30001, 30001, generator=g, device=cuda_device)
    if symmetric:
        K = (K + K.T) / 2
    V = torch.randn((30001, columns) if columns else (30001,), generator=g,
                    dtype=torch.float64, device=cuda_device)
    got = explicit.explicit_product(K, V.float(), torch.float32, symmetric=symmetric)
    want = torch.cat([K[i:i + 4096].double() @ V for i in range(0, 30001, 4096)])
    assert got.dtype == torch.float32 and got.shape == V.shape
    assert float(torch.linalg.norm(got.double() - want) / torch.linalg.norm(want)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,n_classes", [("laplacian", 2), ("chi_squared", 4),
                                              ("rbf", 3)])
@pytest.mark.parametrize("devices", [None, ["cuda:0"] * 3])
def test_explicit_fit_on_the_card(cuda_device, kernel, n_classes, devices):
    """A float64 ``cg_explicit`` fit through the kernels (kernel N for the
    distance kernels, on one device or three shards of cuda:0, where each
    shard builds its row block one column block a shard: 3 x 3 rect walks)
    against the same fit through the plain versions (``backend="torch"``)
    on the card: rho within 1e-8."""
    import numpy as np

    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import kernel_matrix

    port.set_verbosity("quiet")
    rng = np.random.default_rng(n_classes)
    y = rng.integers(0, n_classes, 300)
    X = np.abs(rng.normal(size=(300, 12)) + rng.normal(size=(n_classes, 12))[y])
    data = port.DataSet(X, y, scaling=(0.0, 1.0))
    where = dict(device="cuda") if devices is None else dict(devices=devices)
    kernel_matrix.reset_counts()
    models = [port.CSVM(backend=b, dtype=np.float64, kernel_type=kernel, solver="cg_explicit",
                        **where).fit(port.DataSet(X, y, scaling=(0.0, 1.0)), epsilon=1e-10)
              for b in ("cuda", "torch")]
    assert data.num_data_points == 300
    distance_kind = kernel != "rbf"
    assert (kernel_matrix.sym_launches, kernel_matrix.rect_launches) == (
        (int(distance_kind and devices is None), 9 * (distance_kind and devices is not None)))
    assert models[0].n_iter == models[1].n_iter
    assert np.max(np.abs(np.asarray(models[0].rho) - np.asarray(models[1].rho))) <= 1e-8


#: kernel O's ragged machines: an empty one, one row, two rows, one tile and
#: a row, several tiles (the FFMA walk's float tiles 128 / 64 rows, double
#: 64; the tensor-core walks' 128), and more than the FFMA walk's 16 groups
#: of tiles a side at edge 128 (2200 rows: 18 tiles, two a group; 35 and
#: 18 at edge 64), so that a group holds several tiles for every kind and
#: type
PAIRS_LENS = [(2, 0, 1, 129, 300), (65, 64, 63), (1,), (257, 2, 384), (2200, 1, 1100)]


def _pairs_case(name, dtype, lens, d, device, seed):
    """A seeded ragged stack (zero past each machine), its norms (None for
    the distance kinds), right-hand side and lengths on ``device``."""
    g = torch.Generator().manual_seed(seed)
    P, m_pad = len(lens), max(lens)
    mask = torch.arange(m_pad)[None, :] < torch.tensor(lens)[:, None]
    X = torch.rand(P, m_pad, d, generator=g, dtype=dtype)
    if name != "chi_squared":
        X = (X - 0.5) * 0.6
    X = (X * mask[..., None]).to(device)
    V = (torch.randn(P, m_pad, generator=g, dtype=dtype) * mask).to(device)
    sq = None if name in ("laplacian", "chi_squared") else (X * X).sum(-1)
    return X, sq, V, torch.tensor(lens, dtype=torch.int64, device=device), mask.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("name", list(COEF0) + ["laplacian", "chi_squared"])
@pytest.mark.parametrize("lens", PAIRS_LENS)
@pytest.mark.parametrize("d", [3, 37, 200])
@pytest.mark.parametrize("precision", ["f32", "bf16", "highest"])
def test_pairs_matvec_against_plain(cuda_device, name, dtype, tol, lens, d, precision):
    """Kernel O against its plain version, every kind at every tier in
    float32 and float64 on ragged machines (one of 2 rows; d = 3 and 37 no
    multiple of 4 or 8): relative to max|plain| on the tier's operands (the
    TF32 walk against the plain version on ``round_to_tf32``'s rows with
    the float32 norms, the bf16 walk against the plain version at "bf16"),
    rows past each machine's length exactly 0, a second launch bit for bit
    the first, each launch counted on its walk's counter: the tensor-core
    walk for the Gram kinds at "f32" / "bf16" in float32 and at every tier
    in float64 (DMMA), the FFMA walk else."""
    from plssvm_tpu_torch.ops import pairs

    tkind = getattr(TKind, name.upper())
    X, sq, V, lens_t, mask = _pairs_case(name, dtype, lens, d, cuda_device, 17 + d)
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0.get(name, 0.0), degree=3)
    route = pairs.walk(X, tkind, precision)
    counter = {"tc": "tc_launches", "dmma": "dmma_launches", "ffma": "launches"}[route]
    before = getattr(pairs, counter)
    got = pairs.pairs_matvec(X, sq, V, lens_t, precision=precision, **kw)
    again = pairs.pairs_matvec(X, sq, V, lens_t, precision=precision, **kw)
    oracle = matvec.round_to_tf32(X) if route == "tc" and precision == "f32" else X
    want = pairs.pairs_matvec_plain(oracle, sq, V, lens_t, precision=precision, **kw)
    assert getattr(pairs, counter) == before + 2
    assert torch.equal(got, again)
    assert bool((got[~mask] == 0).all())
    assert (got - want).abs().max() <= tol * max(float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["rbf", "sigmoid", "laplacian", "chi_squared"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "highest"])
@pytest.mark.parametrize("lens", [(300, 2, 129, 511, 1), (2200, 1, 1100)])
def test_pairs_machine_alone_equals_inside_the_stack(cuda_device, dtype, name, precision,
                                                     lens):
    """A machine gives bit for bit the same output alone (a stack of one,
    its own length for m_pad) as inside a stack of neighbours with a longer
    m_pad, on every walk: no walk reads a neighbour's rows into a sum, and
    the FFMA walk groups a machine's tiles by its own length (2200 rows:
    several tiles a group, a longer workspace slot inside the stack than
    alone)."""
    from plssvm_tpu_torch.ops import pairs

    X, sq, V, lens_t, _ = _pairs_case(name, dtype, lens, 37, cuda_device, 5)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / 37, coef0=COEF0.get(name, 0.0),
              degree=3, precision=precision)
    inside = pairs.pairs_matvec(X, sq, V, lens_t, **kw)
    for p, n in enumerate(lens):
        if n == 0:
            continue
        alone = pairs.pairs_matvec(
            X[p:p + 1, :n].contiguous(), None if sq is None else sq[p:p + 1, :n].contiguous(),
            V[p:p + 1, :n].contiguous(), lens_t[p:p + 1].clone(), **kw)
        assert torch.equal(alone[0], inside[p, :n])


@pytest.mark.cuda
def test_pairs_operand_made_once_is_the_one_made_per_call(cuda_device):
    """Kernel O on a solve's operand copy (``pairs_operand``) gives what it
    gives on the copy it makes itself, and refuses a copy of another
    tier."""
    from plssvm_tpu_torch.ops import pairs

    X, sq, V, lens_t, _ = _pairs_case("rbf", torch.float32, (65, 200), 37, cuda_device, 8)
    kw = dict(kind=TKind.RBF, gamma=1.0 / 37, coef0=0.0, degree=3)
    for precision in ("f32", "bf16"):
        op = pairs.pairs_operand(X, TKind.RBF, precision)
        assert torch.equal(pairs.pairs_matvec(X, sq, V, lens_t, precision=precision, **kw),
                           pairs.pairs_matvec(X, sq, V, lens_t, precision=precision,
                                              operand=op, **kw))
    with pytest.raises(ValueError, match="operand"):
        pairs.pairs_matvec(X, sq, V, lens_t, precision="f32",
                           operand=pairs.pairs_operand(X, TKind.RBF, "bf16"), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,name,edge", [(torch.float32, "rbf", 128),
                                             (torch.float32, "laplacian", 128),
                                             (torch.float32, "chi_squared", 64),
                                             (torch.float64, "laplacian", 64)])
@pytest.mark.parametrize("length", ["0", "1", "2", "BM-1", "BM", "BM+1", "G*BM", "G*BM+1",
                                    "12132", "400000"])
def test_pairs_workspace_elements(cuda_device, dtype, name, edge, length):
    """The FFMA walk's workspace (csrc/pairs.cu, the one place that holds
    its layout): P G (G + 1) S BM values for P machines padded to m_pad
    rows, with BM the walk's tile edge, T = ceil(m_pad / BM) tiles a side
    and S = ceil(T / G) tiles a group (G = 16 groups a side at most), under
    the (G + 1) (m_pad + G BM) a machine that the wrapper's docstring
    states."""
    from plssvm_tpu_torch.ops import _build

    G, P = 16, 45
    m_pad = eval(length, {"BM": edge, "G": G})
    per_group = -(-(-(-m_pad // edge)) // G)
    n = _build.load().plssvm_pairs_workspace_elements(
        P, m_pad, int(getattr(TKind, name.upper())), int(dtype == torch.float64))
    assert n == P * G * (G + 1) * per_group * edge
    assert n <= P * (G + 1) * (m_pad + G * edge)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,name", [(torch.float32, "chi_squared"),
                                        (torch.float32, "rbf"), (torch.float64, "laplacian")])
def test_pairs_ffma_walk_ignores_what_its_workspace_held(cuda_device, dtype, name):
    """The FFMA walk writes every slot of its uninitialised workspace before
    it reads it: after the caching allocator held NaN in the memory that the
    product's output and workspace are cut from, the product is finite and
    bit for bit a second one."""
    from plssvm_tpu_torch.ops import pairs

    X, sq, V, lens_t, _ = _pairs_case(name, dtype, (2200, 1, 1100), 37, cuda_device, 9)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / 37, coef0=0.0, degree=3,
              precision="highest")
    torch.full((1 << 24,), float("nan"), dtype=dtype, device=cuda_device)
    got = pairs.pairs_matvec(X, sq, V, lens_t, **kw)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, pairs.pairs_matvec(X, sq, V, lens_t, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rbf", "chi_squared"])
@pytest.mark.parametrize("devices", [None, ["cuda:0"] * 3])
def test_batched_oao_fit_on_the_card(cuda_device, kernel, devices):
    """A float64 batched one-vs-one fit through kernel O (on one device, or
    its machines split over three entries of cuda:0) against the same fit
    through the plain versions (``backend="torch"``) on the card: rho
    within 1e-6 and each machine's iterations within 2 (the two sum in other
    orders, and from x = 1 a last-bit change can move a machine's count at
    epsilon 1e-10: on the first card run a chi-squared machine took 15
    against 13)."""
    import numpy as np

    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import pairs

    port.set_verbosity("quiet")
    rng = np.random.default_rng(5)
    y = rng.integers(0, 5, 300)
    X = np.abs(rng.normal(size=(300, 12)) + 2.0 * rng.normal(size=(5, 12))[y])
    where = dict(device="cuda") if devices is None else dict(devices=devices)
    pairs.reset_counts()
    models = [port.CSVM(backend=b, dtype=np.float64, kernel_type=kernel, oao_batch="batched",
                        **where).fit(port.DataSet(X, y, scaling=(0.0, 1.0)),
                                     classification="oao", epsilon=1e-10)
              for b in ("cuda", "torch")]
    # RBF on the DMMA walk, chi-squared on the FFMA walk
    assert (pairs.dmma_launches if kernel == "rbf" else pairs.launches) > 0
    assert max(abs(a - b) for a, b in zip(models[0].n_iter_per_machine,
                                          models[1].n_iter_per_machine)) <= 2
    assert np.max(np.abs(np.asarray(models[0].rho) - np.asarray(models[1].rho))) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rbf", "chi_squared"])
def test_batched_oao_split_is_one_device_bit_for_bit(cuda_device, kernel):
    """The float64 batched one-vs-one fit with its machines split over
    three entries of cuda:0 is the one-device fit's bits: each group's
    plain CG scalars sum its (P_group, m) block padded to the whole stack's
    shape (``machine_sums``), since ``torch.sum`` splits the rows by the
    block's shape."""
    import numpy as np

    import plssvm_tpu_torch as port

    port.set_verbosity("quiet")
    rng = np.random.default_rng(6)
    y = rng.integers(0, 6, 400)
    X = np.abs(rng.normal(size=(400, 12)) + 2.0 * rng.normal(size=(6, 12))[y])
    models = [port.CSVM(backend="cuda", dtype=np.float64, kernel_type=kernel,
                        oao_batch="batched", **where).fit(
        port.DataSet(X, y, scaling=(0.0, 1.0)), classification="oao", epsilon=1e-10)
        for where in (dict(device="cuda"), dict(devices=["cuda:0"] * 3))]
    assert models[0].n_iter_per_machine == models[1].n_iter_per_machine
    assert np.array_equal(np.asarray(models[0].alpha), np.asarray(models[1].alpha))
    assert np.array_equal(np.asarray(models[0].rho), np.asarray(models[1].rho))


def _one_class_dense(X, gamma, cost=1.0):
    """alpha of ``(K + I/C) a = 1`` and the scores ``K a``, in float64 with
    numpy, for the RBF kernel."""
    import numpy as np

    X = np.asarray(X, dtype=np.float64)
    sq = np.sum(X * X, axis=1)
    K = np.exp(-gamma * np.maximum(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, 0.0))
    alpha = np.linalg.solve(K + np.eye(len(X)) / cost, np.ones(len(X)))
    return alpha, K @ alpha


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precision,tol", [
    ("float32", "f32", 3e-3), ("float32", "highest", 1e-4), ("float64", "f32", 1e-9)])
def test_one_class_fit_against_a_dense_solve(cuda_device, dtype, precision, tol):
    """The one-class ridge solve on the card (kernel A at the tier: the
    TF32 tile, the split tile at "highest", the DMMA tile in float64)
    against the float64 dense solve: alpha within ``tol`` of its largest
    magnitude (TF32 rounds the Gram products to 2^-11), A launched once per
    product, the predict's labels those of the dense scores on all but
    1 % of the points near the threshold."""
    import numpy as np

    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import gram_matvec

    port.set_verbosity("quiet")
    X = np.random.default_rng(7).normal(size=(1500, 40))
    gamma = 1.0 / 40
    alpha, g = _one_class_dense(X, gamma)
    svm = port.CSVM(backend="cuda", dtype=np.dtype(dtype), kernel_type="rbf", gamma=gamma,
                    gram_precision=precision, solver="cg_implicit")
    gram_matvec.reset_counts()
    model = port.fit_one_class(svm, port.DataSet(X), nu=0.1,
                               epsilon=1e-10 if dtype == "float64" else 1e-6)
    launched = (gram_matvec.sym_dmma_launches if dtype == "float64"
                else gram_matvec.sym_tc_launches)
    assert launched == model.n_iter + model.n_iter // 50 + 1
    assert np.max(np.abs(model.alpha - alpha)) <= tol * np.max(np.abs(alpha))
    predicted = svm.predict(model, port.DataSet(X))
    want = np.where(g - np.quantile(g, 0.1) > 0, 1, -1)
    assert np.mean(predicted == want) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kernel", ["rbf", "laplacian"])
def test_one_class_ring_against_one_device(cuda_device, kernel, dtype):
    """``CSVM(devices=["cuda:0"] * 4)`` one-class against one device:
    float64 the same iterations, alpha within 1e-10; float32 (the ring's
    compensated shard partials against one device's plain dot) the
    labels on 99.5 % of the points."""
    import numpy as np

    import plssvm_tpu_torch as port

    port.set_verbosity("quiet")
    X = np.random.default_rng(8).normal(size=(2001, 30))
    svms = [port.CSVM(backend="cuda", dtype=np.dtype(dtype), kernel_type=kernel,
                      solver="cg_implicit", **where)
            for where in (dict(device="cuda"), dict(devices=["cuda:0"] * 4))]
    data = port.DataSet(X, dtype=np.dtype(dtype))
    eps = 1e-10 if dtype == "float64" else 1e-6
    one, ring = (port.fit_one_class(svm, data, nu=0.05, epsilon=eps) for svm in svms)
    if dtype == "float64":
        assert one.n_iter == ring.n_iter
        assert np.max(np.abs(one.alpha - ring.alpha)) <= 1e-10 * np.max(np.abs(one.alpha))
    agree = np.mean(svms[0].predict(one, data) == svms[1].predict(ring, data))
    assert agree >= (0.999 if dtype == "float64" else 0.995)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("float64", 1e-10)])
@pytest.mark.parametrize("kernel,devices", [("chi_squared", 1), ("laplacian", 3), ("rbf", 1)])
def test_nystroem_reduction_against_the_cpu(cuda_device, kernel, devices, dtype, tol):
    """``sparse.nystroem_fit`` on the card (kernel N's symmetric walk for
    K_mm and its rect walk for every row block of the distance kinds; the
    Gram build at "highest", full float32, for RBF) against the CPU's
    plain run on the same landmarks: alpha within ``tol`` of its largest
    magnitude, rho within ``tol`` (float32: the normal equations square
    Phi's condition), N's launches 1 symmetric and one rect a row block;
    with ``devices`` three shards of cuda:0, each its own rows."""
    import numpy as np

    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import kernel_matrix

    port.set_verbosity("quiet")
    rng = np.random.default_rng(3)
    y = rng.integers(0, 3, 2000)
    X = np.abs(rng.normal(size=(2000, 24)) + 2.0 * rng.normal(size=(3, 24))[y])
    kw = dict(dtype=np.dtype(dtype), kernel_type=kernel, gram_precision="highest")
    card = port.CSVM(backend="cuda", devices=["cuda:0"] * devices if devices > 1 else None,
                     **kw)
    cpu = port.CSVM(device="cpu", **kw)
    kernel_matrix.reset_counts()
    got, idx = port.nystroem_fit(card, port.DataSet(X, y), n_landmarks=200, row_block=256,
                                 return_indices=True)
    sym, rect = kernel_matrix.sym_launches, kernel_matrix.rect_launches
    want = port.nystroem_fit(cpu, port.DataSet(X, y), landmarks=idx, row_block=256)
    alpha = np.asarray(want.alpha, dtype=np.float64)
    assert np.max(np.abs(got.alpha - alpha)) <= tol * np.max(np.abs(alpha))
    assert np.max(np.abs(np.asarray(got.rho) - np.asarray(want.rho))) <= tol
    # plssvm_tpu's block rule and padded row split, the port's shorter last
    # blocks: 8 blocks on one device, 3 + 3 + 2 on three shards
    block = min(256, max(8, -(-2000 // devices)))
    per = -(-2000 // (block * devices)) * block
    blocks = sum(-(-(min((p + 1) * per, 2000) - p * per) // block) for p in range(devices))
    assert blocks == 8
    assert (sym, rect) == ((1, blocks) if kernel != "rbf" else (0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,need,tiles", [("float32", 0.995, "tc"),
                                              ("float64", 0.999, "dmma")])
def test_multihost_gloo_ranks_on_one_card(cuda_device, tmp_path, dtype, need, tiles):
    """Two gloo ranks on cuda:0 (``tools/multihost_rehearsal.py``, NCCL puts
    no two ranks on one card) fit a one-vs-all set of config 2's shape
    (10 Gaussian classes, 10000 x 200, RBF) from its file and predict 2000
    held-out points, against the in-process ring of 2 shards on the same
    file: labels agree on >= 0.995 (float32) / 0.999 (float64), the ring's
    rules; per rank and product one C and one rows-only D launch (W = 2 has
    no dual step) on the tier's tiles, D once to predict, nothing on the
    plain versions or the FFMA tiles, no jax."""
    import numpy as np

    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.tools import multihost_rehearsal as rehearsal

    port.set_verbosity("quiet")
    rng = np.random.default_rng(11)
    # unit Gaussians around means ~4 apart (chip_smoke.py's classes)
    means = 4.0 / np.sqrt(2.0) * rng.normal(size=(10, 200)) / np.sqrt(200)
    y = rng.integers(0, 10, 12000)
    X = means[y] + rng.normal(size=(12000, 200))
    train, test = str(tmp_path / "train.libsvm"), str(tmp_path / "test.libsvm")
    port.DataSet(X[:10000], y[:10000]).save(train)
    port.DataSet(X[10000:], y[10000:]).save(test)
    csvm = dict(backend="cuda", device="cuda:0", dtype=dtype, kernel_type="rbf",
                solver="cg_implicit")
    records = rehearsal.launch(
        {"tasks": [dict(name="fit", op="fit", file=train, predict=test, csvm=csvm,
                        fit=dict(epsilon=1e-8))]},
        2, str(tmp_path / "out"), device="cuda:0", backend="gloo", timeout=600)
    svm = port.CSVM(backend="cuda", devices=["cuda:0"] * 2, dtype=np.dtype(dtype),
                    kernel_type="rbf", solver="cg_implicit")
    ring = svm.fit(port.DataSet(train, dtype=np.dtype(dtype)), epsilon=1e-8)
    want = svm.predict(ring, port.DataSet(test, dtype=np.dtype(dtype)))
    iterations = records[0]["tasks"][0]["cg.iterations"]
    products = 1 + iterations + iterations // 50
    for rank, record in enumerate(records):
        task = record["tasks"][0]
        got = rehearsal.load_arrays(str(tmp_path / "out"), "fit", rank)["predictions"]
        assert np.mean(got == want) >= need
        assert not record["jax_imported"] and task["staged_bytes"] > 0
        assert task["launches"] == {f"gram_matmat.sym_{tiles}_launches": products,
                                    f"gram_matmat.rect_{tiles}_launches": products}
        assert task["predict_launches"] == {f"gram_matmat.rect_{tiles}_launches": 1}


# -- fixed-order sums: the same call twice gives equal bits ----------------

#: (m, d, classes): odd m over several tiles of every walk, C = 1 as a
#: matvec (None) and as a one-class matmat, and 10 classes
DETERMINISM_SHAPES = [(1037, 203, None), (1037, 203, 1), (2053, 37, 10)]
#: the tiers of float32 at which each Gram walk runs, and float64
GRAM_TIERS = [(torch.float32, "f32"), (torch.float32, "bf16"),
              (torch.float32, "highest"), (torch.float64, "f32")]


def _determinism_case(walk, dtype, tier, m, d, classes, device):
    """A zero-argument call of the walk's wrapper on seeded operands."""
    g = torch.Generator().manual_seed(m * 31 + d)

    def normal(*shape, positive=False):
        t = torch.randn(*shape, generator=g, dtype=torch.float64)
        return (t.abs() if positive else t).to(device, dtype)

    tail = () if classes is None else (classes,)
    module = gram_matvec if classes is None else gram_matmat
    op = "matvec" if classes is None else "matmat"
    kw = dict(kind=TKind.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
    X = normal(m, d) * 0.3
    P = normal(m // 2 + 1, d) * 0.3
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    V = normal(m, *tail)
    if walk == "sym":
        return lambda: getattr(module, f"gram_{op}_sym")(X, sq, V, precision=tier, **kw)
    if walk == "rect":
        return lambda: getattr(module, f"gram_{op}_rect")(P, X, sq_p, sq, V, precision=tier,
                                                         **kw)
    if walk == "dual":
        V_r = normal(P.shape[0], *tail)
        return lambda: getattr(module, f"gram_{op}_dual")(P, X, sq_p, sq, V, V_r,
                                                          precision=tier, **kw)
    if walk == "ffma":
        name = {"sym": "sym", "rect": "rect"}.get(tier)
        if name is None:  # K's FFMA tile
            V_r = normal(P.shape[0], *tail)
            return lambda: gram_matvec.gram_ffma("matmat_dual", (P, X), (sq_p, sq),
                                                 (V, V_r), **kw)
        operands, norms = ((X,), (sq,)) if name == "sym" else ((P, X), (sq_p, sq))
        return lambda: gram_matvec.gram_ffma(f"{op}_{name}", operands, norms, V, **kw)
    # the distance walks: E-H, L and M, and kernel I
    kind = TKind.LAPLACIAN if tier == "laplacian" else TKind.CHI_SQUARED
    X, P = normal(m, d, positive=True) / d, normal(m // 2 + 1, d, positive=True) / d
    kd = dict(kind=kind, gamma=1.0 if kind == TKind.CHI_SQUARED else 1.0 / d)
    if walk == "distance sym":
        return lambda: getattr(distance, f"distance_{op}_sym")(X, V, **kd)
    if walk == "distance rect":
        return lambda: getattr(distance, f"distance_{op}_rect")(P, X, V, **kd)
    if walk == "distance dual":
        V_r = normal(P.shape[0], *tail)
        return lambda: getattr(distance, f"distance_{op}_dual")(P, X, V, V_r, **kd)
    XT = X.T.contiguous()
    v = normal(m)
    return lambda: banded.banded_matvec(XT, v, 1.0 / d, symmetric=walk == "banded sym")


def _determinism_cases():
    cases = []
    for walk in ("sym", "rect", "dual"):
        for dtype, tier in GRAM_TIERS:
            for shape in DETERMINISM_SHAPES:
                cases.append((walk, dtype, tier) + shape)
    for tier in ("sym", "rect", "dual"):
        for shape in DETERMINISM_SHAPES:
            if tier != "dual" or shape[2] is not None:
                cases.append(("ffma", torch.float32, tier) + shape)
    for walk in ("distance sym", "distance rect", "distance dual"):
        for dtype in (torch.float32, torch.float64):
            for tier in ("laplacian", "chi_squared"):
                for shape in DETERMINISM_SHAPES:
                    cases.append((walk, dtype, tier) + shape)
    for walk in ("banded sym", "banded rect"):
        for dtype in (torch.float32, torch.float64):
            cases.append((walk, dtype, "laplacian", 1037, 203, None))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("walk,dtype,tier,m,d,classes", _determinism_cases())
def test_the_same_call_twice_gives_equal_bits(cuda_device, walk, dtype, tier, m, d, classes):
    """Every walk whose blocks share output entries sums them in an order
    fixed by the shapes (csrc/fixed_sum.cuh): two calls on the same inputs
    give the same bits, in both types, at every tier, symmetric,
    rectangular and dual, one class and ten, odd m."""
    call = _determinism_case(walk, dtype, tier, m, d, classes, cuda_device)
    first, second = call(), call()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["sym", "distance sym"])
def test_the_passes_of_a_large_walk_give_the_product(cuda_device, walk):
    """A symmetric walk whose slots pass the workspace budget runs in
    passes over its column tiles (MNIST's width, ten classes: 469 column
    tiles of 128 rows, over 1 GiB of float32 slots in one pass): the
    product is the plain version's, twice the same bits, and the workspace
    it asked for stays within 1 GiB."""
    m, d, C = 60000, 784 if walk == "sym" else 64, 10
    g = torch.Generator().manual_seed(81)
    X = (torch.randn(m, d, generator=g) * 0.05).to(cuda_device)
    V = torch.randn(m, C, generator=g).to(cuda_device)
    gram_matvec.workspace_peak.clear()
    if walk == "sym":
        sq = (X * X).sum(-1)
        kw = dict(kind=TKind.RBF, gamma=1.0 / d, coef0=0.0, degree=3, precision="highest")
        call = lambda: gram_matmat.gram_matmat_sym(X, sq, V, **kw)  # noqa: E731
        want = matvec.kernel_matmat_plain(X, sq, V, **kw)
    else:
        X = X.abs()
        kw = dict(kind=TKind.LAPLACIAN, gamma=1.0 / d)
        call = lambda: distance.distance_matmat_sym(X, V, **kw)  # noqa: E731
        want = matvec.distance_matmat_plain(X, V, **kw)
    got = call()
    assert torch.equal(got, call())
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    peak = max(gram_matvec.workspace_peak.values())
    assert 256 << 20 < peak <= 1 << 30


def _config2(device, dtype=torch.float32):
    import numpy as np

    rng = np.random.default_rng(12)
    n, d = 10000, 200
    labels = rng.integers(0, 2, n)
    X = rng.normal(size=(n, d)) + np.where(labels[:, None] == 1, 0.1, -0.1)
    return X, labels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_fits_of_config2_give_equal_alphas(cuda_device, dtype):
    """BASELINE config 2 (RBF, 10000 x 200) fitted twice on the card: the
    same iterations and the same alphas, bit for bit."""
    import numpy as np

    import plssvm_tpu_torch

    X, labels = _config2(cuda_device)
    fits = [plssvm_tpu_torch.CSVM(backend="cuda", device="cuda", dtype=getattr(np, dtype),
                                  kernel_type="rbf", solver="cg_implicit").fit(
        plssvm_tpu_torch.DataSet(X, labels), epsilon=1e-8) for _ in range(2)]
    assert fits[0].n_iter == fits[1].n_iter
    assert np.array_equal(np.asarray(fits[0].alpha), np.asarray(fits[1].alpha))
    assert np.array_equal(np.asarray(fits[0].rho), np.asarray(fits[1].rho))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rbf", "laplacian"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_the_ring_fit_run_twice_gives_equal_alphas(cuda_device, kernel, dtype):
    """The row-sharded ring on four shards of cuda:0 (A / E, J / L, the
    rows-only B / F), fitted twice: equal iterations and alphas."""
    import numpy as np

    import plssvm_tpu_torch

    X, labels = _config2(cuda_device)
    X, labels = np.abs(X[:4001]), labels[:4001]
    fits = [plssvm_tpu_torch.CSVM(backend="cuda", devices=["cuda:0"] * 4,
                                  dtype=getattr(np, dtype), kernel_type=kernel,
                                  solver="cg_implicit").fit(
        plssvm_tpu_torch.DataSet(X, labels), epsilon=1e-8) for _ in range(2)]
    assert fits[0].n_iter == fits[1].n_iter
    assert np.array_equal(np.asarray(fits[0].alpha), np.asarray(fits[1].alpha))
