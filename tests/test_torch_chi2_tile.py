"""The per-entry check of the chi-squared tile on the CPU
(``ops/entry_check.py``: ``entry_cases``, ``chi2_gamma``,
``entry_errors``) through the wrappers of kernels E-H, which take their
plain versions for CPU tensors.  The kernels themselves run in
tests/test_torch_cuda.py (``test_chi_squared_per_entry``) and in
``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

from plssvm_tpu_torch.kernel_functions import pairwise_distance
from plssvm_tpu_torch.ops import distance
from plssvm_tpu_torch.ops.entry_check import chi2_gamma, entry_cases, entry_errors
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """The first multithreaded ``torch.exp`` of a process can come out
    ~1e-4 off in the CPU build of torch these tests run on (a race in its
    first dispatch); one exp before the comparisons keeps that out of
    them."""
    torch.exp(torch.rand(300, 300)).sum()


KERNELS = {
    "E": (distance.distance_matvec_sym, False, True),
    "F": (distance.distance_matvec_rect, True, True),
    "G": (distance.distance_matmat_sym, False, False),
    "H": (distance.distance_matmat_rect, True, False),
}


@pytest.mark.parametrize("d", [3, 203, 784])
def test_entry_cases_hold_the_special_rows(d):
    cases = dict((name, (X, cols)) for name, X, cols in entry_cases(d, torch.Generator().manual_seed(1)))
    assert list(cases) == ["zero-rich", "1e-18", "1e12", "subnormal"]
    X, cols = cases["zero-rich"]
    zero, single = cols[:2]
    assert X.shape == (300, d) and len(set(cols)) == len(cols) == 12
    assert not X[zero].any() and int((X[single] != 0).sum()) == 1
    assert 0.2 < float((X == 0).double().mean()) < 0.5
    torch.testing.assert_close(cases["1e-18"][0], X * 1e-18, rtol=0, atol=0)
    torch.testing.assert_close(cases["1e12"][0], X * 1e12, rtol=0, atol=0)
    sub = cases["subnormal"][0].to(torch.float32)
    tiny = sub[(sub > 0) & (sub < torch.finfo(torch.float32).tiny)]
    assert tiny.numel() > 0 and torch.all(tiny == np.float32(1e-40))


def test_chi2_gamma_is_one_over_the_mean_distance_in_float32():
    X, cols = entry_cases(5, torch.Generator().manual_seed(2))[0][1:]
    dist = pairwise_distance(X, X[cols], TKind.CHI_SQUARED)
    gamma = chi2_gamma(X.float(), cols)
    assert gamma == float(np.float32(gamma))
    assert gamma == pytest.approx(1.0 / float(dist.mean()), rel=1e-7)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("case", ["zero-rich", "1e12", "subnormal"])
def test_entry_errors_read_columns_of_k(kernel, case):
    """On CPU tensors the wrappers are the plain versions: each picked
    column is K(rows, X[j]), so the float32 "kernel" errs exactly as the
    plain version against float64, and the float64 one exactly as the
    float64 plain version against long double, by a rounding or two."""
    fn, rect, one_column = KERNELS[kernel]
    _, X, cols = next(c for c in entry_cases(17, torch.Generator().manual_seed(3)) if c[0] == case)
    X32 = X.float()
    gamma = chi2_gamma(X32, cols)
    got, plain = entry_errors(fn, X32, cols, gamma, points=X32[:40] if rect else None,
                              one_column=one_column)
    assert 0 < plain < 1e-6 and got == plain
    got, plain = entry_errors(fn, X, cols, gamma, points=X[:40] if rect else None,
                              one_column=one_column)
    assert 0 < plain < 1e-14 and got == plain


def test_entry_errors_flag_a_wrong_column():
    X, cols = entry_cases(9, torch.Generator().manual_seed(4))[0][1:]

    def shifted(X, V, *, kind, gamma):
        return distance.distance_matmat_sym(X, V.roll(1, dims=1), kind=kind, gamma=gamma)

    assert entry_errors(shifted, X, cols, chi2_gamma(X, cols))[0] > 1e-3
