"""The float64 chi-squared term of kernels E-H, L and M on the CPU.

The kernels compute ``(x - y)^2 / (x + y)`` in float64 without a divide
(csrc/gram_tile.cuh ``ChiSquaredDistance``): a reciprocal seed from the
special-function unit, two Newton steps, the quotient, its exact remainder
and one correction.  The card runs that sequence only on staged chunks
whose values pass ``chi2_f64_in_range``; a chunk with any other value takes
the IEEE divide.  This file holds a Python twin of the sequence, every FMA
exact through ``fractions.Fraction`` and rounded once to a double, with a
seed of 20 bits off by up to 2^-20, and checks that within the guard's
range it is the IEEE quotient bit for bit (``diff * diff / den`` in Python
floats, as the plain version divides), that one binary exponent outside
either limit it overflows or rounds below the normal range, and that the
limits it proves are the ones the source and ``ops/entry_check.py`` hold.
It also models the tile's summation order in numpy against a long double
reference, which is why the double tile adds compensated chunk partials,
and checks that the library declares no float64 FFMA Gram entry point.
The kernels themselves run in tests/test_torch_cuda.py
(``test_chi_squared_per_entry``) and in ``chip_smoke.py`` on the card.
"""

import ctypes
import math
import os
import re
import sys
import types
import zlib
from fractions import Fraction

import numpy as np
import pytest
import torch

from plssvm_tpu_torch.ops import _build, gram_matvec
from plssvm_tpu_torch.ops.entry_check import (
    CHI2_F64_EXPONENTS,
    chi2_f64_in_range,
    chi2_gamma,
    entry_cases,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "plssvm_tpu_torch", "csrc")

#: the twin's range: a non-zero value takes the divide-free quotient when
#: its binary exponent lies in [LO, HI] (2^LO <= |v| < 2^(HI + 1))
LO, HI = -433, 510
TINY = Fraction(2) ** -1022  # the smallest normal double
SEED_BITS, SEED_ERROR = 20, 2.0 ** -20


class Twin:
    """One run of the sequence: each operation exact, then rounded once to
    a double; ``events`` records every rounding that overflowed or landed
    below the normal range and was not exact there."""

    def __init__(self):
        self.events = []

    def rn(self, exact: Fraction, what: str) -> float:
        try:
            value = float(exact)  # int / int: correctly rounded, ties to even
        except OverflowError:
            self.events.append(f"{what} overflows")
            return math.inf if exact > 0 else -math.inf
        if math.isinf(value):
            self.events.append(f"{what} overflows")
        elif exact != 0 and abs(exact) < TINY and Fraction(value) != exact:
            self.events.append(f"{what} rounds below 2^-1022 inexactly")
        return value

    def fma(self, a: float, b: float, c: float, what: str) -> float:
        if not all(map(math.isfinite, (a, b, c))):
            return a * b + c  # IEEE: inf and NaN propagate
        return self.rn(Fraction(a) * Fraction(b) + Fraction(c), what)


def seed(den: float, error: float) -> float:
    """rcp.approx.ftz.f64: 1 / den off by the relative ``error`` (at most
    2^-20), kept to SEED_BITS mantissa bits (MUFU.RCP64H fills the high
    word only)."""
    if den == 0:
        return math.copysign(math.inf, den)
    approx = (1 / Fraction(den)) * (1 + Fraction(error))
    mantissa, exponent = math.frexp(float(approx))
    return math.ldexp(math.floor(mantissa * 2 ** (SEED_BITS + 1)), exponent - SEED_BITS - 1)


def twin_term(x: float, y: float, error: float = 0.0):
    """The kernel's float64 term for one pair and feature, ``(term,
    events)``: 0 where x + y == 0 (the select), else the divide-free
    quotient of ChiSquaredDistance::step(double&, ...)."""
    t = Twin()
    den = t.rn(Fraction(x) + Fraction(y), "den")
    diff = t.rn(Fraction(x) - Fraction(y), "diff")
    num = t.rn(Fraction(diff) * Fraction(diff), "num") if math.isfinite(diff) else diff * diff
    if den == 0:
        return 0.0, t.events
    r = seed(den, error)
    for step in (1, 2):
        e = t.fma(-den, r, 1.0, f"Newton {step} residual")
        r = t.fma(r, e, r, f"Newton {step} reciprocal")
    q = t.rn(Fraction(num) * Fraction(r), "quotient") if math.isfinite(num) else num * r
    res = t.fma(-den, q, num, "remainder")
    return t.fma(res, r, q, "corrected quotient"), t.events


def ieee_term(x: float, y: float) -> float:
    """The plain version's term: diff * diff / den in IEEE double."""
    den, diff = x + y, x - y
    return 0.0 if den == 0 else diff * diff / den


def draw(rng, n, lo=LO, hi=HI, negative=True):
    """n doubles with uniform binary exponents in [lo, hi] and random
    53-bit mantissas; a tenth of them 0, signs random when ``negative``."""
    mantissa = (2 ** 52 + rng.integers(0, 2 ** 52, n, dtype=np.int64)).tolist()
    exponent = rng.integers(lo, hi + 1, n).tolist()
    sign = rng.choice([-1, 1], n).tolist() if negative else [1] * n
    zero = (rng.random(n) < 0.1).tolist()
    return [0.0 if z else s * math.ldexp(m, e - 52)
            for m, e, s, z in zip(mantissa, exponent, sign, zero)]


def pairs(kind, rng, n=2500):
    """Operand pairs: "random" over the whole range, either sign;
    "close", y one to a few ulps from x, so the remainder is small;
    "edges", exponents at the two limits with mantissas all ones or 1,
    opposite signs included."""
    if kind == "random":
        return list(zip(draw(rng, n), draw(rng, n)))
    if kind == "close":
        xs = draw(rng, n, negative=False)
        return [(x, x + k * math.ulp(x)) for x, k in zip(xs, rng.integers(-3, 4, n).tolist())
                if x > 0 and LO <= math.frexp(x + k * math.ulp(x))[1] - 1 <= HI]
    out = []
    for e in (LO, LO + 1, HI - 1, HI):
        for m in (1.0, 2.0 - 2.0 ** -52, 1.5):
            v = math.ldexp(m, e)
            for w in (v, -v, math.ldexp(1.0, LO), math.ldexp(2.0 - 2.0 ** -52, HI),
                      -math.ldexp(2.0 - 2.0 ** -52, HI), v * (1 - 2.0 ** -53), 0.0):
                if w == 0 or LO <= math.frexp(w)[1] - 1 <= HI:
                    out += [(v, w), (w, v)]
    return out


@pytest.mark.parametrize("error", [-SEED_ERROR, 0.0, SEED_ERROR, "random"])
@pytest.mark.parametrize("kind", ["random", "close", "edges"])
def test_twin_is_the_ieee_quotient_in_range(kind, error):
    """Within the range every intermediate is exact where the proof needs
    it (no event), and the term is the IEEE quotient bit for bit, negative
    denominators included, whatever the seed's error."""
    rng = np.random.default_rng(zlib.crc32(f"{kind} {error}".encode()))
    cases = pairs(kind, rng)
    errors = (rng.uniform(-SEED_ERROR, SEED_ERROR, len(cases)).tolist() if error == "random"
              else [error] * len(cases))
    assert len(cases) > 100
    for (x, y), err in zip(cases, errors):
        got, events = twin_term(x, y, err)
        want = ieee_term(x, y)
        assert not events, (x, y, events)
        assert got == want and math.copysign(1, got) == math.copysign(1, want), (x, y, got, want)


def test_twin_gives_zero_where_the_denominator_is_zero():
    for x in (0.0, -0.0, 1.5, -math.ldexp(1.0, HI), math.ldexp(1.0, LO)):
        assert twin_term(x, -x) == (0.0, [])
    assert twin_term(0.0, 0.0) == (0.0, [])


def test_just_above_the_range_the_square_overflows():
    """|x|, |y| at 2^511, one binary exponent past HI and of opposite sign:
    diff^2 overflows, and the unguarded sequence gives NaN where the IEEE
    divide gives inf.  One exponent lower the same pair stays finite."""
    x = math.ldexp(1.0, HI + 1)
    y = -(x - math.ulp(x) / 2)
    got, events = twin_term(x, y)
    assert "num overflows" in events
    assert math.isnan(got) and ieee_term(x, y) == math.inf
    got, events = twin_term(x / 2, y / 2)
    assert not events and got == ieee_term(x / 2, y / 2)


def test_just_below_the_range_the_remainder_rounds_below_normal():
    """Neighbours at 2^-434, one binary exponent under LO: diff^2 falls to
    2^-972 and the exact remainder to a multiple of 2^-1076, which rounds
    inexactly among the subnormals for some pairs; neighbours at 2^-433
    (diff^2 = 2^-970, den rounded to an even significand) never do."""
    rng = np.random.default_rng(434)
    found = []
    for exponent in (LO - 1, LO):
        hits = 0
        for m in rng.integers(2 ** 52, 2 ** 53 - 1, 400).tolist():
            x = math.ldexp(m, exponent - 52)
            _, events = twin_term(x, x + math.ulp(x))
            hits += any("remainder rounds below" in e for e in events)
        found.append(hits)
    assert found[0] > 10 and found[1] == 0, found


def test_limits_match_the_source_and_the_host_check():
    """kChi2F64MinExponent / kChi2F64MaxExponent in csrc/gram_tile.cuh and
    entry_check.CHI2_F64_EXPONENTS are the twin's LO and HI."""
    source = open(os.path.join(CSRC, "gram_tile.cuh")).read()
    lo = int(re.search(r"constexpr int kChi2F64MinExponent = (-?\d+);", source).group(1))
    hi = int(re.search(r"constexpr int kChi2F64MaxExponent = (-?\d+);", source).group(1))
    assert (lo, hi) == (LO, HI) == CHI2_F64_EXPONENTS


@pytest.mark.parametrize("value,inside", [
    (0.0, True), (-0.0, True), (math.ldexp(1.0, LO), True), (-math.ldexp(1.0, LO), True),
    (math.ldexp(2.0 - 2.0 ** -52, HI), True), (1.0, True), (1e150, True), (1e-200, False),
    (1e200, False),
    (math.ldexp(2.0 - 2.0 ** -52, LO - 1), False), (math.ldexp(1.0, HI + 1), False),
    (5e-324, False), (math.inf, False), (-math.inf, False), (math.nan, False),
])
def test_host_range_check(value, inside):
    X = torch.tensor([[0.5, value], [0.0, 0.25]], dtype=torch.float64)
    assert chi2_f64_in_range(X) is inside


def test_out_of_range_entry_cases():
    """The float64 cases outside the range follow the four of both types,
    drawn from the same rows."""
    base = entry_cases(40, torch.Generator().manual_seed(5))
    cases = entry_cases(40, torch.Generator().manual_seed(5), out_of_range=True)
    assert [c[0] for c in cases] == [c[0] for c in base] + ["1e-200", "1e200", "mixed"]
    X = base[0][1]
    named = {name: Xc for name, Xc, _ in cases}
    assert all(chi2_f64_in_range(Xc) for name, Xc, _ in base)
    for name in ("1e-200", "1e200", "mixed"):
        assert not chi2_f64_in_range(named[name])
    torch.testing.assert_close(named["1e-200"], X * 1e-200, rtol=0, atol=0)
    mixed = named["mixed"]
    for k0 in range(0, 40, 16):
        chunk = mixed[:, k0:k0 + 16]
        assert chi2_f64_in_range(chunk) == (k0 // 16 % 2 == 1), k0


@pytest.mark.parametrize("scale", [1e-200, 1.0, 1e200])
def test_chi2_gamma_of_float64_rows_in_long_double(scale):
    """float64 rows get 1 / the mean distance in long double, finite and
    non-zero where float64 sums would under- or overflow; float32 rows keep
    the float32-rounded gamma."""
    _, X, cols = entry_cases(9, torch.Generator().manual_seed(6))[0]
    gamma = chi2_gamma(X * scale, cols)
    assert math.isfinite(gamma) and gamma > 0
    assert gamma * scale == pytest.approx(chi2_gamma(X, cols), rel=1e-12)
    g32 = chi2_gamma(X.float(), cols)
    assert g32 == float(np.float32(g32))


def _terms(rows, cols):
    diff = rows[:, None, :] - cols[None, :, :]
    den = rows[:, None, :] + cols[None, :, :]
    with np.errstate(all="ignore"):
        return np.where(den != 0, diff * diff / np.where(den != 0, den, 1), 0)


def _summed(terms, order):
    """The distances (rows, columns) from float64 terms summed over the
    last axis as the double tile would: one feature after another
    ("sequential"), in 16-feature chunk partials added one after another
    ("chunks") or with a compensated sum ("compensated")."""
    if order == "sequential":
        return np.cumsum(terms, axis=-1)[..., -1]
    r, c, d = terms.shape
    padded = np.zeros((r, c, -(-d // 16) * 16))
    padded[..., :d] = terms
    parts = np.cumsum(padded.reshape(r, c, -1, 16), axis=-1)[..., -1]
    if order == "chunks":
        return np.cumsum(parts, axis=-1)[..., -1]
    acc, comp = np.zeros((r, c)), np.zeros((r, c))
    for k in range(parts.shape[-1]):
        y = parts[..., k] - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc


@pytest.mark.parametrize("d", [203, 784])
def test_compensated_chunk_partials_hold_the_plain_error(d):
    """Per entry of K on the entry cases, against long double: the double
    tile's summation modelled in numpy, beside the plain version's sums
    (torch over 256-feature blocks).  Compensated chunk partials stay
    within 2x the plain version's worst error; one feature after another
    does not at d = 784."""
    ratios = {"sequential": [], "chunks": [], "compensated": []}
    for _, X, cols in entry_cases(d, torch.Generator().manual_seed(46)):
        rows, C = X.numpy(), X.numpy()[cols]
        terms = _terms(rows, C)
        exact = _terms(rows.astype(np.longdouble), C.astype(np.longdouble)).sum(-1)
        gamma = 1.0 / float(exact.mean())
        want = np.exp(-np.longdouble(gamma) * exact)

        def err(dist):
            return float(np.max(np.abs(np.exp(-gamma * dist).astype(np.longdouble) - want)
                                / want))

        plain = sum(torch.from_numpy(np.ascontiguousarray(terms[..., k:k + 256])).sum(-1).numpy()
                    for k in range(0, d, 256))
        for order, found in ratios.items():
            found.append(err(_summed(terms, order)) / err(plain))
    assert max(ratios["compensated"]) <= 1.0, ratios
    assert max(ratios["chunks"]) > max(ratios["compensated"])
    if d == 784:
        assert min(ratios["sequential"]) > 2.0, ratios


def _extern_c_names():
    names = set()
    for name in os.listdir(CSRC):
        if name.endswith((".cu", ".cuh")):
            names |= set(re.findall(r'extern "C" [^(\n]*?\b(plssvm_\w+)\(',
                                    open(os.path.join(CSRC, name)).read()))
    return names


def test_the_library_declares_its_entry_points_and_no_float64_ffma_gram_one(monkeypatch):
    """_build.load() declares exactly the extern "C" entry points of csrc,
    so none it looks up is missing; no Gram entry point of the FFMA tiles
    (kernels A-D, the walks of J and K) is float64 any more."""
    declared = set()

    class FakeLibrary:
        def __getattr__(self, attr):
            declared.add(attr)
            fn = types.SimpleNamespace()
            setattr(self, attr, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: (None, 0.0))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLibrary())
    _build.load()
    names = _extern_c_names()
    assert declared == names
    assert not [n for n in names if re.fullmatch(r"plssvm_gram_mat(vec|mat)_\w+_f64", n)]
    assert {f"plssvm_distance_{op}_{w}_f64" for op in ("matvec", "matmat")
            for w in ("sym", "rect", "dual")} <= names


@pytest.mark.parametrize("name", ["matvec_sym", "matmat_rect", "matvec_dual"])
def test_the_ffma_gram_path_is_float32_only(name):
    lib = types.SimpleNamespace(**{f"plssvm_gram_{name}_f32": object()})
    assert gram_matvec.ffma_entry(lib, name, torch.float32) is getattr(
        lib, f"plssvm_gram_{name}_f32")
    with pytest.raises(TypeError, match="float32"):
        gram_matvec.ffma_entry(lib, name, torch.float64)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
