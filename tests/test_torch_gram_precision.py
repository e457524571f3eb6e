"""The Gram precision tiers of the port on the CPU, against the JAX package.

- The "bf16" tier of the plain versions (the oracles of kernels A-D at
  "bf16") against the Pallas kernels it replaces with ``precision="bf16"``
  under ``pltpu.force_tpu_interpret_mode()``, as tests/test_torch_gram_matvec.py
  runs them: K1 ``kernel_matvec_pallas_dual`` (symmetric, ``outr + outc``),
  K3 ``kernel_matvec_pallas_rect`` and K4 ``kernel_matmat_pallas_dual``
  (symmetric and rectangular).  Both cast X to bf16 and accumulate bf16
  products, exact in float32, in float32: rtol = atol = 2e-5, as the f32
  tests (only the summation order differs).
- A bf16 CG solve of the port (``impl="cuda"`` on CPU tensors: the
  wrappers' plain versions at "bf16") against the reference's
  ``solve_ls_svm(impl="pallas", gram_precision="bf16")`` in interpret
  mode, at tests/test_solver.py's shape and tolerances.
- ``round_to_tf32`` (the TF32 tier's operand) against a numpy oracle that
  rounds in float64 arithmetic, not on the bit pattern.
- ``chip_smoke.py``'s tensor-core bounds on the main paths' shapes.

Inputs are made with numpy from a seed and handed to both packages.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind
from plssvm_tpu_torch.solver.cg import solve_ls_svm

GRAM_KINDS = ["polynomial", "rbf", "sigmoid"]
COEF0 = {"polynomial": 1.0, "rbf": 0.0, "sigmoid": -0.5}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kinds(name):
    return getattr(JKind, name.upper()), getattr(TKind, name.upper())


def _sq(A):
    return (A * A).sum(1)


def _t(a):
    return torch.from_numpy(a)


# -- K1, K3, K4 at "bf16" ----------------------------------------------------


@pytest.mark.parametrize("m,d", [(768, 256), (256, 1280)])
@pytest.mark.parametrize("name", GRAM_KINDS)
def test_k1_bf16(name, m, d):
    """(768, 256) is a 3 x 3 tile grid; d = 1280 the feature-blocked walk."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matvec_pallas_dual

    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(61)
    X = (rng.normal(size=(m, d)) * 0.2).astype(np.float32)
    v = rng.normal(size=(m,)).astype(np.float32)
    sq = _sq(X)
    with pltpu.force_tpu_interpret_mode():
        outr, outc = kernel_matvec_pallas_dual(
            jnp.asarray(X), jnp.asarray(X), jnp.asarray(sq), jnp.asarray(sq),
            jnp.asarray(v), jnp.asarray(v), kind=jkind, gamma=jnp.float32(1.0 / d),
            coef0=jnp.float32(COEF0[name]), degree=3, precision="bf16", symmetric=True,
        )
    want = np.asarray(outr) + np.asarray(outc)
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3)
    got = matvec.kernel_matvec_plain(_t(X), _t(sq), _t(v), precision="bf16", **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # the wrapper on CPU tensors is the plain version at the tier, and the
    # tier is not the full float32 product
    wrapped = gram_matvec.gram_matvec_sym(_t(X), _t(sq), _t(v), precision="bf16", **kw)
    assert torch.equal(wrapped, _t(got))
    full = matvec.kernel_matvec_plain(_t(X), _t(sq), _t(v), **kw).numpy()
    assert np.abs(full - want).max() > 10 * np.abs(got - want).max()


@pytest.mark.parametrize("d", [128, 1280])
@pytest.mark.parametrize("name", GRAM_KINDS)
def test_k3_bf16(name, d):
    """(128 points, 256 SVs); d = 1280 the feature-blocked body."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matvec_pallas_rect

    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(62)
    P = (rng.normal(size=(128, d)) * 0.2).astype(np.float32)
    S = (rng.normal(size=(256, d)) * 0.2).astype(np.float32)
    a = rng.normal(size=(256,)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(kernel_matvec_pallas_rect(
            jnp.asarray(P), jnp.asarray(S), jnp.asarray(_sq(P)), jnp.asarray(_sq(S)),
            jnp.asarray(a), kind=jkind, gamma=jnp.float32(1.0 / d),
            coef0=jnp.float32(COEF0[name]), degree=3, precision="bf16",
        ))
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3, precision="bf16")
    got = matvec.kernel_matvec_rect_plain(
        _t(P), _t(S), _t(_sq(P)), _t(_sq(S)), _t(a), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    wrapped = gram_matvec.gram_matvec_rect(
        _t(P), _t(S), _t(_sq(P)), _t(_sq(S)), _t(a), **kw)
    assert torch.equal(wrapped, _t(got))


def _class_major(V, cp=8):
    out = np.zeros((cp, V.shape[0]), np.float32)
    out[: V.shape[1]] = V.T
    return out


@pytest.mark.parametrize("n_classes", [1, 3])
@pytest.mark.parametrize("name", GRAM_KINDS)
def test_k4_bf16_symmetric(name, n_classes):
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matmat_pallas_dual

    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(63)
    m, d = 384, 128
    X = (rng.normal(size=(m, d)) * 0.2).astype(np.float32)
    V = rng.normal(size=(m, n_classes)).astype(np.float32)
    sq = _sq(X)
    Vc = jnp.asarray(_class_major(V))
    with pltpu.force_tpu_interpret_mode():
        r, c = kernel_matmat_pallas_dual(
            jnp.asarray(X), jnp.asarray(X), jnp.asarray(sq), jnp.asarray(sq), Vc, Vc,
            kind=jkind, gamma=jnp.float32(1.0 / d), coef0=jnp.float32(COEF0[name]),
            degree=3, precision="bf16", symmetric=True,
        )
    want = (np.asarray(r) + np.asarray(c))[:n_classes].T
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3, precision="bf16")
    got = matvec.kernel_matmat_plain(_t(X), _t(sq), _t(V), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(gram_matmat.gram_matmat_sym(_t(X), _t(sq), _t(V), **kw), _t(got))


def test_k4_bf16_rectangular():
    """K4 with symmetric=False: (K @ Vy^T, K^T @ Vx^T), each side against
    the rectangular plain matmat at "bf16"."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matmat_pallas_dual

    rng = np.random.default_rng(64)
    m1, m2, d, C = 256, 384, 128, 3
    A = (rng.normal(size=(m1, d)) * 0.2).astype(np.float32)
    B = (rng.normal(size=(m2, d)) * 0.2).astype(np.float32)
    Va = rng.normal(size=(m1, C)).astype(np.float32)
    Vb = rng.normal(size=(m2, C)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        r, c = kernel_matmat_pallas_dual(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(_sq(A)), jnp.asarray(_sq(B)),
            jnp.asarray(_class_major(Vb)), jnp.asarray(_class_major(Va)),
            kind=JKind.RBF, gamma=jnp.float32(0.01), coef0=jnp.float32(0.0), degree=3,
            precision="bf16",
        )
    kw = dict(kind=TKind.RBF, gamma=0.01, coef0=0.0, degree=3, precision="bf16")
    rows = matvec.kernel_matmat_rect_plain(_t(A), _t(B), _t(_sq(A)), _t(_sq(B)), _t(Vb), **kw)
    cols = matvec.kernel_matmat_rect_plain(_t(B), _t(A), _t(_sq(B)), _t(_sq(A)), _t(Va), **kw)
    np.testing.assert_allclose(rows.numpy(), np.asarray(r)[:C].T, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(cols.numpy(), np.asarray(c)[:C].T, rtol=2e-5, atol=2e-5)
    wrapped = gram_matmat.gram_matmat_rect(_t(A), _t(B), _t(_sq(A)), _t(_sq(B)), _t(Vb), **kw)
    assert torch.equal(wrapped, rows)


def test_float64_ignores_the_tier():
    """float64 operands compute in float64 at every tier, on the plain
    versions as on the card's FFMA tile."""
    rng = np.random.default_rng(65)
    X = _t(rng.normal(size=(50, 7)))
    v = _t(rng.normal(size=(50,)))
    kw = dict(kind=TKind.RBF, gamma=0.1, coef0=0.0, degree=3)
    want = matvec.kernel_matvec_plain(X, _sq(X), v, **kw)
    for tier in ("f32", "bf16", "highest"):
        assert torch.equal(matvec.kernel_matvec_plain(X, _sq(X), v, precision=tier, **kw), want)


def test_unknown_tier_is_refused():
    X = torch.ones(4, 2)
    kw = dict(kind=TKind.RBF, gamma=0.1, coef0=0.0, degree=3)
    for fn, args in ((gram_matvec.gram_matvec_sym, (X, _sq(X), X[:, 0])),
                     (gram_matmat.gram_matmat_sym, (X, _sq(X), X)),
                     (matvec.kernel_matvec_plain, (X, _sq(X), X[:, 0]))):
        with pytest.raises(ValueError, match="precision"):
            fn(*args, precision="tf32", **kw)


# -- the bf16 CG solve against the reference's ------------------------------


def _reference_solve(X, y, gram_precision):
    """tests/test_solver.py's Pallas solve: n = 129, d = 16, rows padded to
    128 (dept = 128), RBF gamma 0.1, C = 10, epsilon 1e-6."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.solver.cg import solve_ls_svm as j_solve

    n, d = X.shape
    dept = m = n - 1
    Xp = np.zeros((m, d), np.float32)
    Xp[:dept] = X[:dept]
    yp = np.zeros(m, np.float32)
    yp[:dept] = y[:dept]
    with pltpu.force_tpu_interpret_mode():
        res = j_solve(
            jnp.asarray(Xp), jnp.asarray(X[-1], jnp.float32), jnp.asarray(yp),
            jnp.asarray(np.float32(y[-1])), jnp.asarray(np.ones(m, np.float32)),
            jnp.asarray(np.float32(0.1)), jnp.asarray(np.float32(0.0)),
            jnp.asarray(np.float32(10.0)), jnp.asarray(np.float32(1e-6)),
            jnp.asarray(600, jnp.int32), kind=JKind.RBF, degree=3, impl="pallas",
            row_block=128, gram_precision=gram_precision,
        )
    alpha = np.concatenate([np.asarray(res.x)[:dept], [float(res.alpha_last)]])
    return alpha, float(res.rho), int(res.iterations)


def _port_solve(X, y, gram_precision):
    Xt = torch.as_tensor(X, dtype=torch.float32)
    yt = torch.as_tensor(y, dtype=torch.float32)
    res = solve_ls_svm(
        Xt[:-1], Xt[-1], yt[:-1], float(y[-1]), 0.1, 0.0, 10.0, 1e-6, 600,
        kind=TKind.RBF, degree=3, impl="cuda", gram_precision=gram_precision,
    )
    alpha = np.concatenate([res.x.numpy(), [float(res.alpha_last)]])
    return alpha, float(res.rho), res.iterations


def test_bf16_solve_matches_the_reference():
    """The port's bf16 solve (the wrappers' plain versions at "bf16" on CPU
    tensors) against plssvm_tpu's Pallas bf16 solve in interpret mode, at
    tests/test_solver.py::TestGramPrecision's shape and tolerances (the
    solution within 5e-2 relative, rho within 5e-3); both converge, and
    the bf16 solve is not the f32 one."""
    rng = np.random.default_rng(11)
    n, d = 129, 16
    X = rng.normal(size=(n, d))
    y = np.where(X[:, 0] + 0.2 * rng.normal(size=n) > 0, 1.0, -1.0)
    a_ref, rho_ref, it_ref = _reference_solve(X, y, "bf16")
    a, rho, it = _port_solve(X, y, "bf16")
    assert it < 600 and it_ref < 600
    assert np.linalg.norm(a - a_ref) / np.linalg.norm(a_ref) < 5e-2
    assert rho == pytest.approx(rho_ref, abs=5e-3)
    a32, _, _ = _port_solve(X, y, "f32")
    assert not np.array_equal(a, a32)


# -- round_to_tf32 -----------------------------------------------------------


def _tf32_oracle(x):
    """float32 x rounded to 11 significant bits, ties away from zero,
    computed in float64: the quantum 2^(e - 11) for |x| in [2^(e-1), 2^e),
    at least 2^-136 (TF32's subnormal spacing, float32's 2^-149 times
    2^13); past the largest float32 magnitude the value becomes inf."""
    x = np.asarray(x, dtype=np.float32)
    out = np.empty_like(x)
    for i, v in np.ndenumerate(x):
        v = float(v)
        if not np.isfinite(v) or v == 0.0:
            out[i] = v
            continue
        _, e = np.frexp(v)
        q = 2.0 ** max(int(e) - 11, -136)
        r = np.copysign(np.floor(abs(v) / q + 0.5) * q, v)
        with np.errstate(over="ignore"):
            out[i] = np.float32(r) if abs(r) < 2.0 ** 128 else np.float32(np.copysign(np.inf, v))
    return out


def _same_bits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got.view(np.uint32)[~nan], want.view(np.uint32)[~nan])


@settings(max_examples=400, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False),
                min_size=1, max_size=64))
def test_round_to_tf32_hypothesis(values):
    x = np.asarray(values, dtype=np.float32)
    _same_bits(matvec.round_to_tf32(torch.from_numpy(x)).numpy(), _tf32_oracle(x))


def test_round_to_tf32_edges():
    """Ties (the 13 dropped bits exactly 0x1000) round away from zero,
    below a tie down; signed zeros, inf, nan and float32 subnormals; the
    largest float32 becomes inf."""
    bits = np.array([
        0x3F801000, 0x3F800FFF, 0x3F803000, 0xBF801000, 0xBF800FFF,  # ties and near
        0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,  # 0, inf, nan
        0x00000001, 0x00001000, 0x00000FFF, 0x80001000, 0x007FFFFF,  # subnormals
        0x7F7FFFFF, 0x7F7FEFFF, 0x00800000, 0x3F7FF000,
    ], dtype=np.uint32)
    x = bits.view(np.float32)
    got = matvec.round_to_tf32(torch.from_numpy(x.copy())).numpy()
    _same_bits(got, _tf32_oracle(x))
    assert got.view(np.uint32)[0] == 0x3F802000  # 1 + 2^-11 -> 1 + 2^-10
    assert got.view(np.uint32)[1] == 0x3F800000
    assert np.isposinf(got[15])
    with pytest.raises(TypeError):
        matvec.round_to_tf32(torch.zeros(3, dtype=torch.float64))


def test_tier_operand_layout():
    """The tensor-core tile's operand copy: TF32-rounded or bf16 values, the
    feature axis zero-padded to a 16-byte row."""
    rng = np.random.default_rng(66)
    X = torch.from_numpy(rng.normal(size=(5, 37)).astype(np.float32))
    for tier, dtype, width in (("f32", torch.float32, 40), ("bf16", torch.bfloat16, 40)):
        op = gram_matvec.tier_operand(X, tier)
        assert op.dtype == dtype and op.shape == (5, width) and op.is_contiguous()
        assert not op[:, 37:].any()
        want = matvec.round_to_tf32(X) if tier == "f32" else X.to(torch.bfloat16)
        assert torch.equal(op[:, :37], want)
    assert gram_matvec.tier_operand(X[:, :8].contiguous(), "bf16").shape == (5, 8)
    assert not gram_matvec.uses_tensor_cores(X, "f32")  # a CPU tensor


# -- chip_smoke.py's tensor-core bounds --------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("m,d,columns,tf32_ms,bf16_ms", [
    (59999, 784, 10, 5.702, 2.854),   # kernel C, mnist-width
    (49999, 500, 1, 2.525, 1.264),    # kernel A, config 3
    (32768, 512, 1, 1.111, 0.556),    # kernel A, the timing shape
    (32768, 512, 10, 1.111, 0.556),   # kernel C, the timing shape
])
def test_tensor_core_bounds(m, d, columns, tf32_ms, bf16_ms):
    """2 pairs d flops at 495 (TF32) / 989 (bf16) TFLOP/s with m (m + 1) / 2
    pairs; the contraction's FFMAs, the exp and the bytes lie below it."""
    chip_smoke = _chip_smoke()
    for tier, want in (("tf32", tf32_ms), ("bf16", bf16_ms)):
        ms, by = chip_smoke._sym_bound(m, d, columns, "gram", 4, 1, tier, exp=True)
        assert ms == pytest.approx(want, rel=1e-3) and by == "operations"
    ffma_ms, _ = chip_smoke._sym_bound(m, d, columns, "gram", 4, 1)
    assert ffma_ms > 7 * tf32_ms  # the FFMA tile's bound, at 33.5 T FFMA/s
