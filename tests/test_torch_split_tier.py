"""The "highest" Gram tier on the tensor cores, on the CPU: the split
operand, the part sequence of the tiles' walk, the tier's plain oracle
against the TPU kernels it stands for, the bounds and the routing.

On float32 CUDA tensors kernels A-D at "highest" run on the symmetric and
rectangular tensor-core tiles (csrc/gram_tc.cuh) in three TF32 passes over
the split stack [hi; lo] of each operand (``split_tf32``, ``tier_operand``):
hi hi^T + hi lo^T + lo hi^T, f32 accumulation.  Here:

- ``split_tf32`` with hypothesis: both parts exact TF32 values (the low 13
  bits zero), ``|x - hi - lo| <= 2^-22 |x|`` (the subnormal spacing 2^-137
  below 2^-115), and nan, inf and signed zeros as ``round_to_tf32`` makes
  them, with ``lo`` 0 where ``hi`` is not finite;
- the tiles' part sequence, read from the source (``Tf32x3Tier::row_part``
  / ``col_part``) and walked box by box as the tiles walk it, sums hi hi^T
  + hi lo^T + lo hi^T (float64), each (pass, feature box) once;
- the tier's oracle, ``split_kernel_product`` (the plain version with the
  Gram part from ``split_gram``), against plssvm_tpu's K1, K3 and K4 at
  ``precision="highest"`` under ``pltpu.force_tpu_interpret_mode()`` on
  seeded ragged shapes (m not a multiple of 128, odd d, C in {1, 3}; the
  Pallas side on zero-padded copies) at rtol = atol = 2e-5, the "highest"
  tolerance of tests/test_torch_gram_matvec.py;
- ``chip_smoke.py``'s split bounds (the dual tile's too), the routing
  predicates at "highest" (kernel K on the split dual tile, J on its
  matvec walk), the solve's operand made once, ``kernel_resources``' names
  of the split instantiations, the split entry points' declarations;
- a NumPy emulation of the split dual tile (kernel K at "highest": the
  three TF32 products box by box in float32, both contractions) on a ragged
  block, both outputs within the split's first-order error bound of the
  float64 product.

Inputs are made with numpy from a seed and handed to both packages.
"""

import importlib.util
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu_torch.ops import _build, gram_matmat, gram_matvec, matvec, pairs
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind
from plssvm_tpu_torch.solver import cg

GRAM_KINDS = ["polynomial", "rbf", "sigmoid"]
COEF0 = {"polynomial": 1.0, "rbf": 0.0, "sigmoid": -0.5}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAM_TC = os.path.join(REPO, "plssvm_tpu_torch", "csrc", "gram_tc.cuh")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_split_bounds", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _kinds(name):
    return getattr(JKind, name.upper()), getattr(TKind, name.upper())


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# -- split_tf32 ----------------------------------------------------------------

FLOATS = st.floats(width=32, allow_nan=True, allow_infinity=True)


@settings(max_examples=300, deadline=None)
@given(st.lists(FLOATS, min_size=1, max_size=64))
def test_split_tf32_hypothesis(values):
    x = np.asarray(values, np.float32)
    hi, lo = matvec.split_tf32(torch.from_numpy(x.copy()))
    hi, lo = hi.numpy(), lo.numpy()
    rounded = matvec.round_to_tf32(torch.from_numpy(x.copy())).numpy()
    assert np.array_equal(_bits(hi), _bits(rounded))
    finite = np.isfinite(hi)
    assert not (_bits(hi[finite]) & 0x1FFF).any()
    assert not (_bits(lo) & 0x1FFF).any()
    assert np.array_equal(_bits(lo[~finite]), np.zeros((~finite).sum(), np.int32))
    x64 = x[finite].astype(np.float64)
    rest = np.abs(x64 - hi[finite].astype(np.float64) - lo[finite].astype(np.float64))
    assert (rest <= np.maximum(2.0 ** -22 * np.abs(x64), 2.0 ** -137)).all()


def test_split_tf32_edges():
    """nan and inf stay in hi with lo 0; a value past the largest TF32 one
    rounds to inf in hi; signed zeros keep their sign in hi; a remainder
    that falls on a tie of lo's spacing (-(2^-11 - 2^-23), 2047.5 units of
    2^-22) rounds away from zero."""
    big = np.finfo(np.float32).max  # past the largest TF32 value and half its spacing
    x = np.array([np.nan, np.inf, -np.inf, big, -0.0, 0.0, 1.0 + 2.0 ** -12,
                  1.0 + 2.0 ** -11 + 2.0 ** -23], np.float32)
    hi, lo = (t.numpy() for t in matvec.split_tf32(torch.from_numpy(x.copy())))
    assert np.isnan(hi[0]) and hi[1] == np.inf and hi[2] == -np.inf and hi[3] == np.inf
    assert np.array_equal(_bits(lo[:4]), np.zeros(4, np.int32))
    assert _bits(hi[4]) == _bits(np.float32(-0.0)) and _bits(hi[5]) == 0
    assert _bits(lo[4]) == 0 and _bits(lo[5]) == 0
    assert hi[6] == np.float32(1.0) and lo[6] == np.float32(2.0 ** -12)
    assert hi[7] == np.float32(1.0 + 2.0 ** -10) and lo[7] == np.float32(-2.0 ** -11)
    with pytest.raises(TypeError):
        matvec.split_tf32(torch.zeros(3, dtype=torch.float64))


# -- the tiles' part sequence ----------------------------------------------------


def _part_maps():
    """(row_part, col_part) of Tf32x3Tier, read from gram_tc.cuh: each is
    ``return pass == k;``."""
    source = open(GRAM_TC, encoding="utf-8").read()
    tier = source[source.index("struct Tf32x3Tier"):]
    tier = tier[:tier.index("};")]
    passes = int(re.search(r"kPasses = (\d+);", tier).group(1))
    row = int(re.search(r"row_part\(int pass\) \{ return pass == (\d+); \}", tier).group(1))
    col = int(re.search(r"col_part\(int pass\) \{ return pass == (\d+); \}", tier).group(1))
    return passes, (lambda p: int(p == row)), (lambda p: int(p == col))


@pytest.mark.parametrize("m,d", [(7, 3), (200, 37), (130, 203), (65, 64)])
def test_part_sequence_sums_the_three_products(m, d):
    """The split tiles' walk (feature box k of nk, a stage holding both
    parts of the row and of the column box, pass p multiplying row part
    ``row_part(p)`` by column part ``col_part(p)``, as the sym tile's loop
    and ``tc_consume`` take them) over ``tier_operand``'s stack sums hi hi^T
    + hi lo^T + lo hi^T, every (pass, box) once: in float64 that sum up to
    float64's summation order."""
    rng = np.random.default_rng(81)
    X = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    stack = gram_matvec.tier_operand(X, "highest").double()
    passes, row_part, col_part = _part_maps()
    assert passes == 3
    assert (row_part(0), col_part(0)) == (0, 0)  # the stage's first product
    features = 32  # TF32 features a 128-byte box holds
    nk = -(-stack.shape[2] // features)
    acc = torch.zeros(m, m, dtype=torch.float64)
    seen = set()
    for k in range(nk):
        f = k * features
        for p in range(passes):
            seen.add((row_part(p), col_part(p), f))
            acc += stack[row_part(p), :, f:f + features] @ stack[col_part(p), :, f:f + features].T
    assert len(seen) == passes * nk
    hi, lo = (t.double() for t in matvec.split_tf32(X))
    assert torch.allclose(acc, hi @ hi.T + hi @ lo.T + lo @ hi.T, rtol=1e-12, atol=1e-12)
    # the float32 oracle sums the same three products
    gram = matvec.split_gram(X, X).double()
    assert torch.allclose(gram, acc, rtol=0, atol=4 * d * 2.0 ** -24 * float(
        (X.double().abs() @ X.double().abs().T).max()))


def test_split_operand_layout():
    """``tier_operand(X, "highest")``: one contiguous (2, m, d_pad) float32
    stack, d_pad a multiple of 4 (TMA's 16-byte rows), zeros past d in both
    parts, [hi; lo] before."""
    rng = np.random.default_rng(82)
    for d in (1, 3, 4, 37, 203):
        X = torch.from_numpy(rng.normal(size=(9, d)).astype(np.float32))
        op = gram_matvec.tier_operand(X, "highest")
        d_pad = d + (-d % 4)
        assert op.shape == (2, 9, d_pad) and op.dtype == torch.float32 and op.is_contiguous()
        hi, lo = matvec.split_tf32(X)
        assert torch.equal(op[0, :, :d], hi) and torch.equal(op[1, :, :d], lo)
        assert not op[:, :, d:].any()


# -- the oracle against K1, K3, K4 at "highest" ----------------------------------


def _pad(a, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, n) for n in a.shape)] = a
    return out


def _up(n):
    return -(-n // 128) * 128


def _split(P, S, sq_p, sq_s, W, tkind, d, name):
    t = torch.from_numpy
    return matvec.split_kernel_product(
        t(P), t(S), t(sq_p), t(sq_s), t(W), kind=tkind, gamma=1.0 / d,
        coef0=COEF0[name], degree=3).numpy()


@pytest.mark.parametrize("m,d", [(200, 37), (300, 203)])
@pytest.mark.parametrize("name", GRAM_KINDS)
def test_k1_highest(name, m, d):
    """Kernel A's split oracle against K1 (symmetric, ``outr + outc``) at
    "highest", the Pallas side on zero-padded copies (v 0 on padded rows)."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matvec_pallas_dual

    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(83)
    X = (rng.normal(size=(m, d)) * 0.2).astype(np.float32)
    v = rng.normal(size=(m,)).astype(np.float32)
    sq = (X * X).sum(1)
    Xp, vp, sqp = _pad(X, (_up(m), _up(d))), _pad(v, (_up(m),)), _pad(sq, (_up(m),))
    with pltpu.force_tpu_interpret_mode():
        outr, outc = kernel_matvec_pallas_dual(
            jnp.asarray(Xp), jnp.asarray(Xp), jnp.asarray(sqp), jnp.asarray(sqp),
            jnp.asarray(vp), jnp.asarray(vp), kind=jkind, gamma=jnp.float32(1.0 / d),
            coef0=jnp.float32(COEF0[name]), degree=3, precision="highest", symmetric=True,
        )
    want = (np.asarray(outr) + np.asarray(outc))[:m]
    got = _split(X, X, sq, sq, v, tkind, d, name)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_p,n_s,d", [(100, 300, 37), (130, 257, 203)])
@pytest.mark.parametrize("name", GRAM_KINDS)
def test_k3_highest(name, n_p, n_s, d):
    """Kernel B's split oracle against K3 at "highest" (zero-padded P, S
    and a)."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matvec_pallas_rect

    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(84)
    P = (rng.normal(size=(n_p, d)) * 0.2).astype(np.float32)
    S = (rng.normal(size=(n_s, d)) * 0.2).astype(np.float32)
    a = rng.normal(size=(n_s,)).astype(np.float32)
    sq_p, sq_s = (P * P).sum(1), (S * S).sum(1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(kernel_matvec_pallas_rect(
            jnp.asarray(_pad(P, (_up(n_p), _up(d)))), jnp.asarray(_pad(S, (_up(n_s), _up(d)))),
            jnp.asarray(_pad(sq_p, (_up(n_p),))), jnp.asarray(_pad(sq_s, (_up(n_s),))),
            jnp.asarray(_pad(a, (_up(n_s),))), kind=jkind, gamma=jnp.float32(1.0 / d),
            coef0=jnp.float32(COEF0[name]), degree=3, precision="highest",
        ))[:n_p]
    got = _split(P, S, sq_p, sq_s, a, tkind, d, name)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _class_major(V):
    out = np.zeros((8, V.shape[0]), np.float32)
    out[: V.shape[1]] = V.T
    return out


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("n_classes", [1, 3])
@pytest.mark.parametrize("name", GRAM_KINDS)
def test_k4_highest(name, n_classes, symmetric):
    """Kernels C and D's split oracle against K4 at "highest": symmetric
    (``rows + cols``) on 200 x 37, and symmetric=False (its first output,
    K(P, S) @ A) on 130 points x 300 SVs of 37 features; zero-padded
    copies on the Pallas side."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matmat_pallas_dual

    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(85 + n_classes)
    d = 37
    n_s = 200 if symmetric else 300
    n_p = n_s if symmetric else 130
    S = (rng.normal(size=(n_s, d)) * 0.2).astype(np.float32)
    P = S if symmetric else (rng.normal(size=(n_p, d)) * 0.2).astype(np.float32)
    A = rng.normal(size=(n_s, n_classes)).astype(np.float32)
    sq_p, sq_s = (P * P).sum(1), (S * S).sum(1)
    Vy = _class_major(_pad(A, (_up(n_s), n_classes)))
    Vx = Vy if symmetric else np.zeros((8, _up(n_p)), np.float32)
    with pltpu.force_tpu_interpret_mode():
        rows, cols = kernel_matmat_pallas_dual(
            jnp.asarray(_pad(P, (_up(n_p), _up(d)))), jnp.asarray(_pad(S, (_up(n_s), _up(d)))),
            jnp.asarray(_pad(sq_p, (_up(n_p),))), jnp.asarray(_pad(sq_s, (_up(n_s),))),
            jnp.asarray(Vy), jnp.asarray(Vx), kind=jkind, gamma=jnp.float32(1.0 / d),
            coef0=jnp.float32(COEF0[name]), degree=3, precision="highest",
            symmetric=symmetric,
        )
    want = np.asarray(rows) + (np.asarray(cols) if symmetric else 0.0)
    want = want[:n_classes, :n_p].T
    got = _split(P, S, sq_p, sq_s, A, tkind, d, name)
    assert got.shape == (n_p, n_classes)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_split_oracle_is_nearer_float64_than_tf32():
    """The split product is not the TF32 one: against the float64 Gram its
    error is a small fraction of TF32's."""
    rng = np.random.default_rng(86)
    X = torch.from_numpy(rng.normal(size=(150, 203)).astype(np.float32))
    exact = X.double() @ X.double().T
    split = (matvec.split_gram(X, X).double() - exact).abs().max()
    tf32 = matvec.round_to_tf32(X).double()
    assert split < 0.01 * (tf32 @ tf32.T - exact).abs().max()


# -- bounds, routing, the solve's operand -----------------------------------------


@pytest.mark.parametrize("m,d,columns,ms", [
    (32768, 512, 1, 3.3319550976),    # kernel A, the timing shape: 3 x 1.111
    (32768, 512, 10, 3.3319550976),   # kernel C, the timing shape
    (59999, 784, 10, 17.10516945),    # kernel C, MNIST width
    (9999, 200, 1, 0.1212),           # kernel A, config 2
])
def test_split_sym_bounds(m, d, columns, ms):
    """The split tier's bound of the symmetric tile: 3 x 2 pairs d flops at
    495 TFLOP/s (the FFMAs of the contraction and the exps lie below it
    here), three times the TF32 tier's product bound."""
    chip_smoke = _chip_smoke()
    got, by = chip_smoke._sym_bound(m, d, columns, "gram", 4, 1, "tf32x3", exp=True)
    assert got == pytest.approx(ms, rel=1e-4) and by == "operations"
    tf32, _ = chip_smoke._sym_bound(m, d, columns, "gram", 4, 1, "tf32", exp=True)
    assert got == pytest.approx(3 * tf32, rel=1e-9)


@pytest.mark.parametrize("n_p,n_s,d,columns,ms", [
    (32768, 32768, 512, 1, 6.663706835),   # kernel B, the timing shape
    (10000, 60000, 784, 10, 5.701818182),  # kernel D, MNIST width's predict
    (2000, 10000, 200, 1, 0.048485),       # kernel B, config 2's predict
])
def test_split_rect_bounds(n_p, n_s, d, columns, ms):
    chip_smoke = _chip_smoke()
    got, by = chip_smoke._rect_bound(n_p, n_s, d, columns, "gram", 4, 1, "tf32x3", exp=True)
    assert got == pytest.approx(ms, rel=1e-4) and by == "operations"


def test_split_bound_moves_two_float32_parts():
    """Where the bytes bound the split tier (d = 1), its operand moves as
    two float32 parts, 8 bytes a feature, twice the TF32 tier's."""
    chip_smoke = _chip_smoke()
    assert chip_smoke.TC_TIERS["tf32x3"] == (chip_smoke.TF32_FLOP_PER_S / 3, 8)
    assert chip_smoke.TIER_OF["highest"] == "tf32x3"
    n_bytes = 8 * 4096 * 1 + 4 * 4096 * 3
    assert chip_smoke._sym_bound(4096, 1, 1, "gram", 4, 1, "tf32x3")[0] >= \
        n_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3


def _like(dtype, device):
    return types.SimpleNamespace(dtype=dtype, device=torch.device(device))


def test_routing_at_highest():
    """float32 CUDA at "highest": the tensor-core tiles for A-D and K
    (entries ``*_tf32x3``; K counted on ``dual_tc_launches``), the FFMA
    walks for J and O (the one-pass tiers only take their tensor-core
    tiles; J counted on ``dual_launches``); float64 the DMMA tiles; CPU
    tensors the plain versions."""
    X32, X64 = _like(torch.float32, "cuda"), _like(torch.float64, "cuda")
    assert gram_matvec.uses_tensor_cores(X32, "highest")
    assert gram_matvec._TC_TIERS["highest"] == ("tf32x3", torch.float32, 4)
    assert "highest" not in gram_matvec.ONE_PASS_TIERS
    assert not gram_matvec.uses_tensor_cores(X64, "highest") and gram_matvec.uses_dmma(X64)
    assert not gram_matvec.uses_tensor_cores(_like(torch.float32, "cpu"), "highest")
    assert pairs.walk(X32, TKind.RBF, "highest") == "ffma"
    assert pairs.walk(X32, TKind.RBF, "f32") == "tc"
    chip_smoke = _chip_smoke()
    assert chip_smoke._dual_counter("gram_matvec_dual", torch.float32, "highest") == (
        gram_matvec, "dual_launches")
    assert chip_smoke._dual_counter("gram_matmat_dual", torch.float32, "f32") == (
        gram_matmat, "dual_tc_launches")
    assert chip_smoke._dual_counter("gram_matmat_dual", torch.float32, "highest") == (
        gram_matmat, "dual_tc_launches")
    for v, base in ((torch.zeros(3), "gram_matvec"), (torch.zeros(3, 2), "gram_matmat")):
        assert [e[0] for e in chip_smoke._pairs(v, "highest")] == [
            f"{base}_sym_tc", f"{base}_rect_tc"]
        assert [e[0] for e in chip_smoke._pairs(v, "highest", ffma=True)] == [
            f"{base}_sym", f"{base}_rect"]


@pytest.mark.parametrize("name", GRAM_KINDS)
def test_cpu_wrappers_at_highest_are_the_full_float32_plain_versions(name):
    """On CPU tensors the wrappers at "highest" are the plain versions in
    full float32, not the split oracle: the split tier is the card's."""
    _, tkind = _kinds(name)
    rng = np.random.default_rng(87)
    X = torch.from_numpy((rng.normal(size=(70, 13)) * 0.3).astype(np.float32))
    V = torch.from_numpy(rng.normal(size=(70, 3)).astype(np.float32))
    sq = (X * X).sum(-1)
    kw = dict(kind=tkind, gamma=1.0 / 13, coef0=COEF0[name], degree=3)
    assert torch.equal(gram_matmat.gram_matmat_sym(X, sq, V, precision="highest", **kw),
                       matvec.kernel_matmat_plain(X, sq, V, **kw))
    assert torch.equal(gram_matvec.gram_matvec_rect(X, X, sq, sq, V[:, 0].contiguous(),
                                                    precision="highest", **kw),
                       matvec.kernel_matvec_rect_plain(X, X, sq, sq, V[:, 0].contiguous(),
                                                       **kw))


def test_given_operand_is_checked():
    """A caller's operand copy must be ``tier_operand``'s at the tier."""
    X = torch.randn(9, 5)
    op = gram_matvec.tier_operand(X, "highest")
    assert gram_matvec._given_operand(op, X, "highest") is op
    assert gram_matvec._given_operand(None, X, "highest").shape == (2, 9, 8)
    for wrong in (gram_matvec.tier_operand(X, "f32"), op[:, :8].contiguous(),
                  op.double()):
        with pytest.raises(ValueError, match="operand copy"):
            gram_matvec._given_operand(wrong, X, "highest")


def test_gram_ffma_takes_cuda_tensors_only():
    """The FFMA tiles' launcher refuses CPU tensors (it has no plain
    version: the wrappers hold those)."""
    X = torch.randn(5, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gram_matvec.gram_ffma("matvec_sym", (X,), ((X * X).sum(-1),), torch.ones(5),
                              kind=TKind.RBF, gamma=0.1, coef0=0.0, degree=3)


@pytest.mark.parametrize("make", ["_make_kernel_matvec", "_make_kernel_matmat"])
def test_solve_makes_the_operand_once(monkeypatch, make):
    """The CG solve's product makes the tile's operand copy at its first
    product and hands the same copy to every later one of the same X; a
    new X gets its own."""
    made, seen = [], []

    def tier_operand(X, precision):
        made.append((X, precision))
        return torch.full((1,), float(len(made)))

    def sym(X, sq, V, *, operand=None, precision, **kw):
        seen.append((operand, precision))
        return V

    monkeypatch.setattr(cg, "uses_tensor_cores", lambda X, precision: True)
    monkeypatch.setattr(cg, "tier_operand", tier_operand)
    monkeypatch.setattr(cg, "gram_matvec_sym", sym)
    monkeypatch.setattr(cg, "gram_matmat_sym", sym)
    product = getattr(cg, make)(TKind.RBF, 3, "cuda", "highest")
    X, Y, v = torch.zeros(4, 2), torch.zeros(4, 2), torch.zeros(4)
    for _ in range(3):
        product(X, None, v, 0.5, 0.0)
    product(Y, None, v, 0.5, 0.0)
    assert [p for _, p in made] == ["highest", "highest"]
    assert made[0][0] is X and made[1][0] is Y
    assert [float(op) for op, _ in seen] == [1.0, 1.0, 1.0, 2.0]
    assert {p for _, p in seen} == {"highest"}


def test_kernel_resources_names_the_split_tiles(tmp_path, monkeypatch):
    """``kernel_resources`` names the split tier's instantiations of the
    sym and rect tiles ``gram_tc_sym tf32x3 <kind>`` beside the one-pass
    ones."""
    lib = tmp_path / "libplssvm_gram_x.so"
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    (tmp_path / "libplssvm_gram_x.so.ptxas.txt").write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118gram_tc_sym_kernelINS_10Tf32x3TierELi2EEEv14CUtensorMap_st'"
        " for 'sm_90a'\n"
        "ptxas info    : Used 124 registers, 13360 bytes smem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119gram_tc_rect_kernelINS_8Tf32TierELi1EEEv14CUtensorMap_st'"
        " for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 112 registers, 13360 bytes smem\n",
        encoding="utf-8")
    assert _build.kernel_resources() == {
        "gram_tc_sym tf32x3 rbf": {"registers": 124, "smem_bytes": 13360},
        "gram_tc_rect tf32 poly": {"spill_bytes": 0, "registers": 112, "smem_bytes": 13360},
    }


def test_the_split_entries_are_declared():
    """Each split entry point of csrc has its C signature in _build.load()'s
    declarations (the same parameters as the TF32 entry beside it): A-D's
    and, in csrc/dual.cu, kernel K's on the dual tile (J has none)."""
    sources = "".join(open(os.path.join(REPO, "plssvm_tpu_torch", "csrc", f),
                           encoding="utf-8").read()
                      for f in ("gram_matvec.cu", "gram_matmat.cu", "dual.cu"))
    names = re.findall(r'extern "C" int (plssvm_gram_\w+_tf32x3)\(', sources)
    assert sorted(names) == sorted(
        f"plssvm_gram_{n}_tf32x3" for n in ("matvec_sym", "matmat_sym", "matvec_rect_tc",
                                            "matmat_rect_tc", "matmat_dual_tc"))
    for name in names:
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', sources).group(1)
        twin = re.search(rf'extern "C" int {name[:-2]}\(([^)]*)\)', sources).group(1)
        assert re.sub(r"\s+", " ", params) == re.sub(r"\s+", " ", twin)


def test_bench_highest_on_the_cpu(capsys):
    """The tool on the CPU: one line per cell, the wrappers' plain versions
    against themselves (rel_err 0), no FFMA time; without a GPU and
    without ``--cpu`` it refuses to run."""
    import json

    from plssvm_tpu_torch.tools import bench_highest

    assert bench_highest.main(["--cpu", "--repeats", "1"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["kernel"] for r in rows] == [c[0] for c in bench_highest.CELLS]
    assert [(r["n_p"], r["n_s"]) for r in rows if r["kernel"] == "D"][-1] == (100, 600)
    assert [(r["n_p"], r["classes"]) for r in rows if r["kernel"] == "K"] == [(150, 10),
                                                                              (150, 1)]
    assert all(r["rel_err"] == 0.0 and r["ffma_ms"] is None and r["ms"] > 0 for r in rows)
    assert rows[-1]["walk_ms"] is None
    assert bench_highest.main(["--cpu", "--repeats", "1", "--kernels", "K"]) == 0
    assert [json.loads(line)["kernel"] for line in
            capsys.readouterr().out.splitlines()] == ["K", "K"]
    if not torch.cuda.is_available():
        assert bench_highest.main([]) == 1


# -- kernel K at "highest": the split dual tile -------------------------------------


def test_the_split_dual_entry_is_declared_as_its_tf32_twin(monkeypatch):
    """_build.load() declares ``plssvm_gram_matmat_dual_tc_tf32x3`` with the
    argument and result types of its TF32 twin (the same C parameters)."""
    import ctypes

    class FakeLibrary:
        def __getattr__(self, attr):
            fn = types.SimpleNamespace()
            setattr(self, attr, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: (None, 0.0))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLibrary())
    lib = _build.load()
    split, twin = lib.plssvm_gram_matmat_dual_tc_tf32x3, lib.plssvm_gram_matmat_dual_tc_tf32
    assert split.argtypes == twin.argtypes and len(split.argtypes) == 19
    assert split.restype is twin.restype is ctypes.c_int


def test_kernel_resources_names_the_split_dual_tile(tmp_path, monkeypatch):
    """``kernel_resources`` names the split tier's instantiation of the dual
    tile ``gram_tc_dual tf32x3 <kind>``, beside the TF32 one."""
    lib = tmp_path / "libplssvm_gram_y.so"
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    (tmp_path / "libplssvm_gram_y.so.ptxas.txt").write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119gram_tc_dual_kernelINS_10Tf32x3TierELi2EEEv14CUtensorMap_stS2_"
        "PKfS4_S4_S4_PfS5_iiiiiiiiff' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, 15408 bytes smem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119gram_tc_dual_kernelINS_8Tf32TierELi3EEEv14CUtensorMap_stS2_"
        "PKfS4_S4_S4_PfS5_iiiiiiiiff' for 'sm_90a'\n"
        "ptxas info    : Used 128 registers, 15408 bytes smem\n",
        encoding="utf-8")
    assert _build.kernel_resources() == {
        "gram_tc_dual tf32x3 rbf": {"spill_bytes": 0, "registers": 168, "smem_bytes": 15408},
        "gram_tc_dual tf32 sigmoid": {"registers": 128, "smem_bytes": 15408},
    }


@pytest.mark.parametrize("mr,mc,d,columns,ms", [
    (15000, 15000, 784, 10, 2.1381818),   # the ring's MNIST-width block: 3 x 0.713
    (32768, 32768, 512, 10, 6.6637068),   # the kernels phase's own timing shape
    (12500, 12500, 500, 1, 0.9469697),    # config 3's ring block, C = 1
])
def test_split_dual_bound(mr, mc, d, columns, ms):
    """``_dual_bound`` at tier ``tf32x3``: three times the TF32 tier's
    product bound (2 mr mc d flops at a third of 495 TFLOP/s), beside which
    the contractions' FFMAs and the exps lie below it here."""
    chip_smoke = _chip_smoke()
    got, by = chip_smoke._dual_bound(mr, mc, d, columns, "gram", 4, 1, "tf32x3", exp=True)
    assert got == pytest.approx(ms, rel=1e-6) and by == "operations"
    assert got == pytest.approx(2.0 * mr * mc * d / (chip_smoke.TF32_FLOP_PER_S / 3) * 1e3,
                                rel=1e-12)
    tf32, _ = chip_smoke._dual_bound(mr, mc, d, columns, "gram", 4, 1, "tf32", exp=True)
    assert got == pytest.approx(3 * tf32, rel=1e-9)


def test_split_dual_bound_moves_two_float32_parts():
    """Where the bytes bound the split dual tile (one row against many
    columns, d = 1), Xr and Xc move as two float32 parts, 8 bytes a
    feature, beside the float32 right-hand sides, outputs and norms."""
    chip_smoke = _chip_smoke()
    mr, mc, columns = 1, 100000, 1
    got, by = chip_smoke._dual_bound(mr, mc, 1, columns, "gram", 4, 1, "tf32x3")
    n_bytes = 8 * (mr + mc) * 1 + 4 * (mr + mc) * (2 * columns + 1)
    assert by == "bytes" and got == pytest.approx(
        n_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)


def _tf32_np(x):
    """float32 x rounded to TF32 as ``cvt.rna.tf32.f32`` (finite x)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & -0x2000).view(np.float32)


def _split_dual_emulation(Xr, Xc, V_c, V_r, gamma):
    """Kernel K at "highest" as the split dual tile computes it, in float32
    NumPy: each 32-feature box adds hi hi^T, hi lo^T and lo hi^T to the
    Gram block (hi = tf32(x), lo = tf32(x - hi)); then the RBF values from
    the float32 operands' norms and both contractions."""
    hr, hc = _tf32_np(Xr), _tf32_np(Xc)
    lr, lc = _tf32_np(Xr - hr), _tf32_np(Xc - hc)
    gram = np.zeros((Xr.shape[0], Xc.shape[0]), np.float32)
    for f in range(0, Xr.shape[1], 32):
        box = slice(f, f + 32)
        for a, b in ((hr, hc), (hr, lc), (lr, hc)):
            gram += a[:, box] @ b[:, box].T
    sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
    K = np.exp(np.float32(-gamma) * (sq_r[:, None] + sq_c[None, :] - np.float32(2) * gram))
    return K @ V_c, K.T @ V_r


@pytest.mark.parametrize("mr,mc,d,columns", [(130, 77, 203, 10), (65, 200, 37, 1),
                                             (129, 129, 784, 3)])
def test_split_dual_emulation_within_the_split_bound(mr, mc, d, columns):
    """The split dual tile's arithmetic, emulated, gives both outputs of
    kernel K within the first-order bound of the split tier against the
    float64 product: a Gram entry off by at most (3 2^-22 + d 2^-24) sum
    |x_r| |x_c| (the dropped lo lo^T, lo's rounding, the float32 sums), an
    RBF value by 2 gamma K times that plus 2^-22 K (the float32 epilogue),
    a contraction by those errors against |V| plus the float32 sum's
    (rows) 2^-24 |K| |V|; and far nearer the float64 product than the TF32
    one-pass tile."""
    rng = np.random.default_rng(88)
    Xr = (rng.normal(size=(mr, d)) * 0.5).astype(np.float32)
    Xc = (rng.normal(size=(mc, d)) * 0.5).astype(np.float32)
    V_c = rng.normal(size=(mc, columns)).astype(np.float32)
    V_r = rng.normal(size=(mr, columns)).astype(np.float32)
    gamma = 1.0 / d
    got = _split_dual_emulation(Xr, Xc, V_c, V_r, gamma)
    X64r, X64c = Xr.astype(np.float64), Xc.astype(np.float64)
    sq_r, sq_c = (X64r ** 2).sum(-1), (X64c ** 2).sum(-1)
    K = np.exp(-gamma * (sq_r[:, None] + sq_c[None, :] - 2 * X64r @ X64c.T))
    want = (K @ V_c.astype(np.float64), K.T @ V_r.astype(np.float64))
    d_gram = (3 * 2.0 ** -22 + d * 2.0 ** -24) * (np.abs(X64r) @ np.abs(X64c).T)
    d_norms = d * 2.0 ** -24 * (sq_r[:, None] + sq_c[None, :])
    dK = K * (gamma * (2 * d_gram + d_norms) + 2.0 ** -22)
    bounds = (dK @ np.abs(V_c) + (mc + 1) * 2.0 ** -24 * (K @ np.abs(V_c)),
              dK.T @ np.abs(V_r) + (mr + 1) * 2.0 ** -24 * (K.T @ np.abs(V_r)))
    for g, w, b in zip(got, want, bounds):
        assert g.shape == w.shape and np.all(np.isfinite(g))
        assert np.all(np.abs(g - w) <= b)
    # the TF32 one-pass product of the same block is far coarser
    tr, tc = _tf32_np(Xr).astype(np.float64), _tf32_np(Xc).astype(np.float64)
    K_tf32 = np.exp(-gamma * (sq_r[:, None] + sq_c[None, :] - 2 * tr @ tc.T))
    tf32_err = np.abs(K_tf32 @ V_c - want[0]).max()
    assert np.abs(got[0] - want[0]).max() < 0.1 * tf32_err

