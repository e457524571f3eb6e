"""The rectangular tensor-core tile's tier oracle (kernels B and D at "f32"
and "bf16") on the CPU, against the TPU kernels it replaces.

On float32 CUDA tensors kernels B and D at "f32" take TF32-rounded copies
of P and S (``round_to_tf32``) with the squared norms of the float32 P and
S, and at "bf16" bf16 copies.  Their exact oracle is the plain version on
those operands.  Here that oracle is held against the Pallas kernels of
plssvm_tpu under ``pltpu.force_tpu_interpret_mode()``, fed the same
TF32-rounded operands and float32 norms: K3 ``kernel_matvec_pallas_rect``
(d = 128 runs its full-d body, d = 1280 its feature-blocked one) and the
first output of K4 ``kernel_matmat_pallas_dual(..., symmetric=False)``, at
rtol = atol = 2e-5 as tests/test_torch_gram_precision.py holds the bf16
tier (only the f32 summation order differs).  Also ``chip_smoke.py``'s
rectangular tensor-core bounds, the operand copies' padding, and
``kernel_resources``' names of the tile's instantiations.

Inputs are made with numpy from a seed and handed to both packages.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu_torch.ops import _build, gram_matmat, gram_matvec, matvec
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind

GRAM_KINDS = ["polynomial", "rbf", "sigmoid"]
COEF0 = {"polynomial": 1.0, "rbf": 0.0, "sigmoid": -0.5}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kinds(name):
    return getattr(JKind, name.upper()), getattr(TKind, name.upper())


def _operands(seed, n_p, n_s, d, n_classes):
    """TF32-rounded P (n_p, d) and S (n_s, d), the squared norms of the
    float32 P and S before rounding, and the weights a (n_s,) or A (n_s,
    n_classes)."""
    rng = np.random.default_rng(seed)
    P = (rng.normal(size=(n_p, d)) * 0.2).astype(np.float32)
    S = (rng.normal(size=(n_s, d)) * 0.2).astype(np.float32)
    shape = (n_s,) if n_classes is None else (n_s, n_classes)
    weights = rng.normal(size=shape).astype(np.float32)
    sq_p, sq_s = (P * P).sum(1), (S * S).sum(1)
    P_t = matvec.round_to_tf32(torch.from_numpy(P)).numpy()
    S_t = matvec.round_to_tf32(torch.from_numpy(S)).numpy()
    return P_t, S_t, sq_p, sq_s, weights


def _tier_oracle(plain, P, S, sq_p, sq_s, weights, tier, **kw):
    """The port's rect oracle: the plain version on the tier's operands of
    P and S (TF32-rounded for "f32", bf16-rounded for "bf16") with the
    given float32 norms."""
    P, S = torch.from_numpy(P), torch.from_numpy(S)
    if tier == "f32":
        P, S = matvec.round_to_tf32(P), matvec.round_to_tf32(S)
    return plain(P, S, torch.from_numpy(sq_p), torch.from_numpy(sq_s),
                 torch.from_numpy(weights), precision=tier, **kw).numpy()


@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("d", [128, 1280])
@pytest.mark.parametrize("name", GRAM_KINDS)
def test_k3_rect_tier_oracle(name, d, tier):
    """Kernel B's oracle against K3 on 128 points x 256 SVs."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matvec_pallas_rect

    jkind, tkind = _kinds(name)
    P, S, sq_p, sq_s, a = _operands(71, 128, 256, d, None)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(kernel_matvec_pallas_rect(
            jnp.asarray(P), jnp.asarray(S), jnp.asarray(sq_p), jnp.asarray(sq_s),
            jnp.asarray(a), kind=jkind, gamma=jnp.float32(1.0 / d),
            coef0=jnp.float32(COEF0[name]), degree=3, precision=tier,
        ))
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3)
    got = _tier_oracle(matvec.kernel_matvec_rect_plain, P, S, sq_p, sq_s, a, tier, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _class_major(V):
    cp = -(-V.shape[1] // 8) * 8
    out = np.zeros((cp, V.shape[0]), np.float32)
    out[: V.shape[1]] = V.T
    return out


@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("n_classes", [1, 3, 10])
@pytest.mark.parametrize("d", [128, 1280])
@pytest.mark.parametrize("name", GRAM_KINDS)
def test_k4_rect_tier_oracle(name, d, n_classes, tier):
    """Kernel D's oracle against the first output of K4 with
    symmetric=False (K(P, S) @ A) on 256 points x 384 SVs."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matmat_pallas_dual

    jkind, tkind = _kinds(name)
    P, S, sq_p, sq_s, A = _operands(72, 256, 384, d, n_classes)
    Vx = np.zeros((_class_major(A).shape[0], P.shape[0]), np.float32)
    with pltpu.force_tpu_interpret_mode():
        rows, _ = kernel_matmat_pallas_dual(
            jnp.asarray(P), jnp.asarray(S), jnp.asarray(sq_p), jnp.asarray(sq_s),
            jnp.asarray(_class_major(A)), jnp.asarray(Vx), kind=jkind,
            gamma=jnp.float32(1.0 / d), coef0=jnp.float32(COEF0[name]), degree=3,
            precision=tier, symmetric=False,
        )
    want = np.asarray(rows)[:n_classes].T
    kw = dict(kind=tkind, gamma=1.0 / d, coef0=COEF0[name], degree=3)
    got = _tier_oracle(matvec.kernel_matmat_rect_plain, P, S, sq_p, sq_s, A, tier, **kw)
    assert got.shape == (256, n_classes)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_tf32_rounding_is_the_tier_not_the_identity():
    """The oracle on TF32 operands differs from the full-float32 product,
    and rounding the rounded operands again changes nothing."""
    rng = np.random.default_rng(73)
    P0 = (rng.normal(size=(40, 96)) * 0.2).astype(np.float32)
    S0 = (rng.normal(size=(70, 96)) * 0.2).astype(np.float32)
    a = rng.normal(size=(70,)).astype(np.float32)
    sq_p, sq_s = (P0 * P0).sum(1), (S0 * S0).sum(1)
    kw = dict(kind=TKind.RBF, gamma=1.0 / 96, coef0=0.0, degree=3)
    P, S = matvec.round_to_tf32(torch.from_numpy(P0)), matvec.round_to_tf32(torch.from_numpy(S0))
    assert torch.equal(matvec.round_to_tf32(P), P)
    tier = _tier_oracle(matvec.kernel_matvec_rect_plain, P0, S0, sq_p, sq_s, a, "f32", **kw)
    full = matvec.kernel_matvec_rect_plain(
        torch.from_numpy(P0), torch.from_numpy(S0), torch.from_numpy(sq_p),
        torch.from_numpy(sq_s), torch.from_numpy(a), **kw).numpy()
    assert np.abs(tier - full).max() > 0
    # the first-order TF32 bound of an RBF entry: 4 u gamma max|x|^2
    limit = 4 * 2.0 ** -11 * kw["gamma"] * max(sq_p.max(), sq_s.max())
    assert np.abs(tier - full).max() <= limit * np.abs(full).max()


def test_cpu_wrappers_keep_the_plain_version_at_f32():
    """On CPU tensors kernels B and D's wrappers take the plain version at
    the tier, full float32 at "f32", and launch nothing."""
    P, S, sq_p, sq_s, A = _operands(74, 9, 13, 7, 3)
    args = [torch.from_numpy(x) for x in (P, S, sq_p, sq_s)]
    kw = dict(kind=TKind.SIGMOID, gamma=0.1, coef0=-0.5, degree=3, precision="f32")
    gram_matvec.reset_counts()
    gram_matmat.reset_counts()
    got = gram_matmat.gram_matmat_rect(*args, torch.from_numpy(A), **kw)
    assert torch.equal(got, matvec.kernel_matmat_rect_plain(*args, torch.from_numpy(A), **kw))
    got = gram_matvec.gram_matvec_rect(*args, torch.from_numpy(A[:, 0].copy()), **kw)
    assert torch.equal(got, matvec.kernel_matvec_rect_plain(
        *args, torch.from_numpy(A[:, 0].copy()), **kw))
    assert (gram_matvec.rect_tc_launches, gram_matmat.rect_tc_launches,
            gram_matvec.rect_launches, gram_matmat.rect_launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("d,width", [(37, 40), (40, 40), (5, 8)])
def test_tier_operand_pads_p_and_s_alike(d, width):
    """P and S of different row counts get operand copies of one feature
    width, as the rect tile's two tensor maps need."""
    rng = np.random.default_rng(75)
    P = torch.from_numpy(rng.normal(size=(3, d)).astype(np.float32))
    S = torch.from_numpy(rng.normal(size=(11, d)).astype(np.float32))
    for tier in ("f32", "bf16"):
        P_op, S_op = gram_matvec.tier_operand(P, tier), gram_matvec.tier_operand(S, tier)
        want = width if tier == "f32" else -(-d // 8) * 8
        assert P_op.shape == (3, want) and S_op.shape == (11, want)
        assert P_op.is_contiguous() and S_op.is_contiguous()
        assert not P_op[:, d:].any() and not S_op[:, d:].any()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rect_bounds", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n_p,n_s,d,columns,tf32_ms,bf16_ms", [
    (10000, 60000, 784, 10, 1.901, 0.951),   # kernel D, mnist-width predict
    (32768, 32768, 512, 1, 2.221, 1.111),    # kernel B, the timing shape
    (32768, 32768, 512, 10, 2.221, 1.111),   # kernel D, the timing shape
    (2000, 10000, 200, 1, 0.01616, 0.00809),  # kernel B, config 2 predict
])
def test_rect_tensor_core_bounds(n_p, n_s, d, columns, tf32_ms, bf16_ms):
    """2 n_p n_s d flops at 495 (TF32) / 989 (bf16) TFLOP/s; the
    contraction's FFMAs, the exp per pair and the bytes lie below it."""
    chip_smoke = _chip_smoke()
    for tier, want in (("tf32", tf32_ms), ("bf16", bf16_ms)):
        ms, by = chip_smoke._rect_bound(n_p, n_s, d, columns, "gram", 4, 1, tier, exp=True)
        assert ms == pytest.approx(want, rel=1e-3) and by == "operations"
    ffma_ms, _ = chip_smoke._rect_bound(n_p, n_s, d, columns, "gram", 4, 1)
    assert ffma_ms > 7 * tf32_ms  # the FFMA tile's bound, at 33.5 T FFMA/s


def test_kernel_resources_names_the_tensor_core_tiles(tmp_path, monkeypatch):
    """kernel_resources() names the symmetric and the rectangular
    tensor-core tile by tier and kind, one name for both .cu files' copies."""
    library = tmp_path / "libplssvm_gram_0.so"
    library.with_name(library.name + ".ptxas.txt").write_text(
        "== gram_matmat.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119gram_tc_rect_kernelINS_8Tf32TierELi2EEEv14CUtensorMap_stS2_"
        "PKfS4_S4_Pflllilllifff' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 112 registers, 13360 bytes smem, 936 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118gram_tc_sym_kernelINS_8Bf16TierELi1EEEv14CUtensorMap_stPKfS4_"
        "Pfllilifff' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 126 registers, 13360 bytes smem, 808 bytes cmem[0]\n",
        encoding="utf-8",
    )
    monkeypatch.setattr(_build, "library_path", lambda: library)
    assert _build.kernel_resources() == {
        "gram_tc_rect tf32 rbf": {"spill_bytes": 0, "registers": 112, "smem_bytes": 13360},
        "gram_tc_sym bf16 poly": {"spill_bytes": 0, "registers": 126, "smem_bytes": 13360},
    }
