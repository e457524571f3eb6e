"""The port's Gram matvecs against the Pallas kernels they replace.

The plain PyTorch versions (plssvm_tpu_torch/ops/matvec.py) are the oracles
of the CUDA kernels A and B; here they are held against plssvm_tpu's Pallas
kernels in interpret mode, as tests/test_ops.py runs those on the CPU:
kernel A's oracle against ``kernel_matvec_pallas_dual(symmetric=True)``
(``outr + outc``), kernel B's against ``kernel_matvec_pallas_rect``.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances: f32 rtol/atol 2e-5 (as test_ops.py), f64 1e-10.

The kernels themselves run only on an NVIDIA GPU: tests/test_torch_cuda.py
compares them with the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plssvm_tpu.ops.matvec import kernel_matvec_xla
from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu_torch.exceptions import NotPortedError
from plssvm_tpu_torch.ops import gram_matvec, matvec
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind

GRAM_KINDS = ["polynomial", "rbf", "sigmoid"]
COEF0 = {"polynomial": 1.0, "rbf": 0.0, "sigmoid": -0.5}


def _kinds(name):
    return getattr(JKind, name.upper()), getattr(TKind, name.upper())


def _pad(a, shape):
    out = np.zeros(shape, dtype=a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _plain_sym(X, v, tkind, gamma, coef0):
    Xt = torch.from_numpy(X)
    return matvec.kernel_matvec_plain(
        Xt, (Xt * Xt).sum(-1), torch.from_numpy(v),
        kind=tkind, gamma=gamma, coef0=coef0, degree=3,
    ).numpy()


def _plain_rect(P, S, a, tkind, gamma, coef0):
    Pt, St = torch.from_numpy(P), torch.from_numpy(S)
    return matvec.kernel_matvec_rect_plain(
        Pt, St, (Pt * Pt).sum(-1), (St * St).sum(-1), torch.from_numpy(a),
        kind=tkind, gamma=gamma, coef0=coef0, degree=3,
    ).numpy()


def _pallas_sym(X, v, jkind, gamma, coef0):
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matvec_pallas_dual

    Xj, vj = jnp.asarray(X), jnp.asarray(v)
    sq = jnp.sum(Xj * Xj, axis=-1)
    with pltpu.force_tpu_interpret_mode():
        outr, outc = kernel_matvec_pallas_dual(
            Xj, Xj, sq, sq, vj, vj, kind=jkind, gamma=jnp.float32(gamma),
            coef0=jnp.float32(coef0), degree=3, symmetric=True,
        )
    return np.asarray(outr) + np.asarray(outc)


def _pallas_rect(P, S, a, jkind, gamma, coef0):
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matvec_pallas_rect

    Pj, Sj = jnp.asarray(P), jnp.asarray(S)
    with pltpu.force_tpu_interpret_mode():
        out = kernel_matvec_pallas_rect(
            Pj, Sj, jnp.sum(Pj * Pj, axis=-1), jnp.sum(Sj * Sj, axis=-1),
            jnp.asarray(a), kind=jkind, gamma=jnp.float32(gamma),
            coef0=jnp.float32(coef0), degree=3,
        )
    return np.asarray(out)


class TestSymAgainstPallasDual:
    @pytest.mark.parametrize("name", GRAM_KINDS)
    def test_multi_tile(self, name):
        """m=768 is a 3x3 tile grid of the Pallas walk."""
        jkind, tkind = _kinds(name)
        m, d = 768, 256
        rng = np.random.default_rng(31)
        X = (rng.normal(size=(m, d)) * 0.2).astype(np.float32)
        v = rng.normal(size=(m,)).astype(np.float32)
        want = _pallas_sym(X, v, jkind, 1.0 / d, COEF0[name])
        got = _plain_sym(X, v, tkind, 1.0 / d, COEF0[name])
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_k_blocked_wide_features(self):
        """d=1280 runs the Pallas walk's feature-blocked accumulation."""
        jkind, tkind = _kinds("rbf")
        m, d = 256, 1280
        rng = np.random.default_rng(32)
        X = (rng.normal(size=(m, d)) * 0.1).astype(np.float32)
        v = rng.normal(size=(m,)).astype(np.float32)
        want = _pallas_sym(X, v, jkind, 1.0 / d, 0.0)
        got = _plain_sym(X, v, tkind, 1.0 / d, 0.0)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("name", ["polynomial", "rbf"])
    def test_unpadded_against_zero_padded(self, name):
        """The port takes m=700, d=200 as they are; the Pallas kernel takes
        zero-padded copies (padded v entries are 0)."""
        jkind, tkind = _kinds(name)
        m, d = 700, 200
        rng = np.random.default_rng(33)
        X = (rng.normal(size=(m, d)) * 0.2).astype(np.float32)
        v = rng.normal(size=(m,)).astype(np.float32)
        want = _pallas_sym(_pad(X, (768, 256)), _pad(v, (768,)), jkind, 1.0 / d, COEF0[name])
        got = _plain_sym(X, v, tkind, 1.0 / d, COEF0[name])
        np.testing.assert_allclose(got, want[:m], rtol=2e-5, atol=2e-5)


class TestRectAgainstPallasRect:
    @pytest.mark.parametrize("d", [128, 1280])
    @pytest.mark.parametrize("name", GRAM_KINDS)
    def test_rect(self, name, d):
        """(128 points, 256 SVs); d=1280 runs the feature-blocked body."""
        jkind, tkind = _kinds(name)
        rng = np.random.default_rng(34)
        P = (rng.normal(size=(128, d)) * 0.2).astype(np.float32)
        S = (rng.normal(size=(256, d)) * 0.2).astype(np.float32)
        a = rng.normal(size=(256,)).astype(np.float32)
        want = _pallas_rect(P, S, a, jkind, 1.0 / d, COEF0[name])
        got = _plain_rect(P, S, a, tkind, 1.0 / d, COEF0[name])
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_unpadded_against_zero_padded(self):
        jkind, tkind = _kinds("rbf")
        n_p, n_s, d = 300, 700, 200
        rng = np.random.default_rng(35)
        P = (rng.normal(size=(n_p, d)) * 0.2).astype(np.float32)
        S = (rng.normal(size=(n_s, d)) * 0.2).astype(np.float32)
        a = rng.normal(size=(n_s,)).astype(np.float32)
        want = _pallas_rect(
            _pad(P, (384, 256)), _pad(S, (768, 256)), _pad(a, (768,)),
            jkind, 1.0 / d, 0.0,
        )
        got = _plain_rect(P, S, a, tkind, 1.0 / d, 0.0)
        np.testing.assert_allclose(got, want[:n_p], rtol=2e-5, atol=2e-5)


#: 700 x 200 for every kind; for the Gram kinds also the DMMA tile's ragged
#: edges: m across its 128-row tile, odd d (its operand padded by one zero
#: feature), d = 1 and d past 1024
F64_SHAPES = [pytest.param(name, 700, 200, id=name) for name in GRAM_KINDS + ["linear"]] + [
    pytest.param(name, m, d, id=f"{name}-{m}x{d}")
    for name in GRAM_KINDS for m, d in ((129, 3), (257, 1), (300, 1279))
]


@pytest.mark.parametrize("name,m,d", F64_SHAPES)
def test_f64_against_xla(name, m, d):
    """Both plain versions against plssvm_tpu's XLA matvec in float64, and
    the symmetric one on the DMMA tile's operand (``dmma_operand``: odd d
    padded with a zero feature), the tile's oracle on the card."""
    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(36)
    X = rng.normal(size=(m, d)) * 0.2
    v = rng.normal(size=(m,))
    sq = (X * X).sum(1)
    want = np.asarray(kernel_matvec_xla(
        jnp.asarray(X), jnp.asarray(sq), jnp.asarray(v), kind=jkind,
        gamma=1.0 / d, coef0=COEF0.get(name, 0.0), degree=3,
    ))
    if name == "linear":
        Xt = torch.from_numpy(X)
        got = matvec.linear_kernel_matvec(Xt, torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
        return
    got_sym = _plain_sym(X, v, tkind, 1.0 / d, COEF0[name])
    got_rect = _plain_rect(X, X, v, tkind, 1.0 / d, COEF0[name])
    np.testing.assert_allclose(got_sym, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got_rect, want, rtol=1e-10, atol=1e-10)
    X_op = gram_matvec.dmma_operand(torch.from_numpy(X)).numpy()
    got_op = _plain_sym(X_op, v, tkind, 1.0 / d, COEF0[name])
    np.testing.assert_allclose(got_op, want, rtol=1e-10, atol=1e-10)


class TestWrappers:
    def _operands(self, dtype=torch.float64, device="cpu"):
        rng = np.random.default_rng(37)
        X = torch.tensor(rng.normal(size=(50, 7)), dtype=dtype, device=device)
        v = torch.tensor(rng.normal(size=(50,)), dtype=dtype, device=device)
        return X, (X * X).sum(-1), v

    def test_cpu_tensors_take_the_plain_versions(self):
        gram_matvec.reset_counts()
        X, sq, v = self._operands()
        kw = dict(kind=TKind.RBF, gamma=0.1, coef0=0.0, degree=3)
        got = gram_matvec.gram_matvec_sym(X, sq, v, **kw)
        want = matvec.kernel_matvec_plain(X, sq, v, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        got = gram_matvec.gram_matvec_rect(X[:20], X, sq[:20], sq, v, **kw)
        torch.testing.assert_close(got, want[:20], rtol=1e-12, atol=1e-12)
        assert gram_matvec.sym_launches == 0
        assert gram_matvec.rect_launches == 0
        assert matvec.sym_plain_calls == 2
        assert matvec.rect_plain_calls == 1
        gram_matvec.reset_counts()
        assert matvec.sym_plain_calls == 0

    def test_other_devices_raise_instead_of_falling_back(self):
        X, sq, v = self._operands(device="meta")
        kw = dict(kind=TKind.RBF, gamma=0.1, coef0=0.0, degree=3)
        with pytest.raises(ValueError, match="CUDA tensors"):
            gram_matvec.gram_matvec_sym(X, sq, v, **kw)
        with pytest.raises(ValueError, match="CUDA tensors"):
            gram_matvec.gram_matvec_rect(X, X, sq, sq, v, **kw)

    def test_distance_kernels_are_not_ported(self):
        """The Gram wrappers do not take the distance kernels, on any
        device: those go through ops/distance.py (kernels E-H)."""
        X, sq, v = self._operands()
        for kind in (TKind.LAPLACIAN, TKind.CHI_SQUARED):
            with pytest.raises(ValueError, match="ops/distance.py"):
                gram_matvec.gram_matvec_sym(
                    X, sq, v, kind=kind, gamma=0.1, coef0=0.0, degree=3
                )
            with pytest.raises(ValueError, match="distance kernel"):
                gram_matvec.gram_matvec_rect(
                    X, X, sq, sq, v, kind=kind, gamma=0.1, coef0=0.0, degree=3
                )
        assert issubclass(NotPortedError, NotImplementedError)
