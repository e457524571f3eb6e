"""The rect DMMA tile's oracle (kernels B and D in float64) on the CPU,
against the JAX package's float64 function for the same block.

On float64 CUDA tensors kernels B and D run on the rect DMMA tile
(csrc/gram_dmma.cu), whose on-card oracle is the port's plain version,
``kernel_matvec_rect_plain`` / ``kernel_matmat_rect_plain``
(tests/test_torch_dmma.py holds the tile against it on the card).  Here
that plain version is held against the float64 function the JAX package
runs for the same block: the TPU has no float64 unit and its Pallas kernels
K3 (``kernel_matvec_pallas_rect``) and K4 (``kernel_matmat_pallas_dual``)
compute in float32 whatever they are given, so float64 predict and the
ring's float64 rows-only walk go through XLA: ``predict_values`` with
``impl="xla"`` (``K(P, S) @ alpha - rho``, rho 0 here) and the ring's
``cross_rows`` (``kernel_block(...) @ v_c``).  Both at 1e-12 of
max|reference|, as tests/test_torch_sharded.py holds the float64 dual
walks: only the summation order differs.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plssvm_tpu.kernel_functions import kernel_block
from plssvm_tpu.ops.predict import predict_values
from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu_torch.ops import matvec
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind

COEF0 = {"polynomial": 1.0, "rbf": 0.0, "sigmoid": -0.5}
F64_REL = 1e-12


def _block(seed, n_p, n_s, d, n_classes):
    """Points P (n_p, d), support vectors S (n_s, d) and the weights a
    (n_s,) or A (n_s, n_classes), float64."""
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(n_p, d)) * 0.3
    S = rng.normal(size=(n_s, d)) * 0.3
    A = rng.normal(size=(n_s,) if n_classes is None else (n_s, n_classes))
    return P, S, A


def _plain(P, S, A, tkind, d, coef0):
    """The port's plain B (A (n_s,)) or D (A (n_s, C)) on float64 CPU
    tensors: the rect DMMA tile's oracle."""
    P, S, A = (torch.from_numpy(x) for x in (P, S, A))
    plain = matvec.kernel_matvec_rect_plain if A.ndim == 1 else matvec.kernel_matmat_rect_plain
    return plain(P, S, (P * P).sum(-1), (S * S).sum(-1), A, kind=tkind, gamma=1.0 / d,
                 coef0=coef0, degree=3).numpy()


@pytest.mark.parametrize("n_classes", [None, 1, 9])
@pytest.mark.parametrize("name", list(COEF0))
def test_rect_plain_f64_against_the_reference_predict(name, n_classes):
    """B and D's oracle against plssvm_tpu's float64 XLA predict on 300
    points x 257 support vectors x 17 features (odd d, across the 128-row
    tile): ``predict_values(..., impl="xla")`` with rho 0."""
    P, S, A = _block(90, 300, 257, 17, n_classes)
    rho = jnp.zeros(() if n_classes is None else (n_classes,), jnp.float64)
    want = np.asarray(predict_values(
        jnp.asarray(S), jnp.asarray(A), rho, jnp.zeros((17,), jnp.float64), jnp.asarray(P),
        jnp.float64(1.0 / 17), jnp.float64(COEF0[name]),
        kind=getattr(JKind, name.upper()), degree=3, impl="xla"))
    assert want.dtype == np.float64
    got = _plain(P, S, A, getattr(TKind, name.upper()), 17, COEF0[name])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F64_REL * np.abs(want).max()


@pytest.mark.parametrize("n_classes", [None, 10])
@pytest.mark.parametrize("name", list(COEF0))
def test_rect_plain_f64_against_the_reference_rows_only_walk(name, n_classes):
    """B and D's oracle against the reference ring's float64 rows-only walk
    (its XLA ``cross_rows``: the kernel block contracted against the
    column shard's weights) on a 129 x 127 block of 16 features, the
    tile's edges on both sides."""
    P, S, A = _block(91, 129, 127, 16, n_classes)
    K = np.asarray(kernel_block(jnp.asarray(P), jnp.asarray(S), jnp.asarray((P * P).sum(1)),
                                jnp.asarray((S * S).sum(1)), getattr(JKind, name.upper()),
                                1.0 / 16, COEF0[name], 3))
    want = K @ A
    got = _plain(P, S, A, getattr(TKind, name.upper()), 16, COEF0[name])
    assert np.abs(got - want).max() <= F64_REL * np.abs(want).max()
