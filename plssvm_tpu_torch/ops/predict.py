"""Prediction ops, binary and multiclass.

Counterpart of plssvm_tpu/ops/predict.py (reference: gpu_csvm.hpp:656-730,
src/plssvm/backends/CUDA/predict_kernel.cu:17-74).  For the linear kernel a
``w = sum_i alpha_i sv_i`` vector ((d, C) for C columns) is computed once
and cached by the caller, so prediction is a single product per point; for
the other Gram kernels the decision values are ``K(points, SV) @ alpha -
rho``: through kernel B for a binary ``alpha`` (n_sv,) and kernel D for an
``alpha`` (n_sv, C) on the ``cuda`` implementation, and through their plain
versions on ``torch``.  The laplacian and chi-squared kernels take kernels
F and H (ops/distance.py) the same way, without squared norms.
"""

from __future__ import annotations

import torch

from ..kernel_functions import DISTANCE_KERNELS
from ..parameter import KernelFunctionType
from .distance import distance_matmat_rect, distance_matvec_rect
from .gram_matmat import gram_matmat_rect
from .gram_matvec import gram_matvec_rect
from .matvec import (
    distance_matmat_rect_plain,
    distance_matvec_rect_plain,
    kernel_matmat_rect_plain,
    kernel_matvec_rect_plain,
)


def calculate_w(support_vectors: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """w[j] = sum_i alpha_i * sv[i, j] (reference: gpu_csvm.hpp:386-429);
    (d, C) for ``alpha`` (n_sv, C)."""
    return support_vectors.T @ alpha


def predict_values(
    support_vectors: torch.Tensor,  # (n_sv, d)
    alpha: torch.Tensor,            # (n_sv,) or (n_sv, C)
    rho,                            # float, or (C,) tensor
    w,                              # (d,) / (d, C) for the linear kernel, else None
    predict_points: torch.Tensor,   # (n_pred, d)
    gamma: float,
    coef0: float,
    *,
    kind: KernelFunctionType,
    degree: int,
    impl: str = "torch",
    precision: str = "f32",
) -> torch.Tensor:
    """Decision values f(x) = sum_i alpha_i k(sv_i, x) - rho for each point:
    (n_pred,) for a binary ``alpha``, (n_pred, C) for ``alpha`` (n_sv, C).

    ``impl="cuda"`` routes the Gram kernels through kernel B
    (:func:`gram_matvec_rect`) or kernel D (:func:`gram_matmat_rect`) at
    the Gram tier ``precision`` (as the reference passes ``gram_precision``
    to its predict, plssvm_tpu/csvm.py:2383, :2401): on float32 CUDA
    tensors on the rectangular tensor-core tile at every tier ("f32" TF32
    operands, "bf16", "highest" three TF32 passes over the split
    operands, made once per predict); float64 on the rect DMMA
    tile (the FP64 tensor cores) at every tier.  The distance
    kernels go through kernel F or H; ``"torch"`` takes the plain versions
    at full precision, as plssvm_tpu's XLA path ignores the tier.
    """
    if kind == KernelFunctionType.LINEAR:
        return predict_points @ w - rho
    if kind in DISTANCE_KERNELS:
        # distance kernels never read the squared norms
        if alpha.ndim == 2:
            rect = distance_matmat_rect if impl == "cuda" else distance_matmat_rect_plain
        else:
            rect = distance_matvec_rect if impl == "cuda" else distance_matvec_rect_plain
        return rect(predict_points, support_vectors, alpha, kind=kind, gamma=gamma) - rho
    sq_pred = torch.sum(predict_points * predict_points, dim=-1)
    sq_sv = torch.sum(support_vectors * support_vectors, dim=-1)
    if alpha.ndim == 2:
        rect = gram_matmat_rect if impl == "cuda" else kernel_matmat_rect_plain
    else:
        rect = gram_matvec_rect if impl == "cuda" else kernel_matvec_rect_plain
    out = rect(
        predict_points, support_vectors, sq_pred, sq_sv, alpha,
        kind=kind, gamma=gamma, coef0=coef0, degree=degree,
        precision=precision if impl == "cuda" else "f32",
    )
    return out - rho
