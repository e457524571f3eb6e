"""Binary prediction ops.

Counterpart of plssvm_tpu/ops/predict.py (reference: gpu_csvm.hpp:656-730,
src/plssvm/backends/CUDA/predict_kernel.cu:17-74).  For the linear kernel a
``w = sum_i alpha_i sv_i`` vector is computed once and cached by the caller,
so prediction is a single product per point; for the other Gram kernels the
decision values are ``K(points, SV) @ alpha - rho``, through kernel B on the
``cuda`` implementation and its plain version on ``torch``.
"""

from __future__ import annotations

import torch

from ..exceptions import NotPortedError
from ..parameter import KernelFunctionType
from .gram_matvec import gram_matvec_rect
from .matvec import kernel_matvec_rect_plain


def calculate_w(support_vectors: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """w[j] = sum_i alpha_i * sv[i, j] (reference: gpu_csvm.hpp:386-429)."""
    return support_vectors.T @ alpha


def predict_values(
    support_vectors: torch.Tensor,  # (n_sv, d)
    alpha: torch.Tensor,            # (n_sv,)
    rho: float,
    w,                              # (d,) for the linear kernel, else None
    predict_points: torch.Tensor,   # (n_pred, d)
    gamma: float,
    coef0: float,
    *,
    kind: KernelFunctionType,
    degree: int,
    impl: str = "torch",
) -> torch.Tensor:
    """Decision values f(x) = sum_i alpha_i k(sv_i, x) - rho for each point.

    ``impl="cuda"`` routes the Gram kernels through kernel B
    (:func:`gram_matvec_rect`); ``"torch"`` takes its plain version.
    """
    if alpha.ndim != 1:
        raise NotPortedError(
            "multiclass models are not ported yet (ROADMAP Queue 1, item 2: "
            "one-vs-all multiclass)"
        )
    if kind == KernelFunctionType.LINEAR:
        return predict_points @ w - rho
    sq_pred = torch.sum(predict_points * predict_points, dim=-1)
    sq_sv = torch.sum(support_vectors * support_vectors, dim=-1)
    rect = gram_matvec_rect if impl == "cuda" else kernel_matvec_rect_plain
    out = rect(
        predict_points, support_vectors, sq_pred, sq_sv, alpha,
        kind=kind, gamma=gamma, coef0=coef0, degree=degree,
    )
    return out - rho
