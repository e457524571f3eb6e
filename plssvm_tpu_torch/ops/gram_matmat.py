"""Wrappers of the hand-written CUDA Gram block matmats (csrc/gram_matmat.cu).

Kernel C, :func:`gram_matmat_sym` — ``K(X, X) @ V`` for V (m, C), every
block-CG iteration of a one-vs-all fit — and kernel D,
:func:`gram_matmat_rect` — ``K(P, S) @ A`` for A (n_s, C), multiclass and
one-vs-one predict — replace plssvm_tpu/ops/pallas_matvec.py
``kernel_matmat_pallas_dual`` with ``symmetric=True`` (through
``kernel_matmat_pallas_big``) and ``symmetric=False``.  The source note in
csrc/gram_matmat.cu says how they are built and what bounds them.  Kernel
K, :func:`gram_matmat_dual` — ``(K(Xr, Xc) @ V_c, K(Xr, Xc)^T @ V_r)``,
the one-vs-all ring's off-diagonal block — is the same function's
``symmetric=False`` dual output (the dual tensor-core tile of
csrc/gram_tc.cuh at every tier, "highest" in three TF32 passes over the
split operands; in float64 the dual DMMA tile of csrc/gram_dmma.cu).

As in ops/gram_matvec.py: ``precision`` is the Gram precision tier; on
float32 CUDA tensors kernels C and D take the tensor-core tiles at every
tier (csrc/gram_tc.cuh: the symmetric one for C, the rectangular one for
D; "f32" TF32, "bf16", "highest" three TF32 passes over the split
operand) and K the dual one at the same tiers (its FFMA tile of
csrc/dual.cu is on no wrapper's path: ``gram_matvec.gram_ffma`` launches
it for the card tests and chip_smoke.py); in float64, at every tier,
kernels C, D and K
run on the FP64 tensor cores (the symmetric, the rect and the dual DMMA
tile of csrc/gram_dmma.cu).
Each wrapper takes its plain PyTorch version (ops/matvec.py) at the same
tier for tensors that lie on the CPU, and only then; for a CUDA tensor it
launches its kernel or raises, never falls back.  Each counts its launches
in a plain module-level int (``sym_tc_launches``, ``rect_tc_launches`` for
the tensor-core tiles, ``sym_dmma_launches`` and ``rect_dmma_launches``
for kernels C and D on the DMMA tiles, ``dual_launches``,
``dual_tc_launches`` and ``dual_dmma_launches`` for kernel K on the FFMA,
tensor-core and DMMA tiles; ``sym_launches``, ``rect_launches`` and
``dual_launches`` count ``gram_matvec.gram_ffma``'s launches of C, D and
K's FFMA tiles, on no wrapper's path).  V, A and the output are row-major (rows, C) for any C
>= 1.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from . import matvec as _plain
from .gram_matvec import (
    _check_gram_kind,
    _check_operands,
    _require_cuda,
    launch_dual_dmma,
    launch_dual_tc,
    launch_rect_dmma,
    launch_rect_tc,
    launch_sym_dmma,
    launch_sym_tc,
    uses_dmma,
)
from ..parameter import KernelFunctionType

#: launches of kernels C and D's FFMA tiles (gram_matvec.gram_ffma, on no
#: wrapper's path)
sym_launches = 0
rect_launches = 0
#: kernel C's / kernel D's launches on the tensor-core tiles ("f32" as
#: TF32, "bf16", "highest" as three TF32 passes)
sym_tc_launches = 0
rect_tc_launches = 0
#: kernel C's / kernel D's launches on the FP64 tensor-core (DMMA) tiles,
#: float64
sym_dmma_launches = 0
rect_dmma_launches = 0
#: kernel K's launches on the FFMA tile (gram_matvec.gram_ffma, on no
#: wrapper's path), of gram_matmat_dual on the tensor-core tile ("f32",
#: "bf16", "highest" as three TF32 passes) and, float64, on the DMMA tile
dual_launches = 0
dual_tc_launches = 0
dual_dmma_launches = 0


def reset_counts() -> None:
    """Zero the launch counts of both kernels and the call counts of their
    plain versions."""
    global sym_launches, rect_launches, sym_tc_launches, rect_tc_launches
    global sym_dmma_launches, rect_dmma_launches, dual_launches, dual_tc_launches
    global dual_dmma_launches
    sym_launches = 0
    rect_launches = 0
    sym_tc_launches = 0
    rect_tc_launches = 0
    sym_dmma_launches = 0
    rect_dmma_launches = 0
    dual_launches = 0
    dual_tc_launches = 0
    dual_dmma_launches = 0
    _plain.sym_matmat_plain_calls = 0
    _plain.rect_matmat_plain_calls = 0
    _plain.dual_matmat_plain_calls = 0


def gram_matmat_sym(
    X: torch.Tensor,
    sq: torch.Tensor,
    V: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
    coef0: float,
    degree: int,
    precision: str = "f32",
    operand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``K(X, X) @ V`` for a poly / RBF / sigmoid kernel (kernel C).

    ``X`` (m, d), ``sq`` (m,) its squared row norms, ``V`` (m, C);
    ``precision`` and ``operand`` as in ``gram_matvec.gram_matvec_sym``.
    """
    _check_gram_kind(kind)
    _plain.check_precision(precision)
    if X.device.type == "cpu":
        return _plain.kernel_matmat_plain(
            X, sq, V, kind=kind, gamma=gamma, coef0=coef0, degree=degree,
            precision=precision,
        )
    _require_cuda(X, "gram_matmat_sym")
    m, d = X.shape
    C = V.shape[1] if V.ndim == 2 else -1
    _check_operands(
        kind, [("X", X), ("sq", sq), ("V", V)], [(m, d), (m,), (m, C)]
    )
    out = torch.zeros((m, C), dtype=X.dtype, device=X.device)
    if m == 0 or C == 0:
        return out
    lib = _build.load()
    if uses_dmma(X):
        launch_sym_dmma(lib, "matmat", X, sq, V, out, (C,), kind, gamma, coef0, degree)
        global sym_dmma_launches
        sym_dmma_launches += 1
        return out
    launch_sym_tc(lib, "matmat", X, sq, V, out, (C,), kind, gamma, coef0, degree,
                  precision, operand)
    global sym_tc_launches
    sym_tc_launches += 1
    return out


def gram_matmat_rect(
    P: torch.Tensor,
    S: torch.Tensor,
    sq_p: torch.Tensor,
    sq_s: torch.Tensor,
    A: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
    coef0: float,
    degree: int,
    precision: str = "f32",
) -> torch.Tensor:
    """``K(P, S) @ A`` for a poly / RBF / sigmoid kernel (kernel D).

    ``P`` (n_p, d) points, ``S`` (n_s, d) support vectors, ``sq_p`` /
    ``sq_s`` their squared row norms, ``A`` (n_s, C) the weights, one
    column per class or machine; ``precision`` the tier, as in
    ``gram_matvec.gram_matvec_rect``.
    """
    _check_gram_kind(kind)
    _plain.check_precision(precision)
    if P.device.type == "cpu":
        return _plain.kernel_matmat_rect_plain(
            P, S, sq_p, sq_s, A, kind=kind, gamma=gamma, coef0=coef0,
            degree=degree, precision=precision,
        )
    _require_cuda(P, "gram_matmat_rect")
    n_p, d = P.shape
    n_s = S.shape[0]
    C = A.shape[1] if A.ndim == 2 else -1
    _check_operands(
        kind,
        [("P", P), ("S", S), ("sq_p", sq_p), ("sq_s", sq_s), ("A", A)],
        [(n_p, d), (n_s, d), (n_p,), (n_s,), (n_s, C)],
    )
    out = torch.zeros((n_p, C), dtype=P.dtype, device=P.device)
    if n_p == 0 or n_s == 0 or C == 0:
        return out
    lib = _build.load()
    if uses_dmma(P):
        launch_rect_dmma(lib, "matmat", P, S, sq_p, sq_s, A, out, (C,), kind,
                         gamma, coef0, degree)
        global rect_dmma_launches
        rect_dmma_launches += 1
        return out
    launch_rect_tc(lib, "matmat", P, S, sq_p, sq_s, A, out, (C,), kind,
                   gamma, coef0, degree, precision)
    global rect_tc_launches
    rect_tc_launches += 1
    return out


def gram_matmat_dual(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    sq_r: torch.Tensor,
    sq_c: torch.Tensor,
    V_c: torch.Tensor,
    V_r: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
    coef0: float,
    degree: int,
    precision: str = "f32",
    operand=None,
):
    """``(K @ V_c, K.T @ V_r)`` with ``K = K(Xr, Xc)`` for a poly / RBF /
    sigmoid kernel (kernel K), one walk of the block.

    ``Xr`` (mr, d), ``Xc`` (mc, d), ``sq_r`` / ``sq_c`` their squared row
    norms, ``V_c`` (mc, C), ``V_r`` (mr, C); ``precision`` the tier: on
    float32 CUDA tensors the dual tensor-core tile at every tier ("highest"
    in three TF32 passes over the split stacks), on
    ``gram_matvec.tier_operand``'s copies of Xr and Xc (``operand``, their
    pair, made here when not given and ignored in float64); float64 CUDA
    tensors the dual DMMA tile at every tier.
    """
    _check_gram_kind(kind)
    _plain.check_precision(precision)
    if Xr.device.type == "cpu":
        return _plain.kernel_matmat_dual_plain(
            Xr, Xc, sq_r, sq_c, V_c, V_r, kind=kind, gamma=gamma,
            coef0=coef0, degree=degree, precision=precision,
        )
    _require_cuda(Xr, "gram_matmat_dual")
    mr, d = Xr.shape
    mc = Xc.shape[0]
    C = V_c.shape[1] if V_c.ndim == 2 else -1
    _check_operands(
        kind,
        [("Xr", Xr), ("Xc", Xc), ("sq_r", sq_r), ("sq_c", sq_c),
         ("V_c", V_c), ("V_r", V_r)],
        [(mr, d), (mc, d), (mr,), (mc,), (mc, C), (mr, C)],
    )
    out_r = torch.zeros((mr, C), dtype=Xr.dtype, device=Xr.device)
    out_c = torch.zeros((mc, C), dtype=Xr.dtype, device=Xr.device)
    if mr == 0 or mc == 0 or C == 0:
        return out_r, out_c
    lib = _build.load()
    if uses_dmma(Xr):
        launch_dual_dmma(lib, "matmat", Xr, Xc, sq_r, sq_c, V_c, V_r, out_r, out_c,
                         (C,), kind, gamma, coef0, degree)
        global dual_dmma_launches
        dual_dmma_launches += 1
        return out_r, out_c
    launch_dual_tc(lib, "matmat", Xr, Xc, sq_r, sq_c, V_c, V_r, out_r, out_c,
                   (C,), kind, gamma, coef0, degree, precision, operand)
    global dual_tc_launches
    dual_tc_launches += 1
    return out_r, out_c
