"""Wrappers of the hand-written CUDA Gram block matmats (csrc/gram_matmat.cu).

Kernel C, :func:`gram_matmat_sym` — ``K(X, X) @ V`` for V (m, C), every
block-CG iteration of a one-vs-all fit — and kernel D,
:func:`gram_matmat_rect` — ``K(P, S) @ A`` for A (n_s, C), multiclass and
one-vs-one predict — replace plssvm_tpu/ops/pallas_matvec.py
``kernel_matmat_pallas_dual`` with ``symmetric=True`` (through
``kernel_matmat_pallas_big``) and ``symmetric=False``.  The source note in
csrc/gram_matmat.cu says how they are built and what bounds them.

As in ops/gram_matvec.py: ``precision`` is the Gram precision tier; on
float32 CUDA tensors kernel C takes the tensor-core tile (csrc/gram_tc.cuh)
at "f32" (TF32) and "bf16" and the FFMA tile at "highest", kernel D the FFMA
tile at every tier (bf16 operands at "bf16"); float64 runs the FFMA tile.
Each wrapper takes its plain PyTorch version (ops/matvec.py) at the same
tier for tensors that lie on the CPU, and only then; for a CUDA tensor it
launches its kernel or raises, never falls back.  Each counts its launches
in a plain module-level int (``sym_launches``, ``rect_launches`` for the
FFMA tile, ``sym_tc_launches`` for the tensor-core tile).  V, A and the
output are row-major (rows, C) for any C >= 1.
"""

from __future__ import annotations

import torch

from . import _build
from . import matvec as _plain
from .gram_matvec import (
    _TC_TIERS,
    _check_gram_kind,
    _check_operands,
    _raise_on_error,
    _require_cuda,
    bf16_operands,
    tier_operand,
    uses_tensor_cores,
)
from ..parameter import KernelFunctionType

#: kernel launches of gram_matmat_sym / gram_matmat_rect on the FFMA tile
sym_launches = 0
rect_launches = 0
#: kernel C's launches on the tensor-core tile ("f32" as TF32, "bf16")
sym_tc_launches = 0


def reset_counts() -> None:
    """Zero the launch counts of both kernels and the call counts of their
    plain versions."""
    global sym_launches, rect_launches, sym_tc_launches
    sym_launches = 0
    rect_launches = 0
    sym_tc_launches = 0
    _plain.sym_matmat_plain_calls = 0
    _plain.rect_matmat_plain_calls = 0


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
) -> torch.Tensor:
    """``K(X, X) @ V`` for a poly / RBF / sigmoid kernel (kernel C).

    ``X`` (m, d), ``sq`` (m,) its squared row norms, ``V`` (m, C);
    ``precision`` the tier, as in ``gram_matvec.gram_matvec_sym``.
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
    suffix = _check_operands(
        kind, [("X", X), ("sq", sq), ("V", V)], [(m, d), (m,), (m, C)]
    )
    out = torch.zeros((m, C), dtype=X.dtype, device=X.device)
    if m == 0 or C == 0:
        return out
    lib = _build.load()
    if uses_tensor_cores(X, precision):
        op = tier_operand(X, precision)
        fn = getattr(lib, f"plssvm_gram_matmat_sym_{_TC_TIERS[precision][0]}")
        with torch.cuda.device(X.device):
            err = fn(
                op.data_ptr(), sq.data_ptr(), V.data_ptr(), out.data_ptr(), m,
                op.shape[1], C, int(kind), int(degree), float(gamma),
                float(coef0), torch.cuda.current_stream().cuda_stream,
            )
        _raise_on_error(lib, err, "gram_matmat_sym (tensor cores)")
        global sym_tc_launches
        sym_tc_launches += 1
        return out
    fn = getattr(lib, f"plssvm_gram_matmat_sym_{suffix}")
    with torch.cuda.device(X.device):
        err = fn(
            X.data_ptr(), sq.data_ptr(), V.data_ptr(), out.data_ptr(), m, d, C,
            int(kind), int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "gram_matmat_sym")
    global sym_launches
    sym_launches += 1
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
    column per class or machine; ``precision`` the tier.
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
    suffix = _check_operands(
        kind,
        [("P", P), ("S", S), ("sq_p", sq_p), ("sq_s", sq_s), ("A", A)],
        [(n_p, d), (n_s, d), (n_p,), (n_s,), (n_s, C)],
    )
    out = torch.zeros((n_p, C), dtype=P.dtype, device=P.device)
    if n_p == 0 or n_s == 0 or C == 0:
        return out
    lib = _build.load()
    P, S, suffix = bf16_operands(P, S, precision, suffix)
    fn = getattr(lib, f"plssvm_gram_matmat_rect_{suffix}")
    with torch.cuda.device(P.device):
        err = fn(
            P.data_ptr(), S.data_ptr(), sq_p.data_ptr(), sq_s.data_ptr(),
            A.data_ptr(), out.data_ptr(), n_p, n_s, d, C,
            int(kind), int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "gram_matmat_rect")
    global rect_launches
    rect_launches += 1
    return out
