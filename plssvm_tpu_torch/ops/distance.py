"""Wrappers of the hand-written CUDA distance-kernel products
(csrc/distance.cu), for the laplacian and chi-squared kernels.

Kernel E, :func:`distance_matvec_sym` — ``K(X, X) @ v``, every binary CG
iteration — and kernel F, :func:`distance_matvec_rect` — ``K(P, S) @ a``,
binary predict — replace plssvm_tpu/ops/pallas_distance.py
``distance_matvec_pallas_dual`` with ``symmetric=True`` (through
``distance_matvec_pallas_big``) and ``symmetric=False``.  Kernel G,
:func:`distance_matmat_sym` — ``K(X, X) @ V`` for V (m, C), every block-CG
iteration — and kernel H, :func:`distance_matmat_rect` — ``K(P, S) @ A``,
multiclass and one-vs-one predict — replace ``distance_matmat_pallas_dual``
(through ``distance_matmat_pallas_big``) the same two ways.  The source
note in csrc/distance.cu says what bounds them.  Kernels L,
:func:`distance_matvec_dual`, and M, :func:`distance_matmat_dual` — ``(K(Xr,
Xc) @ v_c, K(Xr, Xc)^T @ v_r)``, the row-sharded ring's off-diagonal block
— are the ``symmetric=False`` dual outputs of the same two TPU kernels
(csrc/dual.cu).

As in ops/gram_matvec.py: each wrapper takes its plain PyTorch version
(ops/matvec.py ``distance_*_plain``) for tensors that lie on the CPU, and
only then; for a CUDA tensor it launches its kernel or raises, never falls
back.  Each counts its launches in a plain module-level int.  No squared
norms are taken: the distance kernels do not read them.  float32 and
float64, each computed in its own type (the TPU kernels always computed in
float32).
"""

from __future__ import annotations

import torch

from ..kernel_functions import DISTANCE_KERNELS
from ..parameter import KernelFunctionType
from . import _build
from . import matvec as _plain
from .gram_matvec import _check_tensors, _require_cuda, call_entry

#: kernel launches of kernels E, F, G and H
matvec_sym_launches = 0
matvec_rect_launches = 0
matmat_sym_launches = 0
matmat_rect_launches = 0
#: kernel launches of kernels L and M (the dual walks)
matvec_dual_launches = 0
matmat_dual_launches = 0


def reset_counts() -> None:
    """Zero the launch counts of the four kernels and the call counts of
    their plain versions."""
    global matvec_sym_launches, matvec_rect_launches
    global matmat_sym_launches, matmat_rect_launches
    global matvec_dual_launches, matmat_dual_launches
    matvec_sym_launches = matvec_rect_launches = 0
    matmat_sym_launches = matmat_rect_launches = 0
    matvec_dual_launches = matmat_dual_launches = 0
    _plain.dist_sym_plain_calls = 0
    _plain.dist_rect_plain_calls = 0
    _plain.dist_sym_matmat_plain_calls = 0
    _plain.dist_rect_matmat_plain_calls = 0
    _plain.dist_dual_plain_calls = 0
    _plain.dist_dual_matmat_plain_calls = 0


def _check_distance_kind(kind) -> None:
    if kind not in DISTANCE_KERNELS:
        raise ValueError(
            f"the distance kernels take laplacian or chi_squared, not {kind}"
        )


def _launch(name, tensors, sizes, kind, gamma, *outs):
    """Run entry point ``plssvm_<name>_<suffix>`` on the tensors' device and
    return ``outs`` (one tensor, or the dual walks' two)."""
    suffix = "f32" if outs[0].dtype == torch.float32 else "f64"
    lib = _build.load()
    call_entry(lib, getattr(lib, f"plssvm_{name}_{suffix}"), outs[0].device, (
        *(t.data_ptr() for t in tensors), *(o.data_ptr() for o in outs),
        *sizes, int(kind), float(gamma),
    ), name)
    return outs[0] if len(outs) == 1 else outs


def distance_matvec_sym(
    X: torch.Tensor, v: torch.Tensor, *, kind: KernelFunctionType, gamma: float
) -> torch.Tensor:
    """``K(X, X) @ v`` for a laplacian / chi-squared kernel (kernel E).

    ``X`` (m, d), ``v`` (m,).
    """
    _check_distance_kind(kind)
    if X.device.type == "cpu":
        return _plain.distance_matvec_plain(X, v, kind=kind, gamma=gamma)
    _require_cuda(X, "distance_matvec_sym")
    m, d = X.shape
    _check_tensors([("X", X), ("v", v)], [(m, d), (m,)])
    out = torch.zeros((m,), dtype=X.dtype, device=X.device)
    if m == 0:
        return out
    _launch("distance_matvec_sym", (X, v), (m, d), kind, gamma, out)
    global matvec_sym_launches
    matvec_sym_launches += 1
    return out


def distance_matvec_rect(
    P: torch.Tensor,
    S: torch.Tensor,
    a: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
) -> torch.Tensor:
    """``K(P, S) @ a`` for a laplacian / chi-squared kernel (kernel F).

    ``P`` (n_p, d) points, ``S`` (n_s, d) support vectors, ``a`` (n_s,).
    """
    _check_distance_kind(kind)
    if P.device.type == "cpu":
        return _plain.distance_matvec_rect_plain(P, S, a, kind=kind, gamma=gamma)
    _require_cuda(P, "distance_matvec_rect")
    n_p, d = P.shape
    n_s = S.shape[0]
    _check_tensors([("P", P), ("S", S), ("a", a)], [(n_p, d), (n_s, d), (n_s,)])
    out = torch.zeros((n_p,), dtype=P.dtype, device=P.device)
    if n_p == 0 or n_s == 0:
        return out
    _launch("distance_matvec_rect", (P, S, a), (n_p, n_s, d), kind, gamma, out)
    global matvec_rect_launches
    matvec_rect_launches += 1
    return out


def distance_matmat_sym(
    X: torch.Tensor, V: torch.Tensor, *, kind: KernelFunctionType, gamma: float
) -> torch.Tensor:
    """``K(X, X) @ V`` for a laplacian / chi-squared kernel (kernel G).

    ``X`` (m, d), ``V`` (m, C) row-major, any C >= 1.
    """
    _check_distance_kind(kind)
    if X.device.type == "cpu":
        return _plain.distance_matmat_plain(X, V, kind=kind, gamma=gamma)
    _require_cuda(X, "distance_matmat_sym")
    m, d = X.shape
    C = V.shape[1] if V.ndim == 2 else -1
    _check_tensors([("X", X), ("V", V)], [(m, d), (m, C)])
    out = torch.zeros((m, C), dtype=X.dtype, device=X.device)
    if m == 0 or C == 0:
        return out
    _launch("distance_matmat_sym", (X, V), (m, d, C), kind, gamma, out)
    global matmat_sym_launches
    matmat_sym_launches += 1
    return out


def distance_matmat_rect(
    P: torch.Tensor,
    S: torch.Tensor,
    A: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
) -> torch.Tensor:
    """``K(P, S) @ A`` for a laplacian / chi-squared kernel (kernel H).

    ``P`` (n_p, d) points, ``S`` (n_s, d) support vectors, ``A`` (n_s, C)
    the weights, one column per class or machine.
    """
    _check_distance_kind(kind)
    if P.device.type == "cpu":
        return _plain.distance_matmat_rect_plain(P, S, A, kind=kind, gamma=gamma)
    _require_cuda(P, "distance_matmat_rect")
    n_p, d = P.shape
    n_s = S.shape[0]
    C = A.shape[1] if A.ndim == 2 else -1
    _check_tensors([("P", P), ("S", S), ("A", A)], [(n_p, d), (n_s, d), (n_s, C)])
    out = torch.zeros((n_p, C), dtype=P.dtype, device=P.device)
    if n_p == 0 or n_s == 0 or C == 0:
        return out
    _launch("distance_matmat_rect", (P, S, A), (n_p, n_s, d, C), kind, gamma, out)
    global matmat_rect_launches
    matmat_rect_launches += 1
    return out


def distance_matvec_dual(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    v_c: torch.Tensor,
    v_r: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
):
    """``(K @ v_c, K.T @ v_r)`` with ``K = K(Xr, Xc)`` for a laplacian /
    chi-squared kernel (kernel L), one walk of the block.

    ``Xr`` (mr, d), ``Xc`` (mc, d), ``v_c`` (mc,), ``v_r`` (mr,).  On CUDA
    tensors, float32 or float64, the matvec walk of ``csrc/dual.cu``: a
    persistent grid of the card's SMs times the blocks an SM holds, each
    block an equal run of strips of the block's row tiles, its chunks of
    features copied asynchronously into a double buffer; row sums kept in
    registers along a run's row tile, column sums reduced by warp shuffles,
    both stored in slots and added to the zeroed outputs in a fixed order
    (csrc/fixed_sum.cuh).
    """
    _check_distance_kind(kind)
    if Xr.device.type == "cpu":
        return _plain.distance_matvec_dual_plain(Xr, Xc, v_c, v_r, kind=kind, gamma=gamma)
    _require_cuda(Xr, "distance_matvec_dual")
    mr, d = Xr.shape
    mc = Xc.shape[0]
    _check_tensors([("Xr", Xr), ("Xc", Xc), ("v_c", v_c), ("v_r", v_r)],
                   [(mr, d), (mc, d), (mc,), (mr,)])
    out_r = torch.zeros((mr,), dtype=Xr.dtype, device=Xr.device)
    out_c = torch.zeros((mc,), dtype=Xr.dtype, device=Xr.device)
    if mr == 0 or mc == 0:
        return out_r, out_c
    _launch("distance_matvec_dual", (Xr, Xc, v_c, v_r), (mr, mc, d), kind,
            gamma, out_r, out_c)
    global matvec_dual_launches
    matvec_dual_launches += 1
    return out_r, out_c


def distance_matmat_dual(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    V_c: torch.Tensor,
    V_r: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
):
    """``(K @ V_c, K.T @ V_r)`` with ``K = K(Xr, Xc)`` for a laplacian /
    chi-squared kernel (kernel M), one walk of the block.

    ``Xr`` (mr, d), ``Xc`` (mc, d), ``V_c`` (mc, C), ``V_r`` (mr, C).
    """
    _check_distance_kind(kind)
    if Xr.device.type == "cpu":
        return _plain.distance_matmat_dual_plain(Xr, Xc, V_c, V_r, kind=kind, gamma=gamma)
    _require_cuda(Xr, "distance_matmat_dual")
    mr, d = Xr.shape
    mc = Xc.shape[0]
    C = V_c.shape[1] if V_c.ndim == 2 else -1
    _check_tensors([("Xr", Xr), ("Xc", Xc), ("V_c", V_c), ("V_r", V_r)],
                   [(mr, d), (mc, d), (mc, C), (mr, C)])
    out_r = torch.zeros((mr, C), dtype=Xr.dtype, device=Xr.device)
    out_c = torch.zeros((mc, C), dtype=Xr.dtype, device=Xr.device)
    if mr == 0 or mc == 0 or C == 0:
        return out_r, out_c
    _launch("distance_matmat_dual", (Xr, Xc, V_c, V_r), (mr, mc, d, C), kind,
            gamma, out_r, out_c)
    global matmat_dual_launches
    matmat_dual_launches += 1
    return out_r, out_c
