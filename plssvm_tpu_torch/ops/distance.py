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
note in csrc/distance.cu says what bounds them.

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
from .gram_matvec import _check_tensors, _raise_on_error, _require_cuda

#: kernel launches of kernels E, F, G and H
matvec_sym_launches = 0
matvec_rect_launches = 0
matmat_sym_launches = 0
matmat_rect_launches = 0


def reset_counts() -> None:
    """Zero the launch counts of the four kernels and the call counts of
    their plain versions."""
    global matvec_sym_launches, matvec_rect_launches
    global matmat_sym_launches, matmat_rect_launches
    matvec_sym_launches = matvec_rect_launches = 0
    matmat_sym_launches = matmat_rect_launches = 0
    _plain.dist_sym_plain_calls = 0
    _plain.dist_rect_plain_calls = 0
    _plain.dist_sym_matmat_plain_calls = 0
    _plain.dist_rect_matmat_plain_calls = 0


def _check_distance_kind(kind) -> None:
    if kind not in DISTANCE_KERNELS:
        raise ValueError(
            f"the distance kernels take laplacian or chi_squared, not {kind}"
        )


def _launch(name, tensors, sizes, kind, gamma, out) -> torch.Tensor:
    """Run entry point ``plssvm_<name>_<suffix>`` on the tensors' device and
    return ``out``."""
    suffix = "f32" if out.dtype == torch.float32 else "f64"
    lib = _build.load()
    fn = getattr(lib, f"plssvm_{name}_{suffix}")
    with torch.cuda.device(out.device):
        err = fn(
            *(t.data_ptr() for t in tensors), out.data_ptr(), *sizes,
            int(kind), float(gamma), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, name)
    return out


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
