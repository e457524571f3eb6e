"""Wrapper of kernel N (csrc/kernel_matrix.cu): the explicit solver's
kernel matrix for the laplacian and chi-squared kernels.

:func:`kernel_matrix_sym` builds ``K(X, X)`` (m, m) for the one-device
explicit solve (solver/explicit.py), evaluating the upper triangle's tiles
and storing each at (i, j) and (j, i); :func:`kernel_matrix_rect` builds
``K(Xr, Xc)`` (mr, mc), the ring's row block ``K_p = k(X_p, X)``
(parallel/sharded.py).  No Pallas kernel is replaced: plssvm_tpu builds its
explicit matrix in XLA (plssvm_tpu/solver/explicit.py
``kernel_matrix_block``).  The source note in csrc/kernel_matrix.cu says
what bounds it.

As in ops/distance.py: each wrapper takes its plain PyTorch version
(:func:`kernel_matrix_rect_plain`, the port's ``kernel_block`` per row
block: ``exp(-gamma * pairwise_distance)``) for tensors that lie on the CPU, and
only then; for a CUDA tensor it launches kernel N or raises, never falls
back.  Each counts its launches (and the plain version its calls) in a
plain module-level int.  ``X`` is float32 or float64; K is of X's type, or
bfloat16 (``out_dtype=torch.bfloat16``: the "bf16" tier's storage, rounded
once at the store as ``Tensor.to`` rounds).
"""

from __future__ import annotations

import torch

from ..kernel_functions import kernel_block
from ..parameter import KernelFunctionType
from . import _build
from .distance import _check_distance_kind
from .gram_matvec import _check_tensors, _raise_on_error, _require_cuda

#: kernel launches of kernel N's two walks
sym_launches = 0
rect_launches = 0
#: calls of the plain version (CPU tensors)
plain_calls = 0

#: rows of K the plain version computes at a time
PLAIN_ROW_BLOCK = 256


def reset_counts() -> None:
    """Zero the launch counts of kernel N and the plain version's calls."""
    global sym_launches, rect_launches, plain_calls
    sym_launches = rect_launches = plain_calls = 0


def _storage(X: torch.Tensor, out_dtype) -> torch.dtype:
    dtype = X.dtype if out_dtype is None else out_dtype
    if dtype not in (X.dtype, torch.bfloat16):
        raise TypeError(f"K is stored as {X.dtype} or bfloat16, not {dtype}")
    return dtype


def kernel_matrix_rect_plain(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
    out_dtype=None,
) -> torch.Tensor:
    """``K[i, j] = exp(-gamma * dist(Xr_i, Xc_j))`` -> (mr, mc): the
    port's ``kernel_block`` (``pairwise_distance``, then the exp) per block
    of PLAIN_ROW_BLOCK rows, as plssvm_tpu's ``kernel_matrix_block`` scans
    its row blocks."""
    _check_distance_kind(kind)
    global plain_calls
    plain_calls += 1
    dtype = _storage(Xr, out_dtype)
    K = torch.empty((Xr.shape[0], Xc.shape[0]), dtype=dtype, device=Xr.device)
    for i in range(0, Xr.shape[0], PLAIN_ROW_BLOCK):
        # a distance kernel's block reads no norms, coef0 or degree
        K[i:i + PLAIN_ROW_BLOCK] = kernel_block(Xr[i:i + PLAIN_ROW_BLOCK], Xc, None, None,
                                                kind, gamma, 0.0, 1)
    return K


def kernel_matrix_sym_plain(
    X: torch.Tensor, *, kind: KernelFunctionType, gamma: float, out_dtype=None
) -> torch.Tensor:
    """``K(X, X)`` -> (m, m) through :func:`kernel_matrix_rect_plain`."""
    return kernel_matrix_rect_plain(X, X, kind=kind, gamma=gamma, out_dtype=out_dtype)


def _launch(name, tensors, K, sizes, kind, gamma):
    suffix = "f32" if tensors[0].dtype == torch.float32 else "f64"
    lib = _build.load()
    fn = getattr(lib, f"plssvm_{name}_{suffix}")
    with torch.cuda.device(K.device):
        err = fn(
            *(t.data_ptr() for t in tensors), K.data_ptr(), *sizes, int(kind),
            float(gamma), int(K.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, name)


def kernel_matrix_sym(
    X: torch.Tensor, *, kind: KernelFunctionType, gamma: float, out_dtype=None
) -> torch.Tensor:
    """``K(X, X)`` (m, m) for a laplacian / chi-squared kernel (kernel N's
    symmetric walk).  ``X`` (m, d) row-major."""
    _check_distance_kind(kind)
    if X.device.type == "cpu":
        return kernel_matrix_sym_plain(X, kind=kind, gamma=gamma, out_dtype=out_dtype)
    _require_cuda(X, "kernel_matrix_sym")
    m, d = X.shape
    _check_tensors([("X", X)], [(m, d)])
    K = torch.empty((m, m), dtype=_storage(X, out_dtype), device=X.device)
    if m == 0:
        return K
    if d == 0:
        return K.fill_(1.0)
    _launch("kernel_matrix_sym", (X,), K, (m, d), kind, gamma)
    global sym_launches
    sym_launches += 1
    return K


def kernel_matrix_rect(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
    out_dtype=None,
) -> torch.Tensor:
    """``K(Xr, Xc)`` (mr, mc) for a laplacian / chi-squared kernel (kernel
    N's rectangular walk).  ``Xr`` (mr, d), ``Xc`` (mc, d) row-major."""
    _check_distance_kind(kind)
    if Xr.device.type == "cpu":
        return kernel_matrix_rect_plain(Xr, Xc, kind=kind, gamma=gamma, out_dtype=out_dtype)
    _require_cuda(Xr, "kernel_matrix_rect")
    mr, d = Xr.shape
    mc = Xc.shape[0]
    _check_tensors([("Xr", Xr), ("Xc", Xc)], [(mr, d), (mc, d)])
    K = torch.empty((mr, mc), dtype=_storage(Xr, out_dtype), device=Xr.device)
    if mr == 0 or mc == 0:
        return K
    if d == 0:
        return K.fill_(1.0)
    _launch("kernel_matrix_rect", (Xr, Xc), K, (mr, mc, d), kind, gamma)
    global rect_launches
    rect_launches += 1
    return K
