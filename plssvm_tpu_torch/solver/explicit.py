"""The explicit solver (``cg_explicit``): K built once, CG on the stored K.

Counterpart of plssvm_tpu/solver/explicit.py.  When the (dept, dept) kernel
matrix fits the device, building it once and running CG against the stored
matrix turns each iteration's O(m^2 d) kernel work into one O(m^2) read of
K.  The CG core is the implicit solve's (solver/cg.py ``cg_ls_svm_core`` /
``cg_ls_svm_multi_core``); only the ``kernel_mv`` / ``kernel_mm`` closure
differs, so Jacobi, weights, warm start, resume, the every-50th exact
residual, ``debug`` and the compensated scalars work as they do there.  The
port pads nothing, so K is (dept, dept).

The build (:func:`kernel_matrix_block`):

- **Gram kernels** (linear, polynomial, RBF, sigmoid): one matrix product
  per block of rows plus the port's ``apply_kernel_to_gram`` epilogue,
  written into K block by block, so no second m^2 buffer exists.  plssvm_tpu
  leaves this product to XLA outside any Pallas kernel; here it goes to
  ``torch.matmul`` at the solve's tier: on float32 CUDA tensors with
  ``impl="cuda"`` "f32" runs in TF32, "bf16" on bf16-rounded operands (exact
  in TF32, so the products are those of a bf16 GEMM with float32 sums),
  "highest" in full float32; float64 in float64 at every tier.  TF32 is
  switched on only inside the build (``_tf32``) and restored after.  On CPU
  tensors "bf16" takes the bf16-rounded operands too (the plain version at
  the tier); ``impl="torch"`` ignores the tier, as plssvm_tpu's XLA path
  does.  The squared norms are the unrounded X's, as kernel A's are.
- **Distance kernels** (laplacian, chi-squared): kernel N
  (ops/kernel_matrix.py), its plain version on CPU tensors or with
  ``impl="torch"``.
- At ``"bf16"`` K is stored in bfloat16 whatever X's type, as plssvm_tpu's
  ``_explicit_k_bytes`` counts it: half the memory and half the bytes each
  iteration reads.

The product (:func:`explicit_product`) is ``K @ v`` through cuBLAS on the
stored K, with TF32 switched off, so a float32 K is read in full float32.
A float32 K is contracted in slices, each partial product added to the
running one (``addmm_`` / ``addmv_``): one cuBLAS call sums each output
over all m columns in one float32 chain, 7.6x kernel G's error at
chi2-width (59999 x 784, C = 10; PERF.md), which lost labels that the
implicit fit keeps and made the fit collapse at epsilon 1e-8.  The
one-device K is symmetric, so ``K @ V = (V^T K)^T`` takes slices of
PRODUCT_ROWS rows, each a contiguous block of K; a ring's row block
``K_p`` takes slices of PRODUCT_COLUMNS columns.  A bfloat16 K contracts ``v`` rounded to bfloat16 (plssvm_tpu casts ``v``
to K's type) with float32 sums, never rounding the product to bfloat16:
on CUDA ``torch.mm(..., out_dtype=torch.float32)``; on the CPU, and for a
float64 solve, row blocks of K converted to the solve's type (float64 sums,
as plssvm_tpu's ``preferred_element_type``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..kernel_functions import DISTANCE_KERNELS, kernel_block
from ..ops import kernel_matrix as _kernel_matrix
from ..ops.matvec import check_precision
from ..parameter import KernelFunctionType
from .cg import (
    CGResult,
    MultiCGResult,
    _scalar_reductions,
    cg_ls_svm_core,
    cg_ls_svm_multi_core,
    compensated_sum,
)

#: bytes of one row block of the Gram build's product (the epilogue's
#: temporaries are of its size too)
BUILD_BLOCK_BYTES = 256 << 20
#: the build's and the bfloat16 product's workspace, at most: the block's
#: product and the epilogue's temporaries (ops/csvm count it against the
#: explicit budget)
BUILD_WORKSPACE_BYTES = 4 * BUILD_BLOCK_BYTES
#: rows of a symmetric float32 K, and columns of a rectangular one, per
#: partial product of ``explicit_product``: the float32 sum of an output
#: runs over at most this many terms, then over the partials
PRODUCT_ROWS, PRODUCT_COLUMNS = 4096, 512


def storage_dtype(dtype: torch.dtype, precision: str) -> torch.dtype:
    """The type K is stored in: bfloat16 at ``"bf16"``, else the solve's."""
    return torch.bfloat16 if precision == "bf16" else dtype


@contextlib.contextmanager
def _tf32(enabled: bool):
    """``torch.backends.cuda.matmul.allow_tf32`` set to ``enabled`` inside
    the block and restored after: the flag is global, and no other product
    of the port may see it."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def _rows_per_block(columns: int, itemsize: int) -> int:
    return max(1, BUILD_BLOCK_BYTES // max(1, columns * itemsize))


def _gram_build(Xr, Xc, K, gamma, coef0, kind, degree, precision, impl) -> None:
    """K[:] = k(Xr, Xc) for a Gram kernel, one block of rows at a time."""
    tier = impl == "cuda" and Xr.dtype == torch.float32
    sq_r = torch.sum(Xr * Xr, dim=-1)
    sq_c = torch.sum(Xc * Xc, dim=-1)
    A, B = Xr, Xc
    if tier and precision == "bf16":
        A = Xr.to(torch.bfloat16).to(Xr.dtype)
        B = A if Xc is Xr else Xc.to(torch.bfloat16).to(Xc.dtype)
    rows = _rows_per_block(Xc.shape[0], Xr.element_size())
    with _tf32(tier and precision != "highest" and Xr.device.type == "cuda"):
        for i in range(0, Xr.shape[0], rows):
            K[i:i + rows] = kernel_block(A[i:i + rows], B, sq_r[i:i + rows], sq_c, kind,
                                         gamma, coef0, degree)


def kernel_matrix_block(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    gamma: float,
    coef0: float,
    *,
    kind: KernelFunctionType,
    degree: int,
    precision: str = "f32",
    impl: str = "cuda",
    symmetric: bool = False,
) -> torch.Tensor:
    """Dense ``K[i, j] = k(Xr_i, Xc_j)`` -> (mr, mc), on Xr's device, of
    :func:`storage_dtype`.  ``symmetric=True`` says ``Xc`` is ``Xr``, so
    kernel N may walk the upper triangle only."""
    check_precision(precision)
    dtype = storage_dtype(Xr.dtype, precision)
    if kind in DISTANCE_KERNELS:
        if impl != "cuda":
            return _kernel_matrix.kernel_matrix_rect_plain(
                Xr, Xc, kind=kind, gamma=gamma, out_dtype=dtype)
        if symmetric:
            return _kernel_matrix.kernel_matrix_sym(Xr, kind=kind, gamma=gamma,
                                                    out_dtype=dtype)
        return _kernel_matrix.kernel_matrix_rect(Xr, Xc, kind=kind, gamma=gamma,
                                                 out_dtype=dtype)
    K = torch.empty((Xr.shape[0], Xc.shape[0]), dtype=dtype, device=Xr.device)
    _gram_build(Xr, Xc, K, gamma, coef0, kind, degree, precision, impl)
    return K


def build_kernel_matrix(
    X: torch.Tensor,
    gamma: float,
    coef0: float,
    *,
    kind: KernelFunctionType,
    degree: int,
    precision: str = "f32",
    impl: str = "cuda",
) -> torch.Tensor:
    """The dense kernel matrix ``K[i, j] = k(x_i, x_j)`` -> (m, m)."""
    return kernel_matrix_block(X, X, gamma, coef0, kind=kind, degree=degree,
                               precision=precision, impl=impl, symmetric=True)


def explicit_product(K: torch.Tensor, V: torch.Tensor, out_dtype: torch.dtype,
                     symmetric: bool = False) -> torch.Tensor:
    """``K @ V`` for V (m,) or (m, C) in ``out_dtype``, as described in the
    module docstring; ``symmetric`` says K equals its transpose."""
    if K.dtype == torch.float32:
        with _tf32(False):
            return _sliced_product(K, V, symmetric)
    if K.dtype != torch.bfloat16:
        with _tf32(False):
            return K @ V
    Vb = V.to(torch.bfloat16)
    if K.device.type == "cuda" and out_dtype == torch.float32:
        out = torch.mm(K, Vb.reshape(V.shape[0], -1), out_dtype=torch.float32)
        return out.reshape((K.shape[0],) + tuple(V.shape[1:]))
    Vw = Vb.to(out_dtype)
    out = torch.empty((K.shape[0],) + tuple(V.shape[1:]), dtype=out_dtype, device=K.device)
    rows = _rows_per_block(K.shape[1], torch.finfo(out_dtype).bits // 8)
    with _tf32(False):
        for i in range(0, K.shape[0], rows):
            out[i:i + rows] = K[i:i + rows].to(out_dtype) @ Vw
    return out


def _sliced_product(K: torch.Tensor, V: torch.Tensor, symmetric: bool) -> torch.Tensor:
    """``K @ V`` as a sum of partial products added in place: over slices
    of PRODUCT_ROWS rows of a symmetric K (``K[j:j+c].T @ V[j:j+c]``),
    else over slices of PRODUCT_COLUMNS columns (``K[:, j:j+c] @
    V[j:j+c]``)."""
    if symmetric:
        c = PRODUCT_ROWS
        if V.ndim == 1:
            out = K[:c].T @ V[:c]
            for j in range(c, K.shape[0], c):
                out.addmv_(K[j:j + c].T, V[j:j + c])
            return out
        out = V[:c].T @ K[:c]  # (C, m)
        for j in range(c, K.shape[0], c):
            out.addmm_(V[j:j + c].T, K[j:j + c])
        return out.T.contiguous()
    c = PRODUCT_COLUMNS
    out = K[:, :c] @ V[:c]
    add = out.addmm_ if V.ndim == 2 else out.addmv_
    for j in range(c, K.shape[1], c):
        add(K[:, j:j + c], V[j:j + c])
    return out


def _explicit_matvec(K: torch.Tensor) -> Callable:
    """The cores' ``kernel_mv`` / ``kernel_mm`` on the stored K."""
    def kv(X, sq_norms, v, gamma, coef0):
        return explicit_product(K, v, X.dtype, symmetric=True)

    return kv


def solve_ls_svm_explicit(
    K: torch.Tensor,
    X: torch.Tensor,
    x_last: torch.Tensor,
    y: torch.Tensor,
    y_last: float,
    gamma: float,
    coef0: float,
    cost: float,
    eps: float,
    max_iter: int,
    *,
    kind: KernelFunctionType,
    degree: int,
    impl: Optional[str] = None,
    scalars: str = "plain",
    gram_precision: str = "f32",
    **extras,
) -> CGResult:
    """The binary LS-SVM CG solve against the prebuilt ``K`` (dept, dept).

    The arguments after ``K`` are :func:`solver.cg.solve_ls_svm`'s (``impl``
    and ``gram_precision`` are the build's, so the solve takes and ignores
    them); ``extras`` are the core's warm start, weights, Jacobi, resume
    (``init_state``, plssvm_tpu's ``solve_ls_svm_explicit_resume``) and
    ``debug``.
    """
    check_precision(gram_precision)
    dot, vsum = _scalar_reductions(scalars)
    return cg_ls_svm_core(
        X, x_last, y, y_last, gamma, coef0, cost, eps, max_iter,
        kind=kind, degree=degree, kernel_mv=_explicit_matvec(K),
        dot=dot, vsum=vsum, **extras,
    )


def solve_ls_svm_explicit_multi(
    K: torch.Tensor,
    X: torch.Tensor,
    x_last: torch.Tensor,
    Y: torch.Tensor,
    y_last: torch.Tensor,
    gamma: float,
    coef0: float,
    cost: float,
    eps: float,
    max_iter: int,
    *,
    kind: KernelFunctionType,
    degree: int,
    impl: Optional[str] = None,
    scalars: str = "plain",
    gram_precision: str = "f32",
    **extras,
) -> MultiCGResult:
    """The one-vs-all block CG against the prebuilt ``K``: K is read once
    per iteration for all C right-hand sides.  Arguments as in
    :func:`solver.cg.solve_ls_svm_multi`; resume through ``init_state``
    (plssvm_tpu's ``solve_ls_svm_explicit_multi_resume``)."""
    check_precision(gram_precision)
    if scalars == "compensated":
        colsum = compensated_sum
    else:
        def colsum(M):
            return torch.sum(M, dim=0)
    return cg_ls_svm_multi_core(
        X, x_last, Y, y_last, gamma, coef0, cost, eps, max_iter,
        kind=kind, degree=degree, kernel_mm=_explicit_matvec(K),
        colsum=colsum, **extras,
    )
