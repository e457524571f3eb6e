"""Plain PyTorch Gram matvecs — the oracles of the CUDA kernels.

Counterpart of plssvm_tpu/ops/matvec.py.  The CG solver applies the implicit
matrix

    A_hat @ v = K @ v + (QA_cost - q) * sum(v) - (q . v) * 1 + (1/C) * v

(reference: src/plssvm/backends/CUDA/svm_kernel.cu:17-222,
gpu_csvm.hpp:431-447) and only ``K @ v`` touches O(n^2) work.  For the
linear kernel ``K @ v = X (X^T v)`` costs O(n d) and stays a matrix product,
as the JAX package left it to XLA.  For the other Gram kernels the functions
here walk row blocks: one (block, m) kernel block at a time, contracted
against ``v`` at once, so memory stays O(block * m).  ``v`` is (m,) or, for
the C right-hand sides of a one-vs-all fit, (m, C): each kernel block is
computed once and contracted with all C columns.

``kernel_matvec_plain`` is the oracle of kernel A and
``kernel_matvec_rect_plain`` of kernel B (ops/gram_matvec.py);
``kernel_matmat_plain`` of kernel C and ``kernel_matmat_rect_plain`` of
kernel D (ops/gram_matmat.py).  The laplacian and chi-squared kernels have
their own four (``distance_*_plain``, the oracles of kernels E-H in
ops/distance.py): the same row-blocked walk over the full square through
``kernel_block``'s distance branch, with no squared norms.
``banded_matvec_plain`` is kernel I's (ops/banded.py): the laplacian product
split on 128-row bands.  The four ``*_dual_plain`` versions are the oracles
of kernels J-M (csrc/dual.cu), the row-sharded ring's off-diagonal blocks:
``(K(Xr, Xc) @ v_c, K(Xr, Xc)^T @ v_r)`` from one row-blocked walk, at the
tier as the Gram versions.  Each counts its calls in a plain module-level int, so a run can show that its main path
took the kernels and not these.  Rows need no padding: the blocks follow
the tensor's own length.

The four Gram versions take the Gram precision tier (``precision``) of the
reference's ``kernel_matvec_pallas_dual`` / ``_rect`` /
``kernel_matmat_pallas_dual`` on float32 operands: "f32" and "highest"
compute in full float32, as the JAX package does on the CPU, where its
default dot is full f32; "bf16" computes on ``X.to(torch.bfloat16).float()``
with the caller's squared norms of the float32 X (``pallas_matvec.py:464``,
``:500-503``): bf16 products are exact in float32, so only the operands'
rounding differs.  float64 operands compute in float64 at every tier.
:func:`round_to_tf32` gives the operand of the tensor-core tile's "f32"
tier (TF32), the card tests' exact oracle of it; :func:`split_tf32` the
"highest" tier's split operand on the same tiles, and
:func:`split_kernel_product` that tier's oracle (the Gram part summed as
the tiles' three TF32 passes sum it).
"""

from __future__ import annotations

import torch

from ..kernel_functions import apply_kernel_to_gram, kernel_block
from ..parameter import KernelFunctionType

#: row-block height: a (2048, m) block is 256 MB in f32 at m = 32768
DEFAULT_ROW_BLOCK = 2048
#: row-block height of the distance versions: their broadcast temporaries
#: are (rows, 256, 256), 64 MB in f32 at 256 rows
DISTANCE_ROW_BLOCK = 256

#: calls of kernel_matvec_plain / kernel_matvec_rect_plain
sym_plain_calls = 0
rect_plain_calls = 0
#: calls of kernel_matmat_plain / kernel_matmat_rect_plain
sym_matmat_plain_calls = 0
rect_matmat_plain_calls = 0
#: calls of distance_matvec_plain / distance_matvec_rect_plain /
#: distance_matmat_plain / distance_matmat_rect_plain
dist_sym_plain_calls = 0
dist_rect_plain_calls = 0
dist_sym_matmat_plain_calls = 0
dist_rect_matmat_plain_calls = 0
#: calls of banded_matvec_plain
banded_plain_calls = 0
#: calls of kernel_matvec_dual_plain / kernel_matmat_dual_plain /
#: distance_matvec_dual_plain / distance_matmat_dual_plain
dual_plain_calls = 0
dual_matmat_plain_calls = 0
dist_dual_plain_calls = 0
dist_dual_matmat_plain_calls = 0
#: rows of a band of banded_matvec_plain's split
BAND = 128


#: the Gram precision tiers, as ``gram_precision`` names them
PRECISIONS = ("f32", "bf16", "highest")


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be 'f32', 'bf16' or 'highest', not {precision!r}"
        )


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero on the 13 dropped bits, as ``cvt.rna.tf32.f32``: a value
    past the largest TF32 one becomes inf; inf, nan, signed zeros and the
    subnormals' rounding follow from the bit pattern (nan stays nan)."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_to_tf32 takes float32, not {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x.contiguous(), rounded)


def split_tf32(x: torch.Tensor):
    """float32 ``x`` split into two TF32 parts, ``(hi, lo)``: ``hi =
    round_to_tf32(x)``, ``lo = round_to_tf32(x - hi)`` (``x - hi`` is exact
    in float32), so ``x - hi - lo`` is at most 2^-22 |x| (the subnormal
    spacing 2^-137 below |x| = 2^-115).  Where ``hi`` is not finite (x is
    inf or nan, or rounds past the largest TF32 value) ``hi`` carries it
    and ``lo`` is 0; signed zeros keep their sign in ``hi``.  The operand
    of the "highest" tier on the tensor-core tiles, which sum ``hi hi^T +
    hi lo^T + lo hi^T``."""
    hi = round_to_tf32(x)
    lo = round_to_tf32(torch.where(torch.isfinite(hi), x - hi, 0.0))
    return hi, lo


def split_gram(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``X Y^T`` as the "highest" tier's tensor-core tiles compute it from
    :func:`split_tf32`'s parts: ``hi_x hi_y^T``, then ``hi_x lo_y^T``, then
    ``lo_x hi_y^T``, each a float32 product added in that order; ``lo_x
    lo_y^T`` is dropped."""
    hx, lx = split_tf32(X)
    hy, ly = (hx, lx) if Y is X else split_tf32(Y)
    return hx @ hy.T + hx @ ly.T + lx @ hy.T


def split_kernel_product(
    P: torch.Tensor,
    S: torch.Tensor,
    sq_p: torch.Tensor,
    sq_s: torch.Tensor,
    A: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
    row_block: int = DEFAULT_ROW_BLOCK,
) -> torch.Tensor:
    """``K(P, S) @ A`` for float32 P (n_p, d), S (n_s, d) and A (n_s,) or
    (n_s, C), with the Gram part from :func:`split_gram` and the squared
    norms of the float32 operands: the "highest" tier's oracle on the
    tensor-core tiles (P = S for kernels A and C)."""
    out = torch.empty((P.shape[0],) + A.shape[1:], dtype=A.dtype, device=A.device)
    for i in range(0, P.shape[0], row_block):
        rows = slice(i, i + row_block)
        gram = split_gram(P[rows], S)
        out[rows] = apply_kernel_to_gram(
            gram, sq_p[rows, None], sq_s[None, :], kind, gamma, coef0, degree) @ A
    return out


def _at_tier(X: torch.Tensor, precision: str) -> torch.Tensor:
    """The operand the tier computes on: bf16-rounded float32 X for "bf16",
    else X itself."""
    check_precision(precision)
    if precision == "bf16" and X.dtype == torch.float32:
        return X.to(torch.bfloat16).to(torch.float32)
    return X


def linear_kernel_matvec(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(X X^T) @ v computed as X @ (X^T @ v): O(n d) instead of O(n^2 d)."""
    return X @ (X.T @ v)


def kernel_matvec_plain(
    X: torch.Tensor,
    sq_norms: torch.Tensor,
    v: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
    row_block: int = DEFAULT_ROW_BLOCK,
    precision: str = "f32",
) -> torch.Tensor:
    """``K @ v`` with ``K[i, j] = k(x_i, x_j)`` over the rows of ``X`` (m, d);
    ``v`` (m,) or (m, C)."""
    global sym_plain_calls
    sym_plain_calls += 1
    X = _at_tier(X, precision)
    return _row_blocked(
        X, X, sq_norms, sq_norms, v, kind, gamma, coef0, degree, row_block
    )


def kernel_matvec_rect_plain(
    P: torch.Tensor,
    S: torch.Tensor,
    sq_p: torch.Tensor,
    sq_s: torch.Tensor,
    a: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
    row_block: int = DEFAULT_ROW_BLOCK,
    precision: str = "f32",
) -> torch.Tensor:
    """``K(P, S) @ a`` with ``K[i, j] = k(p_i, s_j)``: points P (n_p, d)
    against support vectors S (n_s, d) weighted by ``a`` (n_s,)."""
    global rect_plain_calls
    rect_plain_calls += 1
    P, S = _at_tier(P, precision), _at_tier(S, precision)
    return _row_blocked(P, S, sq_p, sq_s, a, kind, gamma, coef0, degree, row_block)


def kernel_matmat_plain(
    X: torch.Tensor,
    sq_norms: torch.Tensor,
    V: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
    row_block: int = DEFAULT_ROW_BLOCK,
    precision: str = "f32",
) -> torch.Tensor:
    """``K @ V`` over the rows of ``X`` (m, d) for ``V`` (m, C)."""
    global sym_matmat_plain_calls
    sym_matmat_plain_calls += 1
    X = _at_tier(X, precision)
    return _row_blocked(
        X, X, sq_norms, sq_norms, V, kind, gamma, coef0, degree, row_block
    )


def kernel_matmat_rect_plain(
    P: torch.Tensor,
    S: torch.Tensor,
    sq_p: torch.Tensor,
    sq_s: torch.Tensor,
    A: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
    row_block: int = DEFAULT_ROW_BLOCK,
    precision: str = "f32",
) -> torch.Tensor:
    """``K(P, S) @ A``: points P (n_p, d) against support vectors S (n_s, d)
    weighted by ``A`` (n_s, C), one column per class or machine."""
    global rect_matmat_plain_calls
    rect_matmat_plain_calls += 1
    P, S = _at_tier(P, precision), _at_tier(S, precision)
    return _row_blocked(P, S, sq_p, sq_s, A, kind, gamma, coef0, degree, row_block)


def distance_matvec_plain(
    X: torch.Tensor,
    v: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    row_block: int = DISTANCE_ROW_BLOCK,
) -> torch.Tensor:
    """``K @ v`` for a laplacian / chi-squared kernel over the rows of ``X``
    (m, d); ``v`` (m,)."""
    global dist_sym_plain_calls
    dist_sym_plain_calls += 1
    return _distance_row_blocked(X, X, v, kind, gamma, row_block)


def distance_matvec_rect_plain(
    P: torch.Tensor,
    S: torch.Tensor,
    a: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    row_block: int = DISTANCE_ROW_BLOCK,
) -> torch.Tensor:
    """``K(P, S) @ a`` for a distance kernel: points P (n_p, d) against
    support vectors S (n_s, d) weighted by ``a`` (n_s,)."""
    global dist_rect_plain_calls
    dist_rect_plain_calls += 1
    return _distance_row_blocked(P, S, a, kind, gamma, row_block)


def distance_matmat_plain(
    X: torch.Tensor,
    V: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    row_block: int = DISTANCE_ROW_BLOCK,
) -> torch.Tensor:
    """``K @ V`` for a distance kernel over the rows of ``X`` (m, d), for
    ``V`` (m, C)."""
    global dist_sym_matmat_plain_calls
    dist_sym_matmat_plain_calls += 1
    return _distance_row_blocked(X, X, V, kind, gamma, row_block)


def distance_matmat_rect_plain(
    P: torch.Tensor,
    S: torch.Tensor,
    A: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    row_block: int = DISTANCE_ROW_BLOCK,
) -> torch.Tensor:
    """``K(P, S) @ A`` for a distance kernel, ``A`` (n_s, C)."""
    global dist_rect_matmat_plain_calls
    dist_rect_matmat_plain_calls += 1
    return _distance_row_blocked(P, S, A, kind, gamma, row_block)


def kernel_matvec_dual_plain(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    sq_r: torch.Tensor,
    sq_c: torch.Tensor,
    v_c: torch.Tensor,
    v_r: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
    row_block: int = DEFAULT_ROW_BLOCK,
    precision: str = "f32",
):
    """``(K @ v_c, K.T @ v_r)`` with ``K = K(Xr, Xc)``: rows Xr (mr, d)
    against columns Xc (mc, d), ``v_c`` (mc,), ``v_r`` (mr,); the argument
    order of ``kernel_matvec_pallas_dual``."""
    global dual_plain_calls
    dual_plain_calls += 1
    Xr, Xc = _at_tier(Xr, precision), _at_tier(Xc, precision)
    return _row_blocked_dual(Xr, Xc, sq_r, sq_c, v_c, v_r, kind, gamma,
                             coef0, degree, row_block)


def kernel_matmat_dual_plain(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    sq_r: torch.Tensor,
    sq_c: torch.Tensor,
    V_c: torch.Tensor,
    V_r: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
    row_block: int = DEFAULT_ROW_BLOCK,
    precision: str = "f32",
):
    """``(K @ V_c, K.T @ V_r)`` with ``K = K(Xr, Xc)`` for ``V_c`` (mc, C)
    and ``V_r`` (mr, C)."""
    global dual_matmat_plain_calls
    dual_matmat_plain_calls += 1
    Xr, Xc = _at_tier(Xr, precision), _at_tier(Xc, precision)
    return _row_blocked_dual(Xr, Xc, sq_r, sq_c, V_c, V_r, kind, gamma,
                             coef0, degree, row_block)


def distance_matvec_dual_plain(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    v_c: torch.Tensor,
    v_r: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    row_block: int = DISTANCE_ROW_BLOCK,
):
    """``(K @ v_c, K.T @ v_r)`` for a laplacian / chi-squared kernel, ``K =
    K(Xr, Xc)``."""
    global dist_dual_plain_calls
    dist_dual_plain_calls += 1
    return _row_blocked_dual(Xr, Xc, None, None, v_c, v_r, kind, gamma, 0.0,
                             0, row_block)


def distance_matmat_dual_plain(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    V_c: torch.Tensor,
    V_r: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    row_block: int = DISTANCE_ROW_BLOCK,
):
    """``(K @ V_c, K.T @ V_r)`` for a distance kernel, ``V_c`` (mc, C),
    ``V_r`` (mr, C)."""
    global dist_dual_matmat_plain_calls
    dist_dual_matmat_plain_calls += 1
    return _row_blocked_dual(Xr, Xc, None, None, V_c, V_r, kind, gamma, 0.0,
                             0, row_block)


def fixed_sum_plain(slots: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out + (slots[0] + slots[1] + ... + slots[-1])`` for ``slots`` (S,
    ...) of ``out``'s shape, the slots added one after another from 0: the
    order of csrc/fixed_sum.cuh's reduction, so its bits."""
    total = torch.zeros_like(out)
    for part in slots:
        total += part
    return out + total


def banded_matvec_plain(
    XT: torch.Tensor,
    v: torch.Tensor,
    gamma,
    *,
    symmetric: bool = True,
    row_block: int = DISTANCE_ROW_BLOCK,
):
    """``(out_r, out_c)`` of the laplacian kernel over the columns of ``XT``
    (d, m) against ``v`` (m,), split on ``BAND``-row bands.  With ``b(i) =
    i // BAND``: when ``symmetric``, ``out_r[i]`` sums ``k(i, j) v[j]`` over
    ``b(j) >= b(i)`` and ``out_c[j]`` sums ``k(i, j) v[i]`` over ``b(i) <
    b(j)``; else ``out_r = K @ v`` and ``out_c = K.T @ v``."""
    global banded_plain_calls
    banded_plain_calls += 1
    X = XT.T.contiguous()
    m = X.shape[0]
    out_r = torch.empty((m,), dtype=v.dtype, device=v.device)
    out_c = torch.zeros((m,), dtype=v.dtype, device=v.device)
    band = torch.arange(m, device=v.device) // BAND
    for i in range(0, m, row_block):
        rows = slice(i, i + row_block)
        # when symmetric, only the columns from the block's first band on
        c0 = (i // BAND) * BAND if symmetric else 0
        K_blk = kernel_block(
            X[rows], X[c0:], None, None, KernelFunctionType.LAPLACIAN,
            gamma, 0.0, 0,
        )
        if symmetric:
            b_row, b_col = band[rows, None], band[None, c0:]
            out_r[rows] = (K_blk * (b_col >= b_row)) @ v[c0:]
            out_c[c0:] += (K_blk * (b_row < b_col)).T @ v[rows]
        else:
            out_r[rows] = K_blk @ v
            out_c += K_blk.T @ v[rows]
    return out_r, out_c


def _distance_row_blocked(X, Y, v, kind, gamma, row_block):
    return _row_blocked(X, Y, None, None, v, kind, gamma, 0.0, 0, row_block)


def _row_blocked(X, Y, sq_x, sq_y, v, kind, gamma, coef0, degree, row_block):
    out = torch.empty((X.shape[0],) + v.shape[1:], dtype=v.dtype, device=v.device)
    for i in range(0, X.shape[0], row_block):
        K_blk = kernel_block(
            X[i:i + row_block], Y,
            None if sq_x is None else sq_x[i:i + row_block], sq_y,
            kind, gamma, coef0, degree,
        )
        out[i:i + row_block] = K_blk @ v
    return out


def _row_blocked_dual(X, Y, sq_x, sq_y, v_y, v_x, kind, gamma, coef0, degree,
                      row_block):
    """(K(X, Y) @ v_y, K(X, Y).T @ v_x), one (block, mc) kernel block at a
    time contracted both ways."""
    out_r = torch.empty((X.shape[0],) + v_y.shape[1:], dtype=v_y.dtype,
                        device=v_y.device)
    out_c = torch.zeros((Y.shape[0],) + v_x.shape[1:], dtype=v_x.dtype,
                        device=v_x.device)
    for i in range(0, X.shape[0], row_block):
        K_blk = kernel_block(
            X[i:i + row_block], Y,
            None if sq_x is None else sq_x[i:i + row_block], sq_y,
            kind, gamma, coef0, degree,
        )
        out_r[i:i + row_block] = K_blk @ v_y
        out_c += K_blk.T @ v_x[i:i + row_block]
    return out_r, out_c
