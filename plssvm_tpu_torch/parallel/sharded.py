"""Row-sharded LS-SVM training and SV-sharded predict over a list of devices.

Counterpart of plssvm_tpu/parallel/sharded.py, its single-process half: the
JAX package runs the solve under ``shard_map`` over a mesh of local devices;
here one process drives P shards, each a contiguous row range of the
``dept`` rows placed on a device of the list.  Entries may repeat: P shards
on one ``cpu`` in the tests, P shards on one ``cuda:0`` on a one-card
machine, one shard per card on a machine with several.

- **The symmetric ring** (:func:`ring_kernel_matvec`,
  :func:`ring_kernel_matmat`): ``K(X_p, X_q) = K(X_q, X_p)^T``, so each
  off-diagonal block pair is computed once, both contractions taken from one
  walk of the block (kernels J-M, ``*_dual``), the transposed one sent back
  to its owner shard.  Per shard: the diagonal block through the symmetric
  kernel (A / C / E / G), ``floor((P - 1) / 2)`` dual steps, and for even P
  one rows-only step (B / D / F / H) for the antipodal pair.  The
  reference's ``ppermute`` rotation of ``(X_q, sq_q, v_q)`` is a copy to the
  receiving shard's device, a no-op when the shards share one.  Where the
  shards take a tensor-core tile (float32 CUDA Gram products), each shard's
  operand copy (``tier_operand``: TF32, bf16 or the split stack) is made
  once per solve and handed to its symmetric product and to the dual walks
  it takes part in, as the one-device solve hands its copy to A and C.
- **The linear kernel** takes the factored ``X_p (sum_q X_q^T v_q)``
  (:func:`linear_sharded_matvec`), as the JAX package left it to XLA.
- **The solvers** (:func:`solve_ls_svm_sharded`,
  :func:`solve_ls_svm_multi_sharded`) run the port's own CG cores
  (solver/cg.py) with the ring as their ``kernel_mv`` / ``kernel_mm`` and
  scalar reductions that take a partial per shard over its rows
  zero-padded to the shards' common height (:func:`shard_partial`,
  compensated where the solve is) and sum the partials in shard order: the
  reference's ``psum(compensated_dot(a_p, b_p))``.  The CG vectors (O(n))
  live whole on the first device.  The cores take the whole X there too:
  they compute ``q`` (one shard at a time, :func:`per_shard_point_kernel`)
  and the squared norms once per solve; the ring's kernels read only the
  row shards.  A multi-process job (parallel/multihost.py) runs the same
  ring with one shard a process, and with the same shards, steps and
  summation trees computes the same bits on the CPU.
- **The explicit solver** (:func:`build_sharded_kernel_matrix`, the
  ``kernel_matrix`` argument of the solvers): each shard's device holds its
  row block ``K_p = k(X_p, X)``, built once one column block ``k(X_p,
  X_q)`` at a time (kernel N's rectangular walk for the distance kernels,
  the matrix product and the epilogue for the Gram kernels,
  solver/explicit.py), and a product copies v (or V) to every
  shard's device and returns the ``K_p @ v`` in shard order: the
  reference's ``build_sharded_kernel_matrix_fn`` and
  ``build_sharded_explicit_solver``, whose ``all_gather`` of v is that copy.
- **Predict** (:func:`predict_values_sharded`): the support vectors are
  sharded, the points replicated; each shard scores all points against its
  SV slice (B / D or F / H) and the partial decision values are summed in
  shard order.

- **One-class** (:func:`ridge_sharded_operators`): the ridge solve's
  product and dots on the same ring and reductions (one_class.py runs the
  CG), the reference's ``build_sharded_one_class_solver``.
- **One-vs-one, batched** (:func:`solve_ls_svm_pairs_sharded`): the pair
  machines are independent systems, so the split is over machines, not
  rows: each device gathers and solves a contiguous group of them
  (``solve_ls_svm_pairs``, kernel O), with no collectives: the reference's
  ``build_sharded_pairs_solver`` on its machine mesh.

The shards are P row ranges as equal as possible (:func:`shard_bounds`),
with no padding and no mask: the kernels mask their own edges.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..kernel_functions import DISTANCE_KERNELS, kernel_against_point
from ..ops import distance as _distance
from ..ops import gram_matmat as _gram_matmat
from ..ops import gram_matvec as _gram_matvec
from ..ops import matvec as _plain
from ..ops.gram_matvec import tier_operand, uses_tensor_cores
from ..ops.predict import predict_values
from ..parameter import KernelFunctionType
from ..solver.cg import (
    CGResult,
    MultiCGResult,
    PairsCGResult,
    cg_ls_svm_core,
    cg_ls_svm_multi_core,
    compensated_sum,
    solve_ls_svm_pairs,
)
from ..solver.explicit import explicit_product, kernel_matrix_block


def shard_bounds(m: int, num_shards: int) -> List[Tuple[int, int]]:
    """``num_shards`` contiguous row ranges ``[lo, hi)`` covering ``[0, m)``,
    as equal as possible: the first ``m % num_shards`` are one row longer.
    Every shard holds at least one row."""
    if not 1 <= num_shards <= m:
        raise ValueError(f"cannot split {m} rows into {num_shards} non-empty shards")
    base, extra = divmod(m, num_shards)
    bounds, lo = [], 0
    for p in range(num_shards):
        hi = lo + base + (p < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def shard_rows(t: torch.Tensor, bounds, devices) -> List[torch.Tensor]:
    """The row ranges ``bounds`` of ``t`` on their devices: views where a
    shard's device is ``t``'s, copies elsewhere.  Counterpart of the
    reference's ``shard_arrays`` / ``shard_predict_arrays`` placement."""
    return [t[lo:hi].to(dev) for (lo, hi), dev in zip(bounds, devices)]


def _symmetric_ring(own, cross_dual, cross_rows, devices) -> List[torch.Tensor]:
    """The reference's ring skeleton over P shards.

    At step s shard p holds the chunk of q = p - s and contracts its rows
    against it both ways: ``K(X_p, X_q) @ v_q`` for its own rows and
    ``K(X_p, X_q)^T @ v_p`` for shard q's, which goes back to q.  So shard
    p adds, per step, its own row output and the transposed output of shard
    p + s, in the reference's order: ``acc = own; acc += r + back(c)``.  For
    even P the antipodal chunk (s = P/2) is contracted rows-only by both
    members of the pair.
    """
    num = len(devices)
    acc = [own(p) for p in range(num)]
    for s in range(1, (num - 1) // 2 + 1):
        duals = [cross_dual(p, (p - s) % num) for p in range(num)]
        for p in range(num):
            acc[p] = acc[p] + duals[p][0] + duals[(p + s) % num][1].to(devices[p])
    if num % 2 == 0:
        for p in range(num):
            acc[p] = acc[p] + cross_rows(p, (p - num // 2) % num)
    return acc


def _block_products(kind, degree, gamma, coef0, impl, precision, matmat):
    """``(own, dual, rows)`` of one shard's blocks, with uniform signatures:
    ``own(X, sq, v) = K(X, X) @ v``; ``dual(Xr, Xc, sq_r, sq_c, v_c, v_r) =
    (K v_c, K^T v_r)`` (both with an ``operand`` keyword, the tensor-core
    tiles' copies, which the distance kernels and plain versions ignore);
    ``rows(Xr, Xc, sq_r, sq_c, v_c) = K v_c`` for ``K = K(Xr, Xc)``.
    ``impl="cuda"`` the kernels (their plain versions on CPU tensors) at
    the tier, ``"torch"`` the plain versions at full precision; distance
    kernels ignore the norms."""
    cuda = impl == "cuda"
    if kind in DISTANCE_KERNELS:
        if matmat:
            fns = ((_distance.distance_matmat_sym, _distance.distance_matmat_dual,
                    _distance.distance_matmat_rect) if cuda else
                   (_plain.distance_matmat_plain, _plain.distance_matmat_dual_plain,
                    _plain.distance_matmat_rect_plain))
        else:
            fns = ((_distance.distance_matvec_sym, _distance.distance_matvec_dual,
                    _distance.distance_matvec_rect) if cuda else
                   (_plain.distance_matvec_plain, _plain.distance_matvec_dual_plain,
                    _plain.distance_matvec_rect_plain))
        own_fn, dual_fn, rows_fn = fns
        kw = dict(kind=kind, gamma=gamma)
        return (
            lambda X, sq, v, operand=None: own_fn(X, v, **kw),
            lambda Xr, Xc, sq_r, sq_c, v_c, v_r, operand=None: dual_fn(Xr, Xc, v_c, v_r,
                                                                       **kw),
            lambda Xr, Xc, sq_r, sq_c, v_c: rows_fn(Xr, Xc, v_c, **kw),
        )
    if matmat:
        fns = ((_gram_matmat.gram_matmat_sym, _gram_matmat.gram_matmat_dual,
                _gram_matmat.gram_matmat_rect) if cuda else
               (_plain.kernel_matmat_plain, _plain.kernel_matmat_dual_plain,
                _plain.kernel_matmat_rect_plain))
    else:
        fns = ((_gram_matvec.gram_matvec_sym, _gram_matvec.gram_matvec_dual,
                _gram_matvec.gram_matvec_rect) if cuda else
               (_plain.kernel_matvec_plain, _plain.kernel_matvec_dual_plain,
                _plain.kernel_matvec_rect_plain))
    own_fn, dual_fn, rows_fn = fns
    kw = dict(kind=kind, gamma=gamma, coef0=coef0, degree=degree,
              precision=precision if cuda else "f32")

    def given(operand):
        """The operand keyword, for the kernels' wrappers only."""
        return {} if operand is None else {"operand": operand}

    return (
        lambda X, sq, v, operand=None: own_fn(X, sq, v, **kw, **given(operand)),
        lambda *args, operand=None: dual_fn(*args, **kw, **given(operand)),
        lambda *args: rows_fn(*args, **kw),
    )


def ring_kernel_matvec(
    X_shards: Sequence[torch.Tensor],
    sq_shards: Optional[Sequence[torch.Tensor]],
    v_shards: Sequence[torch.Tensor],
    gamma,
    coef0,
    *,
    kind: KernelFunctionType,
    degree: int,
    impl: str = "cuda",
    precision: str = "f32",
    operands: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Every shard's rows of ``K @ v``: ``out_p = sum_q K(X_p, X_q) @ v_q``
    through the symmetric ring, each on its shard's device.

    ``X_shards`` (m_p, d), ``sq_shards`` (m_p,) their squared row norms
    (None for a distance kernel, which reads none), ``v_shards`` (m_p,) or,
    for the one-vs-all block CG, (m_p, C).  ``impl="cuda"`` takes kernels
    A, J and B (C, K and D for (m_p, C); E, L and F or G, M and H for a
    distance kernel) at the Gram tier ``precision``; ``"torch"`` the plain
    versions.  ``operands`` the shards' tensor-core operand copies
    (:func:`shard_operands`), handed to the symmetric products and the dual
    walks; None makes them per call where a tile takes them.
    """
    devices = [X.device for X in X_shards]
    if sq_shards is None:
        sq_shards = [None] * len(X_shards)
    own, dual, rows = _block_products(kind, degree, gamma, coef0, impl,
                                      precision, v_shards[0].ndim == 2)

    def received(q, p):
        """Shard q's (X, sq, v) as shard p receives them."""
        dev, sq = devices[p], sq_shards[q]
        return (X_shards[q].to(dev), None if sq is None else sq.to(dev),
                v_shards[q].to(dev))

    def operand(p, q=None):
        """Shard p's operand copy, or with q the pair of shard p's and of
        shard q's as shard p receives it."""
        if operands is None:
            return None
        return operands[p] if q is None else (operands[p], operands[q].to(devices[p]))

    def cross_dual(p, q):
        Xc, sq_c, v_c = received(q, p)
        return dual(X_shards[p], Xc, sq_shards[p], sq_c, v_c, v_shards[p],
                    operand=operand(p, q))

    def cross_rows(p, q):
        Xc, sq_c, v_c = received(q, p)
        return rows(X_shards[p], Xc, sq_shards[p], sq_c, v_c)

    return _symmetric_ring(
        lambda p: own(X_shards[p], sq_shards[p], v_shards[p], operand=operand(p)),
        cross_dual, cross_rows, devices,
    )


#: the reference's ring_kernel_matmat: the same ring on (m_p, C) blocks
ring_kernel_matmat = ring_kernel_matvec


def linear_sharded_matvec(
    X_shards: Sequence[torch.Tensor], v_shards: Sequence[torch.Tensor]
) -> List[torch.Tensor]:
    """Every shard's rows of ``(X X^T) @ v`` as ``X_p (sum_q X_q^T v_q)``:
    the d-length partials summed in shard order on the first shard's
    device, the sum sent to every shard."""
    home = X_shards[0].device
    xtv = None
    for X, v in zip(X_shards, v_shards):
        part = (X.T @ v).to(home)
        xtv = part if xtv is None else xtv + part
    return [X @ xtv.to(X.device) for X in X_shards]


def shard_operands(X_shards, kind, impl, precision) -> Optional[List[torch.Tensor]]:
    """Each shard's operand copy for the tensor-core tiles at the tier
    (``tier_operand``), where the ring's Gram products take them (float32
    CUDA shards, ``impl="cuda"``); else None."""
    if (impl != "cuda" or kind in DISTANCE_KERNELS or kind == KernelFunctionType.LINEAR
            or not uses_tensor_cores(X_shards[0], precision)):
        return None
    return [tier_operand(Xs, precision) for Xs in X_shards]


def _sharded_product(X, bounds, devices, kind, degree, impl, precision) -> Callable:
    """The cores' ``kernel_mv`` / ``kernel_mm`` over the row shards of X:
    the right-hand side, whole on X's device, is split into its shards, the
    ring (or the factored linear product) runs, and the shards' rows come
    back whole.  X is placed once, the shards' squared norms and their
    tensor-core operand copies (:func:`shard_operands`) made once: once per
    solve, not once per product."""
    X_shards = shard_rows(X, bounds, devices)
    sq_shards = (None if kind in DISTANCE_KERNELS or kind == KernelFunctionType.LINEAR
                 else [torch.sum(Xs * Xs, dim=-1) for Xs in X_shards])
    operands = shard_operands(X_shards, kind, impl, precision)

    def product(_X, _sq_norms, v, gamma, coef0):
        v_shards = shard_rows(v, bounds, devices)
        if kind == KernelFunctionType.LINEAR:
            outs = linear_sharded_matvec(X_shards, v_shards)
        else:
            outs = ring_kernel_matvec(X_shards, sq_shards, v_shards, gamma, coef0,
                                      kind=kind, degree=degree, impl=impl,
                                      precision=precision, operands=operands)
        return torch.cat([out.to(v.device) for out in outs])

    return product


def build_sharded_kernel_matrix(
    X: torch.Tensor,
    devices: Sequence,
    gamma: float,
    coef0: float,
    *,
    kind: KernelFunctionType,
    degree: int,
    precision: str = "f32",
    impl: str = "cuda",
) -> List[torch.Tensor]:
    """The row blocks ``K_p = k(X_p, X)`` of the explicit kernel matrix of
    ``X`` (dept, d), one per shard of :func:`shard_bounds` over ``devices``
    (a system with fewer rows than devices takes one shard per row), each
    on its shard's device, where X is placed whole once per device.  The
    counterpart of ``build_sharded_kernel_matrix_fn``.  Each K_p is built
    one column block ``k(X_p, X_q)`` per shard q, as a process of a
    multi-process solve builds its block while the shards come round the
    ring (:func:`fill_kernel_columns`)."""
    devices = list(devices)[:X.shape[0]]
    bounds = shard_bounds(X.shape[0], len(devices))
    whole: dict = {}
    blocks = []
    for (lo, hi), dev in zip(bounds, devices):
        Xd = whole.setdefault(dev, X.to(dev))
        K_p = None
        for q_lo, q_hi in bounds:
            K_p = fill_kernel_columns(K_p, Xd[lo:hi], Xd[q_lo:q_hi], (q_lo, q_hi),
                                      X.shape[0], gamma, coef0, kind=kind, degree=degree,
                                      precision=precision, impl=impl)
        blocks.append(K_p)
    return blocks


def fill_kernel_columns(K_p, X_p, X_q, columns, width, gamma, coef0, **kw) -> torch.Tensor:
    """``K_p[:, lo:hi] = k(X_p, X_q)`` for ``columns = (lo, hi)``, shard
    q's columns of the (m_p, ``width``) row block ``K_p``, made at the
    first call (None) in :func:`kernel_matrix_block`'s type; returns K_p.
    ``kw`` are that function's ``kind``, ``degree``, ``precision`` and
    ``impl``."""
    block = kernel_matrix_block(X_p, X_q, gamma, coef0, **kw)
    if K_p is None:
        K_p = block.new_empty((X_p.shape[0], width))
    K_p[:, columns[0]:columns[1]] = block
    return K_p


def _explicit_sharded_product(K_shards: Sequence[torch.Tensor]) -> Callable:
    """The cores' ``kernel_mv`` / ``kernel_mm`` on the row blocks of K: v
    (or V), whole on the first device, is copied to each block's device,
    and the blocks' products come back in shard order."""
    def product(X, _sq_norms, v, gamma, coef0):
        return torch.cat([explicit_product(K, v.to(K.device), X.dtype).to(v.device)
                          for K in K_shards])

    return product


def _kernel_product(X, bounds, devices, kind, degree, impl, precision,
                    kernel_matrix) -> Callable:
    """The ring's product, or with ``kernel_matrix`` (the row blocks of
    :func:`build_sharded_kernel_matrix` over the same devices) the explicit
    one."""
    if kernel_matrix is None:
        return _sharded_product(X, bounds, devices, kind, degree, impl, precision)
    if [k.shape[0] for k in kernel_matrix] != [hi - lo for lo, hi in bounds]:
        raise ValueError("kernel_matrix's row blocks do not match the shards of X")
    return _explicit_sharded_product(kernel_matrix)


def shard_partial(fold: Callable, rows: torch.Tensor, height: int) -> torch.Tensor:
    """One shard's partial of a column-wise ``fold`` ((h, k) -> (k,)):
    its ``rows`` (m_p,) or (m_p, C) zero-padded to the common ``height`` of
    the shards (a zero adds nothing), so every shard folds a column of one
    length, the summation tree of the sum over all shards' rows.  A process
    of a multi-process solve takes its partial so (parallel/multihost.py)."""
    block = rows.new_zeros((height,) + rows.shape[1:])
    block[:rows.shape[0]] = rows
    return fold(block.reshape(height, -1)).reshape(rows.shape[1:])


def sum_partials(partials) -> torch.Tensor:
    """The shards' partials summed in shard order: the reference's
    ``psum`` of per-shard partials."""
    total = partials[0]
    for part in partials[1:]:
        total = total + part
    return total


def _in_shard_order(reduce: Callable, bounds, elementwise: bool) -> Callable:
    """A column-wise ``reduce`` taken over every row range of ``bounds``
    (:func:`shard_partial`) and the partials summed in shard order.  An
    ``elementwise`` fold (the compensated one: its halving steps are
    elementwise, so a column's result never depends on the others) takes
    the shards side by side as the columns of one zero-padded block, one
    fold for them all (~10 launches per halving step; one fold per shard
    would cost P times as many); ``torch.sum`` orders a column's sum by the
    block's width, so it folds each shard's column alone, as each process
    of a multi-process solve does."""
    height = max(hi - lo for lo, hi in bounds)

    def sharded(t):
        if not elementwise:
            return sum_partials([shard_partial(reduce, t[lo:hi], height)
                                 for lo, hi in bounds])
        block = t.new_zeros((height, len(bounds)) + t.shape[1:])
        for p, (lo, hi) in enumerate(bounds):
            block[:hi - lo, p] = t[lo:hi]
        partials = reduce(block.reshape(height, -1)).reshape((len(bounds),) + t.shape[1:])
        return sum_partials(partials)

    return sharded


def scalar_fold(scalars: str) -> Callable:
    """The column-wise fold of the sharded solves' scalars: compensated
    with ``scalars="compensated"``, else ``torch.sum``."""
    return (compensated_sum if scalars == "compensated"
            else lambda M: torch.sum(M, dim=0))


def _sharded_reductions(bounds, scalars: str):
    """(dot, vsum, colsum) of the sharded solves: per-shard partials,
    compensated with ``scalars="compensated"``, summed in shard order."""
    total = _in_shard_order(scalar_fold(scalars), bounds, scalars == "compensated")
    return (lambda a, b: total(a * b)), total, total


def per_shard_point_kernel(bounds) -> Callable:
    """The cores' ``point_kernel``: q = k(X, x_last) one shard of
    ``bounds`` at a time, as each process of a multi-process solve computes
    its own (a matrix-vector product's rounding depends on its row
    count)."""
    def point_kernel(X, point, *args):
        return torch.cat([kernel_against_point(X[lo:hi], point, *args) for lo, hi in bounds])

    return point_kernel


def solve_ls_svm_sharded(
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
    devices: Sequence,
    kind: KernelFunctionType,
    degree: int,
    impl: str = "torch",
    scalars: str = "plain",
    gram_precision: str = "f32",
    kernel_matrix: Optional[Sequence[torch.Tensor]] = None,
    **extras,
) -> CGResult:
    """The binary LS-SVM CG solve with X row-sharded over ``devices`` (one
    shard per entry); the counterpart of ``build_sharded_solver``.

    ``X`` (dept, d) and the CG vectors lie on the first device (a system
    with fewer rows than devices takes one shard per row); the ring
    (or the factored linear product) applies K, and every CG scalar is a
    sum of per-shard partials in shard order.  ``scalars``,
    ``gram_precision`` and the ``extras`` (warm start, sample weights,
    Jacobi, resume, debug) as in ``solver.cg.solve_ls_svm``: the core runs
    them on the first device, where the CG state lies whole, so a
    checkpoint of the ring is saved from there (plssvm_tpu's
    ``shard_warm_start`` and its gather of the sharded state have nothing
    to do here).  ``kernel_matrix`` (the row blocks of
    :func:`build_sharded_kernel_matrix` over ``devices``) solves against the
    stored K instead of the ring: the explicit solver.
    """
    _plain.check_precision(gram_precision)
    devices = list(devices)[:X.shape[0]]
    bounds = shard_bounds(X.shape[0], len(devices))
    dot, vsum, _ = _sharded_reductions(bounds, scalars)
    return cg_ls_svm_core(
        X, x_last, y, y_last, gamma, coef0, cost, eps, max_iter,
        kind=kind, degree=degree,
        kernel_mv=_kernel_product(X, bounds, devices, kind, degree, impl,
                                  gram_precision, kernel_matrix),
        dot=dot, vsum=vsum, point_kernel=per_shard_point_kernel(bounds), **extras,
    )


def solve_ls_svm_multi_sharded(
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
    devices: Sequence,
    kind: KernelFunctionType,
    degree: int,
    impl: str = "torch",
    scalars: str = "plain",
    gram_precision: str = "f32",
    kernel_matrix: Optional[Sequence[torch.Tensor]] = None,
    **extras,
) -> MultiCGResult:
    """The one-vs-all block-CG solve with X row-sharded over ``devices``;
    the counterpart of ``build_sharded_multi_solver``.  The per-class
    column sums are per-shard partials (compensated with ``scalars=
    "compensated"``) summed in shard order; ``kernel_matrix`` and
    ``extras`` as in :func:`solve_ls_svm_sharded`."""
    _plain.check_precision(gram_precision)
    devices = list(devices)[:X.shape[0]]
    bounds = shard_bounds(X.shape[0], len(devices))
    _, _, colsum = _sharded_reductions(bounds, scalars)
    return cg_ls_svm_multi_core(
        X, x_last, Y, y_last, gamma, coef0, cost, eps, max_iter,
        kind=kind, degree=degree,
        kernel_mm=_kernel_product(X, bounds, devices, kind, degree, impl,
                                  gram_precision, kernel_matrix),
        colsum=colsum, point_kernel=per_shard_point_kernel(bounds), **extras,
    )


def ridge_sharded_operators(
    X: torch.Tensor,
    *,
    devices: Sequence,
    kind: KernelFunctionType,
    degree: int,
    impl: str = "torch",
    scalars: str = "plain",
    gram_precision: str = "f32",
    kernel_matrix: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Callable, Callable]:
    """``(kernel_mv, dot)`` of the one-class ridge solve with X (m, d)
    row-sharded over ``devices``: the counterpart of
    ``build_sharded_one_class_solver``'s ring product and psum'd dot.
    ``kernel_mv(X, sq_norms, v, gamma, coef0)`` is the ring (the factored
    product for the linear kernel, or with ``kernel_matrix`` the stored row
    blocks), ``dot`` a sum of per-shard partials in shard order,
    compensated with ``scalars="compensated"``.  The CG vectors stay whole
    on X's device, as in :func:`solve_ls_svm_sharded`."""
    _plain.check_precision(gram_precision)
    devices = list(devices)[:X.shape[0]]
    bounds = shard_bounds(X.shape[0], len(devices))
    dot, _, _ = _sharded_reductions(bounds, scalars)
    return (_kernel_product(X, bounds, devices, kind, degree, impl, gram_precision,
                            kernel_matrix), dot)


def predict_values_sharded(
    support_vectors: torch.Tensor,  # (n_sv, d)
    alpha: torch.Tensor,            # (n_sv,) or (n_sv, C)
    rho,                            # float, or (C,) tensor
    predict_points: torch.Tensor,   # (n_pred, d)
    gamma: float,
    coef0: float,
    *,
    devices: Sequence,
    kind: KernelFunctionType,
    degree: int,
    impl: str = "torch",
    precision: str = "f32",
) -> torch.Tensor:
    """Decision values with the support vectors sharded over ``devices`` and
    the points replicated; the counterpart of ``build_sharded_predict``.

    Each shard runs ``ops.predict.predict_values`` over its SV slice
    against all points (kernel B / D, or F / H, on ``impl="cuda"``); the
    partial values are summed in shard order on the points' device, then
    ``rho`` is subtracted.  Not for the linear kernel, whose ``w`` product
    needs no sharding.
    """
    home = predict_points.device
    devices = list(devices)[:support_vectors.shape[0]]
    bounds = shard_bounds(support_vectors.shape[0], len(devices))
    total = None
    for sv, a, dev in zip(shard_rows(support_vectors, bounds, devices),
                          shard_rows(alpha, bounds, devices), devices):
        part = predict_values(
            sv, a, 0.0, None, predict_points.to(dev), gamma, coef0,
            kind=kind, degree=degree, impl=impl, precision=precision,
        ).to(home)
        total = part if total is None else total + part
    return total - rho


def machine_groups(num_machines: int, num_devices: int) -> List[Tuple[int, int]]:
    """The contiguous machine ranges ``[lo, hi)`` of the machine-axis split:
    :func:`shard_bounds` over the machines, one group a device (fewer when
    there are fewer machines than devices).  The groups run one after
    another with no collectives, so unlike the reference's
    ``shard_pairs_arrays`` they need not be equal and no dummy machine pads
    them."""
    return shard_bounds(num_machines, min(num_devices, num_machines))


def solve_ls_svm_pairs_sharded(
    X_aug: torch.Tensor,       # (n + 1, d) the parent rows and a zero row
    idx_b: torch.Tensor,       # (P, m) each machine's parent rows (int64)
    last_idx: torch.Tensor,    # (P,) each machine's folded-out last row
    Yb: torch.Tensor,
    y_last_b: torch.Tensor,
    maskb: torch.Tensor,
    gamma: float,
    coef0: float,
    cost: float,
    eps: float,
    max_iter_b: torch.Tensor,
    *,
    devices: Sequence,
    x_init: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    weight_last: Optional[torch.Tensor] = None,
    **solve_kw,
) -> PairsCGResult:
    """The batched one-vs-one solve with the machine axis split over
    ``devices``: the counterpart of ``build_sharded_pairs_solver``.

    The P machines form up to ``len(devices)`` contiguous groups
    (:func:`machine_groups`).  Each group's rows are gathered
    on its device from the parent operand ``X_aug`` (copied once to each
    physical device) and solved there by ``solve_ls_svm_pairs`` on the
    group's machines alone, with no collectives; the groups run one after
    another.  The per-machine results come back to the first device in
    machine order, and ``iterations`` is the largest group's count (the
    reference's ``pmax``).  Each machine's arithmetic is what it is on one
    device, bit for bit: the groups share the stack's m, and each group's
    plain CG scalars reduce its block padded to the whole stack's (P, m)
    shape (``stack``).
    ``solve_kw`` are ``solve_ls_svm_pairs``' ``kind``, ``degree``,
    ``impl``, ``scalars``, ``gram_precision``, ``preconditioner`` and
    ``debug``; each group's solve makes its own operand copy for kernel O's
    tensor-core walks.
    """
    home = Yb.device
    whole: dict = {}
    results = []
    for (lo, hi), dev in zip(machine_groups(Yb.shape[0], len(devices)), devices):
        Xd = whole.setdefault(dev, X_aug.to(dev))

        def local(t):
            return None if t is None else t[lo:hi].to(dev)

        results.append(solve_ls_svm_pairs(
            Xd[idx_b[lo:hi].to(dev)], Xd[last_idx[lo:hi].to(dev)], local(Yb),
            local(y_last_b), local(maskb), gamma, coef0, cost, eps, local(max_iter_b),
            x_init=local(x_init), weights=local(weights), weight_last=local(weight_last),
            stack=(Yb.shape[0], lo), **solve_kw))

    def joined(field):
        return torch.cat([getattr(res, field).to(home) for res in results])

    return PairsCGResult(
        x=joined("x"), rho=joined("rho"), alpha_last=joined("alpha_last"),
        iterations=max(res.iterations for res in results),
        iterations_per_pair=joined("iterations_per_pair"), delta=joined("delta"),
        delta0=joined("delta0"),
    )
