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
  receiving shard's device, a no-op when the shards share one.
- **The linear kernel** takes the factored ``X_p (sum_q X_q^T v_q)``
  (:func:`linear_sharded_matvec`), as the JAX package left it to XLA.
- **The solvers** (:func:`solve_ls_svm_sharded`,
  :func:`solve_ls_svm_multi_sharded`) run the port's own CG cores
  (solver/cg.py) with the ring as their ``kernel_mv`` / ``kernel_mm`` and
  scalar reductions that take a partial per shard (compensated where the
  solve is) and sum the partials in shard order: the reference's
  ``psum(compensated_dot(a_p, b_p))``.  The CG vectors (O(n)) live whole on
  the first device.  The cores take the whole X there too: they compute
  ``q`` and the squared norms from it once per solve; the ring's kernels
  read only the row shards.
- **Predict** (:func:`predict_values_sharded`): the support vectors are
  sharded, the points replicated; each shard scores all points against its
  SV slice (B / D or F / H) and the partial decision values are summed in
  shard order.

The shards are P row ranges as equal as possible (:func:`shard_bounds`),
with no padding and no mask: the kernels mask their own edges.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..kernel_functions import DISTANCE_KERNELS
from ..ops import distance as _distance
from ..ops import gram_matmat as _gram_matmat
from ..ops import gram_matvec as _gram_matvec
from ..ops import matvec as _plain
from ..ops.predict import predict_values
from ..parameter import KernelFunctionType
from ..solver.cg import (
    CGResult,
    MultiCGResult,
    cg_ls_svm_core,
    cg_ls_svm_multi_core,
    compensated_sum,
)


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
    (K v_c, K^T v_r)``; ``rows(Xr, Xc, sq_r, sq_c, v_c) = K v_c`` for ``K =
    K(Xr, Xc)``.  ``impl="cuda"`` the kernels (their plain versions on CPU
    tensors) at the tier, ``"torch"`` the plain versions at full precision;
    distance kernels ignore the norms."""
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
            lambda X, sq, v: own_fn(X, v, **kw),
            lambda Xr, Xc, sq_r, sq_c, v_c, v_r: dual_fn(Xr, Xc, v_c, v_r, **kw),
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
    return (
        lambda X, sq, v: own_fn(X, sq, v, **kw),
        lambda *args: dual_fn(*args, **kw),
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
) -> List[torch.Tensor]:
    """Every shard's rows of ``K @ v``: ``out_p = sum_q K(X_p, X_q) @ v_q``
    through the symmetric ring, each on its shard's device.

    ``X_shards`` (m_p, d), ``sq_shards`` (m_p,) their squared row norms
    (None for a distance kernel, which reads none), ``v_shards`` (m_p,) or,
    for the one-vs-all block CG, (m_p, C).  ``impl="cuda"`` takes kernels
    A, J and B (C, K and D for (m_p, C); E, L and F or G, M and H for a
    distance kernel) at the Gram tier ``precision``; ``"torch"`` the plain
    versions.
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

    def cross_dual(p, q):
        Xc, sq_c, v_c = received(q, p)
        return dual(X_shards[p], Xc, sq_shards[p], sq_c, v_c, v_shards[p])

    def cross_rows(p, q):
        Xc, sq_c, v_c = received(q, p)
        return rows(X_shards[p], Xc, sq_shards[p], sq_c, v_c)

    return _symmetric_ring(
        lambda p: own(X_shards[p], sq_shards[p], v_shards[p]),
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


def _sharded_product(X, bounds, devices, kind, degree, impl, precision) -> Callable:
    """The cores' ``kernel_mv`` / ``kernel_mm`` over the row shards of X:
    the right-hand side, whole on X's device, is split into its shards, the
    ring (or the factored linear product) runs, and the shards' rows come
    back whole.  X is placed once, the shards' squared norms computed
    once."""
    X_shards = shard_rows(X, bounds, devices)
    sq_shards = (None if kind in DISTANCE_KERNELS or kind == KernelFunctionType.LINEAR
                 else [torch.sum(Xs * Xs, dim=-1) for Xs in X_shards])

    def product(_X, _sq_norms, v, gamma, coef0):
        v_shards = shard_rows(v, bounds, devices)
        if kind == KernelFunctionType.LINEAR:
            outs = linear_sharded_matvec(X_shards, v_shards)
        else:
            outs = ring_kernel_matvec(X_shards, sq_shards, v_shards, gamma, coef0,
                                      kind=kind, degree=degree, impl=impl,
                                      precision=precision)
        return torch.cat([out.to(v.device) for out in outs])

    return product


def _in_shard_order(reduce: Callable, bounds) -> Callable:
    """A column-wise ``reduce`` ((rows, k) -> (k,)) taken over every row
    range of ``bounds`` and the partials summed in shard order: the
    reference's ``psum`` of per-shard partials.  The shards are laid side
    by side as the columns of one zero-padded block, so one fold serves
    them all (a compensated fold costs ~10 launches per halving step, and
    one per shard would cost P times as many; a zero adds nothing)."""
    height = max(hi - lo for lo, hi in bounds)

    def sharded(t):
        block = t.new_zeros((height, len(bounds)) + t.shape[1:])
        for p, (lo, hi) in enumerate(bounds):
            block[:hi - lo, p] = t[lo:hi]
        partials = reduce(block.reshape(height, -1)).reshape((len(bounds),) + t.shape[1:])
        total = partials[0]
        for part in partials[1:]:
            total = total + part
        return total

    return sharded


def _sharded_reductions(bounds, scalars: str):
    """(dot, vsum, colsum) of the sharded solves: per-shard partials,
    compensated with ``scalars="compensated"``, summed in shard order."""
    fold = (compensated_sum if scalars == "compensated"
            else lambda M: torch.sum(M, dim=0))
    total = _in_shard_order(fold, bounds)
    return (lambda a, b: total(a * b)), total, total


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
) -> CGResult:
    """The binary LS-SVM CG solve with X row-sharded over ``devices`` (one
    shard per entry); the counterpart of ``build_sharded_solver``.

    ``X`` (dept, d) and the CG vectors lie on the first device (a system
    with fewer rows than devices takes one shard per row); the ring
    (or the factored linear product) applies K, and every CG scalar is a
    sum of per-shard partials in shard order.  ``scalars`` and
    ``gram_precision`` as in ``solver.cg.solve_ls_svm``.
    """
    _plain.check_precision(gram_precision)
    devices = list(devices)[:X.shape[0]]
    bounds = shard_bounds(X.shape[0], len(devices))
    dot, vsum, _ = _sharded_reductions(bounds, scalars)
    return cg_ls_svm_core(
        X, x_last, y, y_last, gamma, coef0, cost, eps, max_iter,
        kind=kind, degree=degree,
        kernel_mv=_sharded_product(X, bounds, devices, kind, degree, impl,
                                   gram_precision),
        dot=dot, vsum=vsum,
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
) -> MultiCGResult:
    """The one-vs-all block-CG solve with X row-sharded over ``devices``;
    the counterpart of ``build_sharded_multi_solver``.  The per-class
    column sums are per-shard partials (compensated with ``scalars=
    "compensated"``) summed in shard order."""
    _plain.check_precision(gram_precision)
    devices = list(devices)[:X.shape[0]]
    bounds = shard_bounds(X.shape[0], len(devices))
    _, _, colsum = _sharded_reductions(bounds, scalars)
    return cg_ls_svm_multi_core(
        X, x_last, Y, y_last, gamma, coef0, cost, eps, max_iter,
        kind=kind, degree=degree,
        kernel_mm=_sharded_product(X, bounds, devices, kind, degree, impl,
                                   gram_precision),
        colsum=colsum,
    )


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
