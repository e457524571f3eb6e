"""Compact LS-SVM models: Suykens pruning and fixed-size (Nystroem) fits.

Counterpart of plssvm_tpu/sparse.py.  An exact LS-SVM keeps every training
point as a support vector, so its model is O(n) to store and O(n d) to
evaluate.  The two standard answers:

1. **Pruning** (:func:`pruned_fit`; Suykens, De Brabanter, Lukas &
   Vandewalle, Neurocomputing 48, 2002, section 4): |alpha_i| is
   proportional to the point's error, so the ``prune_rate`` share of points
   with the smallest weights goes and the machine is refit on the rest,
   warm-started from their alpha (``CSVM.fit(initial_model=)``), until at
   most ``n_sv`` remain.  Every fit and refit is an ordinary ``CSVM.fit``:
   kernel A / C at the CSVM's tier, or kernel N / the Gram build and
   ``K @ V`` under the explicit solver, or the ring with ``devices``.
2. **Fixed-size LS-SVM** (:func:`nystroem_fit`; Suykens et al., "Least
   Squares Support Vector Machines", 2002, ch. 6): m landmark rows Z give
   the feature map ``phi(x) = K_mm^{-1/2} k(Z, x)``, and the primal ridge
   system in that basis is reduced over row blocks into the bordered
   (m+1) x (m+1) normal equations, solved on the host in float64.  The
   result is an ordinary m-support-vector model (``alpha = K_mm^{-1/2}
   w``, ``rho = -b``), so predict (kernels B / D) and model files are the
   usual paths.

The kernel blocks K_mm and ``K(X_blk, Z)`` come from
``solver/explicit.py::kernel_matrix_block`` at the CSVM's ``gram_precision``:
kernel N for the distance kinds (its symmetric walk for K_mm, its rect walk
for every row block), ``torch.matmul`` and the kernel epilogue for the Gram
kinds, where plssvm_tpu computes both with ``kernel_block`` in XLA, outside
any Pallas kernel.  That call takes no precision; on the TPU it is one bf16
MXU pass, the reference's "f32" tier.  The port's "f32" is TF32 on float32
CUDA tensors, which is finer; "highest" is full float32, float64 float64.
The projections ``Phi = K_bm @ K_mm^{-1/2}``, ``A += Phi' S Phi``, ``c +=
Phi' S Y`` and ``u += Phi' S 1`` are ``torch.matmul`` calls in the data's
type with TF32 off, as ``explicit_product`` runs.

The reduction is a loop over row blocks of ``min(row_block, max(8,
ceil(n / n_dev)))`` rows, plssvm_tpu's block rule, on the CSVM's device;
with ``devices`` each shard reduces the rows that plssvm_tpu's row-sharded
reduction gives it, on its own device, and the (m, m), (m, C) and (m,)
partials are summed on the first device in shard order.  The port pads
nothing: the last block is shorter (plssvm_tpu's padding rows carry s = 0
and add nothing).  No (n, m) block lives on the device at once.

:func:`nystroem_fit_from_file` reads the training file in windows through
the native parser's selected-row reads, so the host holds O(row_block d +
m d + n).  :func:`nystroem_fit_multihost` reduces each process's window
of the file in a ``torch.distributed`` job, the partials summed in rank
order.

Each Nystroem fit records its phases in the tracker's "nystroem" entries
(:class:`_Timer`): ``basis_ms`` (K_mm and its float64 inverse square
root), ``reduce_ms`` (the row blocks, read back to the host, which waits
for the device), ``solve_ms`` (the host solve and, for one-class, the
threshold's scores), ``landmarks`` and ``row_blocks``.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .data_set import DataSet
from .exceptions import InvalidParameterError
from .model import Model
from .parameter import ClassificationType, KernelFunctionType
from .solver.explicit import _tf32, kernel_matrix_block
from .utils.tracker import add_tracking_entry


# ---------------------------------------------------------------------------
# Pruning (Suykens 2002 sparse approximation)
# ---------------------------------------------------------------------------


def _alpha_magnitude(alpha: np.ndarray) -> np.ndarray:
    """Per-point pruning score: |alpha| (binary) or row L2 norm (OAA)."""
    a = np.asarray(alpha, dtype=np.float64)
    if a.ndim == 1:
        return np.abs(a)
    return np.sqrt(np.sum(a * a, axis=1))


def _keep_with_class_floor(
    magnitude: np.ndarray, k: int, class_idx: Optional[np.ndarray]
) -> np.ndarray:
    """Indices of the k largest-magnitude points, each class kept non-empty.

    Plain top-k can drop a whole (small or well-separated) class, which
    would change the label mapping of the surviving DataSet; then the
    class's best point is swapped in for the worst kept point of a class
    that keeps at least two.
    """
    order = np.argsort(-magnitude, kind="stable")
    keep = order[:k]
    if class_idx is None:
        return np.sort(keep)
    kept_classes = set(class_idx[keep].tolist())
    missing = [c for c in np.unique(class_idx) if c not in kept_classes]
    if missing:
        keep = list(keep)
        for c in missing:
            members = np.nonzero(class_idx == c)[0]
            best = members[np.argmax(magnitude[members])]
            counts = {}
            for i in keep:
                counts[class_idx[i]] = counts.get(class_idx[i], 0) + 1
            for pos in range(len(keep) - 1, -1, -1):
                if counts[class_idx[keep[pos]]] >= 2:
                    counts[class_idx[keep[pos]]] -= 1
                    keep.pop(pos)
                    break
            keep.append(best)
        keep = np.asarray(keep)
    return np.sort(keep)


def _prune_target(current: int, n_sv: int, prune_rate: float) -> int:
    """The size of the next round: ``prune_rate`` fewer, at least one
    fewer, never below ``n_sv``."""
    target = max(n_sv, int(np.ceil(current * (1.0 - prune_rate))))
    return current - 1 if target >= current else target


def pruned_fit(
    csvm,
    data: DataSet,
    *,
    n_sv: int,
    prune_rate: float = 0.25,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    sample_weight=None,
    return_indices: bool = False,
):
    """Sparse LS-SVM by iterative smallest-|alpha| pruning (Suykens 2002).

    Fits on the full ``data``, then repeatedly drops the ``prune_rate``
    share of points with the smallest dual weights and refits on the
    survivors, warm-started from their alpha, until at most ``n_sv`` support
    vectors remain.  Binary, one-vs-all and LS-SVR; ``sample_weight`` is
    pruned with its rows.  Returns the compact Model, or ``(model,
    indices)`` into ``data``'s rows with ``return_indices``.
    """
    n = data.num_data_points
    if not 1 <= n_sv < n:
        raise InvalidParameterError(
            f"n_sv must be in [1, {n - 1}] to prune a {n}-point data set, "
            f"but is {n_sv}!"
        )
    if not data.is_regression and data.has_labels():
        n_classes = data.num_different_labels
        if n_sv < n_classes:
            # the class floor keeps one point a class: the schedule could
            # never shrink below num_classes
            raise InvalidParameterError(
                f"n_sv ({n_sv}) must be at least the number of classes "
                f"({n_classes}) — pruning keeps every class non-empty!"
            )
    if not 0.0 < prune_rate < 1.0:
        raise InvalidParameterError(
            f"prune_rate must be in (0, 1), but is {prune_rate}!"
        )
    if sample_weight is not None:
        sample_weight = np.asarray(sample_weight, dtype=np.float64)

    model = csvm.fit(
        data, epsilon=epsilon, max_iter=max_iter, sample_weight=sample_weight
    )
    if model.classification == ClassificationType.OAO:
        raise InvalidParameterError(
            "pruned_fit supports binary/one-vs-all models only — prune the "
            "one-vs-one pair machines individually instead!"
        )

    X = np.asarray(data.data)
    labels = np.asarray(data.labels)
    # prune within the label partition, so that no class disappears
    class_idx = None if data.is_regression else np.unique(labels, return_inverse=True)[1]
    indices = np.arange(n)
    while indices.shape[0] > n_sv:
        target = _prune_target(indices.shape[0], n_sv, prune_rate)
        ci = class_idx[indices] if class_idx is not None else None
        local_keep = _keep_with_class_floor(_alpha_magnitude(model.alpha), target, ci)
        indices = indices[local_keep]

        sub = DataSet(X[indices], labels[indices], dtype=X.dtype,
                      regression=data.is_regression)
        warm = Model(model.params.copy(), sub,
                     alpha=np.asarray(model.alpha)[local_keep], rho=model.rho)
        warm.classification = model.classification
        warm.is_regression = model.is_regression
        sw = sample_weight[indices] if sample_weight is not None else None
        model = csvm.fit(sub, epsilon=epsilon, max_iter=max_iter,
                         initial_model=warm, sample_weight=sw)
    if return_indices:
        return model, indices
    return model


# ---------------------------------------------------------------------------
# Fixed-size LS-SVM (Nystroem primal ridge)
# ---------------------------------------------------------------------------


def _select_landmarks(data: DataSet, m: int, random_state) -> np.ndarray:
    """m landmark row indices — class-stratified for classification."""
    n = data.num_data_points
    rng = np.random.default_rng(random_state)
    if data.is_regression or not data.has_labels():
        return _stratified_landmarks(None, n, m, rng)
    return _stratified_landmarks(np.asarray(data.labels), n, m, rng)


def _stratified_landmarks(labels, n, m, rng) -> np.ndarray:
    """Class-stratified landmark indices from a raw label array (None: a
    plain sample without replacement), exactly m of them."""
    if labels is None:
        return np.sort(rng.choice(n, size=m, replace=False))
    classes, class_idx = np.unique(labels, return_inverse=True)
    if m < classes.shape[0]:
        raise InvalidParameterError(
            f"n_landmarks ({m}) must be at least the number of classes "
            f"({classes.shape[0]})!"
        )
    # proportional allocation with one landmark guaranteed a class; the
    # floor can overshoot m on imbalanced data, so the largest allocations
    # shrink back (keeping the floor), then the remainder goes to the
    # largest classes with room
    counts = np.bincount(class_idx, minlength=classes.shape[0])
    alloc = np.maximum(1, np.floor(m * counts / n).astype(int))
    alloc = np.minimum(alloc, counts)
    while alloc.sum() > m:
        shrink = int(np.argmax(np.where(alloc > 1, alloc, -1)))
        if alloc[shrink] <= 1:
            break
        alloc[shrink] -= 1
    while alloc.sum() < m:
        room = counts - alloc
        grow = int(np.argmax(np.where(room > 0, counts, -1)))
        if room[grow] <= 0:
            break
        alloc[grow] += 1
    picked = []
    for ci in range(classes.shape[0]):
        members = np.nonzero(class_idx == ci)[0]
        picked.append(rng.choice(members, size=alloc[ci], replace=False))
    return np.sort(np.concatenate(picked))


def _explicit_landmarks(landmarks, n: int) -> np.ndarray:
    """Caller-given landmark indices, sorted; duplicates and indices out of
    range raise (the model must not shrink below the asked size)."""
    raw_idx = np.asarray(landmarks, dtype=np.int64)
    idx = np.unique(raw_idx)
    if idx.size == 0 or idx.size != raw_idx.size or idx[0] < 0 or idx[-1] >= n:
        raise InvalidParameterError(
            f"landmark indices must be unique and within [0, {n - 1}]!"
        )
    return idx


def _kmm_inv_sqrt(K_mm: np.ndarray, rcond: float) -> np.ndarray:
    """Symmetric K_mm^{-1/2} in float64 with eigenvalue clipping at
    ``rcond`` times the largest."""
    K = np.asarray(K_mm, dtype=np.float64)
    K = 0.5 * (K + K.T)
    w, V = np.linalg.eigh(K)
    cutoff = rcond * float(w[-1]) if w[-1] > 0 else 0.0
    inv_sqrt = np.where(w > cutoff, 1.0 / np.sqrt(np.maximum(w, cutoff)), 0.0)
    return (V * inv_sqrt[None, :]) @ V.T


def _validated_weights(sample_weight, n) -> np.ndarray:
    """Per-sample weights as a validated (n,) float64 vector (ones when
    unweighted), one rule for every fit of this module."""
    if sample_weight is None:
        return np.ones(n, dtype=np.float64)
    s = np.asarray(sample_weight, dtype=np.float64)
    if s.shape != (n,):
        raise InvalidParameterError(
            f"sample_weight must have one entry per data point ({n}), "
            f"but has shape {s.shape}!"
        )
    if not np.all(s > 0.0):
        raise InvalidParameterError("sample_weight entries must all be positive!")
    return s


def _resolve_kernel_params(csvm, d):
    """(params, kind, gamma, coef0, degree, cost) with gamma's default
    resolved against d."""
    params = csvm.params.copy()
    if params.gamma.is_default():
        params.gamma.value = 1.0 / d
    return (
        params, params.kernel_type.value, params.resolved_gamma(d),
        params.coef0.value, params.degree.value, params.cost.value,
    )


def _check_non_negative(X: np.ndarray, kind) -> None:
    if kind == KernelFunctionType.CHI_SQUARED and np.any(X < 0.0):
        raise InvalidParameterError("chi-squared kernel requires non-negative data!")


class _Timer:
    """Milliseconds of a fit's phases, recorded as the tracker's
    "nystroem" entries when the fit ends."""

    def __init__(self, m: int):
        self.m = m
        self.blocks = 0
        self.last = time.perf_counter()
        self.ms = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.ms[name] = (now - self.last) * 1000.0
        self.last = now

    def record(self) -> None:
        add_tracking_entry("nystroem", "landmarks", self.m)
        add_tracking_entry("nystroem", "row_blocks", self.blocks)
        for name, ms in self.ms.items():
            add_tracking_entry("nystroem", name, ms)


class _Basis:
    """The landmark basis on one device: Z and K_mm^{-1/2} in the data's
    type, and the kernel's parameters; :meth:`update` adds one row block to
    the normal equations."""

    def __init__(self, csvm, Z: torch.Tensor, ivr: torch.Tensor, kind, gamma, coef0, degree):
        self.csvm, self.Z, self.ivr = csvm, Z, ivr
        self.kind, self.gamma, self.coef0, self.degree = kind, gamma, coef0, degree
        self.device = Z.device

    def on(self, device) -> "_Basis":
        """This basis on ``device`` (itself where it lies there already)."""
        if torch.device(device) == self.device:
            return self
        return _Basis(self.csvm, self.Z.to(device), self.ivr.to(device), self.kind,
                      self.gamma, self.coef0, self.degree)

    def block(self, Xr: torch.Tensor) -> torch.Tensor:
        """``K(Xr, Z)`` at the CSVM's tier, in the data's type."""
        K = kernel_matrix_block(
            Xr, self.Z, self.gamma, self.coef0, kind=self.kind, degree=self.degree,
            precision=self.csvm.gram_precision, impl=self.csvm._impl())
        return K.to(Xr.dtype)

    def update(self, A, c, u, Xblk: np.ndarray, sblk: np.ndarray, Yblk: np.ndarray):
        """``A += Phi' S Phi``, ``c += Phi' S Y``, ``u += Phi' S 1`` with
        ``Phi = K(X_blk, Z) K_mm^{-1/2}``."""
        dev, dt = self.device, self.Z.dtype
        Xb = torch.as_tensor(np.ascontiguousarray(Xblk, dtype=self.csvm.dtype), device=dev)
        sb = torch.as_tensor(np.asarray(sblk), dtype=dt, device=dev)
        Yb = torch.as_tensor(np.asarray(Yblk), dtype=dt, device=dev)
        Kbm = self.block(Xb)
        with _tf32(False):
            Phi = Kbm @ self.ivr
            Phi_s = Phi * sb[:, None]
            A += Phi.T @ Phi_s
            c += Phi_s.T @ Yb
        u += Phi_s.sum(dim=0)


def _landmark_basis(csvm, Z, kind, gamma, coef0, degree, rcond, device):
    """(basis, inv_sqrt): K_mm from kernel N's symmetric walk or the Gram
    build on ``device``, its float64 inverse square root on the host."""
    Zd = torch.as_tensor(np.ascontiguousarray(Z, dtype=csvm.dtype), device=device)
    K_mm = kernel_matrix_block(Zd, Zd, gamma, coef0, kind=kind, degree=degree,
                               precision=csvm.gram_precision, impl=csvm._impl(),
                               symmetric=True)
    inv_sqrt = _kmm_inv_sqrt(K_mm.to(torch.float64).cpu().numpy(), rcond)
    ivr = torch.as_tensor(inv_sqrt.astype(csvm.dtype), device=device)
    return _Basis(csvm, Zd, ivr, kind, gamma, coef0, degree), inv_sqrt


def _zeros(basis: _Basis, C: int):
    m = basis.Z.shape[0]
    kw = dict(dtype=basis.Z.dtype, device=basis.device)
    return torch.zeros((m, m), **kw), torch.zeros((m, C), **kw), torch.zeros((m,), **kw)


def _reduce_rows(basis: _Basis, X, s, Y, block: int):
    """The normal equations' (A, c, u) of rows X, s, Y, one block of
    ``block`` rows at a time, on the basis's device."""
    A, c, u = _zeros(basis, Y.shape[1])
    for b in range(0, X.shape[0], block):
        basis.update(A, c, u, X[b:b + block], s[b:b + block], Y[b:b + block])
    return A, c, u


def _nystroem_reduce(csvm, basis: _Basis, X, s, Y, row_block):
    """(A, c, u) as float64 host arrays and the count of row blocks: one
    device's loop over row blocks, or with ``csvm.devices`` each shard's
    rows (plssvm_tpu's padded row split) on its own device, the partials
    summed on the first in shard order."""
    n = X.shape[0]
    devices = csvm.devices
    n_dev = len(devices) if devices else 1
    block = int(min(row_block, max(8, -(-n // n_dev))))
    if n_dev == 1:
        shards = [(basis, 0, n)]
    else:
        per = -(-n // (block * n_dev)) * block
        shards = [(basis.on(dev), p * per, min((p + 1) * per, n))
                  for p, dev in enumerate(devices) if p * per < n]
    parts = [_reduce_rows(shard, X[lo:hi], s[lo:hi], Y[lo:hi], block)
             for shard, lo, hi in shards]
    first = basis.device
    totals = [part.to(first) for part in parts[0]]
    for part in parts[1:]:
        for total, partial in zip(totals, part):
            total += partial.to(first)
    blocks = sum(-(-(hi - lo) // block) for _, lo, hi in shards)
    return tuple(t.to(torch.float64).cpu().numpy() for t in totals) + (blocks,)


def _bordered_solve(A, c, u, s, Y, cost, inv_sqrt):
    """Solve the bordered (m+1) x (m+1) normal equations on the host in
    float64::

        [A + I/C   u ] [w]   [c ]
        [u'        s1] [b] = [sy]

    Returns ``(alpha, b)``, ``alpha = K_mm^{-1/2} w`` the (m, C) landmark
    dual block.
    """
    m = A.shape[0]
    s1 = float(np.sum(s))
    sy = (s[:, None] * Y).sum(axis=0)
    H = np.empty((m + 1, m + 1), dtype=np.float64)
    H[:m, :m] = A + np.eye(m) / cost
    H[:m, m] = u
    H[m, :m] = u
    H[m, m] = s1
    rhs = np.concatenate([c, sy[None, :]], axis=0)
    sol = np.linalg.solve(H, rhs)
    return inv_sqrt @ sol[:m], sol[m]


def _nystroem_model(params, Z, sub_labels, alpha, b, dt, regression):
    """The ordinary m-SV Model of a Nystroem primal solution (binary,
    one-vs-all or regression layout)."""
    if regression:
        model = Model(params, DataSet(Z, dtype=dt), alpha=alpha[:, 0], rho=-float(b[0]))
        model.is_regression = True
    else:
        sub = DataSet(Z, sub_labels, dtype=dt)
        if alpha.shape[1] == 1:
            model = Model(params, sub, alpha=alpha[:, 0], rho=-float(b[0]))
        else:
            model = Model(params, sub, alpha=alpha, rho=-b)
            model.classification = ClassificationType.OAA
    model.n_iter = 0  # a direct solve
    return model


def _check_classification_data(data: DataSet) -> None:
    """CSVM.fit's front-door rules for a classification data set."""
    if not data.has_labels():
        raise InvalidParameterError(
            "No labels given for training! Maybe the data is only usable for prediction?"
        )
    if data.num_different_labels < 2:
        raise InvalidParameterError(
            f"At least two classes are needed for classification, but the "
            f"training data contains only {data.num_different_labels}!"
        )


def _targets(data: DataSet) -> np.ndarray:
    """(n, C) float64 targets: the continuous labels, the +-1 binary
    mapping, or the one-vs-all columns."""
    if data.is_regression:
        return np.asarray(data.labels, dtype=np.float64)[:, None]
    if data.num_different_labels == 2:
        return np.asarray(data.y, dtype=np.float64)[:, None]
    return data.mapper.oaa_targets(np.asarray(data.labels), dtype=np.float64)


def nystroem_fit(
    csvm,
    data: DataSet,
    *,
    n_landmarks: Optional[int] = None,
    landmarks: Optional[Union[Sequence[int], np.ndarray]] = None,
    random_state=0,
    sample_weight=None,
    rcond: float = 1e-10,
    row_block: int = 4096,
    return_indices: bool = False,
):
    """Fixed-size LS-SVM: Nystroem primal ridge fit with m landmark SVs.

    Solves ``min 1/2 |w|^2 + 1/2 sum_i C s_i (y_i - w.phi(x_i) - b)^2`` in
    the basis ``phi(x) = K_mm^{-1/2} k(Z, x)`` and returns a Model whose
    support vectors are the m landmarks (``alpha = K_mm^{-1/2} w``, ``rho =
    -b``).  ``landmarks`` gives row indices into ``data``; otherwise
    ``n_landmarks`` rows are drawn (class-stratified, seeded by
    ``random_state``, the indices plssvm_tpu draws).  Binary, one-vs-all
    and regression; ``sample_weight`` is the per-point penalty ``C * s_i``.
    ``return_indices=True`` returns ``(model, landmark_indices)``.
    """
    n = data.num_data_points
    d = data.num_features
    if not data.is_regression:
        _check_classification_data(data)
    if landmarks is not None:
        idx = _explicit_landmarks(landmarks, n)
    else:
        if n_landmarks is None:
            raise InvalidParameterError(
                "nystroem_fit needs n_landmarks or explicit landmarks!"
            )
        if not 1 <= n_landmarks <= n:
            raise InvalidParameterError(
                f"n_landmarks must be in [1, {n}], but is {n_landmarks}!"
            )
        idx = _select_landmarks(data, int(n_landmarks), random_state)
    if not data.is_regression and (
            np.unique(np.asarray(data.labels)[idx]).shape[0] != data.num_different_labels):
        raise InvalidParameterError(
            "the landmark sample lost a class — pass class-covering "
            "landmarks or a larger n_landmarks!"
        )

    Y = _targets(data)
    s = _validated_weights(sample_weight, n)
    params, kind, gamma, coef0, degree, cost = _resolve_kernel_params(csvm, d)
    dt = csvm.dtype
    X = np.asarray(data.data, dtype=dt)
    if kind == KernelFunctionType.CHI_SQUARED:
        from .csvm import _check_chi_squared_data

        _check_chi_squared_data(X, "training data")
    Z = X[idx]

    timer = _Timer(idx.shape[0])
    basis, inv_sqrt = _landmark_basis(csvm, Z, kind, gamma, coef0, degree, rcond,
                                      csvm.device)
    timer.lap("basis_ms")
    A, c, u, timer.blocks = _nystroem_reduce(csvm, basis, X, s, Y, row_block)
    timer.lap("reduce_ms")
    alpha, b = _bordered_solve(A, c, u, s, Y, cost, inv_sqrt)
    timer.lap("solve_ms")
    timer.record()
    model = _nystroem_model(
        params, Z, None if data.is_regression else np.asarray(data.labels)[idx],
        alpha, b, dt, data.is_regression,
    )
    if return_indices:
        return model, idx
    return model


def compact_fold_fit_fn(
    csvm, *, n_landmarks=None, max_sv=None, epsilon=0.001, max_iter=None,
    random_state=None,
):
    """Fold fit for the calibration and cross-validation of COMPACT models.

    The folds train with the deployed model's compact procedure, scaled to
    the fold's size, so the sigmoid (or the CV accuracy) reflects the
    compact model.  Shared by the sklearn facade and the CLI.  A fold too
    small to prune (n_fold <= num_classes) takes the exact fit.
    """

    def fit_fn(fold_data, fold_sw):
        n_fold = fold_data.num_data_points
        if n_landmarks is not None:
            return nystroem_fit(
                csvm, fold_data, n_landmarks=min(n_landmarks, n_fold),
                random_state=random_state or 0, sample_weight=fold_sw,
            )
        n_classes = (
            fold_data.num_different_labels
            if not fold_data.is_regression and fold_data.has_labels() else 1
        )
        target = max(n_classes, min(max_sv, n_fold - 1))
        if not n_classes <= target < n_fold:
            kwargs = {} if max_iter is None else {"max_iter": max_iter}
            if fold_sw is not None:
                kwargs["sample_weight"] = fold_sw
            return csvm.fit(fold_data, epsilon=epsilon, **kwargs)
        return pruned_fit(csvm, fold_data, n_sv=target, epsilon=epsilon,
                          max_iter=max_iter, sample_weight=fold_sw)

    return fit_fn


# ---------------------------------------------------------------------------
# Windowed file ingest: fixed-size fits with O(window) host memory
# ---------------------------------------------------------------------------


def _parse_rows_checked(filename, spans_subset, d, dt):
    """Selected-row parse that fails cleanly if the native read breaks
    mid-stream (None = an I/O failure after the validating parse)."""
    from .exceptions import InvalidFileFormatError
    from .native.loader import parse_libsvm_native_rows

    rows = parse_libsvm_native_rows(filename, spans_subset, d, dtype=dt)
    if rows is None:
        raise InvalidFileFormatError(
            f"selected-row parse of '{filename}' failed mid-stream — "
            "file removed or truncated during the windowed read?"
        )
    return rows


def _file_index(csvm, filename):
    """``(n, d, raw_labels, spans)`` of a LIBSVM file from one validating
    native parse and the line index, or None where the native parser is
    missing or the file is ARFF (its grammar has no line index)."""
    from .native.loader import check_line_spans, libsvm_line_spans, parse_libsvm_native_window

    if filename.lower().endswith(".arff"):
        return None
    meta = parse_libsvm_native_window(filename, 0, 0, dtype=csvm.dtype)
    spans = libsvm_line_spans(filename) if meta is not None else None
    if meta is None or spans is None:
        return None
    _, raw_labels, n, d = meta
    check_line_spans(spans, n)
    return n, d, raw_labels, spans


def _windows(filename, spans, n, d, dt, kind, block):
    """``(begin, end, X_window)`` over the file's rows, ``block`` at a
    time, each parsed by one selected-row read."""
    for b in range(0, n, block):
        e = min(b + block, n)
        Xw = _parse_rows_checked(filename, spans[b:e], d, dt)
        _check_non_negative(Xw, kind)
        yield b, e, Xw


def _file_targets(raw_labels, n, n_landmarks, label_type, regression, random_state):
    """``(labels, Y, landmark indices)`` of a file's label column: the
    continuous targets or the +-1 / one-vs-all columns (n, C) in float64,
    and plssvm_tpu's draw of the landmarks (class-stratified, seeded)."""
    from .data_set import LabelMapper, _infer_label_array

    if not 1 <= n_landmarks <= n:
        raise InvalidParameterError(
            f"n_landmarks must be in [1, {n}], but is {n_landmarks}!"
        )
    rng = np.random.default_rng(random_state)
    if regression:
        labels = np.asarray(_infer_label_array(list(raw_labels), float), dtype=np.float64)
        return labels, labels[:, None], _stratified_landmarks(None, n, int(n_landmarks), rng)
    labels = _infer_label_array(list(raw_labels), label_type)
    mapper = LabelMapper(labels)
    if mapper.num_mappings > 2:
        Y = mapper.oaa_targets(labels, dtype=np.float64)
    else:
        Y = mapper.map_labels(labels, dtype=np.float64)[:, None]
    return labels, Y, _stratified_landmarks(labels, n, int(n_landmarks), rng)


def nystroem_fit_from_file(
    csvm,
    filename: str,
    *,
    n_landmarks: int,
    label_type=None,
    regression: bool = False,
    random_state=0,
    sample_weight=None,
    rcond: float = 1e-10,
    row_block: int = 65536,
    return_indices: bool = False,
):
    """Fixed-size LS-SVM trained from a LIBSVM file in two passes.

    1. **Landmarks**: one validating native parse gives (n, d) and the
       label column, the landmarks are drawn from it (plssvm_tpu's draw),
       and their rows come in one selected-row read against the file's line
       index.
    2. **Reduce**: the file streams through ``row_block``-row windows, each
       one block update of the normal equations on the CSVM's device.

    Host memory stays O(row_block d + m d + n) at any n.  The result is
    ``nystroem_fit(csvm, DataSet(filename), landmarks=<the same>)`` up to
    the row blocks' summation order.  Without the native parser, or for an
    ARFF file, the in-memory fit runs instead.  One device: ``devices`` is
    not sharded here.
    """
    index = _file_index(csvm, filename)
    if index is None:
        data = DataSet(filename, label_type=float if regression else label_type,
                       dtype=csvm.dtype, regression=regression)
        return nystroem_fit(csvm, data, n_landmarks=n_landmarks, random_state=random_state,
                            sample_weight=sample_weight, rcond=rcond,
                            return_indices=return_indices)
    n, d, raw_labels, spans = index
    if raw_labels is None:
        raise InvalidParameterError(
            "No labels given for training! Maybe the data is only usable for prediction?"
        )
    labels, Y, idx = _file_targets(raw_labels, n, n_landmarks, label_type, regression,
                                   random_state)
    s = _validated_weights(sample_weight, n)
    params, kind, gamma, coef0, degree, cost = _resolve_kernel_params(csvm, d)
    dt = csvm.dtype

    timer = _Timer(idx.shape[0])
    Z = _parse_rows_checked(filename, spans[idx], d, dt)
    _check_non_negative(Z, kind)
    block = int(min(row_block, max(8, n)))
    basis, inv_sqrt = _landmark_basis(csvm, Z, kind, gamma, coef0, degree, rcond,
                                      csvm.device)
    timer.lap("basis_ms")
    A, c, u = _zeros(basis, Y.shape[1])
    for b, e, Xw in _windows(filename, spans, n, d, dt, kind, block):
        basis.update(A, c, u, Xw, s[b:e], Y[b:e])
        timer.blocks += 1
    A, c, u = (t.to(torch.float64).cpu().numpy() for t in (A, c, u))
    timer.lap("reduce_ms")
    alpha, b_sol = _bordered_solve(A, c, u, s, Y, cost, inv_sqrt)
    timer.lap("solve_ms")
    timer.record()
    model = _nystroem_model(params, Z, None if regression else labels[idx], alpha, b_sol,
                            dt, regression)
    if return_indices:
        return model, idx
    return model


def nystroem_fit_multihost(
    csvm,
    filename: str,
    *,
    n_landmarks: int,
    label_type=None,
    regression: bool = False,
    random_state=0,
    sample_weight=None,
    rcond: float = 1e-10,
    row_block: int = 65536,
    return_indices: bool = False,
):
    """A fixed-size (Nystroem) fit of ``filename`` over the processes of a
    ``torch.distributed`` job (plssvm_tpu's ``nystroem_fit_multihost``).

    Every rank reads the label column and draws the same landmarks
    (plssvm_tpu's seeded stratified draw), parses the m landmark rows (one
    selected-row read) and builds the same basis; each reduces only its
    window of rows, the row split of the single-process reduction over as
    many shards (``_nystroem_reduce``: blocks of ``min(row_block, max(8,
    ceil(n / world)))`` rows, ``ceil(n / (block * world))`` blocks a
    rank), and the (m, m), (m, C) and (m,) partials are summed in rank order
    (``all_gather``: O(m^2) traffic, whatever n), so every rank solves the
    same bordered system on its host and returns the same model.  At one
    process it equals :func:`nystroem_fit` on the same landmarks.
    """
    from .parallel import multihost as mh

    group = mh.rank_group(csvm)
    dt = csvm.dtype
    windows = mh._FileWindows(filename, dt)
    n, d = windows.n, windows.d
    if windows.raw_labels is None:
        raise InvalidParameterError(
            "No labels given for training! Maybe the data is only usable for prediction?"
        )
    labels, Y, idx = _file_targets(windows.raw_labels, n, n_landmarks, label_type,
                                   regression, random_state)
    s = _validated_weights(sample_weight, n)
    params, kind, gamma, coef0, degree, cost = _resolve_kernel_params(csvm, d)

    timer = _Timer(idx.shape[0])
    windows.check_index(group)
    Z = windows.selected(idx)
    block = int(min(row_block, max(8, -(-n // group.world))))
    per = -(-n // (block * group.world)) * block
    lo, hi = min(group.rank * per, n), min((group.rank + 1) * per, n)
    X_win = windows.rows(lo, hi)
    mh.check_chi_squared(group, kind, mh._local_min(X_win, Z),
                         "chi-squared kernel requires non-negative data!")
    basis, inv_sqrt = _landmark_basis(csvm, Z, kind, gamma, coef0, degree, rcond,
                                      csvm.device)
    timer.lap("basis_ms")
    partials = _reduce_rows(basis, X_win, s[lo:hi], Y[lo:hi], block)
    empty = [r for r in range(group.world) if r * per >= n]
    A, c, u = (group.sum_in_rank_order(t, skip=empty).to(torch.float64).cpu().numpy()
               for t in partials)
    timer.blocks = -(-n // block)
    mh._record((lo, hi), dict(X=X_win.shape[0]))
    timer.lap("reduce_ms")
    alpha, b = _bordered_solve(A, c, u, s, Y, cost, inv_sqrt)
    timer.lap("solve_ms")
    timer.record()
    model = _nystroem_model(params, Z, None if regression else labels[idx], alpha, b, dt,
                            regression)
    if return_indices:
        return model, idx
    return model


def nystroem_fit_one_class_from_file(
    csvm,
    filename: str,
    *,
    n_landmarks: int,
    nu: float = 0.5,
    random_state=0,
    rcond: float = 1e-10,
    row_block: int = 65536,
    return_indices: bool = False,
):
    """Fixed-size ONE-CLASS LS-SVM trained from a LIBSVM file.

    The two passes of :func:`nystroem_fit_from_file` (the target is the
    constant 1, no bias row), then a third over the same windows for the
    threshold: the training scores ``k(x, Z) @ alpha`` of each window come
    from the CSVM's predict (kernel B / F), and ``rho`` is their
    ``nu``-quantile over the whole file.  Labels in the file are ignored.
    Without the native parser, or for an ARFF file, the in-memory
    :func:`nystroem_fit_one_class` runs instead.
    """
    if not 0.0 < nu < 1.0:
        raise InvalidParameterError(f"nu must be in (0, 1), but is {nu}!")
    index = _file_index(csvm, filename)
    if index is None:
        # one-class files may carry one class or string labels that
        # DataSet's loaders refuse: parse X alone
        if filename.lower().endswith(".arff"):
            from .io.arff import parse_arff_file

            X_all, _ = parse_arff_file(filename, dtype=csvm.dtype)
        else:
            from .io.libsvm import parse_libsvm_file

            X_all, _ = parse_libsvm_file(filename, dtype=csvm.dtype)
        return nystroem_fit_one_class(
            csvm, DataSet(X_all, dtype=csvm.dtype), n_landmarks=n_landmarks, nu=nu,
            random_state=random_state, rcond=rcond, return_indices=return_indices,
        )
    n, d, _, spans = index
    if not 1 <= n_landmarks <= n:
        raise InvalidParameterError(
            f"n_landmarks must be in [1, {n}], but is {n_landmarks}!"
        )
    rng = np.random.default_rng(random_state)
    idx = np.sort(rng.choice(n, size=int(n_landmarks), replace=False))
    params, kind, gamma, coef0, degree, cost = _resolve_kernel_params(csvm, d)
    dt = csvm.dtype

    m = idx.shape[0]
    timer = _Timer(m)
    Z = _parse_rows_checked(filename, spans[idx], d, dt)
    _check_non_negative(Z, kind)
    block = int(min(row_block, max(8, n)))
    basis, inv_sqrt = _landmark_basis(csvm, Z, kind, gamma, coef0, degree, rcond,
                                      csvm.device)
    timer.lap("basis_ms")
    A, c, u = _zeros(basis, 1)
    for b, e, Xw in _windows(filename, spans, n, d, dt, kind, block):
        basis.update(A, c, u, Xw, np.ones(e - b), np.ones((e - b, 1)))
        timer.blocks += 1
    A = A.to(torch.float64).cpu().numpy()
    # the one-class right-hand side Phi' 1 is u
    u = u.to(torch.float64).cpu().numpy()
    timer.lap("reduce_ms")
    w = np.linalg.solve(A + np.eye(m) / cost, u)
    alpha = inv_sqrt @ w

    model = Model(params, DataSet(Z, dtype=dt), alpha=alpha, rho=0.0)
    model.is_one_class = True
    model.n_iter = 0
    g_all = np.empty(n, dtype=np.float64)
    for b, e, Xw in _windows(filename, spans, n, d, dt, kind, block):
        g_all[b:e] = csvm.predict_values(model, DataSet(Xw, dtype=dt))
    model.rho = float(np.quantile(g_all, nu))
    timer.lap("solve_ms")
    timer.record()
    if return_indices:
        return model, idx
    return model


# ---------------------------------------------------------------------------
# Compact one-class models (novelty detection with m << n support vectors)
# ---------------------------------------------------------------------------


def _one_class_rho(csvm, model, data: DataSet, nu: float) -> float:
    """The nu-quantile threshold of a compact one-class model over the
    FULL training data's scores under the compact expansion."""
    saved = model.rho
    model.rho = 0.0
    try:
        g = np.asarray(csvm.predict_values(model, data), dtype=np.float64)
    finally:
        model.rho = saved
    return float(np.quantile(g, nu))


def pruned_fit_one_class(
    csvm,
    data: DataSet,
    *,
    n_sv: int,
    nu: float = 0.5,
    prune_rate: float = 0.25,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    sample_weight=None,
    return_indices: bool = False,
):
    """Compact one-class LS-SVM by iterative smallest-|alpha| pruning.

    :func:`pruned_fit` on the novelty-detection ridge ``(K + I/C) a = 1``
    (one_class.py), each refit warm-started.  The final ``rho`` is the
    ``nu``-quantile of the FULL training data's scores under the compact
    expansion, so about ``nu`` of the training cloud is still flagged.
    """
    from .one_class import fit_one_class

    n = data.num_data_points
    if not 1 <= n_sv < n:
        raise InvalidParameterError(
            f"n_sv must be in [1, {n - 1}] to prune a {n}-point data set, "
            f"but is {n_sv}!"
        )
    if not 0.0 < prune_rate < 1.0:
        raise InvalidParameterError(
            f"prune_rate must be in (0, 1), but is {prune_rate}!"
        )
    if sample_weight is not None:
        sample_weight = np.asarray(sample_weight, dtype=np.float64)
    model = fit_one_class(csvm, data, nu=nu, epsilon=epsilon, max_iter=max_iter,
                          sample_weight=sample_weight)
    X = np.asarray(data.data)
    indices = np.arange(n)
    while indices.shape[0] > n_sv:
        target = _prune_target(indices.shape[0], n_sv, prune_rate)
        local_keep = _keep_with_class_floor(_alpha_magnitude(model.alpha), target, None)
        indices = indices[local_keep]

        sub = DataSet(X[indices], dtype=X.dtype)
        warm = Model(model.params.copy(), sub,
                     alpha=np.asarray(model.alpha)[local_keep], rho=model.rho)
        warm.is_one_class = True
        sw = sample_weight[indices] if sample_weight is not None else None
        model = fit_one_class(csvm, sub, nu=nu, epsilon=epsilon, max_iter=max_iter,
                              initial_model=warm, sample_weight=sw)
    model.rho = _one_class_rho(csvm, model, data, nu)
    if return_indices:
        return model, indices
    return model


def nystroem_fit_one_class(
    csvm,
    data: DataSet,
    *,
    n_landmarks: Optional[int] = None,
    landmarks: Optional[Union[Sequence[int], np.ndarray]] = None,
    nu: float = 0.5,
    random_state=0,
    sample_weight=None,
    rcond: float = 1e-10,
    row_block: int = 4096,
    return_indices: bool = False,
):
    """Fixed-size one-class LS-SVM: Nystroem primal ridge with m landmarks.

    Solves ``min 1/2 |w|^2 + C/2 sum_i s_i (1 - w.phi(x_i))^2`` in the
    Nystroem basis (no bias: LIBSVM's one-class decision function keeps the
    threshold in ``rho``) and returns an m-SV one-class Model (``alpha =
    K_mm^{-1/2} w``); ``rho`` is the ``nu``-quantile of the full training
    scores.  The reduction is :func:`nystroem_fit`'s, row-sharded over
    ``devices`` alike.  The landmarks are a plain seeded sample (no labels).
    """
    n = data.num_data_points
    d = data.num_features
    if not 0.0 < nu < 1.0:
        raise InvalidParameterError(f"nu must be in (0, 1), but is {nu}!")
    if landmarks is not None:
        idx = _explicit_landmarks(landmarks, n)
    else:
        if n_landmarks is None:
            raise InvalidParameterError(
                "nystroem_fit_one_class needs n_landmarks or explicit landmarks!"
            )
        if not 1 <= n_landmarks <= n:
            raise InvalidParameterError(
                f"n_landmarks must be in [1, {n}], but is {n_landmarks}!"
            )
        rng = np.random.default_rng(random_state)
        idx = np.sort(rng.choice(n, size=int(n_landmarks), replace=False))
    m = idx.shape[0]
    params, kind, gamma, coef0, degree, cost = _resolve_kernel_params(csvm, d)
    dt = csvm.dtype
    X = np.asarray(data.data, dtype=dt)
    if kind == KernelFunctionType.CHI_SQUARED:
        from .csvm import _check_chi_squared_data

        _check_chi_squared_data(X, "training data")
    Z = X[idx]
    # the support-function target is the constant 1 (one_class.py)
    Y = np.ones((n, 1), dtype=np.float64)
    s = _validated_weights(sample_weight, n)

    timer = _Timer(m)
    basis, inv_sqrt = _landmark_basis(csvm, Z, kind, gamma, coef0, degree, rcond,
                                      csvm.device)
    timer.lap("basis_ms")
    A, c, _, timer.blocks = _nystroem_reduce(csvm, basis, X, s, Y, row_block)
    timer.lap("reduce_ms")
    # bias-free m x m ridge: (A + I/C) w = c, c = Phi' S 1
    w = np.linalg.solve(A + np.eye(m) / cost, c[:, 0])
    alpha = inv_sqrt @ w

    model = Model(params, DataSet(Z, dtype=dt), alpha=alpha, rho=0.0)
    model.is_one_class = True
    model.n_iter = 0
    model.rho = _one_class_rho(csvm, model, data, nu)
    timer.lap("solve_ms")
    timer.record()
    if return_indices:
        return model, idx
    return model
