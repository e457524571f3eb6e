"""CG-state checkpointing: save / restore a training run mid-solve.

Counterpart of plssvm_tpu/solver/checkpoint.py, with the same ``.npz`` keys.
A capability the reference lacks entirely — its only persisted artifact is
the finished LIBSVM model file, so an interrupted training run restarts from
scratch (SURVEY.md §5, model.hpp:169-222).  Here the full CG state
(x, r, d, delta, delta0, iteration) is dumped to a ``.npz`` alongside a
fingerprint of the problem; `CSVM.fit(checkpoint_path=...)` saves it every
``checkpoint_interval`` iterations and resumes automatically when the file
matches the problem.  Saving and loading stay on the host: the caller moves
the arrays to and from the solve's device.

The exact-residual recomputation every 50 iterations (gpu_csvm.hpp:595-609)
keeps its cadence across a resume (the iteration count is saved), and a
resumed solve continues from the saved state bit for bit.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple, Optional

import numpy as np


class CGCheckpoint(NamedTuple):
    """Host-side snapshot of the CG solver state."""

    x: np.ndarray
    r: np.ndarray
    d: np.ndarray
    delta: float
    delta0: float
    iteration: int
    fingerprint: str


class MultiCGCheckpoint(NamedTuple):
    """Host-side snapshot of the one-vs-all block-CG solver state.

    Like :class:`CGCheckpoint` but per-class: ``x``/``r``/``d`` are (m, C)
    blocks, ``delta``/``delta0`` are (C,) vectors and ``itpc`` counts the
    iterations each class was still active (multiclass is an extension —
    the reference rejects > 2 labels, data_set.hpp:443).
    """

    x: np.ndarray
    r: np.ndarray
    d: np.ndarray
    delta: np.ndarray     # (C,)
    delta0: np.ndarray    # (C,)
    iteration: int
    itpc: np.ndarray      # (C,) per-class active-iteration counts
    fingerprint: str


def weights_digest_suffix(weights) -> str:
    """``"|weights:<sha256>"`` fingerprint suffix for Suykens sample
    weights — the ONE digest rule (CSVM, multihost and one-class
    checkpointing all append it), so differently-weighted runs never
    resume each other's checkpoints and the rule cannot drift between
    call sites."""
    return "|weights:" + hashlib.sha256(
        np.ascontiguousarray(np.asarray(weights, np.float64)).tobytes()
    ).hexdigest()


def problem_fingerprint(X, y, params_repr: str, epsilon: float) -> str:
    """Cheap fingerprint tying a checkpoint to its training problem.

    ``X`` and ``y`` may be NumPy arrays or torch tensors on any device.
    Only a ~4096-element strided sample of ``X`` is ever copied to the
    host, and the sampled elements are identical either way, so
    fingerprints match across array types.
    """
    h = hashlib.sha256()
    h.update(str(tuple(X.shape)).encode())
    h.update(str(_numpy_dtype(X.dtype)).encode())
    size = 1
    for s in X.shape:
        size *= int(s)
    stride = max(1, size // 4096)
    if isinstance(X, np.ndarray):
        sample = np.ascontiguousarray(
            np.ascontiguousarray(X).reshape(-1)[::stride]
        )
    else:
        # strided gather on the tensor's device; copy only the sample
        sample = np.ascontiguousarray(X.reshape(-1)[::stride].cpu().numpy())
    h.update(sample.tobytes())
    h.update(np.ascontiguousarray(_host(y)).tobytes())
    h.update(params_repr.encode())
    h.update(repr(float(epsilon)).encode())
    return h.hexdigest()


def _numpy_dtype(dtype) -> np.dtype:
    """The NumPy dtype of a NumPy or torch dtype (``torch.float32`` ->
    ``float32``)."""
    return np.dtype(str(dtype).replace("torch.", ""))


def _host(a) -> np.ndarray:
    """A NumPy copy of an array or a tensor on any device."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def save_checkpoint(path: str, ckpt: CGCheckpoint) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    np.savez(
        tmp if tmp.endswith(".npz") else tmp + ".npz",
        x=ckpt.x, r=ckpt.r, d=ckpt.d,
        delta=np.float64(ckpt.delta), delta0=np.float64(ckpt.delta0),
        iteration=np.int64(ckpt.iteration),
        fingerprint=np.bytes_(ckpt.fingerprint.encode()),
    )
    written = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(written, path)


def load_checkpoint(path: str, fingerprint: str) -> Optional[CGCheckpoint]:
    """Load a checkpoint if it exists and matches the problem; else None."""
    if not os.path.isfile(path):
        return None
    try:
        with np.load(path) as data:
            stored = bytes(data["fingerprint"]).decode()
            if stored != fingerprint or "itpc" in data:
                return None
            return CGCheckpoint(
                x=data["x"], r=data["r"], d=data["d"],
                delta=float(data["delta"]), delta0=float(data["delta0"]),
                iteration=int(data["iteration"]),
                fingerprint=stored,
            )
    except (OSError, KeyError, ValueError):
        return None


def save_multi_checkpoint(path: str, ckpt: MultiCGCheckpoint) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    np.savez(
        tmp if tmp.endswith(".npz") else tmp + ".npz",
        x=ckpt.x, r=ckpt.r, d=ckpt.d,
        delta=np.asarray(ckpt.delta, np.float64),
        delta0=np.asarray(ckpt.delta0, np.float64),
        iteration=np.int64(ckpt.iteration),
        itpc=np.asarray(ckpt.itpc, np.int64),
        fingerprint=np.bytes_(ckpt.fingerprint.encode()),
    )
    written = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(written, path)


def load_multi_checkpoint(
    path: str, fingerprint: str
) -> Optional[MultiCGCheckpoint]:
    """Load a block-CG checkpoint if it matches the problem; else None."""
    if not os.path.isfile(path):
        return None
    try:
        with np.load(path) as data:
            stored = bytes(data["fingerprint"]).decode()
            if stored != fingerprint or "itpc" not in data:
                return None
            return MultiCGCheckpoint(
                x=data["x"], r=data["r"], d=data["d"],
                delta=data["delta"], delta0=data["delta0"],
                iteration=int(data["iteration"]),
                itpc=data["itpc"],
                fingerprint=stored,
            )
    except (OSError, KeyError, ValueError):
        return None


def run_segments(solve, place, *, fingerprint: str, epsilon: float, max_iter: int,
                 path: str, interval: int, multi: bool = False, ridge: bool = False,
                 label: str = "CG", group=None, bounds=None):
    """A CG solve in segments of ``interval`` iterations with its state
    saved between them (plssvm_tpu's ``_fit_with_checkpointing``,
    ``_run_ridge_segments`` and ``_run_segments_multihost``): a file at
    ``path`` that matches ``fingerprint`` is resumed from, and the file
    goes when the solve ends.

    ``solve(seg_end, init_state)`` runs the core (``init_state`` None for
    the cold start) and returns its result (``ridge``: ``ridge_cg_core``'s
    tuple; ``multi``: the block CG's, saved with its per-class counts);
    ``place(ckpt)`` makes a checkpoint the core's ``init_state`` on the
    solve's device.  Every decision reads the solve's (joint) scalars.
    With ``group`` (parallel/multihost.py's ``RankGroup``, each rank
    holding its rows ``bounds[rank]`` of the state) every rank reads the
    file after a barrier, the state is gathered from every rank, rank 0
    alone writes and removes the file, and a barrier follows each write.
    """
    from ..utils.logger import VerbosityLevel, log

    writer = group is None or group.rank == 0

    def barrier():
        if group is not None:
            group.barrier()

    def whole(t):
        return _host(t if group is None else group.all_gather_rows(t, bounds))

    barrier()
    ckpt = (load_multi_checkpoint if multi else load_checkpoint)(path, fingerprint)
    if ckpt is not None and writer:
        log(VerbosityLevel.FULL, "Resuming {} from checkpoint '{}' at iteration {}.\n",
            label, path, ckpt.iteration)
    while True:
        if ckpt is None:
            res = solve(min(interval, max_iter), None)
        else:
            res = solve(min(int(ckpt.iteration) + interval, max_iter), place(ckpt))
        if ridge:
            x, r, d, delta, delta0, iterations = res
        else:
            x, r, d, delta, delta0 = res.x, res.r, res.d, res.delta, res.delta0
            iterations = int(res.iterations)
        delta, delta0 = _host(delta), _host(delta0)
        if bool(np.all(delta <= float(epsilon) ** 2 * delta0)) or iterations >= max_iter:
            break
        if ckpt is not None and iterations <= int(ckpt.iteration):
            # no forward progress: the solver's in-dtype stop target can be
            # minutely looser than this float64 check at the boundary
            break
        fields = dict(x=whole(x), r=whole(r), d=whole(d), iteration=iterations,
                      fingerprint=fingerprint)
        if multi:
            ckpt = MultiCGCheckpoint(delta=delta, delta0=delta0,
                                     itpc=_host(res.iterations_per_class), **fields)
            if writer:
                save_multi_checkpoint(path, ckpt)
        else:
            ckpt = CGCheckpoint(delta=float(delta), delta0=float(delta0), **fields)
            if writer:
                save_checkpoint(path, ckpt)
        barrier()
    # solved: the checkpoint is stale now
    if writer:
        try:
            if os.path.isfile(path):
                os.remove(path)
        except OSError:
            pass
    barrier()
    return res
