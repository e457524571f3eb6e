"""Multi-process training and predict on ``torch.distributed``.

Counterpart of plssvm_tpu/parallel/multihost.py.  plssvm_tpu runs one JAX
process per host and a mesh over every host's chips; here, as torch jobs
usually run, each process is one rank with one device (``cuda:LOCAL_RANK``
by default, the CPU when asked for), and the row-sharded ring of
parallel/sharded.py spans the ranks: rank p holds row shard p of
:func:`~plssvm_tpu_torch.parallel.sharded.shard_bounds` and nothing else of
X or of a CG vector while it solves.

- :func:`initialize_distributed` brings the process group up from
  torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or from explicit arguments, and does nothing in a plain
  single-process run or when the group is up already.  The backend is
  ``nccl`` for a CUDA rank and ``gloo`` for a CPU rank.
- :class:`RankGroup` is the transport.  Scalars are ``all_gather``-ed and
  the partials summed in rank order (NCCL fixes no order for an
  ``all_reduce`` sum): the reference's ``psum(compensated_dot(a_p, b_p))``,
  each rank folding its rows zero-padded to the shards' common height, as
  the single-process ring folds each shard (``sharded.shard_partial``).
  The ring's rotation of ``(X_q, sq_q, v_q)`` and the return of each dual
  walk's transposed output are ``batch_isend_irecv`` (the reference's
  ``ppermute``).  Where gloo carries a CUDA rank's tensors, they go
  through pinned host memory, and the bytes staged are counted
  (``staged_bytes``, the tracker's ``multihost.staged_bytes``).
- :func:`rank_product` / :func:`rank_reductions` are the CG cores'
  ``kernel_mv`` and scalars over the ranks; every host-side decision of the
  cores reads gathered values, so all ranks take the same branch.
- :func:`fit_multihost`, :func:`predict_multihost` and the one-class and
  Nystroem fits (one_class.py, sparse.py): each rank parses its row window
  of the file (``native/loader.py``, ARFF through
  ``io/arff.py::parse_arff_file_window``), verdicts that could stop one
  rank alone (the line index, chi-squared's non-negative data, the solver
  choice) are reached from gathered values, checkpoint segments run
  ``solver/checkpoint.py::run_segments`` over the ranks (rank 0 writes),
  and every rank returns the same model.

The same inputs give the single-process ring's answer
(``CSVM(devices=[...] * W)``) bit for bit on CPU ranks: the shards, the
order of the ring's steps and the summation trees are the same.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..exceptions import InvalidFileFormatError, InvalidParameterError
from ..kernel_functions import DISTANCE_KERNELS
from ..parameter import KernelFunctionType
from .sharded import (
    _block_products,
    fill_kernel_columns,
    scalar_fold,
    shard_bounds,
    shard_operands,
    shard_partial,
    sum_partials,
)

#: the device of this process's rank ("cuda:0" puts every rank of a
#: one-card rehearsal on that card, "cpu" every rank on the CPU); by
#: default ``cuda:LOCAL_RANK``
RANK_DEVICE_ENV = "PLSSVM_TPU_TORCH_RANK_DEVICE"
#: the process group's backend, over the default (nccl for a CUDA rank,
#: gloo for a CPU rank): NCCL puts no two ranks on one card
BACKEND_ENV = "PLSSVM_TPU_TORCH_DIST_BACKEND"
#: seconds a collective may wait before it fails (and a hung rank with it)
TIMEOUT_ENV = "PLSSVM_TPU_TORCH_DIST_TIMEOUT"

#: bytes staged through pinned host memory for gloo since the last reset
staged_bytes = 0


def reset_counts() -> None:
    """Zero :data:`staged_bytes`."""
    global staged_bytes
    staged_bytes = 0


def _multi_process_env() -> bool:
    """Whether the environment is a launch of several processes.

    Environment only, as the reference's detection: ``WORLD_SIZE`` above 1
    (torchrun sets it with ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
    a launch that leaves one of those out fails loudly in
    ``init_process_group``, where guessing a single process would train W
    separate models).  No SLURM or MPI variables: N independent
    single-process fits under one SLURM job must not be fused into one
    wrong group; such a launcher sets torchrun's variables or passes the
    arguments of :func:`initialize_distributed`.
    """
    try:
        return int(os.environ.get("WORLD_SIZE", "1")) > 1
    except ValueError:
        return False


def rank_device(device=None) -> Optional[torch.device]:
    """This rank's device: ``device``, else ``PLSSVM_TPU_TORCH_RANK_DEVICE``,
    else ``cuda:LOCAL_RANK`` where CUDA is available, else None (a CSVM
    then asks for the CPU itself, or refuses to run)."""
    if device is None:
        device = os.environ.get(RANK_DEVICE_ENV)
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return None


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout: Optional[float] = None,
) -> None:
    """Bring up the process group of a multi-process run.

    With no arguments it reads torchrun's environment (``env://``), and
    does nothing for a plain single-process run (no ``WORLD_SIZE`` above
    1); it does nothing when the group is up already.  ``init_method``
    (``tcp://host:port``), ``world_size`` and ``rank`` set up a group the
    environment does not describe.  ``backend`` (or
    ``PLSSVM_TPU_TORCH_DIST_BACKEND``) overrides ``nccl`` for a CUDA rank
    and ``gloo`` for a CPU rank; ``device`` (or
    ``PLSSVM_TPU_TORCH_RANK_DEVICE``) is the rank's device, made CUDA's
    current device, so that a ``CSVM()`` of this process lies there.
    ``timeout`` (or ``PLSSVM_TPU_TORCH_DIST_TIMEOUT``) seconds bounds
    every collective.
    """
    import torch.distributed as dist

    if not dist.is_available():
        raise InvalidParameterError("torch.distributed is not available in this torch build!")
    if dist.is_initialized():
        return
    if init_method is None and world_size is None and rank is None \
            and not _multi_process_env():
        return
    dev = rank_device(device)
    if backend is None:
        backend = os.environ.get(BACKEND_ENV) or (
            "nccl" if dev is not None and dev.type == "cuda" else "gloo")
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    if timeout is None and os.environ.get(TIMEOUT_ENV):
        timeout = float(os.environ[TIMEOUT_ENV])
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl" and dev is not None and dev.index is not None:
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kwargs)


class RankGroup:
    """This process's rank, the job's world and the transport of tensors.

    Outside a process group it is rank 0 of a world of 1 and moves nothing.
    Inside one, NCCL carries the rank device's tensors, gloo host tensors:
    a CUDA rank on gloo stages each tensor through pinned host memory (a
    buffer per shape, reused), counted in :data:`staged_bytes`.
    """

    def __init__(self, device):
        import torch.distributed as dist

        self.device = torch.device(device)
        self.up = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.up else 0
        self.world = dist.get_world_size() if self.up else 1
        backend = dist.get_backend() if self.up else None
        if backend == "nccl" and self.device.type != "cuda":
            raise InvalidParameterError(
                f"the process group runs nccl, which carries no {self.device} tensors: "
                "a CPU rank takes the gloo backend!")
        self.staged = self.up and backend != "nccl" and self.device.type == "cuda"
        self._pinned: dict = {}

    # -- moving tensors ----------------------------------------------------
    def _buffer(self, slot, shape, dtype) -> torch.Tensor:
        """A tensor the transport sends or receives into: a pinned host
        buffer for ``slot`` when staged, else one on the wire's device."""
        if not self.staged:
            wire = self.device if self.device.type == "cuda" else "cpu"
            return torch.empty(shape, dtype=dtype, device=wire)
        key = (slot, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return buf

    def _send_form(self, t: torch.Tensor, slot) -> torch.Tensor:
        global staged_bytes
        t = t.contiguous()
        if not self.staged:
            return t
        buf = self._buffer(slot, t.shape, t.dtype)
        buf.copy_(t)
        staged_bytes += t.numel() * t.element_size()
        return buf

    def _arrived(self, buf: torch.Tensor) -> torch.Tensor:
        """A received buffer as a tensor of the rank's device."""
        global staged_bytes
        if not self.staged:
            return buf
        staged_bytes += buf.numel() * buf.element_size()
        return buf.to(self.device)

    def exchange(self, sends: Sequence[Tuple[int, torch.Tensor]],
                 receives: Sequence[Tuple[int, tuple, torch.dtype]]) -> List[torch.Tensor]:
        """Point-to-point messages in one ``batch_isend_irecv``: each
        ``(peer, tensor)`` of ``sends`` goes to its peer, each ``(peer,
        shape, dtype)`` of ``receives`` comes from its; the received
        tensors, in order, on the rank's device.  The k-th send to a peer
        meets that peer's k-th receive from this rank (a tag each)."""
        import torch.distributed as dist

        ops, bufs = [], []
        for k, (peer, t) in enumerate(sends):
            ops.append(dist.P2POp(dist.isend, self._send_form(t, ("send", k)), peer, tag=k))
        for k, (peer, shape, dtype) in enumerate(receives):
            buf = self._buffer(("recv", k), shape, dtype)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer, tag=k))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [self._arrived(buf) for buf in bufs]

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on all ranks), in rank order, on
        the rank's device."""
        import torch.distributed as dist

        if not self.up:
            return [t]
        mine = self._send_form(t, "gather")
        outs = [self._buffer(("gathered", r), mine.shape, mine.dtype)
                for r in range(self.world)]
        dist.all_gather(outs, mine)
        return [self._arrived(o) for o in outs]

    def sum_in_rank_order(self, partial: torch.Tensor, skip: Sequence[int] = ()) -> torch.Tensor:
        """The ranks' partials summed in rank order (ranks in ``skip``
        left out): the single-process ring's ``sum_partials``."""
        parts = self.all_gather(partial)
        return sum_partials([p for r, p in enumerate(parts) if r not in skip])

    def all_gather_rows(self, t: torch.Tensor, bounds) -> torch.Tensor:
        """The whole tensor whose row range ``bounds[r]`` rank r holds as
        ``t``: each rank's rows zero-padded to the tallest, gathered, and
        joined in rank order."""
        height = max(hi - lo for lo, hi in bounds)
        padded = t.new_zeros((height,) + t.shape[1:])
        padded[:t.shape[0]] = t
        parts = self.all_gather(padded)
        return torch.cat([part[:hi - lo] for part, (lo, hi) in zip(parts, bounds)])

    def host_values(self, values) -> np.ndarray:
        """Every rank's float64 ``values`` as a (world, k) host array."""
        mine = torch.as_tensor(np.asarray(values, dtype=np.float64).reshape(-1),
                               device=self.device)
        return torch.stack(self.all_gather(mine)).cpu().numpy()

    def agree(self, flag: bool) -> bool:
        """True when ``flag`` holds on every rank."""
        if not self.up:
            return bool(flag)
        return bool(np.all(self.host_values([1.0 if flag else 0.0]) > 0.5))

    def barrier(self) -> None:
        """Wait for every rank (a gathered zero, on any backend)."""
        if self.up:
            self.host_values([0.0])


def rank_bounds(group: RankGroup, rows: int) -> List[Tuple[int, int]]:
    """The row ranges of ``rows`` rows over the ranks, one a rank, as the
    single-process ring splits them over as many shards; too few rows for
    the ranks raises."""
    if rows < group.world:
        raise InvalidParameterError(
            f"{rows} rows cannot be split over {group.world} processes: a multi-process "
            "fit needs at least one row a process!")
    return shard_bounds(rows, group.world)


def _windows_of(n: int, world: int) -> List[Tuple[int, int]]:
    """The row windows of n rows over ``world`` ranks for a read that
    needs no row a rank: ``shard_bounds``, or one row each for the first n
    ranks when there are fewer rows than ranks."""
    if n >= world:
        return shard_bounds(n, world)
    return [(min(r, n), min(r + 1, n)) for r in range(world)]


def _this_rank(group=None):
    """``group``, or this process's (rank, world) in the process group as
    one (rank 0 of 1 outside a group)."""
    if group is not None:
        return group
    import torch.distributed as dist
    from types import SimpleNamespace

    up = dist.is_available() and dist.is_initialized()
    return SimpleNamespace(rank=dist.get_rank() if up else 0,
                           world=dist.get_world_size() if up else 1)


def host_row_range(total_rows: int, group=None) -> Tuple[int, int]:
    """[begin, end) of the ``total_rows`` rows this process owns: its range
    of :func:`~plssvm_tpu_torch.parallel.sharded.shard_bounds` over the
    ranks (the first ``total_rows % world`` one row longer), the rows no
    padding: plssvm_tpu pads its row axis to the device count instead."""
    group = _this_rank(group)
    return rank_bounds(group, total_rows)[group.rank]


# ---------------------------------------------------------------------------
# The ring's product and the scalars over the ranks
# ---------------------------------------------------------------------------


def rank_reductions(group: RankGroup, bounds, scalars: str):
    """(dot, vsum, colsum) over the ranks: this rank's partial over its
    rows zero-padded to the common height (``shard_partial``, compensated
    with ``scalars="compensated"``), every rank's gathered and summed in
    rank order: the single-process ring's sums, bit for bit."""
    fold = scalar_fold(scalars)
    height = max(hi - lo for lo, hi in bounds)

    def total(t):
        return group.sum_in_rank_order(shard_partial(fold, t, height))

    return (lambda a, b: total(a * b)), total, total


def rank_product(group: RankGroup, bounds, X: torch.Tensor, *, kind, degree: int,
                 impl: str, precision: str) -> Callable:
    """The cores' ``kernel_mv`` / ``kernel_mm`` over the ranks: this rank's
    rows of ``K @ v`` from its rows ``X`` and ``v``.

    The symmetric ring of ``sharded._symmetric_ring`` with one shard a
    rank: the diagonal block (A / C, E / G), then ``floor((W - 1) / 2)``
    dual steps, each after the held chunk ``(X_q, sq_q, v_q)`` moved one
    rank on (the reference's ``ppermute``), its transposed output sent back
    to its owner, which adds it after its own row output; for even W one
    rows-only step (B / D, F / H) on the antipodal chunk.  The linear
    kernel takes the factored ``X_p (sum_q X_q^T v_q)``.  The squared
    norms and this rank's tensor-core operand copy are made once per solve;
    a chunk that arrives makes its copy on arrival (one elementwise pass
    over it, where sending it beside X would double the bytes moved).
    """
    from ..ops.gram_matvec import tier_operand

    W, p = group.world, group.rank
    gram = kind not in DISTANCE_KERNELS and kind != KernelFunctionType.LINEAR
    sq = torch.sum(X * X, dim=-1) if gram else None
    operands = shard_operands([X], kind, impl, precision)
    operand = None if operands is None else operands[0]
    rows_of = [hi - lo for lo, hi in bounds]

    def rotate(held, q):
        """Pass the held chunk one rank on; returns chunk q, which the rank
        before held."""
        return group.exchange([((p + 1) % W, t) for t in held],
                              [((p - 1) % W, (rows_of[q],) + tuple(t.shape[1:]), t.dtype)
                               for t in held])

    def product(_X, _sq, v, gamma, coef0):
        if kind == KernelFunctionType.LINEAR:
            return X @ group.sum_in_rank_order(X.T @ v)
        own, dual, rows = _block_products(kind, degree, gamma, coef0, impl, precision,
                                          v.ndim == 2)
        acc = own(X, sq, v, operand=operand)
        held = [X, v] if sq is None else [X, sq, v]
        for s in range(1, (W - 1) // 2 + 1):
            q = (p - s) % W
            held = rotate(held, q)
            Xq, vq = held[0], held[-1]
            sq_q = None if sq is None else held[1]
            pair = None if operand is None else (operand, tier_operand(Xq, precision))
            r, c = dual(X, Xq, sq, sq_q, vq, v, operand=pair)
            back, = group.exchange([(q, c)], [((p + s) % W, tuple(r.shape), r.dtype)])
            acc = acc + r + back
        if W % 2 == 0:
            held = rotate(held, (p - W // 2) % W)
            acc = acc + rows(X, held[0], sq, None if sq is None else held[1], held[-1])
        return acc

    return product


def build_rank_kernel_matrix(group: RankGroup, bounds, X: torch.Tensor, gamma, coef0, *,
                             kind, degree: int, precision: str, impl: str) -> torch.Tensor:
    """This rank's row block ``K_p = k(X_p, X)`` of the explicit kernel
    matrix, one column block ``k(X_p, X_q)`` as each chunk X_q comes round
    the ring (kernel N's rect walk for the distance kernels, the Gram build
    for the others): no rank holds all of X.  The counterpart of
    ``build_sharded_kernel_matrix_fn``; the single-process ring builds its
    blocks column block by column block alike."""
    W, p = group.world, group.rank
    width = bounds[-1][1]
    kw = dict(kind=kind, degree=degree, precision=precision, impl=impl)
    K_p = fill_kernel_columns(None, X, X, bounds[p], width, gamma, coef0, **kw)
    held = X
    for s in range(1, W):
        q = (p - s) % W
        held, = group.exchange([((p + 1) % W, held)],
                               [((p - 1) % W, (bounds[q][1] - bounds[q][0], X.shape[1]),
                                 X.dtype)])
        K_p = fill_kernel_columns(K_p, X, held, bounds[q], width, gamma, coef0, **kw)
    return K_p


def rank_explicit_product(group: RankGroup, bounds, K_p: torch.Tensor) -> Callable:
    """The cores' product on the stored row block: v (or V) gathered from
    every rank (``all_gather``), then ``K_p @ v``, as the single-process
    ring's ``explicit_product`` of each block with the whole v."""
    from ..solver.explicit import explicit_product

    def product(X, _sq, v, gamma, coef0):
        return explicit_product(K_p, group.all_gather_rows(v, bounds), X.dtype)

    return product


# ---------------------------------------------------------------------------
# File windows and collective verdicts
# ---------------------------------------------------------------------------


def _window_failed(filename):
    return InvalidFileFormatError(
        f"windowed re-read of '{filename}' failed — file changed mid-read?")


class _FileWindows:
    """One file's metadata scan and its row windows: LIBSVM through the
    native window and selected-row readers, ARFF through
    ``parse_arff_file_window``; where the native parser is missing, the
    whole file parsed once and sliced."""

    def __init__(self, filename: str, dtype, with_spans: bool = True):
        from ..io.arff import parse_arff_file_window
        from ..native.loader import libsvm_line_spans, parse_libsvm_native_window

        self.filename, self.dtype = filename, dtype
        self.is_arff = filename.lower().endswith(".arff")
        meta = (parse_arff_file_window(filename, 0, 0, dtype=dtype) if self.is_arff
                else parse_libsvm_native_window(filename, 0, 0, dtype=dtype))
        self.X_all = None
        if meta is not None:
            _, self.raw_labels, self.n, self.d = meta
        else:
            if self.is_arff:
                from ..io.arff import parse_arff_file

                self.X_all, self.raw_labels = parse_arff_file(filename, dtype=dtype)
            else:
                from ..io.libsvm import parse_libsvm_file

                self.X_all, self.raw_labels = parse_libsvm_file(filename, dtype=dtype)
            self.n, self.d = self.X_all.shape
        self.spans = (libsvm_line_spans(filename)
                      if with_spans and self.X_all is None and not self.is_arff else None)

    def check_index(self, group: RankGroup) -> None:
        """The line index against the parse, a verdict of every rank (one
        rank raising alone would leave the others in their next
        collective)."""
        rows = -1 if self.spans is None else int(self.spans.shape[0])
        all_rows = group.host_values([rows])[:, 0]
        if any(r != -1 and r != self.n for r in all_rows):
            raise InvalidFileFormatError(
                f"line index ({sorted(set(int(r) for r in all_rows))} rows across "
                f"processes) disagrees with the parse ({self.n} rows) — file changed "
                "mid-read?")

    def rows(self, begin: int, end: int) -> np.ndarray:
        """Rows [begin, end) of the file, (end - begin, d)."""
        from ..native.loader import parse_libsvm_native_rows, parse_libsvm_native_window

        if end <= begin:
            return np.zeros((0, self.d), dtype=self.dtype)
        if self.X_all is not None:
            return np.asarray(self.X_all[begin:end], dtype=self.dtype)
        if self.spans is not None:
            rows = parse_libsvm_native_rows(self.filename, self.spans[begin:end], self.d,
                                            dtype=self.dtype)
        elif self.is_arff:
            from ..io.arff import parse_arff_file_window

            win = parse_arff_file_window(self.filename, begin, end, dtype=self.dtype)
            rows = None if win is None else win[0]
        else:
            win = parse_libsvm_native_window(self.filename, begin, end, dtype=self.dtype)
            rows = None if win is None else win[0]
        if rows is None:
            raise _window_failed(self.filename)
        return rows

    def selected(self, idx: np.ndarray) -> np.ndarray:
        """The rows at ``idx`` (sorted indices): one selected-row read
        where the line index exists."""
        from ..native.loader import parse_libsvm_native_rows

        if self.X_all is not None:
            return np.ascontiguousarray(np.asarray(self.X_all, dtype=self.dtype)[idx])
        if self.spans is not None:
            rows = parse_libsvm_native_rows(self.filename, self.spans[idx], self.d,
                                            dtype=self.dtype)
            if rows is None:
                raise _window_failed(self.filename)
            return rows
        return np.ascontiguousarray(self.rows(0, self.n)[idx])


def check_chi_squared(group: RankGroup, kind, local_min: float, message: str) -> None:
    """Chi-squared's non-negative data over every rank's rows: the ranks'
    minima gathered, so all of them raise or none (the reference's
    collective verdict).  ``message`` may place the lowest value at
    ``{}``."""
    if kind != KernelFunctionType.CHI_SQUARED:
        return
    lowest = float(np.min(group.host_values([local_min])))
    if lowest < 0.0:
        raise InvalidParameterError(message.format(lowest))


def _local_min(*arrays) -> float:
    return float(min([np.min(a) for a in arrays if a.size] or [0.0]))


def _identity_key(device: torch.device) -> float:
    """A number naming this rank's physical device: the host and the card
    (or the host's CPU), so that ranks sharing one card see the same key."""
    import socket

    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        name = str(getattr(props, "uuid", None) or torch.cuda.current_device())
    else:
        name = "cpu"
    digest = hashlib.sha256(f"{socket.gethostname()}|{name}".encode()).digest()
    return float(int.from_bytes(digest[:6], "little"))


def use_explicit_solver(csvm, group: RankGroup, bounds, d: int, kind, columns: int = 1) -> bool:
    """``csvm._use_explicit_solver`` over the ranks: each card's bytes are
    the row blocks ``K_p`` of every rank that shares it, with the column
    block each holds while it fills K_p, against a budget that subtracts
    every such rank's live tensors, workspace and context; every rank
    reads the same gathered table, so all take the same solver, or all
    raise."""
    if csvm.solver == "cg_implicit":
        return False
    dept = bounds[-1][1]
    lo, hi = bounds[group.rank]
    block = max(b - a for a, b in bounds)
    device = csvm.device
    held = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    table = group.host_values([_identity_key(device), csvm._explicit_k_bytes(hi - lo, dept),
                               csvm._explicit_k_bytes(hi - lo, block), held])
    needs = []
    for key in sorted(set(table[:, 0])):
        sharing = table[table[:, 0] == key]
        needs.append((float(np.sum(sharing[:, 1])), float(np.sum(sharing[:, 2])),
                      csvm._explicit_budget(device, dept, d, columns, ranks=sharing.shape[0],
                                            held=float(np.sum(sharing[:, 3])))))
    return csvm._use_explicit_solver(dept, d, kind, group.world, columns, needs=needs)


def _multihost_fingerprint(n_total: int, d: int, params_repr: str, epsilon: float,
                           x_last: np.ndarray, y_all: np.ndarray, rows: int) -> str:
    """A problem fingerprint every rank computes alike from global
    metadata: the shape, the parameters, the FULL label column (edited
    labels must invalidate a checkpoint), the folded-out last row (no rank
    holds the matrix, so the single-process fingerprint of the data does
    not apply) and the solved rows."""
    h = hashlib.sha256()
    h.update(repr((int(n_total), int(d), params_repr, float(epsilon), int(rows))).encode())
    h.update(np.ascontiguousarray(np.asarray(x_last, np.float64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(y_all, np.float64)).tobytes())
    return "mh-" + h.hexdigest()


def _record(window, rows: dict) -> None:
    """What this rank read and held in its fit, as the tracker's
    "multihost" entries: ``window`` [begin, end) of the file's rows it
    parsed, ``rows_X`` and ``rows_x`` / ``rows_r`` / ``rows_d`` the first
    dimension of its X and of each CG vector of the solve."""
    from ..utils.tracker import add_tracking_entry

    add_tracking_entry("multihost", "window", [int(window[0]), int(window[1])])
    for name, value in rows.items():
        add_tracking_entry("multihost", f"rows_{name}", int(value))


def _solve_rows(X, result) -> dict:
    """The first dimension of X and of each CG vector a solve held."""
    return dict(X=X.shape[0], x=result.x.shape[0], r=result.r.shape[0], d=result.d.shape[0])


def _track(group: RankGroup, start: float, iterations: int, residuum: float,
           libsvm: bool = True) -> None:
    """The tracker's entries of a fit and (``libsvm``) its LIBSVM line,
    once a job (rank 0); every rank records its staged bytes."""
    from ..utils.logger import VerbosityLevel, log
    from ..utils.tracker import add_tracking_entry

    add_tracking_entry("multihost", "staged_bytes", int(staged_bytes))
    if group.rank != 0:
        return
    if libsvm:
        log(VerbosityLevel.LIBSVM, "optimization finished, #iter = {}\n", iterations)
        add_tracking_entry("cg", "iterations", iterations)
        add_tracking_entry("cg", "residuum", residuum)
    add_tracking_entry("cg", "total_runtime", (time.perf_counter() - start) * 1000.0)
    add_tracking_entry("backend", "num_processes", group.world)


def rank_group(csvm) -> RankGroup:
    """The process group up (:func:`initialize_distributed` with the
    CSVM's device) and this rank's :class:`RankGroup` on it.  A CSVM with
    ``devices`` is refused: a rank holds one shard on one device."""
    if csvm.devices is not None:
        raise InvalidParameterError(
            "a multi-process fit runs one shard a process on the CSVM's device; a CSVM "
            "with devices (several shards a process) is not supported there!")
    initialize_distributed(device=csvm.device)
    group = RankGroup(csvm.device)
    if group.world > 1:
        # rank 0 builds what a cold cache lacks (the native parser; the
        # kernels' library on a CUDA rank), then every rank loads it: each
        # build is race-safe, but W ranks would each run g++ and nvcc
        if group.rank == 0:
            from ..native.loader import _get_lib

            _get_lib()
            if csvm.device.type == "cuda" and csvm._impl() == "cuda":
                from ..ops import _build

                _build.build()
        group.barrier()
    return group


# ---------------------------------------------------------------------------
# fit / predict
# ---------------------------------------------------------------------------


def fit_multihost(
    csvm,
    filename: str,
    *,
    epsilon: float = 0.001,
    max_iter: Optional[int] = None,
    label_type=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_interval: int = 1000,
    regression: bool = False,
    sample_weight=None,
    initial_model=None,
):
    """An LS-SVM fit of ``filename`` (on storage every rank reads) over the
    ranks of the job; plssvm_tpu's ``fit_multihost``.

    Each rank parses the file's metadata (n, d, the label column) and only
    its window of rows ``shard_bounds(n - 1, world)[rank]`` (plus the
    folded-out last row), and the CG solve runs on the ring of ranks:
    binary, one-vs-all block CG (more than two labels) or LS-SVR
    (``regression``), with the CSVM's solver rule (``cg_explicit`` builds
    each rank's row block of K), Gram tier, scalars, preconditioner and
    debug guards.  ``sample_weight`` (one per file row) and
    ``initial_model`` (re-aligned as ``CSVM.fit`` does) are sliced to each
    rank's window; ``checkpoint_path`` runs ``solver/checkpoint.py::run_segments``.  Every
    rank returns the same model, which holds every training point (each
    rank parses the whole file for it after the solve; one process parses
    nothing twice).  At one process it is ``CSVM.fit`` on the file, up to
    the order of its sums.
    """
    from types import SimpleNamespace

    from ..data_set import DataSet, LabelMapper, _infer_label_array
    from ..model import Model
    from ..solver.cg import cg_ls_svm_core, cg_ls_svm_multi_core
    from ..utils.tracker import add_tracking_entry

    start = time.perf_counter()
    group = rank_group(csvm)
    dtype = csvm.dtype
    windows = _FileWindows(filename, dtype)
    n_total, d = windows.n, windows.d
    if windows.raw_labels is None:
        raise InvalidParameterError(
            "No labels given for training! Maybe the data is only usable for prediction?")
    if regression:
        labels = np.asarray(_infer_label_array(list(windows.raw_labels), float),
                            dtype=np.float64)
        multiclass = False
        y_all = labels.astype(dtype)
    else:
        labels = _infer_label_array(list(windows.raw_labels), label_type)
        mapper = LabelMapper(labels)
        multiclass = mapper.num_mappings > 2
        y_all = (mapper.oaa_targets(labels, dtype=dtype) if multiclass
                 else mapper.map_labels(labels, dtype=dtype))
    if max_iter is None:
        max_iter = n_total
    dept = n_total - 1
    if sample_weight is not None:
        sample_weight = np.asarray(sample_weight, dtype=np.float64)
        if sample_weight.shape != (n_total,):
            raise InvalidParameterError(
                f"sample_weight must have one entry per data point ({n_total}), but has "
                f"shape {sample_weight.shape}!")
        if not np.all(sample_weight > 0.0):
            raise InvalidParameterError("sample_weight entries must all be positive!")
    params = csvm.params.copy()
    if params.gamma.is_default():
        params.gamma.value = 1.0 / d
    kind = params.kernel_type.value
    degree = params.degree.value

    bounds = rank_bounds(group, dept)
    lo, hi = bounds[group.rank]
    windows.check_index(group)
    X_win = windows.rows(lo, hi)
    x_last_row = windows.rows(dept, n_total)[0]
    check_chi_squared(group, kind, _local_min(X_win, x_last_row),
                      "The chi-squared kernel requires non-negative values, but the "
                      "training data contains {}!")

    X = csvm._tensor(X_win)
    x_last = csvm._tensor(x_last_row)
    y = csvm._tensor(y_all[lo:hi])
    y_last = csvm._tensor(y_all[dept]) if multiclass else float(y_all[dept])
    extras = dict(preconditioner=csvm.preconditioner, debug=csvm.debug, agree=group.agree)
    params_repr = repr(params)
    if sample_weight is not None:
        from ..solver.checkpoint import weights_digest_suffix

        extras["weights"] = csvm._tensor(sample_weight[lo:hi])
        extras["weight_last"] = float(sample_weight[-1])
        params_repr += weights_digest_suffix(sample_weight)
    if initial_model is not None:
        if initial_model.num_support_vectors != n_total:
            raise InvalidParameterError(
                f"initial_model has {initial_model.num_support_vectors} support vectors "
                f"but the data set has {n_total} points!")
        # the realignment needs only the label column, which every rank read
        view = SimpleNamespace(is_regression=regression, labels=labels,
                               different_labels=None if regression else mapper.labels())
        extras["x_init"] = csvm._tensor(csvm._warm_start_alpha(initial_model, view)[lo:hi])

    gamma, coef0 = params.resolved_gamma(d), params.coef0.value
    columns = y_all.shape[1] if multiclass else 1
    use_explicit = use_explicit_solver(csvm, group, bounds, d, kind, columns)
    add_tracking_entry("cg", "solver", "cg_explicit" if use_explicit else "cg_implicit")
    impl = csvm._impl()
    if use_explicit:
        build_start = time.perf_counter()
        K_p = build_rank_kernel_matrix(group, bounds, X, gamma, coef0, kind=kind,
                                       degree=degree, precision=csvm.gram_precision,
                                       impl=impl)
        if K_p.device.type == "cuda":
            torch.cuda.synchronize(K_p.device)
        add_tracking_entry("cg", "kernel_matrix_build_time",
                           (time.perf_counter() - build_start) * 1000.0)
        product = rank_explicit_product(group, bounds, K_p)
    else:
        product = rank_product(group, bounds, X, kind=kind, degree=degree, impl=impl,
                               precision=csvm.gram_precision)
    dot, vsum, colsum = rank_reductions(group, bounds, csvm.scalar_precision)
    reductions = dict(colsum=colsum) if multiclass else dict(dot=dot, vsum=vsum)
    core = cg_ls_svm_multi_core if multiclass else cg_ls_svm_core

    def solve(seg_end, init_state=None):
        return core(X, x_last, y, y_last, gamma, coef0, params.cost.value, epsilon, seg_end,
                    kind=kind, degree=degree, init_state=init_state,
                    **({"kernel_mm": product} if multiclass else {"kernel_mv": product}),
                    **reductions, **extras)

    def place(ckpt):
        state = tuple(torch.as_tensor(np.asarray(a, dtype=dtype), device=csvm.device)
                      for a in (ckpt.x[lo:hi], ckpt.r[lo:hi], ckpt.d[lo:hi], ckpt.delta,
                                ckpt.delta0)) + (ckpt.iteration,)
        if multiclass:
            state += (torch.as_tensor(ckpt.itpc, dtype=torch.int64, device=csvm.device),)
        return state

    solve_start = time.perf_counter()
    if checkpoint_path is None:
        result = solve(max_iter)
    else:
        from ..solver.checkpoint import run_segments

        fingerprint = _multihost_fingerprint(n_total, d, params_repr, epsilon, x_last_row,
                                             y_all, dept)
        result = run_segments(solve, place, fingerprint=fingerprint, epsilon=epsilon,
                              max_iter=int(max_iter), path=checkpoint_path,
                              interval=int(checkpoint_interval), multi=multiclass,
                              label="multi-process CG", group=group, bounds=bounds)
    x_sol = group.all_gather_rows(result.x, bounds).cpu().numpy()
    add_tracking_entry("multihost", "solve_ms", (time.perf_counter() - solve_start) * 1000.0)
    # the windows' parse, the placement, the solver's choice and any build
    add_tracking_entry("multihost", "setup_ms", (solve_start - start) * 1000.0)
    _record((lo, hi), _solve_rows(X, result))
    if multiclass:
        alpha = np.vstack([x_sol, result.alpha_last.cpu().numpy()[None, :]]).astype(dtype)
        rho = result.rho.cpu().numpy().astype(np.float64)
        residuum = float(torch.max(result.delta))
    else:
        alpha = np.concatenate([x_sol, [float(result.alpha_last)]]).astype(dtype)
        rho = float(result.rho)
        residuum = float(result.delta)
    iterations = int(result.iterations)
    _track(group, start, iterations, residuum)
    if multiclass:
        add_tracking_entry("cg", "iterations_per_class",
                           result.iterations_per_class.cpu().tolist())

    # the model holds every training point: one process has them all
    # parsed already, several parse the whole file now
    if group.world == 1:
        X_full = np.vstack([X_win, x_last_row[None, :]])
    else:
        X_full = windows.rows(0, n_total)
    model = Model(params, DataSet(X_full, labels, regression=regression, dtype=dtype),
                  alpha=alpha, rho=rho)
    model.n_iter = iterations
    return model


def predict_multihost(csvm, model, filename: str, *, dtype=None):
    """Each rank predicts its window of the test file ``filename`` (LIBSVM
    or ARFF, its rows ``shard_bounds(n, world)[rank]``) through
    ``csvm.predict`` on its device (kernels B / D, or F / H); the windows'
    predictions are gathered in rank order, so every rank returns the whole
    ``(n,)`` vector.  The labels of the file are read with the metadata,
    not used.  At one process it equals ``csvm.predict(model,
    DataSet(filename))``.  Returns ``(predictions, raw_labels_or_None,
    n)``; plssvm_tpu's ``predict_multihost``."""
    from ..data_set import DataSet

    group = rank_group(csvm)
    dtype = csvm.dtype if dtype is None else dtype
    windows = _FileWindows(filename, dtype, with_spans=False)
    n = windows.n
    bounds = _windows_of(n, group.world)
    lo, hi = bounds[group.rank]
    Xw = windows.rows(lo, hi)
    local = csvm.predict(model, DataSet(Xw, dtype=dtype)) if hi > lo else None
    if group.world == 1:
        return local, windows.raw_labels, n
    numeric = model.is_regression or model.is_one_class
    order = None if numeric else list(model.class_order())
    values = np.zeros(hi - lo, dtype=np.float64)
    if local is not None:
        if numeric:
            values[:] = np.asarray(local, dtype=np.float64)
        else:
            index_of = {str(lab): i for i, lab in enumerate(order)}
            values[:] = [index_of[str(lab)] for lab in local]
    flat = group.all_gather_rows(torch.as_tensor(values, device=csvm.device),
                                 bounds).cpu().numpy()
    if model.is_one_class:
        return flat.astype(np.int64), windows.raw_labels, n
    if numeric:
        return flat, windows.raw_labels, n
    return np.asarray(order)[flat.astype(np.intp)], windows.raw_labels, n


def parse_libsvm_rows_for_host(filename: str, total_rows_hint: Optional[int] = None,
                               dtype=np.float64, group=None):
    """This rank's rows of a LIBSVM file, and only those: ``(X_local,
    labels_local, total_rows, num_features)``, the window
    ``shard_bounds(n, world)[rank]`` of n rows (any n: the first ``n %
    world`` windows one row longer; ranks beyond n get none).  Every rank
    scans the file (d and the labels are global); the native window parser
    materialises only the window, the NumPy parser (no native library) the
    whole file, then slices it.  ``total_rows_hint`` skips nothing here:
    the scan reads n anyway, so a wrong hint cannot split the rows
    wrongly."""
    from ..native.loader import parse_libsvm_native_window

    group = _this_rank(group)
    meta = parse_libsvm_native_window(filename, 0, 0, dtype=dtype)
    if meta is not None:
        _, labels_all, n, d = meta
    else:
        from ..io.libsvm import parse_libsvm_file

        X, labels_all = parse_libsvm_file(filename, dtype=dtype)
        n, d = X.shape
    begin, end = _windows_of(n, group.world)[group.rank]
    if meta is None:
        X_local = X[begin:end]
    elif end > begin:
        X_local = parse_libsvm_native_window(filename, begin, end, dtype=dtype)[0]
    else:
        X_local = np.zeros((0, d), dtype=dtype)
    labels_local = labels_all[begin:end] if labels_all is not None else None
    return X_local, labels_local, n, d
