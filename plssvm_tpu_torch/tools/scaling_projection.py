"""Projected multi-card scaling of the row-sharded LS-SVM solve.

    python -m plssvm_tpu_torch.tools.scaling_projection [--devices 8]
        [--m_per_dev 512] [--d 256] [--tflops T] [--link-bytes-per-s B]
        [--json]

The counterpart of tools/scaling_projection.py, with its arguments.  The
JAX tool counts the collectives XLA compiles into the sharded solve; here
the transfers are counted where the port makes them, in the ring over
processes of parallel/multihost.py: ``--devices`` CPU ranks (gloo, one
process each, torchrun's environment) fit the same seeded data (``m_per_dev``
rows a rank, ``d`` features, ``solver="cg_implicit"``), once capped at 3
CG iterations and once at 5, and each rank counts what its
``RankGroup`` sends: the point-to-point messages of ``exchange`` (the ring
rotating its row chunks and sending the transposed outputs back) and the
``all_gather``-ed partials of the CG's scalars (and, for the linear
kernel, of its factored product), with their bytes.  Half the difference
of the two fits is one CG iteration's inventory, one product and its
reductions; the RBF fit shows rotations and gathers, the linear one
gathers only.

``ring_model`` projects the seconds of a CG iteration of the 1M x 1k RBF
problem over P cards from the ring's own traffic (floor(P / 2) rotations
of a row chunk with its norms and weights, (n / P)(d + 2) 4 bytes, and
floor((P - 1) / 2) transposed outputs of (n / P) 4 bytes, over one link a
direction) and a single card's rate: ``--tflops`` (in full-matrix Gram
flops, 2 n^2 d), or measured at start-up by kernel A on the card (RBF,
16384 x 1024, float32 at "f32": the median of 5 launches with CUDA
events).  Without a card and without ``--tflops`` there is no rate, and
no projection.  The link's rate is ``--link-bytes-per-s``, by default
NVLink's 450 GB/s a direction of an H100 SXM (NVIDIA's H100 data sheet:
900 GB/s a card, both directions).  Both the overlapped (max) and the
serialized (sum) estimates are given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: NVLink's rate a direction of one H100 SXM (NVIDIA's H100 data sheet:
#: 900 GB/s a card, both directions together)
H100_NVLINK_BYTES_PER_S = 450e9
#: the fits' CG caps: half their difference is one iteration
CAPS = (3, 5)
KINDS = ("rbf", "linear")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.scaling_projection",
        description="Count the ring's transfers a CG iteration and project "
                    "multi-card scaling.",
    )
    ap.add_argument("--devices", type=int, default=8, help="CPU ranks of the count")
    ap.add_argument("--m_per_dev", type=int, default=512)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--tflops", type=float, default=None,
                    help="a single card's rate in full-matrix Gram TFLOP/s "
                    "(default: kernel A measured on the card at start-up)")
    ap.add_argument("--link-bytes-per-s", type=float, default=H100_NVLINK_BYTES_PER_S,
                    help="one link's rate a direction (default: H100 SXM NVLink, "
                    "450e9, NVIDIA's H100 data sheet)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--worker", metavar="DIR", default=None, help=argparse.SUPPRESS)
    return ap


def _count(group_cls, counts: dict) -> None:
    """Wrap ``RankGroup.exchange`` and ``all_gather`` to count the messages
    this rank sends and their bytes."""
    exchange, all_gather = group_cls.exchange, group_cls.all_gather

    def counted_exchange(self, sends, receives):
        entry = counts.setdefault("exchange", {"count": 0, "bytes": 0})
        entry["count"] += len(sends)
        entry["bytes"] += sum(t.numel() * t.element_size() for _, t in sends)
        return exchange(self, sends, receives)

    def counted_all_gather(self, t):
        if self.up:
            entry = counts.setdefault("all_gather", {"count": 0, "bytes": 0})
            entry["count"] += 1
            entry["bytes"] += t.numel() * t.element_size() * (self.world - 1)
        return all_gather(self, t)

    group_cls.exchange = counted_exchange
    group_cls.all_gather = counted_all_gather


def _worker(args) -> int:
    """One rank: the fits of each kind at both caps, counted."""
    from ..csvm import CSVM
    from ..data_set import DataSet
    from ..parallel import multihost
    from ..utils.logger import VerbosityLevel, set_verbosity

    set_verbosity(VerbosityLevel.QUIET)
    multihost.initialize_distributed()
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    rng = np.random.default_rng(0)
    X = rng.normal(size=(world * args.m_per_dev, args.d)).astype(np.float32)
    y = np.where(X[:, 0] > 0, 1, -1)
    path = os.path.join(args.worker, f"data.rank{rank}.libsvm")
    DataSet(X, y).save(path)
    counts: dict = {}
    _count(multihost.RankGroup, counts)
    record = {}
    for kind in KINDS:
        svm = CSVM(device="cpu", kernel_type=kind, gamma=1.0 / args.d, solver="cg_implicit")
        per_cap = []
        for cap in CAPS:
            counts.clear()
            model = svm.fit_multihost(path, epsilon=1e-30, max_iter=cap)
            per_cap.append({op: dict(c) for op, c in counts.items()})
            assert model.n_iter == cap, (model.n_iter, cap)
        iteration = {}
        for op in set(per_cap[0]) | set(per_cap[1]):
            lo = per_cap[0].get(op, {"count": 0, "bytes": 0})
            hi = per_cap[1].get(op, {"count": 0, "bytes": 0})
            steps = CAPS[1] - CAPS[0]
            iteration[op] = {"count": (hi["count"] - lo["count"]) / steps,
                             "bytes": (hi["bytes"] - lo["bytes"]) / steps}
        record[kind] = iteration
    with open(os.path.join(args.worker, f"rank{rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(record, fh)
    return 0


def measure_transfers(world: int, m_per_dev: int, d: int, timeout: float = 600.0) -> dict:
    """Rank 0's transfers a CG iteration, per kind, from ``world`` CPU ranks:
    ``{"rbf": {"exchange": {"count", "bytes"}, "all_gather": {...}},
    "linear": {...}}``."""
    from .multihost_rehearsal import free_port

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = []
        for rank in range(world):
            env = dict(os.environ)
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), PLSSVM_TPU_TORCH_RANK_DEVICE="cpu",
                       PLSSVM_TPU_TORCH_DIST_BACKEND="gloo",
                       PLSSVM_TPU_TORCH_DIST_TIMEOUT=str(timeout),
                       OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join(
                           [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                                     if p]))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "plssvm_tpu_torch.tools.scaling_projection",
                 "--worker", out, "--m_per_dev", str(m_per_dev), "--d", str(d)],
                env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + timeout
        try:
            for rank, proc in enumerate(procs):
                output, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
                if proc.returncode != 0:
                    raise RuntimeError(f"rank {rank} failed ({proc.returncode}):\n"
                                       f"{output[-3000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
        with open(os.path.join(out, "rank0.json"), encoding="utf-8") as fh:
            return json.load(fh)


def measure_card_tflops() -> float:
    """Kernel A's rate on the card in full-matrix Gram TFLOP/s (2 m^2 d
    over its time): RBF, 16384 x 1024 float32 at "f32", the median of 5
    launches with CUDA events after a warm-up."""
    import torch

    from ..ops.gram_matvec import gram_matvec_sym
    from ..parameter import KernelFunctionType

    m, d = 16384, 1024
    gen = torch.Generator().manual_seed(0)
    X = torch.randn((m, d), generator=gen).cuda()
    v = torch.randn((m,), generator=gen).cuda()
    sq = (X * X).sum(-1)
    kw = dict(kind=KernelFunctionType.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
    gram_matvec_sym(X, sq, v, **kw)
    times = []
    for _ in range(5):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        gram_matvec_sym(X, sq, v, **kw)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / 1e3)
    return 2.0 * m * m * d / float(np.median(times)) / 1e12


def ring_model(P: int, n: int, d: int, tflops: float, link: float) -> dict:
    """Seconds a CG iteration of the ring over P cards, and the scaling
    efficiency against one card: the compute, the full-matrix 2 n^2 d
    flops at ``tflops`` split over P; the traffic, floor(P / 2) rotations of
    (n / P)(d + 2) 4 bytes and floor((P - 1) / 2) transposed outputs of
    (n / P) 4 bytes at ``link`` bytes a second (each card sends and
    receives one message a step, on one link a direction)."""
    compute_s = (2.0 * n * n * d / (tflops * 1e12)) / P
    hop_bytes = (n / P) * (d + 2) * 4
    back_bytes = ((P - 1) // 2) * (n / P) * 4
    comm_s = ((P // 2) * hop_bytes + back_bytes) / link
    overlapped = max(compute_s, comm_s)
    serialized = compute_s + comm_s
    t1 = 2.0 * n * n * d / (tflops * 1e12)
    return {
        "cards": P,
        "compute_s_per_iter": compute_s,
        "comm_s_per_iter": comm_s,
        "projected_s_per_iter_overlapped": overlapped,
        "projected_s_per_iter_serialized": serialized,
        "scaling_efficiency_overlapped": t1 / (P * overlapped),
        "scaling_efficiency_serialized": t1 / (P * serialized),
    }


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.worker is not None:
        return _worker(args)
    result = {"transfers_per_cg_iteration": measure_transfers(
        args.devices, args.m_per_dev, args.d)}
    tflops, source = args.tflops, "--tflops"
    if tflops is None:
        import torch

        if torch.cuda.is_available():
            tflops = measure_card_tflops()
            source = f"kernel A measured on {torch.cuda.get_device_name(0)}"
    result["projection_1Mx1k_rbf"] = None if tflops is None else [
        ring_model(P, 1048576, 1024, tflops, args.link_bytes_per_s)
        for P in (1, 2, 4, 8, 16)]
    result["assumptions"] = {
        "link_bytes_per_s": args.link_bytes_per_s,
        "single_card_tflops": tflops,
        "single_card_tflops_source": source if tflops is not None else "not measured",
        "ranks": f"{args.devices} CPU ranks (gloo; m/P={args.m_per_dev}, d={args.d})",
    }
    if args.json:
        print(json.dumps(result, indent=1))
    else:
        for kind, inventory in result["transfers_per_cg_iteration"].items():
            print(f"{kind}: {inventory}")
        for row in result["projection_1Mx1k_rbf"] or ["no single-card rate: no projection"]:
            print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
