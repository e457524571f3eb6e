"""Scaling sweep of the row-sharded CG fit over device counts.

    python -m plssvm_tpu_torch.tools.scaling_sweep [--n 32768] [--d 256]
        [--iters 25] [--devices cpu|default] [--mesh-sizes 1,2,4]
        [--kernel rbf] [--performance_tracking FILE] [--multihost]

The counterpart of tools/scaling_sweep.py, with its arguments.  For each
entry k of ``--mesh-sizes`` it fits seeded data (n x d normal rows in
float32, labels the sign of the first feature, gamma = 1/d) with
``CSVM(devices=[...] * k)``, the row-sharded ring of parallel/sharded.py
(k = 1: one device), and reports CG iterations a second and the scaling
efficiency against the first entry's rate a device.  ``--devices cpu``
shards over CPU entries (default sizes 1, 2, 4); ``default`` over the CUDA
devices, repeated where k exceeds them (default sizes 1, 2, 4, ... up to
the cards).  A fit's CG rate is the marginal one: (iters - 1) / (t(iters)
- t(1)) for the seconds t of a fit capped at ``iters`` and at one
iteration (epsilon 1e-30, so neither stops early), each the best of two
after a warm-up, with CUDA events on the card; the fits log nothing.

``--multihost`` runs the leg of one process of a ``torch.distributed``
job (torchrun's environment, as the port's ``fit_multihost`` reads it;
gloo on the CPU): every rank writes the same seeded data to a file of its
own, times the fit of its own device alone as the baseline and then
``CSVM.fit_multihost`` over the job, and rank 0 prints the line and writes
the tracker's YAML.  ``--performance_tracking FILE`` appends the results
in the tracker's schema (categories scaling and parameter).  A rate from a
CPU run says nothing about a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from ..csvm import CSVM
from ..data_set import DataSet
from ..utils.logger import VerbosityLevel, set_verbosity
from ..utils.tracker import add_tracking_entry, global_tracker
from . import seconds

EPSILON = 1e-30


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.scaling_sweep",
        description="CG iterations a second of the row-sharded fit over device counts.",
    )
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--iters", type=int, default=25,
                    help="CG iterations to run per mesh size")
    ap.add_argument("--devices", default="default", choices=["cpu", "default"])
    ap.add_argument("--mesh-sizes", default=None,
                    help="comma-separated device counts (default: 1,2,4,.., the cards)")
    ap.add_argument("--kernel", default="rbf")
    ap.add_argument("--performance_tracking", metavar="FILE", default=None,
                    help="append the sweep results to FILE in the tracker YAML schema")
    ap.add_argument("--multihost", action="store_true",
                    help="one process of a torch.distributed job (torchrun's "
                    "environment): fit_multihost over the job against the rank's "
                    "device alone")
    return ap


def _data(n: int, d: int):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(X[:, 0] > 0, 1, -1)
    return X, y


def _rate(fit, iters: int, device) -> float:
    """CG iterations a second of ``fit(max_iter)``: the marginal rate
    between a fit of ``iters`` iterations and one of one, each the best of
    two after a warm-up."""
    fit(1)
    fit(iters)
    one = min(seconds(lambda: fit(1), device) for _ in range(2))
    full = min(seconds(lambda: fit(iters), device) for _ in range(2))
    return (iters - 1) / max(full - one, 1e-12)


def _save(path, entries) -> None:
    """The sweep's own entries alone (the fits' tracker entries dropped)
    appended to ``path``."""
    global_tracker.clear()
    for category, key, value in entries:
        add_tracking_entry(category, key, value)
    global_tracker.save(path)


def _main_multihost(args) -> int:
    from ..parallel.multihost import RankGroup, initialize_distributed, rank_device

    set_verbosity(VerbosityLevel.QUIET)
    initialize_distributed()
    # the rank's device (PLSSVM_TPU_TORCH_RANK_DEVICE, else cuda:LOCAL_RANK)
    svm = CSVM(device=rank_device(), kernel_type=args.kernel, gamma=1.0 / args.d)
    group = RankGroup(svm.device)
    X, y = _data(args.n, args.d)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"scaling_sweep.rank{group.rank}.libsvm")
        DataSet(X, y).save(path)
        alone = CSVM(device=svm.device, kernel_type=args.kernel, gamma=1.0 / args.d)
        data = DataSet(X, y)
        base = _rate(lambda it: alone.fit(data, epsilon=EPSILON, max_iter=it),
                     args.iters, svm.device)
        rate = _rate(lambda it: svm.fit_multihost(path, epsilon=EPSILON, max_iter=it),
                     args.iters, svm.device)
    eff = rate / (base * group.world) * 100.0
    if group.rank == 0:
        print(f"processes={group.world}  devices={group.world:3d}  "
              f"baseline {base:8.2f} CG it/s/device  global {rate:8.2f} CG it/s  "
              f"scaling efficiency {eff:6.1f}%", flush=True)
        if args.performance_tracking:
            _save(args.performance_tracking, [
                ("scaling", "num_processes", group.world),
                ("scaling", "num_devices", group.world),
                ("scaling", "baseline_cg_iterations_per_second", base),
                ("scaling", "cg_iterations_per_second", rate),
                ("scaling", "efficiency_percent", eff),
                ("parameter", "num_data_points", args.n),
                ("parameter", "num_features", args.d),
                ("parameter", "kernel_type", args.kernel)])
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    set_verbosity(VerbosityLevel.QUIET)
    if args.multihost:
        return _main_multihost(args)
    if args.devices == "cpu":
        pool, top = [torch.device("cpu")], 4
    else:
        if not torch.cuda.is_available():
            print("scaling_sweep --devices default runs on CUDA devices, and none is "
                  "available; --devices cpu runs it on the CPU", file=sys.stderr)
            return 1
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        top = len(pool)
    if args.mesh_sizes:
        sizes = [int(s) for s in args.mesh_sizes.split(",")]
    else:
        sizes, k = [], 1
        while k <= top:
            sizes.append(k)
            k *= 2
    X, y = _data(args.n, args.d)
    data = DataSet(X, y)
    base_per_dev = None
    entries = []
    for k in sizes:
        devices = [pool[i % len(pool)] for i in range(k)]
        kw = dict(kernel_type=args.kernel, gamma=1.0 / args.d)
        svm = CSVM(device=devices[0], **kw) if k == 1 else CSVM(devices=devices, **kw)
        rate = _rate(lambda it: svm.fit(data, epsilon=EPSILON, max_iter=it), args.iters,
                     devices[0])
        if base_per_dev is None:
            base_per_dev = rate / k
        eff = rate / (base_per_dev * k) * 100.0
        print(f"devices={k:3d}  {rate:8.2f} CG it/s  scaling efficiency {eff:6.1f}%",
              flush=True)
        entries += [("scaling", "num_devices", k),
                    ("scaling", "cg_iterations_per_second", rate),
                    ("scaling", "efficiency_percent", eff)]
    if args.performance_tracking:
        _save(args.performance_tracking, entries + [
            ("parameter", "num_data_points", args.n),
            ("parameter", "num_features", args.d),
            ("parameter", "kernel_type", args.kernel)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
