"""Performance sweep: fits of one (n, d) data set with a timeout, and the
performance tracker's YAML of each.

    python -m plssvm_tpu_torch.tools.performance_analysis --num_data_points N
        --num_features D --num_repeats R [--kernel rbf] [--epsilon 1e-3]
        [--timeout 600] [--performance_tracking tracking.yaml]
        [--intermediate_train_file train_data.libsvm] [--cpu]

The counterpart of tools/performance_analysis.py, with its arguments: it
generates two overlapping Gaussian blobs (the JAX tool's data, seed 0),
writes them to the intermediate LIBSVM file and reads them back for each
repeat, so that the tracker records the I/O times too, fits them with
``CSVM`` on the card (``--cpu``: on the CPU) under a ``--timeout`` of
seconds (SIGALRM; a fit past it is recorded as ``cg.timeout``) and appends
one tracker document a repeat to the ``--performance_tracking`` file
(``performance_tracker_yaml_parser`` reads it).
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np

from ..csvm import CSVM
from ..data_set import DataSet
from ..utils.tracker import add_tracking_entry, global_tracker
from . import tool_device


class CGTimeout(Exception):
    """A fit ran past the timeout."""


def fit_with_timeout(svm, data, eps, seconds):
    def handler(signum, frame):
        raise CGTimeout()

    old = signal.signal(signal.SIGALRM, handler)
    signal.alarm(seconds)
    try:
        return svm.fit(data, epsilon=eps)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def make_classification(n, d, seed):
    """Two overlapping Gaussian blobs, labels -1 and 1, rows shuffled."""
    rng = np.random.default_rng(seed)
    half = n // 2
    X = np.concatenate([
        rng.normal(-0.3, 1.0, size=(half, d)),
        rng.normal(+0.3, 1.0, size=(n - half, d)),
    ]).astype(np.float64)
    y = np.concatenate([-np.ones(half), np.ones(n - half)]).astype(np.int64)
    perm = rng.permutation(n)
    return X[perm], y[perm]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.performance_analysis",
        description="Fit one generated data set several times and track each fit.",
    )
    ap.add_argument("--num_data_points", required=True, type=int)
    ap.add_argument("--num_features", required=True, type=int)
    ap.add_argument("--num_repeats", required=True, type=int)
    ap.add_argument("--kernel", default="rbf", choices=["linear", "polynomial", "rbf"])
    ap.add_argument("--epsilon", default=1e-3, type=float)
    ap.add_argument("--timeout", default=600, type=int, help="per-fit timeout in seconds")
    ap.add_argument("--performance_tracking", default="tracking.yaml")
    ap.add_argument("--intermediate_train_file", default="train_data.libsvm")
    ap.add_argument("--cpu", action="store_true", help="fit on the CPU (default: the GPU)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = tool_device(args.cpu, "performance_analysis")
    if device is None:
        return 1
    n, d = args.num_data_points, args.num_features
    print(f"Generating data set {n}x{d}")
    X, y = make_classification(n, d, seed=0)
    DataSet(X, y).save(args.intermediate_train_file)
    for repeat in range(args.num_repeats):
        add_tracking_entry("parameter", "task", "train")
        add_tracking_entry("parameter", "kernel", args.kernel)
        add_tracking_entry("parameter", "repeat", repeat)
        data = DataSet(args.intermediate_train_file)
        svm = CSVM(device=device, kernel_type=args.kernel)
        start = time.perf_counter()
        try:
            fit_with_timeout(svm, data, args.epsilon, args.timeout)
        except CGTimeout:
            print(f"repeat {repeat}: fit timed out after {args.timeout}s", file=sys.stderr)
            add_tracking_entry("cg", "timeout", True)
        add_tracking_entry("", "total_time", (time.perf_counter() - start) * 1000.0)
        global_tracker.save(args.performance_tracking)
        print(f"repeat {repeat}: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
