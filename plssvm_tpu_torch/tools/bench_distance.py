"""Benchmark of the distance-kernel implicit matvec (kernel E).

    python -m plssvm_tpu_torch.tools.bench_distance [--m 65536] [--d 512]
        [--iters 4] [--kinds laplacian,chi_squared] [--cpu]

The counterpart of tools/bench_distance.py, with its arguments: per kind,
kernel E (``distance_matvec_sym``, the walk of csrc/distance.cu) beside
its plain version (``distance_matvec_plain``, rows in blocks of 2048, the
JAX tool's XLA row block) on the same operand, the absolute values of
seeded normal draws in float32 (chi-squared's domain), gamma = 1/d.  Each
is timed over ``iters`` normalised products ``v <- K v / |K v|`` with CUDA
events on the card, best of two after one untimed run.  One JSON line per
kind: ``{"<kind>": {"kernel": {"s_per_matvec", "top_per_s"}, "plain":
{...}, "speedup"}}``, TOP/s counted as the JAX tool counts them, 3 ops an
entry and feature for the laplacian and 6 for chi-squared (m^2 d entries).
``--cpu`` runs on the CPU, where kernel E's wrapper takes its plain
version; without it the tool runs on the GPU and fails where there is
none.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import distance, matvec
from ..parameter import KernelFunctionType
from . import seconds, tool_device

REPS = 2
#: ops an entry and feature, the JAX tool's cost model
OPS = {"laplacian": 3, "chi_squared": 6}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.bench_distance",
        description="Time kernel E, the distance-kernel matvec, beside its plain version.",
    )
    ap.add_argument("--m", type=int, default=65536)
    ap.add_argument("--d", type=int, default=512)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--kinds", default="laplacian,chi_squared")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    kinds = args.kinds.split(",")
    unknown = sorted(set(kinds) - set(OPS))
    if unknown:
        print(f"unknown kinds: {', '.join(unknown)} (have {', '.join(OPS)})", file=sys.stderr)
        return 2
    device = tool_device(args.cpu, "bench_distance")
    if device is None:
        return 1
    m, d, iters = args.m, args.d, args.iters
    rng = np.random.default_rng(0)
    X = torch.as_tensor(np.abs(rng.normal(size=(m, d))).astype(np.float32), device=device)
    v0 = torch.as_tensor(rng.normal(size=(m,)).astype(np.float32), device=device)
    gamma = float(np.float32(1.0 / d))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"bench_distance on {name}: m={m} d={d} iters={iters}", file=sys.stderr, flush=True)

    def run(mv):
        vv = v0
        for _ in range(iters):
            out = mv(vv)
            vv = out / torch.linalg.norm(out)

    for kind_name in kinds:
        kind = KernelFunctionType.from_string(kind_name)
        ops_per_mv = OPS[kind_name] * float(m) * m * d
        impls = {
            "kernel": lambda v, k=kind: distance.distance_matvec_sym(X, v, kind=k, gamma=gamma),
            "plain": lambda v, k=kind: matvec.distance_matvec_plain(
                X, v, kind=k, gamma=gamma, row_block=2048),
        }
        row = {}
        for impl, mv in impls.items():
            seconds(lambda: run(mv), device)  # untimed: warms up, builds the kernels
            best = min(seconds(lambda: run(mv), device) for _ in range(REPS))
            row[impl] = {"s_per_matvec": best / iters,
                         "top_per_s": ops_per_mv * iters / best / 1e12}
        row["speedup"] = row["plain"]["s_per_matvec"] / row["kernel"]["s_per_matvec"]
        print(json.dumps({kind_name: row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
