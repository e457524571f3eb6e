"""Time kernel N, the explicit solver's kernel matrix of a distance kernel
(csrc/kernel_matrix.cu, its symmetric walk), one checkout at a time.

    python -m plssvm_tpu_torch.tools.bench_kernel_matrix [--repeats N] [--cpu]

Cells: laplacian at config 2's 9999 x 200 (seeded normal rows, gamma =
1/d), chi-squared at 16384 x 256 and at chi2-width's 59999 x 784 (seeded
uniform rows normalised to sum 1, as histograms, gamma = 1/d), float32,
K stored in float32.  One JSON line per cell: ``ms``, the median of
``--repeats`` builds (5; at 59999 x 784, where K is 14.4 GB, 3) after one
untimed, with CUDA events; ``rel_err``, max|err| / max|plain| of sampled
rows of K (the first, the middle and the last) against the plain version's
rows (``kernel_matrix_rect_plain`` of those rows against X);
``symmetric``, whether K equals its transpose bit for bit.  Run from the
root of another checkout with this file copied into its ``tools/``, it
times that checkout's kernel, so two versions compare in separate
processes on one card.  The bounds are ``chip_smoke.py``'s
(``_n_bound``).  ``--cpu`` runs the plain version on the CPU at a
hundredth of the rows; without it the tool runs on the GPU, and fails
where there is none.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from ..ops import kernel_matrix
from ..parameter import KernelFunctionType
from . import seconds, tool_device

#: (kind, rows, features)
CELLS = (
    ("laplacian", 9999, 200),
    ("chi_squared", 16384, 256),
    ("chi_squared", 59999, 784),
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.bench_kernel_matrix",
        description="Time kernel N's symmetric walk (the explicit solver's kernel matrix).")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain version on the CPU (default: the GPU)")
    return ap


def measure(kind: str, m: int, d: int, device, repeats: int) -> dict:
    """One cell: the symmetric walk's ms, its error on sampled rows against
    the plain version and whether K came out symmetric."""
    gen = torch.Generator().manual_seed(m * 1000 + d)
    if kind == "laplacian":
        X = torch.randn(m, d, generator=gen, dtype=torch.float64)
    else:
        X = torch.rand(m, d, generator=gen, dtype=torch.float64)
        X = X / X.sum(-1, keepdim=True)
    X = X.to(device, torch.float32)
    kw = dict(kind=KernelFunctionType.from_string(kind), gamma=1.0 / d)

    def run():
        return kernel_matrix.kernel_matrix_sym(X, **kw)

    K = run()
    rows = sorted({0, m // 2, m - 1})
    want = kernel_matrix.kernel_matrix_rect_plain(X[rows], X, **kw)
    rel_err = float((K[rows] - want).abs().max() / want.abs().max())
    symmetric = bool(torch.equal(K, K.T))
    del K
    times = [seconds(run, device) for _ in range(repeats)]
    return {"kernel": "N", "kind": kind, "m": m, "d": d,
            "ms": statistics.median(times) * 1e3, "rel_err": rel_err, "symmetric": symmetric}


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = tool_device(args.cpu, "bench_kernel_matrix")
    if device is None:
        return 1
    scale = 100 if device.type == "cpu" else 1
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    for kind, m, d in CELLS:
        repeats = min(args.repeats, 3) if m * m * 4 > 8e9 else args.repeats
        row = measure(kind, max(m // scale, 1), d, device, repeats)
        print(json.dumps({**row, "device": where}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
