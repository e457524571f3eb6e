"""Time kernel A or C in float64 on the DMMA tile, one checkout at a time.

    python -m plssvm_tpu_torch.tools.bench_gram_f64 [m] [d] [classes] [kernel] [--repeats N] [--cpu]

``m`` rows (default 32768), ``d`` features (512), ``classes`` right-hand
sides (1: kernel A, ``K(X, X) @ v``; more: kernel C, ``K(X, X) @ V``),
``kernel`` polynomial, rbf or sigmoid (rbf).  ``X`` and ``V`` hold seeded
normal draws in float64, gamma = 1/d, coef0 = 0, degree 3.  The line gives
the median ms of ``--repeats`` launches of the wrapper (5) after one
untimed, with CUDA events, and ``rel_err``, max|err| / max|plain| against
the plain version.  Run from the root of another checkout (a variant of
the tile), it times that checkout's tile, so variants compare in separate
processes on one card.  The tile's bounds and the FFMA tile beside it are
``chip_smoke.py``'s.  ``--cpu`` runs the wrapper's plain version on the
CPU; without it the tool runs on the GPU, and fails where there is none.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from ..kernel_functions import DISTANCE_KERNELS
from ..ops import gram_matmat, gram_matvec, matvec
from ..parameter import KernelFunctionType
from . import seconds, tool_device


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.bench_gram_f64",
        description="Time kernel A or C in float64 on the DMMA tile.",
    )
    ap.add_argument("m", type=int, nargs="?", default=32768)
    ap.add_argument("d", type=int, nargs="?", default=512)
    ap.add_argument("classes", type=int, nargs="?", default=1)
    ap.add_argument("kernel", nargs="?", default="rbf")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain version on the CPU (default: the GPU)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    kind = KernelFunctionType.from_string(args.kernel)
    if kind == KernelFunctionType.LINEAR or kind in DISTANCE_KERNELS:
        print(f"kernels A and C take polynomial, rbf or sigmoid, not {kind}",
              file=sys.stderr)
        return 2
    device = tool_device(args.cpu, "bench_gram_f64")
    if device is None:
        return 1
    m, d, classes = args.m, args.d, args.classes
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(m, d)), device=device)
    V = torch.as_tensor(rng.normal(size=(m, classes) if classes > 1 else (m,)),
                        device=device)
    sq = (X * X).sum(-1)
    kw = dict(kind=kind, gamma=1.0 / d, coef0=0.0, degree=3)
    product = gram_matvec.gram_matvec_sym if classes == 1 else gram_matmat.gram_matmat_sym
    plain = matvec.kernel_matvec_plain if classes == 1 else matvec.kernel_matmat_plain
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"bench_gram_f64 on {name}: m={m} d={d} classes={classes} kernel={kind}",
          flush=True)
    want = plain(X, sq, V, **kw)
    rel = float((product(X, sq, V, **kw) - want).abs().max() / want.abs().max())
    product(X, sq, V, **kw)  # untimed
    ms = statistics.median(
        seconds(lambda: product(X, sq, V, **kw), device) for _ in range(args.repeats)) * 1e3
    print(f"dmma {ms:10.3f} ms  rel_err={rel:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
