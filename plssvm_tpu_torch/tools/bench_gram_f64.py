"""Time a float64 DMMA tile, one checkout at a time.

    python -m plssvm_tpu_torch.tools.bench_gram_f64 [m] [d] [classes] [kernel] [--repeats N] [--dual | --rect] [--cpu]

``m`` rows (default 32768), ``d`` features (512), ``classes`` right-hand
sides, ``kernel`` polynomial, rbf or sigmoid (rbf).  Without ``--dual`` the
symmetric tile: kernel A (``classes`` 1, ``K(X, X) @ v``) or C (``K(X, X) @
V``).  With ``--dual`` the dual tile on an m x m block of the ring: kernel
J (``classes`` 1) or K, ``(K(Xr, Xc) @ V_c, K(Xr, Xc)^T @ V_r)``.  With
``--rect`` the rect tile on an m x m block, rows only: kernel B (``classes``
1, ``K(P, S) @ a``) or D (``K(P, S) @ A``).  ``X``, ``Xr``, ``Xc``, ``P``,
``S`` and the right-hand sides hold seeded normal draws in
float64, gamma = 1/d, coef0 = 0, degree 3.  A line gives the median ms of
``--repeats`` launches of the wrapper (5) after one untimed, with CUDA
events, and ``rel_err``, max|err| / max|plain| against the plain version
(the larger of the dual tile's two outputs).  Run
from the root of another checkout (a variant of a tile), it times that
checkout's tile, so variants compare in separate processes on one card;
copied into a checkout whose float64 B and D still run on the FFMA tile,
``--rect`` times that tile through the same wrapper.
The tiles' bounds and the FFMA tiles beside them are ``chip_smoke.py``'s.
``--cpu`` runs the wrappers' plain versions on the CPU; without it the
tool runs on the GPU, and fails where there is none.
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
        description="Time a float64 DMMA tile: kernel A or C, with --dual J or K, with "
                    "--rect B or D.",
    )
    ap.add_argument("m", type=int, nargs="?", default=32768)
    ap.add_argument("d", type=int, nargs="?", default=512)
    ap.add_argument("classes", type=int, nargs="?", default=1)
    ap.add_argument("kernel", nargs="?", default="rbf")
    ap.add_argument("--repeats", type=int, default=5)
    walk = ap.add_mutually_exclusive_group()
    walk.add_argument("--dual", action="store_true",
                      help="time the dual tile (kernels J and K) on an m x m block")
    walk.add_argument("--rect", action="store_true",
                      help="time the rect tile (kernels B and D) on an m x m block")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain version on the CPU (default: the GPU)")
    return ap


def _median_ms(fn, repeats, device) -> float:
    fn()  # untimed
    return statistics.median(seconds(fn, device) for _ in range(repeats)) * 1e3


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    kind = KernelFunctionType.from_string(args.kernel)
    if kind == KernelFunctionType.LINEAR or kind in DISTANCE_KERNELS:
        print(f"the DMMA tiles take polynomial, rbf or sigmoid, not {kind}",
              file=sys.stderr)
        return 2
    device = tool_device(args.cpu, "bench_gram_f64")
    if device is None:
        return 1
    m, d, classes = args.m, args.d, args.classes
    rng = np.random.default_rng(0)
    tail = (classes,) if classes > 1 else ()
    X = torch.as_tensor(rng.normal(size=(m, d)), device=device)
    V = torch.as_tensor(rng.normal(size=(m, *tail)), device=device)
    sq = (X * X).sum(-1)
    kw = dict(kind=kind, gamma=1.0 / d, coef0=0.0, degree=3)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"bench_gram_f64 on {name}: m={m} d={d} classes={classes} kernel={kind}"
          + (" dual" if args.dual else " rect" if args.rect else ""), flush=True)
    vec = classes == 1
    if args.dual or args.rect:
        Xc = torch.as_tensor(rng.normal(size=(m, d)), device=device)
        operands = (X, Xc, sq, (Xc * Xc).sum(-1), V)
    if args.dual:
        label = "dual"
        operands += (torch.as_tensor(rng.normal(size=(m, *tail)), device=device),)
        product = gram_matvec.gram_matvec_dual if vec else gram_matmat.gram_matmat_dual
        plain = matvec.kernel_matvec_dual_plain if vec else matvec.kernel_matmat_dual_plain
    elif args.rect:
        label = "rect"
        product = gram_matvec.gram_matvec_rect if vec else gram_matmat.gram_matmat_rect
        plain = matvec.kernel_matvec_rect_plain if vec else matvec.kernel_matmat_rect_plain
    else:
        label, operands = "dmma", (X, sq, V)
        product = gram_matvec.gram_matvec_sym if vec else gram_matmat.gram_matmat_sym
        plain = matvec.kernel_matvec_plain if vec else matvec.kernel_matmat_plain
    got, want = product(*operands, **kw), plain(*operands, **kw)
    pairs = zip(got, want) if args.dual else ((got, want),)
    rel = max(float((g - w).abs().max() / w.abs().max()) for g, w in pairs)
    ms = _median_ms(lambda: product(*operands, **kw), args.repeats, device)
    print(f"{label} {ms:10.3f} ms  rel_err={rel:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
