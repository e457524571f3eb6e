"""Microbenchmark of the multiclass block matmat ``K @ V`` (kernel C).

    python -m plssvm_tpu_torch.tools.bench_matmat [m] [d] [C] [iters] [only] [--cpu]

The counterpart of tools/bench_matmat.py, with its arguments: ``m`` rows
(default 65536), ``d`` features (1024), ``C`` right-hand sides (4),
``iters`` normalised products per timing (64) and ``only`` a
comma-separated list of variants.  ``X`` and ``V`` hold seeded normal
draws in float32, RBF with gamma = 1/d.  Variants, and the JAX tool's they
stand for:

=============== ============== =============================================
variant         JAX tool's     what runs
=============== ============== =============================================
plain_rb1024    xla_rb1024     ``kernel_matmat_plain``, rows in blocks of 1024
kernel_c        pallas_dual    ``gram_matmat_sym``: kernel C on the
                               tensor-core tile at "f32" (TF32)
=============== ============== =============================================

Each is timed over ``iters`` products ``V <- K V / |K V|`` with CUDA events
on the card, best of two after one untimed run, and reported in TFLOP/s
counted as the JAX tool counts them, 2 m^2 d + 8 m^2 (the Gram product;
the class contractions ride along).  For m <= 16384 each line also gives
``rel_err = |K V - golden| / |golden|`` against a float64 golden of the
same operands.  ``--cpu`` runs on the CPU, where kernel C's wrapper takes
its plain version; without it the tool runs on the GPU and fails where
there is none.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import gram_matmat, matvec
from ..parameter import KernelFunctionType
from . import seconds, tool_device

GOLDEN_MAX_M = 16384
REPS = 2


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.bench_matmat",
        description="Time kernel C, the block matmat K @ V, beside its plain version.",
    )
    ap.add_argument("m", type=int, nargs="?", default=65536)
    ap.add_argument("d", type=int, nargs="?", default=1024)
    ap.add_argument("C", type=int, nargs="?", default=4)
    ap.add_argument("iters", type=int, nargs="?", default=64)
    ap.add_argument("only", nargs="?", default=None,
                    help="comma-separated variants (default: all)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def golden(X: torch.Tensor, V: torch.Tensor, gamma: float) -> torch.Tensor:
    """The RBF ``K V`` in float64 on X's device, in row blocks."""
    Xd, Vd = X.double(), V.double()
    sq = (Xd * Xd).sum(-1)
    out = torch.empty_like(Vd)
    for i in range(0, Xd.shape[0], 1024):
        K = torch.exp(-gamma * (sq[i:i + 1024, None] + sq[None, :] - 2 * Xd[i:i + 1024] @ Xd.T))
        out[i:i + 1024] = K @ Vd
    return out


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = tool_device(args.cpu, "bench_matmat")
    if device is None:
        return 1
    m, d, C, iters = args.m, args.d, args.C, args.iters
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32), device=device)
    V0 = torch.as_tensor(rng.normal(size=(m, C)).astype(np.float32), device=device)
    sq = (X * X).sum(-1)
    gamma = float(np.float32(1.0 / d))
    kw = dict(kind=KernelFunctionType.RBF, gamma=gamma, coef0=0.0, degree=3)
    flops = 2 * m * m * d + 8 * m * m
    variants = {
        "plain_rb1024": lambda V: matvec.kernel_matmat_plain(X, sq, V, row_block=1024, **kw),
        "kernel_c": lambda V: gram_matmat.gram_matmat_sym(X, sq, V, precision="f32", **kw),
    }
    if args.only:
        wanted = args.only.split(",")
        unknown = sorted(set(wanted) - set(variants))
        if unknown:
            print(f"unknown variants: {', '.join(unknown)} (have {', '.join(variants)})",
                  file=sys.stderr)
            return 2
        variants = {k: fn for k, fn in variants.items() if k in wanted}

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"bench_matmat on {name}: m={m} d={d} C={C} iters={iters} kernel=rbf", flush=True)
    ref = golden(X, V0, gamma) if m <= GOLDEN_MAX_M else None

    def run(fn):
        VV = V0
        for _ in range(iters):
            out = fn(VV)
            VV = out / torch.linalg.norm(out)

    for variant, fn in variants.items():
        if ref is not None:
            err = torch.linalg.norm(fn(V0).double() - ref) / torch.linalg.norm(ref)
            rel = f"rel_err={float(err):.2e}"
        else:
            rel = "rel_err=skipped (m too large for the dense golden)"
        seconds(lambda: run(fn), device)  # untimed: warms up, builds the kernels
        best = min(seconds(lambda: run(fn), device) for _ in range(REPS))
        print(f"{variant:12s}  {flops * iters / best / 1e12:7.2f} TFLOP/s (Gram)  "
              f"{best / iters * 1e3:9.3f} ms/matmat   {rel}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
