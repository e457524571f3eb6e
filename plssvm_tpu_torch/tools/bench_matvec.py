"""Microbenchmark of the port's kernel matvecs, side by side.

    python -m plssvm_tpu_torch.tools.bench_matvec [m] [d] [iters] [only] [kernel] [--cpu]

The counterpart of tools/bench_matvec.py, with its arguments: ``m`` rows
(default 8192), ``d`` features (256), ``iters`` normalised products per
timing (512), ``only`` a comma-separated list of variants or ``all``, and
``kernel`` any kernel function name (rbf).  ``X`` holds seeded normal
draws in float32 (their absolute values for chi-squared), gamma = 1/d,
coef0 = 0, degree 3.  Each variant is timed over ``iters`` products ``v <-
K v / |K v|``, with CUDA events on the card, best of two after one untimed
run, and reported in TFLOP/s counted as 2 m^2 d + 8 m^2 (the JAX tool's
count, for every kernel).  For m <= 16384 each line also gives ``rel_err =
|Kv - golden| / |golden|`` against a float64 golden computed here on the
same device.  ``--cpu`` runs on the CPU, where the kernels' wrappers take
their plain versions; without it the tool runs on the GPU, and fails where
there is none.

Variants, and the variants of the JAX tool they stand for:

================== ============================ ==============================
variant            JAX tool's variant           what runs
================== ============================ ==============================
plain_rb2048       xla_rb2048                   ``kernel_matvec_plain``
kernel_matvec      pallas_f32, dual_f32         ``kernel_matvec``: kernel A
                                                on the tensor cores, TF32
kernel_matvec_hi   dual_hi                      ``kernel_matvec(precision=
                                                "highest")``: kernel A on
                                                the FFMA tile
kernel_matvec_bf16 pallas_bf16, dual_bf16       ``kernel_matvec(precision=
                                                "bf16")``: kernel A on the
                                                tensor cores, bf16
rect_full          rect_full                    ``gram_matvec_rect(X, X)``:
                                                kernel B over the full square
                                                on the tensor cores, TF32
rect_full_hi       rect_full                    ``gram_matvec_rect(X, X,
                                                precision="highest")``:
                                                kernel B on the FFMA tile
plain_rb256        xla_scan_rb256               ``distance_matvec_plain``
sym_walk           sym_walk_rb256, _rb512       ``distance_matvec_sym``:
                                                kernel E (no row block)
================== ============================ ==============================

The first six run for the Gram kernels (polynomial, rbf, sigmoid), the
last two for the distance kernels (laplacian, chi_squared).  On ``--cpu``
every Gram variant but the plain one runs its wrapper's plain version at
the variant's tier: full float32, or bf16-rounded X for
``kernel_matvec_bf16``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..kernel_functions import DISTANCE_KERNELS
from ..ops import distance, gram_matvec, matvec
from ..parameter import KernelFunctionType
from . import seconds, tool_device

GOLDEN_MAX_M = 16384
#: float64 elements of one golden distance block (256 MiB)
GOLDEN_BLOCK_ELEMENTS = 1 << 25
REPS = 2


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.bench_matvec",
        description="Time the port's kernel matvecs side by side.",
    )
    ap.add_argument("m", type=int, nargs="?", default=8192)
    ap.add_argument("d", type=int, nargs="?", default=256)
    ap.add_argument("iters", type=int, nargs="?", default=512)
    ap.add_argument("only", nargs="?", default="all",
                    help="comma-separated variants, or all")
    ap.add_argument("kernel", nargs="?", default="rbf")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def _variants(kind, X, sq, gamma, coef0):
    """name -> (v -> K v)."""
    if kind in DISTANCE_KERNELS:
        return {
            "plain_rb256": lambda v: matvec.distance_matvec_plain(
                X, v, kind=kind, gamma=gamma, row_block=256),
            "sym_walk": lambda v: distance.distance_matvec_sym(
                X, v, kind=kind, gamma=gamma),
        }
    kw = dict(kind=kind, gamma=gamma, coef0=coef0, degree=3)
    return {
        "plain_rb2048": lambda v: matvec.kernel_matvec_plain(
            X, sq, v, row_block=2048, **kw),
        "kernel_matvec": lambda v: gram_matvec.kernel_matvec(
            X, sq, v, precision="f32", **kw),
        "kernel_matvec_hi": lambda v: gram_matvec.kernel_matvec(
            X, sq, v, precision="highest", **kw),
        "kernel_matvec_bf16": lambda v: gram_matvec.kernel_matvec(
            X, sq, v, precision="bf16", **kw),
        "rect_full": lambda v: gram_matvec.gram_matvec_rect(
            X, X, sq, sq, v, precision="f32", **kw),
        "rect_full_hi": lambda v: gram_matvec.gram_matvec_rect(
            X, X, sq, sq, v, precision="highest", **kw),
    }


def golden(X, v, kind, gamma, coef0):
    """``K v`` in float64 on X's device, written out from the kernel
    functions' definitions, in row blocks."""
    Xd, vd = X.double(), v.double()
    m, d = Xd.shape
    out = torch.empty(m, dtype=torch.float64, device=X.device)
    if kind in DISTANCE_KERNELS:
        rows = max(1, GOLDEN_BLOCK_ELEMENTS // max(1, m * d))
    else:
        rows = 1024
        sq = (Xd * Xd).sum(-1)
    for i in range(0, m, rows):
        Xb = Xd[i:i + rows]
        if kind == KernelFunctionType.RBF:
            K = torch.exp(-gamma * (sq[i:i + rows, None] + sq[None, :] - 2 * Xb @ Xd.T))
        elif kind == KernelFunctionType.POLYNOMIAL:
            K = (gamma * (Xb @ Xd.T) + coef0) ** 3
        elif kind == KernelFunctionType.SIGMOID:
            K = torch.tanh(gamma * (Xb @ Xd.T) + coef0)
        elif kind == KernelFunctionType.LAPLACIAN:
            K = torch.exp(-gamma * (Xb[:, None, :] - Xd[None, :, :]).abs().sum(-1))
        else:  # chi-squared, a term 0 where both values are 0
            den = Xb[:, None, :] + Xd[None, :, :]
            num = (Xb[:, None, :] - Xd[None, :, :]) ** 2
            terms = torch.where(den != 0, num / torch.where(den != 0, den, 1.0), 0.0)
            K = torch.exp(-gamma * terms.sum(-1))
        out[i:i + rows] = K @ vd
    return out


def _seconds(fn, v0, iters, device):
    """Seconds of ``iters`` normalised products from v0."""
    def run():
        vv = v0
        for _ in range(iters):
            out = fn(vv)
            vv = out / torch.linalg.norm(out)

    return seconds(run, device)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    kind = KernelFunctionType.from_string(args.kernel)
    if kind == KernelFunctionType.LINEAR:
        print("the linear kernel takes X (X^T v), no kernel matvec",
              file=sys.stderr)
        return 2
    device = tool_device(args.cpu, "bench_matvec")
    if device is None:
        return 1
    m, d, iters = args.m, args.d, args.iters
    rng = np.random.default_rng(0)
    Xh = rng.normal(size=(m, d)).astype(np.float32)
    if kind == KernelFunctionType.CHI_SQUARED:
        Xh = np.abs(Xh)
    X = torch.as_tensor(Xh, device=device)
    v0 = torch.as_tensor(rng.normal(size=(m,)).astype(np.float32), device=device)
    sq = (X * X).sum(-1)
    gamma, coef0 = float(np.float32(1.0 / d)), 0.0
    flops = 2 * m * m * d + 8 * m * m

    variants = _variants(kind, X, sq, gamma, coef0)
    if args.only != "all":
        wanted = args.only.split(",")
        unknown = sorted(set(wanted) - set(variants))
        if unknown:
            print(f"unknown variants for {kind}: {', '.join(unknown)} (have "
                  f"{', '.join(variants)})", file=sys.stderr)
            return 2
        variants = {k: fn for k, fn in variants.items() if k in wanted}

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"bench_matvec on {name}: m={m} d={d} iters={iters} kernel={kind}",
          flush=True)
    ref = golden(X, v0, kind, gamma, coef0) if m <= GOLDEN_MAX_M else None
    for variant, fn in variants.items():
        got = fn(v0)
        if ref is not None:
            err = torch.linalg.norm(got.double() - ref) / torch.linalg.norm(ref)
            rel = f"rel_err={float(err):.2e}"
        else:
            rel = "rel_err=skipped (m too large for the dense golden)"
        _seconds(fn, v0, iters, device)  # untimed: warms up, builds the kernels
        best = min(_seconds(fn, v0, iters, device) for _ in range(REPS))
        print(f"{variant:18s}  {flops * iters / best / 1e12:7.2f} TFLOP/s  "
              f"{best / iters * 1e3:9.3f} ms/matvec   {rel}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
