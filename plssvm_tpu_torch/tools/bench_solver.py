"""Microbenchmark of the explicit against the implicit CG iteration.

    python -m plssvm_tpu_torch.tools.bench_solver [m] [d] [iters] [kernel] [precision] [--cpu]

The counterpart of tools/bench_solver.py, with its arguments: ``m`` rows
(default 32768), ``d`` features (2048), ``iters`` normalised products per
timing (64), ``kernel`` a kernel function name (rbf) and ``precision`` the
Gram tier ("f32", "bf16" or "highest"; float32 data).  It times, as the
JAX tool does, (a) the one-shot build of the kernel matrix
(``solver/explicit.py::build_kernel_matrix``: the Gram build, or kernel N
for the distance kinds), (b) the explicit ``K @ v`` of a CG iteration
(``explicit_product``) and (c) the implicit product of a CG iteration
(the solver's own ``_make_kernel_matvec``: kernel A at the tier, or
kernel E for the distance kinds), the quantities behind
``solver="automatic"`` (csvm.py ``_use_explicit_solver``; the port's
sweep of them is bench_explicit).  Products: ``iters`` of them with CUDA
events on the card, best of two after one untimed run (the distance kinds'
implicit product an eighth of them, as the JAX tool's); the build: one
call, timed the same way.  Data: seeded normal rows in float32 (their
absolute values for chi-squared), gamma = 1/d, coef0 = 0, degree 3.
``--cpu`` runs the plain versions on the CPU; without it the tool runs on
the GPU and fails where there is none.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..kernel_functions import DISTANCE_KERNELS
from ..ops.matvec import check_precision
from ..parameter import KernelFunctionType
from ..solver.cg import _make_kernel_matvec
from ..solver.explicit import build_kernel_matrix, explicit_product
from . import seconds, tool_device

REPS = 2


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.bench_solver",
        description="Time the explicit K build and K @ v against the implicit product.",
    )
    ap.add_argument("m", type=int, nargs="?", default=32768)
    ap.add_argument("d", type=int, nargs="?", default=2048)
    ap.add_argument("iters", type=int, nargs="?", default=64)
    ap.add_argument("kernel", nargs="?", default="rbf")
    ap.add_argument("precision", nargs="?", default="f32")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def bench_loop(product, v0, iters, device) -> float:
    """Seconds per product over ``iters`` normalised products, best of
    REPS after one untimed run."""
    def run():
        vv = v0
        for _ in range(iters):
            out = product(vv)
            vv = out / torch.linalg.norm(out)

    run()
    return min(seconds(run, device) for _ in range(REPS)) / iters


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    kind = KernelFunctionType.from_string(args.kernel)
    check_precision(args.precision)
    if kind == KernelFunctionType.LINEAR:
        print("the linear kernel takes X (X^T v), no kernel matrix", file=sys.stderr)
        return 2
    device = tool_device(args.cpu, "bench_solver")
    if device is None:
        return 1
    m, d, iters = args.m, args.d, args.iters
    rng = np.random.default_rng(0)
    Xh = rng.normal(size=(m, d)).astype(np.float32)
    if kind == KernelFunctionType.CHI_SQUARED:
        Xh = np.abs(Xh)
    X = torch.as_tensor(Xh, device=device)
    sq = (X * X).sum(-1)
    v0 = torch.as_tensor(rng.normal(size=(m,)).astype(np.float32), device=device)
    gamma, coef0 = float(np.float32(1.0 / d)), 0.0
    flops = 2.0 * m * m * d
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"bench_solver on {name}: m={m} d={d} iters={iters} kernel={kind} "
          f"precision={args.precision}", flush=True)

    impl = "cuda" if device.type == "cuda" else "torch"
    K = None

    def build():
        nonlocal K
        K = None
        K = build_kernel_matrix(X, gamma, coef0, kind=kind, degree=3,
                                precision=args.precision, impl=impl)

    build_s = seconds(build, device)
    kb = K.numel() * K.element_size()
    print(f"K build ({K.dtype}, {kb / 1e9:.1f} GB): {build_s:.2f} s", flush=True)
    t_exp = bench_loop(lambda v: explicit_product(K, v, torch.float32, symmetric=True),
                       v0, iters, device)
    print(f"explicit K@v : {t_exp * 1e3:7.2f} ms/iter ({kb / t_exp / 1e9:6.0f} GB/s, "
          f"{flops / t_exp / 1e12:6.1f} implicit-equivalent TFLOP/s)", flush=True)
    K = None
    matvec = _make_kernel_matvec(kind, 3, impl, args.precision)
    distance = kind in DISTANCE_KERNELS
    t_imp = bench_loop(lambda v: matvec(X, sq, v, gamma, coef0), v0,
                       max(iters // 8, 2) if distance else iters, device)
    label = "implicit sym" if distance else "implicit dual"
    print(f"{label:13s}: {t_imp * 1e3:7.2f} ms/iter ({flops / t_imp / 1e12:6.1f} TFLOP/s)",
          flush=True)
    print(f"speedup {t_imp / t_exp:.2f}x/iter; build amortizes over "
          f"{build_s / max(t_imp - t_exp, 1e-9):.1f} iterations", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
