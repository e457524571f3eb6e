"""Time the hand kernels whose sums across blocks are the fixed-order slots
of csrc/fixed_sum.cuh, at the shapes PERF.md section 6 times them.

    python -m plssvm_tpu_torch.tools.bench_fixed_sum [--calls 10] [--repeats 3]
        [--only NAME,...] [--cpu]

One JSON line a kernel: ``{"kernel", "shape", "ms", "workspace_bytes"}``,
``ms`` the median over ``--repeats`` of ``--calls`` launches back to back
through the kernel's wrapper, over CUDA events (the host's work for a call,
the workspace's query and allocation among it, overlaps the card's), after
one warm-up call; ``workspace_bytes`` the most the calls asked for
(``ops/gram_matvec.py::workspace_peak``; null in a tree without the
slots).  The shapes: A, B and the FFMA tiles at 32768 x 512 RBF (C = 10
for C and D), C also at MNIST's 59999 x 784 (10 classes) and D at 10000 x
60000 x 784; J at the config-3 ring's 12500^2 x 500 block, K at the
MNIST ring's 15000^2 x 784 (10 classes); E-H at 16384 x 256 (C = 10), G
also at chi2-width's 59999 x 784; L and M at the laplacian / chi-squared
ring's 2500^2 x 200 block; I at 32768 x 128; float32 at each tier the
kernel runs at, and float64 where it runs in float64.  The module reads
only the wrappers' public functions, so a copy of it in another tree's
``plssvm_tpu_torch/tools/`` times that tree's kernels (run it from that
tree's root); the first line names the card and its power limit.  ``--cpu``
runs the plain versions at a hundredth of the rows, which says nothing of
a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops import banded, distance, gram_matmat, gram_matvec
from ..parameter import KernelFunctionType as K
from . import tool_device

RBF = dict(kind=K.RBF, gamma=1.0 / 512, coef0=0.0, degree=3)


def _cells(device, scale):
    """name -> (shape label, zero-argument call)."""
    gen = torch.Generator().manual_seed(0)

    def normal(*shape, dtype=torch.float32, positive=False):
        t = torch.randn(*shape, generator=gen, dtype=torch.float64)
        return (t.abs() if positive else t).to(device, dtype)

    def gram(m, d, dtype):
        X = normal(m, d, dtype=dtype) * 0.05
        return X, (X * X).sum(-1)

    def rows(n):
        return max(1, n // scale)

    cells = {}
    m, d = rows(32768), 512
    for dtype, label in ((torch.float32, "f32"), (torch.float64, "f64")):
        X, sq = gram(m, d, dtype)
        v, V = normal(m, dtype=dtype), normal(m, 10, dtype=dtype)
        tiers = ("f32", "bf16", "highest") if dtype == torch.float32 else ("f32",)
        for tier in tiers:
            name = tier if dtype == torch.float32 else "f64"
            op = (gram_matvec.tier_operand(X, tier) if dtype == torch.float32 and
                  device.type == "cuda" else None)
            cells[f"A {name}"] = (f"{m}x{d}", lambda X=X, sq=sq, v=v, t=tier, op=op:
                                  gram_matvec.gram_matvec_sym(X, sq, v, precision=t,
                                                              operand=op, **RBF))
            cells[f"C {name}"] = (f"{m}x{d} C=10", lambda X=X, sq=sq, V=V, t=tier, op=op:
                                  gram_matmat.gram_matmat_sym(X, sq, V, precision=t,
                                                              operand=op, **RBF))
            cells[f"B {name}"] = (f"{m}x{m}x{d}", lambda X=X, sq=sq, v=v, t=tier:
                                  gram_matvec.gram_matvec_rect(X, X, sq, sq, v, precision=t,
                                                               **RBF))
            cells[f"D {name}"] = (f"{m}x{m}x{d} C=10", lambda X=X, sq=sq, V=V, t=tier:
                                  gram_matmat.gram_matmat_rect(X, X, sq, sq, V, precision=t,
                                                               **RBF))
        if dtype == torch.float32 and device.type == "cuda":
            for op_name, args in (("matvec_sym", ((X,), (sq,), v)),
                                  ("matmat_sym", ((X,), (sq,), V)),
                                  ("matvec_rect", ((X, X), (sq, sq), v)),
                                  ("matmat_rect", ((X, X), (sq, sq), V))):
                cells[f"FFMA {op_name}"] = (f"{m}x{d}", lambda o=op_name, a=args:
                                            gram_matvec.gram_ffma(o, *a, **RBF))
    # MNIST width: C over 59999 x 784, D 10000 x 60000 x 784, both 10 classes
    mw, dw = rows(59999), 784
    kw = dict(RBF, gamma=1.0 / dw)
    for dtype, label in ((torch.float32, "f32"), (torch.float64, "f64")):
        X, sq = gram(mw, dw, dtype)
        V = normal(mw, 10, dtype=dtype)
        op = gram_matvec.tier_operand(X, "f32") if (
            dtype == torch.float32 and device.type == "cuda") else None
        cells[f"C {label} mnist"] = (f"{mw}x{dw} C=10", lambda X=X, sq=sq, V=V, op=op, kw=kw:
                                     gram_matmat.gram_matmat_sym(X, sq, V, operand=op, **kw))
        P, sq_p = X[:rows(10000)], sq[:rows(10000)]
        cells[f"D {label} mnist"] = (f"{rows(10000)}x{mw}x{dw} C=10",
                                     lambda P=P, X=X, sq_p=sq_p, sq=sq, V=V, kw=kw:
                                     gram_matmat.gram_matmat_rect(P, X, sq_p, sq, V, **kw))
    # the ring's dual blocks
    for dtype, label, tiers in ((torch.float32, "f32", ("f32", "bf16", "highest")),
                                (torch.float64, "f64", ("f32",))):
        mr, dr = rows(12500), 500
        Xr, sq_r = gram(mr, dr, dtype)
        Xc, sq_c = gram(mr, dr, dtype)
        v_c, v_r = normal(mr, dtype=dtype), normal(mr, dtype=dtype)
        kj = dict(RBF, gamma=1.0 / dr)
        for tier in tiers:
            name = tier if dtype == torch.float32 else "f64"
            cells[f"J {name}"] = (f"{mr}x{mr}x{dr}", lambda a=(Xr, Xc, sq_r, sq_c, v_c, v_r),
                                  t=tier, kj=kj: gram_matvec.gram_matvec_dual(
                                      *a, precision=t, **kj))
        mk, dk = rows(15000), 784
        Xr, sq_r = gram(mk, dk, dtype)
        Xc, sq_c = gram(mk, dk, dtype)
        V_c, V_r = normal(mk, 10, dtype=dtype), normal(mk, 10, dtype=dtype)
        kk = dict(RBF, gamma=1.0 / dk)
        for tier in tiers:
            name = tier if dtype == torch.float32 else "f64"
            cells[f"K {name}"] = (f"{mk}x{mk}x{dk} C=10",
                                  lambda a=(Xr, Xc, sq_r, sq_c, V_c, V_r), t=tier, kk=kk:
                                  gram_matmat.gram_matmat_dual(*a, precision=t, **kk))
    # the distance kernels
    for dtype, label in ((torch.float32, "f32"), (torch.float64, "f64")):
        md, dd = rows(16384), 256
        X = normal(md, dd, dtype=dtype, positive=True) / dd
        v, V = normal(md, dtype=dtype), normal(md, 10, dtype=dtype)
        for kind, kname in ((K.LAPLACIAN, "laplacian"), (K.CHI_SQUARED, "chi_squared")):
            kd = dict(kind=kind, gamma=1.0 if kind == K.CHI_SQUARED else 1.0 / dd)
            cells[f"E {label} {kname}"] = (f"{md}x{dd}", lambda X=X, v=v, kd=kd:
                                           distance.distance_matvec_sym(X, v, **kd))
            cells[f"F {label} {kname}"] = (f"{md}x{md}x{dd}", lambda X=X, v=v, kd=kd:
                                           distance.distance_matvec_rect(X, X, v, **kd))
            cells[f"G {label} {kname}"] = (f"{md}x{dd} C=10", lambda X=X, V=V, kd=kd:
                                           distance.distance_matmat_sym(X, V, **kd))
            cells[f"H {label} {kname}"] = (f"{md}x{md}x{dd} C=10", lambda X=X, V=V, kd=kd:
                                           distance.distance_matmat_rect(X, X, V, **kd))
        mr, dr = rows(2500), 200
        Xr = normal(mr, dr, dtype=dtype, positive=True) / dr
        Xc = normal(mr, dr, dtype=dtype, positive=True) / dr
        for kind, kname in ((K.LAPLACIAN, "laplacian"), (K.CHI_SQUARED, "chi_squared")):
            kd = dict(kind=kind, gamma=1.0 if kind == K.CHI_SQUARED else 1.0 / dr)
            cells[f"L {label} {kname}"] = (
                f"{mr}x{mr}x{dr}", lambda a=(Xr, Xc, normal(mr, dtype=dtype),
                                             normal(mr, dtype=dtype)), kd=kd:
                distance.distance_matvec_dual(*a, **kd))
            cells[f"M {label} {kname}"] = (
                f"{mr}x{mr}x{dr} C=10", lambda a=(Xr, Xc, normal(mr, 10, dtype=dtype),
                                                  normal(mr, 10, dtype=dtype)), kd=kd:
                distance.distance_matmat_dual(*a, **kd))
    mc, dc = rows(59999), 784
    Xw = normal(mc, dc, positive=True) / dc
    cells["G f32 chi_squared chi2-width"] = (
        f"{mc}x{dc} C=10", lambda X=Xw, V=normal(mc, 10): distance.distance_matmat_sym(
            X, V, kind=K.CHI_SQUARED, gamma=1.0))
    mi, di = rows(32768), 128
    XT = (normal(di, mi, positive=True) / di).contiguous()
    cells["I f32"] = (f"{mi}x{di}", lambda XT=XT, v=normal(mi): banded.banded_matvec(
        XT, v, 1.0 / di))
    return cells


def _ms(fn, calls, repeats, device):
    fn()
    if device.type != "cuda":
        import time

        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
        return statistics.median(times)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.bench_fixed_sum",
        description="Time the kernels whose sums across blocks are fixed-order slots.")
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--only", default=None, help="comma-separated name prefixes")
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = tool_device(args.cpu, "bench_fixed_sum")
    if device is None:
        return 1
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(json.dumps({"device": torch.cuda.get_device_name(device),
                          "nvidia_smi": smi.stdout.strip()}), flush=True)
    peak = getattr(gram_matvec, "workspace_peak", None)
    cells = _cells(device, 1 if device.type == "cuda" else 100)
    wanted = None if args.only is None else tuple(args.only.split(","))
    for name, (shape, fn) in cells.items():
        if wanted is not None and not name.startswith(wanted):
            continue
        if peak is not None:
            peak.clear()
        ms = _ms(fn, args.calls, args.repeats, device)
        print(json.dumps({"kernel": name, "shape": shape, "ms": ms,
                          "workspace_bytes": None if peak is None else max(peak.values(),
                                                                           default=0)}),
              flush=True)
        torch.cuda.empty_cache() if device.type == "cuda" else None
    return 0


if __name__ == "__main__":
    sys.exit(main())
