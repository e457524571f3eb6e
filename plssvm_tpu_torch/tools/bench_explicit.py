"""Time the explicit solver's pieces against the implicit product, to place
the Gram crossover of ``solver="automatic"``.

    python -m plssvm_tpu_torch.tools.bench_explicit [--sweep M] [--classes C ...] [--repeats N] [--cpu]

For each cell (config 2: RBF 10000 x 200, 20 CG iterations; config 3
width: polynomial 50000 x 500, 6; MNIST width: RBF 60000 x 784, 10 classes,
21) and each tier ("f32", "bf16", "highest" in float32; float64 at "f32"),
one line of JSON: ``implicit_ms``, the product a CG iteration makes on the
implicit path (kernel A, or C for 10 classes, through the solver's own
``_make_kernel_matvec``); ``explicit_ms``, one read of the stored K
(``explicit_product``); ``build_ms``, ``build_kernel_matrix``; and
``explicit_wins``, whether ``explicit_ms + build_ms / iterations`` is under
``implicit_ms``.  With ``--sweep M`` it does the same at M rows over d in
16, 32, ..., 1024 (20 iterations), for each class count of ``--classes``
(1, 3, 4 and 10), and prints, per tier and class count, the smallest d from
which the explicit solve wins at every wider d, then per tier the binary
one and the largest of these over the class counts above 1: the
crossovers that ``csvm.GRAM_CROSSOVER_CUDA`` holds.  Products: median
of ``--repeats`` calls back to back (the host enqueues the next while the card runs one)
after a warm-up; the build: the median of 3 calls.  Data: seeded normal
rows, gamma = 1/d, coef0 = 1, degree 3.  ``--cpu`` runs the plain versions
on the CPU at a hundredth of the rows; without it the tool runs on the
GPU, and fails where there is none.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from ..parameter import KernelFunctionType
from ..solver.cg import _make_kernel_matmat, _make_kernel_matvec
from ..solver.explicit import build_kernel_matrix, explicit_product
from . import tool_device

#: (name, kernel, rows, features, classes, CG iterations of the cell on an
#: H100: PERF.md section 5)
CELLS = (
    ("config2", KernelFunctionType.RBF, 10000, 200, 1, 20),
    ("config3-width", KernelFunctionType.POLYNOMIAL, 50000, 500, 1, 6),
    ("mnist-width", KernelFunctionType.RBF, 60000, 784, 10, 21),
)
#: (label, dtype, gram_precision)
TIERS = (("f32", torch.float32, "f32"), ("bf16", torch.float32, "bf16"),
         ("highest", torch.float32, "highest"), ("f64", torch.float64, "f32"))
SWEEP_D = (16, 32, 64, 128, 256, 512, 1024)
SWEEP_ITERATIONS = 20


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.bench_explicit",
        description="Time the explicit solver's build and product against the "
                    "implicit product.")
    ap.add_argument("--sweep", type=int, default=0, metavar="M",
                    help="also sweep d at M rows (0: no sweep)")
    ap.add_argument("--classes", type=int, nargs="+", default=[1, 3, 4, 10],
                    help="the sweep's class counts (default: 1 3 4 10)")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (default: the GPU)")
    return ap


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(fn, device, repeats: int) -> float:
    """ms per call of ``repeats`` calls back to back, after one warm-up."""
    fn()
    _sync(device)
    start = time.perf_counter()
    for _ in range(repeats):
        fn()
    _sync(device)
    return (time.perf_counter() - start) * 1e3 / repeats


def measure(kind, m, d, classes, iterations, dtype, tier, device, repeats) -> dict:
    """One cell at one tier: the implicit product, one read of K and the
    build, in ms."""
    gen = torch.Generator(device="cpu").manual_seed(m * 1000 + d)
    X = torch.randn((m, d), generator=gen, dtype=torch.float64).to(device, dtype)
    V = torch.randn((m, classes) if classes > 1 else (m,), generator=gen,
                    dtype=torch.float64).to(device, dtype)
    sq = torch.sum(X * X, dim=-1)
    gamma, coef0, degree = 1.0 / d, 1.0, 3
    make = _make_kernel_matmat if classes > 1 else _make_kernel_matvec
    product = make(kind, degree, "cuda" if device.type == "cuda" else "torch", tier)
    implicit = _ms(lambda: product(X, sq, V, gamma, coef0), device, repeats)
    builds = []
    for _ in range(3):
        start = time.perf_counter()
        K = build_kernel_matrix(X, gamma, coef0, kind=kind, degree=degree,
                                precision=tier, impl="cuda")
        _sync(device)
        builds.append((time.perf_counter() - start) * 1e3)
        del K
    K = build_kernel_matrix(X, gamma, coef0, kind=kind, degree=degree,
                            precision=tier, impl="cuda")
    explicit = _ms(lambda: explicit_product(K, V, dtype, symmetric=True), device, repeats)
    build = statistics.median(builds)
    del K
    return {"m": m, "d": d, "classes": classes, "iterations": iterations,
            "implicit_ms": implicit, "explicit_ms": explicit, "build_ms": build,
            "explicit_wins": explicit + build / iterations < implicit}


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = tool_device(args.cpu, "bench_explicit")
    if device is None:
        return 1
    scale = 100 if device.type == "cpu" else 1
    where = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    for name, kind, m, d, classes, iterations in CELLS:
        for label, dtype, tier in TIERS:
            row = measure(kind, m // scale, d, classes, iterations, dtype, tier, device,
                          args.repeats)
            print(json.dumps({"cell": name, "kernel": str(kind), "tier": label,
                              "device": where, **row}), flush=True)
    combined = {label: [] for label, _, _ in TIERS}
    for classes in args.classes if args.sweep else ():
        for label, dtype, tier in TIERS:
            wins = []
            for d in SWEEP_D:
                row = measure(KernelFunctionType.RBF, args.sweep // scale, d, classes,
                              SWEEP_ITERATIONS, dtype, tier, device, args.repeats)
                print(json.dumps({"cell": "sweep", "kernel": "rbf", "tier": label,
                                  "device": where, **row}), flush=True)
                wins.append((d, row["explicit_wins"]))
            # the smallest d from which every wider d wins
            crossover = next((d for i, (d, _) in enumerate(wins)
                              if all(w for _, w in wins[i:])), None)
            print(json.dumps({"crossover": label, "classes": classes,
                              "rows": args.sweep // scale, "iterations": SWEEP_ITERATIONS,
                              "d": crossover, "device": where}), flush=True)
            combined[label].append(crossover)
    # per tier, binary and one-vs-all: the smallest d from which the
    # explicit solve wins at every class count swept (None: at some class
    # count no swept d does), GRAM_CROSSOVER_CUDA's entry
    for label, found in combined.items() if args.sweep else ():
        entry = {}
        for kind, counts in (("binary", [c for c in args.classes if c == 1]),
                             ("one_vs_all", [c for c in args.classes if c > 1])):
            ds = [d for c, d in zip(args.classes, found) if c in counts]
            entry[kind] = None if not ds or None in ds else max(ds)
        print(json.dumps({"crossover": label, "classes": args.classes, **entry,
                          "device": where}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
