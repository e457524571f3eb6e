"""Time kernels A-D and K at ``gram_precision="highest"`` (the tensor-core
tiles in three TF32 passes) beside their FFMA tiles, one checkout at a
time.

    python -m plssvm_tpu_torch.tools.bench_highest [--repeats N] [--kernels LETTERS] [--cpu]

Cells: kernel A and C (10 classes) at 32768 x 512, B and D (10 classes)
over the same square, C at MNIST's width (59999 x 784, 10 classes) and D
of 10000 points against its 60000 support vectors; kernel K at the ring's
MNIST-width block, 15000^2 x 784, with 10 classes and with 1; RBF, gamma =
1/d, coef0 = 0, seeded normal rows in float32.  A and C take the operand
copy made once (``tier_operand``, as the CG solve makes it), K the pair of
Xr's and Xc's (as the ring makes each shard's once per solve); B and D
make theirs per call, as predict does.  One JSON line per cell: ``ms``,
the median of ``--repeats`` calls (10) of the wrapper at "highest" after
two untimed, with CUDA events; ``ffma_ms``, the same of the FFMA tile
(``gram_matvec.gram_ffma``); ``rel_err``, the wrapper's max|err| /
max|plain| against the full-float32 plain version (for K the larger of
its two outputs'); for K with one class also ``walk_ms``, kernel J's
matvec walk on the same block (``gram_matvec_dual`` at "highest"), a
reading beside the split dual tile that routes nothing.  ``--kernels``
keeps the cells of those kernels only (e.g. ``K``).  Run from the
root of another checkout with this file copied into its ``tools/``, it
times that checkout's tiles, so two designs compare in separate
processes on one card.  The tiles' bounds are ``chip_smoke.py``'s.
``--cpu`` runs the plain versions on the CPU at a hundredth of the rows
(``ffma_ms`` and ``walk_ms`` null); without it the tool runs on the GPU,
and fails where there is none.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from ..ops import gram_matmat, gram_matvec, matvec
from ..parameter import KernelFunctionType
from . import seconds, tool_device

#: (kernel, points, rows or support vectors, features, classes)
CELLS = (
    ("A", 32768, 32768, 512, 1),
    ("C", 32768, 32768, 512, 10),
    ("B", 32768, 32768, 512, 1),
    ("D", 32768, 32768, 512, 10),
    ("C", 59999, 59999, 784, 10),
    ("D", 10000, 60000, 784, 10),
    ("K", 15000, 15000, 784, 10),
    ("K", 15000, 15000, 784, 1),
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.bench_highest",
        description='Time kernels A-D and K at gram_precision="highest" beside their FFMA '
                    'tiles.')
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--kernels", default="ABCDK",
                    help="the letters of the kernels whose cells run (default: all)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (default: the GPU)")
    return ap


def _ms(fn, device, repeats: int) -> float:
    for _ in range(2):
        fn()
    return statistics.median(seconds(fn, device) for _ in range(repeats)) * 1e3


def _rel_err(got, want) -> float:
    """max|err| / max|plain|, the larger of the outputs' for a pair."""
    if isinstance(got, tuple):
        return max(_rel_err(g, w) for g, w in zip(got, want))
    return float((got - want).abs().max() / want.abs().max())


def measure_dual(n_r, n_c, d, classes, device, repeats, rows) -> dict:
    """Kernel K's cell: the split dual tile on the pair of operand copies
    made once, its FFMA tile and, for one class, J's matvec walk."""
    Xr, Xc = rows(n_r, d), rows(n_c, d)
    V_c, V_r = rows(n_c, classes), rows(n_r, classes)
    sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
    kw = dict(kind=KernelFunctionType.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
    cuda = device.type == "cuda"
    operand = ((gram_matvec.tier_operand(Xr, "highest"), gram_matvec.tier_operand(Xc, "highest"))
               if cuda else None)

    def run():
        return gram_matmat.gram_matmat_dual(Xr, Xc, sq_r, sq_c, V_c, V_r, precision="highest",
                                            operand=operand, **kw)

    rel_err = _rel_err(run(), matvec.kernel_matmat_dual_plain(Xr, Xc, sq_r, sq_c, V_c, V_r,
                                                              **kw))
    row = {"kernel": "K", "n_p": n_r, "n_s": n_c, "d": d, "classes": classes,
           "ms": _ms(run, device, repeats), "rel_err": rel_err, "ffma_ms": None}
    if cuda:
        row["ffma_ms"] = _ms(lambda: gram_matvec.gram_ffma(
            "matmat_dual", (Xr, Xc), (sq_r, sq_c), (V_c, V_r), **kw), device, repeats)
    if classes == 1:
        v_c, v_r = V_c[:, 0].contiguous(), V_r[:, 0].contiguous()
        row["walk_ms"] = _ms(lambda: gram_matvec.gram_matvec_dual(
            Xr, Xc, sq_r, sq_c, v_c, v_r, precision="highest", **kw), device,
            repeats) if cuda else None
    return row


def measure(kernel, n_p, n_s, d, classes, device, repeats) -> dict:
    """One cell: the wrapper's and the FFMA tile's ms and the wrapper's
    error against the plain version."""
    gen = torch.Generator().manual_seed(n_s * 1000 + d)

    def rows(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).to(device, torch.float32)

    if kernel == "K":
        return measure_dual(n_p, n_s, d, classes, device, repeats, rows)
    S = rows(n_s, d)
    weights = rows(n_s) if classes == 1 else rows(n_s, classes)
    P = S if n_p == n_s else rows(n_p, d)
    sq_s, sq_p = (S * S).sum(-1), (P * P).sum(-1)
    kw = dict(kind=KernelFunctionType.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
    op = "matvec" if classes == 1 else "matmat"
    module = gram_matvec if classes == 1 else gram_matmat
    if kernel in "AC":
        operand = gram_matvec.tier_operand(S, "highest") if device.type == "cuda" else None
        wrapper = getattr(module, f"gram_{op}_sym")
        plain = getattr(matvec, f"kernel_{op}_plain")

        def run():
            return wrapper(S, sq_s, weights, precision="highest", operand=operand, **kw)

        def want():
            return plain(S, sq_s, weights, **kw)

        operands, norms = (S,), (sq_s,)
    else:
        wrapper = getattr(module, f"gram_{op}_rect")
        plain = getattr(matvec, f"kernel_{op}_rect_plain")

        def run():
            return wrapper(P, S, sq_p, sq_s, weights, precision="highest", **kw)

        def want():
            return plain(P, S, sq_p, sq_s, weights, **kw)

        operands, norms = (P, S), (sq_p, sq_s)
    expected = want()
    rel_err = float((run() - expected).abs().max() / expected.abs().max())
    ffma_ms = None
    if device.type == "cuda":
        ffma_ms = _ms(lambda: gram_matvec.gram_ffma(f"{op}_{'sym' if kernel in 'AC' else 'rect'}",
                                                    operands, norms, weights, **kw),
                      device, repeats)
    return {"kernel": kernel, "n_p": n_p, "n_s": n_s, "d": d, "classes": classes,
            "ms": _ms(run, device, repeats), "ffma_ms": ffma_ms, "rel_err": rel_err}


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = tool_device(args.cpu, "bench_highest")
    if device is None:
        return 1
    scale = 100 if device.type == "cpu" else 1
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    for kernel, n_p, n_s, d, classes in CELLS:
        if kernel not in args.kernels:
            continue
        row = measure(kernel, max(n_p // scale, 1), max(n_s // scale, 1), d, classes, device,
                      args.repeats)
        print(json.dumps({**row, "device": where}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
