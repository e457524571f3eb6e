"""plssvm-train equivalent: fit an LS-SVM and write the model file.

reference: src/main_train.cpp:24-70 + src/plssvm/detail/cmd/parser_train.cpp.
Usage: ``python -m plssvm_tpu_torch.cli.train [options] training_set_file [model_file]``

The flags are plssvm_tpu's.  Those whose feature is not ported yet are
still parsed, and rejected with a :class:`PLSSVMError` that names the
ROADMAP item porting them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..csvm import CSVM
from ..data_set import DataSet
from ..exceptions import NotPortedError, PLSSVMError
from ..parameter import KernelFunctionType
from ..utils.logger import VerbosityLevel, log
from ..utils.tracker import add_tracking_entry, global_tracker
from .common import (
    add_common_options,
    add_sycl_compat_options,
    warn_ignored_sycl_options,
    resolve_dtype,
    resolve_label_type,
    resolve_verbosity,
)

#: (argument, flag, ROADMAP item) of the options not ported yet
_NOT_PORTED = (
    ("multihost", "--multihost", "Queue 1, item 10: multihost on torch.distributed"),
    ("cross_validation", "--cross_validation", "Queue 1, item 7: calibration and CV"),
    ("probability", "--probability", "Queue 1, item 7: calibration and CV"),
    ("max_sv", "--max_sv", "Queue 1, item 9: sparse models"),
    ("nystroem", "--nystroem", "Queue 1, item 9: sparse models"),
    ("streaming", "--streaming", "Queue 1, item 9: sparse models"),
    ("checkpoint", "--checkpoint", "Queue 1, item 4: solver extras"),
    ("warm_start", "--warm_start", "Queue 1, item 4: solver extras"),
    ("weight", "--weight", "Queue 1, item 4: solver extras"),
    ("debug", "--debug", "Queue 1, item 4: solver extras"),
    ("profile", "--profile", "Queue 1, item 11: tools"),
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="plssvm-torch-train",
        description="LS-SVM trainer (PyTorch + hand-written CUDA kernels)",
    )
    parser.add_argument(
        "-t", "--kernel_type", default="0",
        help="set type of kernel function.\n"
        " 0 -- linear: u'*v\n"
        " 1 -- polynomial: (gamma*u'*v + coef0)^degree\n"
        " 2 -- radial basis function: exp(-gamma*|u-v|^2)\n"
        " 3 -- sigmoid: tanh(gamma*u'*v + coef0)\n"
        " 4 -- laplacian: exp(-gamma*|u-v|_1)\n"
        " 5 -- chi-squared: exp(-gamma*sum((x-y)^2/(x+y)))",
    )
    parser.add_argument("-d", "--degree", type=int, default=None,
                        help="set degree in kernel function")
    parser.add_argument("-g", "--gamma", type=float, default=None,
                        help="set gamma in kernel function (default: 1 / num_features)")
    parser.add_argument("-r", "--coef0", type=float, default=None,
                        help="set coef0 in kernel function")
    parser.add_argument("-c", "--cost", type=float, default=None,
                        help="set the parameter C")
    parser.add_argument("-e", "--epsilon", type=float, default=0.001,
                        help="set the tolerance of termination criterion")
    parser.add_argument("-i", "--max_iter", type=int, default=None,
                        help="set the maximum number of CG iterations (default: num_data_points)")
    parser.add_argument("-b", "--backend", default="automatic",
                        help="choose the backend: automatic|torch|cuda")
    parser.add_argument("-p", "--target_platform", default="automatic",
                        help="choose the target platform: automatic|cpu|gpu; "
                             "automatic takes the GPU and fails without one, "
                             "-p cpu is the only way to the CPU")
    parser.add_argument(
        "-s", "--svm_type", default="c_svc",
        choices=["c_svc", "epsilon_svr", "svr", "one_class"],
        help="c_svc = classification (default); the regression and "
             "one-class types are not ported yet",
    )
    parser.add_argument(
        "--classification", default="oaa", choices=["oaa", "oao"],
        help="multiclass decomposition (> 2 labels): oaa trains one-vs-all "
             "as one block CG; oao training is not ported yet",
    )
    parser.add_argument("--probability", action="store_true",
                        help="probability calibration (not ported yet)")
    parser.add_argument("--solver", default="automatic",
                        choices=["automatic", "cg_explicit", "cg_implicit"],
                        help="CG solver type; automatic = cg_implicit "
                        "(cg_explicit is not ported yet)")
    parser.add_argument("--preconditioner", default="none",
                        choices=["none", "jacobi"],
                        help="CG preconditioner (jacobi is not ported yet)")
    parser.add_argument("--gram_precision", default="f32",
                        choices=["f32", "bf16", "highest"],
                        help="Gram contraction precision of the CUDA kernels "
                        "on float32 data: f32 = TF32 operands on the tensor "
                        "cores, bf16 = bf16 operands, highest = full fp32 "
                        "FMA; float64 data and -b torch compute at full "
                        "precision")
    parser.add_argument("--debug", action="store_true",
                        help="NaN/Inf guards on the CG state (not ported yet)")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a profiler trace of the fit (not ported yet)")
    parser.add_argument("--cross_validation", metavar="N", type=int, default=None,
                        help="N-fold cross-validation mode (not ported yet)")
    parser.add_argument("--weight", metavar="LABEL=W", action="append", default=None,
                        help="per-class regularization weight (not ported yet)")
    parser.add_argument("--warm_start", metavar="MODEL_FILE", default=None,
                        help="warm-start CG from a model file (not ported yet)")
    parser.add_argument("-n", "--nu", type=float, default=0.5,
                        help="one-class outlier fraction (one-class is not "
                        "ported yet)")
    parser.add_argument("--max_sv", metavar="N", type=int, default=None,
                        help="pruned sparse model (not ported yet)")
    parser.add_argument("--nystroem", metavar="M", type=int, default=None,
                        help="fixed-size Nystroem model (not ported yet)")
    parser.add_argument("--streaming", action="store_true",
                        help="train from the file in windows (not ported yet)")
    parser.add_argument("--checkpoint", metavar="FILE", default=None,
                        help="CG-state checkpoint file (not ported yet)")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host training (not ported yet)")
    parser.add_argument("--checkpoint_interval", type=int, default=1000,
                        help="iterations between CG-state checkpoints")
    add_sycl_compat_options(parser)
    add_common_options(parser)
    parser.add_argument("input", metavar="training_set_file")
    parser.add_argument("model", metavar="model_file", nargs="?", default=None)
    return parser


def _format_params(args, kernel: KernelFunctionType, model_filename: str) -> str:
    """The 'task: training' parameter dump printed at full verbosity.

    reference: src/plssvm/detail/cmd/parser_train.cpp:234-271 (operator<<).
    """
    lines = [f"kernel_type: {kernel} -> {kernel.math_string}"]
    gamma_line = (
        "gamma: 1 / num_features (default)" if args.gamma is None
        else f"gamma: {args.gamma}"
    )
    coef0_line = (
        f"coef0: {args.coef0 if args.coef0 is not None else 0.0}"
        f"{' (default)' if args.coef0 is None else ''}"
    )
    if kernel == KernelFunctionType.POLYNOMIAL:
        lines.append(gamma_line)
        lines.append(coef0_line)
        lines.append(
            f"degree: {args.degree if args.degree is not None else 3}"
            f"{' (default)' if args.degree is None else ''}"
        )
    elif kernel == KernelFunctionType.SIGMOID:
        lines.append(gamma_line)
        lines.append(coef0_line)
    elif kernel != KernelFunctionType.LINEAR:
        lines.append(gamma_line)
    lines.append(
        f"cost: {args.cost if args.cost is not None else 1.0}"
        f"{' (default)' if args.cost is None else ''}"
    )
    lines.append(f"epsilon: {args.epsilon}")
    lines.append(
        "max_iter: num_data_points (default)" if args.max_iter is None
        else f"max_iter: {args.max_iter}"
    )
    lines.append(
        f"label_type: {'str' if args.use_strings_as_labels else 'int (default)'}"
    )
    lines.append(
        "real_type: float64"
        if args.use_double_as_real_type
        else "real_type: float32 (default)"
    )
    lines.append(f"input file (data set): '{args.input}'")
    lines.append(f"output file (model): '{model_filename}'")
    if args.performance_tracking:
        lines.append(f"performance tracking file: '{args.performance_tracking}'")
    return "\n".join(lines)


def _reject_not_ported(args) -> None:
    for attr, flag, item in _NOT_PORTED:
        if getattr(args, attr):
            raise NotPortedError(f"{flag} is not ported yet (ROADMAP {item})")
    if args.svm_type != "c_svc":
        raise NotPortedError(
            f"-s {args.svm_type} is not ported yet (ROADMAP Queue 1, item 7: "
            "regression and one-class)"
        )
    if args.classification == "oao":
        raise NotPortedError(
            "--classification oao is not ported yet (ROADMAP Queue 1, item 6: "
            "one-vs-one)"
        )


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    resolve_verbosity(args)
    warn_ignored_sycl_options(args)

    if args.gamma is not None and args.gamma <= 0.0:
        print(f"gamma must be greater than 0.0, but is {args.gamma}!", file=sys.stderr)
        return 1
    if args.max_iter is not None and args.max_iter <= 0:
        print(f"max_iter must be greater than 0, but is {args.max_iter}!", file=sys.stderr)
        return 1

    model_filename = args.model
    if model_filename is None:
        # default model filename: <input basename>.model (parser_train.cpp:218-221)
        model_filename = os.path.basename(args.input) + ".model"

    start = time.perf_counter()
    try:
        _reject_not_ported(args)
        kernel = KernelFunctionType.from_string(args.kernel_type)
        log(
            VerbosityLevel.FULL,
            "\ntask: training\n{}\n\n",
            _format_params(args, kernel, model_filename),
        )
        add_tracking_entry("parameter", "kernel_type", str(kernel))
        add_tracking_entry("parameter", "epsilon", args.epsilon)
        data = DataSet(
            args.input,
            label_type=resolve_label_type(args),
            dtype=resolve_dtype(args),
        )
        svm = CSVM(
            backend=args.backend,
            target=args.target_platform,
            dtype=resolve_dtype(args),
            preconditioner=args.preconditioner,
            gram_precision=args.gram_precision,
            solver=args.solver,
            kernel_type=kernel,
            degree=args.degree,
            gamma=args.gamma,
            coef0=args.coef0,
            cost=args.cost,
        )
        model = svm.fit(data, epsilon=args.epsilon, max_iter=args.max_iter)
        model.save(model_filename)
    except PLSSVMError as exc:
        print(exc, file=sys.stderr)
        return 1

    total_ms = (time.perf_counter() - start) * 1000.0
    log(VerbosityLevel.FULL | VerbosityLevel.TIMING, "\nTotal runtime: {:.2f}ms\n", total_ms)
    add_tracking_entry("", "total_time", total_ms)
    if args.performance_tracking is not None:
        global_tracker.save(args.performance_tracking)
    return 0


if __name__ == "__main__":
    sys.exit(main())
