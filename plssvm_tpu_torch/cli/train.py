"""plssvm-train equivalent: fit an LS-SVM and write the model file.

reference: src/main_train.cpp:24-70 + src/plssvm/detail/cmd/parser_train.cpp.
Usage: ``python -m plssvm_tpu_torch.cli.train [options] training_set_file [model_file]``

The flags are plssvm_tpu's, with its messages (``--weight``'s checks, the
flag conflicts of ``-s one_class`` and ``--cross_validation``, the
``--debug`` guard's "numeric check failed: ...").  ``-s one_class`` trains
the one-class model (one_class.py), ``--probability`` calibrates the model
after its fit and ``--cross_validation N`` reports the N-fold CV accuracy
(or MSE) and writes no model (probability.py); ``--max_sv N`` prunes the
model to N support vectors and ``--nystroem M`` fits a fixed-size model on M
landmarks, from the file in windows with ``--streaming``, also with ``-s
one_class`` (sparse.py; the calibration and the CV then fold with the same
compact fit).  ``--multihost`` trains over the processes of a
``torch.distributed`` job (torchrun's environment; parallel/multihost.py):
each parses its window of the file, ``--nystroem`` and ``-s one_class``
compose with it, and rank 0 alone writes the model and the tracker's file.
``--profile DIR`` writes a ``torch.profiler`` trace of the fit to DIR
(``plssvm-torch-train.pt.trace.json``, one a rank with ``--multihost``):
CPU activity always, CUDA activity when the fit runs on the card; Chrome's
trace viewer or Perfetto read it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..csvm import CSVM
from ..data_set import DataSet
from ..exceptions import NumericCheckError, PLSSVMError
from ..model import Model
from ..one_class import fit_one_class
from ..parameter import KernelFunctionType
from ..probability import calibrate_model, cross_validate
from ..sparse import (
    compact_fold_fit_fn,
    nystroem_fit,
    nystroem_fit_from_file,
    nystroem_fit_one_class,
    nystroem_fit_one_class_from_file,
    pruned_fit,
    pruned_fit_one_class,
)
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
        help="c_svc = classification (default); epsilon_svr/svr = "
             "LS-SVR regression on the continuous label column (the model "
             "uses LIBSVM's epsilon_svr layout); one_class = one-class "
             "LS-SVM novelty detection (labels ignored, -n sets the outlier "
             "fraction, LIBSVM's one_class model layout)",
    )
    parser.add_argument(
        "--classification", default="oaa", choices=["oaa", "oao"],
        help="multiclass decomposition (> 2 labels): oaa trains one-vs-all "
             "as one block CG (default), oao the one-vs-one pair machines, "
             "stored in LIBSVM's multiclass model layout",
    )
    parser.add_argument("--probability", action="store_true",
                        help="Platt-calibrate the model from 5-fold "
                        "cross-validated decision values and store probA/probB "
                        "in the model file (LIBSVM's -b 1; regression models "
                        "get the Laplace noise scale)")
    parser.add_argument("--solver", default="automatic",
                        choices=["automatic", "cg_explicit", "cg_implicit"],
                        help="CG solver type; cg_explicit builds the kernel "
                        "matrix once and runs CG on the stored matrix; "
                        "automatic takes it when the matrix fits the device "
                        "(PLSSVM_TPU_TORCH_EXPLICIT_BUDGET bytes overrides the "
                        "budget) for the laplacian and chi-squared kernels, "
                        "and for the Gram kernels past a feature count "
                        "(csvm.GRAM_CROSSOVER_CUDA on a GPU); else, and "
                        "always for the linear kernel, cg_implicit")
    parser.add_argument("--preconditioner", default="none",
                        choices=["none", "jacobi"],
                        help="CG preconditioner; 'jacobi' can cut iterations "
                        "on ill-conditioned problems (default: none)")
    parser.add_argument("--gram_precision", default="f32",
                        choices=["f32", "bf16", "highest"],
                        help="Gram contraction precision of the CUDA kernels "
                        "on float32 data: f32 = TF32 operands on the tensor "
                        "cores, bf16 = bf16 operands, highest = full fp32 "
                        "FMA; float64 data and -b torch compute at full "
                        "precision")
    parser.add_argument("--debug", action="store_true",
                        help="NaN/Inf guards on the CG state: a numeric blowup "
                        "aborts with the failing iteration instead of silently "
                        "converging to a garbage model (one device and the ring)")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler trace of the fit to DIR "
                        "(Chrome trace JSON: CPU activity, and the card's "
                        "kernels when the fit runs on CUDA)")
    parser.add_argument(
        "--cross_validation", metavar="N", type=int, default=None,
        help="N-fold cross-validation mode (svm-train's -v n; -v is taken "
             "by --version here): prints the CV accuracy (classification) "
             "or MSE + squared correlation coefficient (regression) and "
             "exits WITHOUT writing a model file",
    )
    parser.add_argument(
        "--weight", metavar="LABEL=W", action="append", default=None,
        help="per-class regularization weight (repeatable; LIBSVM's -wi): "
             "class LABEL's diagonal regularizer becomes 1/(C*W) — Suykens' "
             "weighted LS-SVM for class imbalance",
    )
    parser.add_argument("--warm_start", metavar="MODEL_FILE", default=None,
                        help="warm-start CG from an existing model file's "
                        "alpha (same data set and classification) — "
                        "refine a converged model at a tighter -e or after "
                        "a -c change without solving from scratch")
    parser.add_argument(
        "-n", "--nu", type=float, default=0.5,
        help="one-class training outlier fraction (svm-train's -n for "
             "-s one_class): rho is the nu-quantile of the training "
             "scores, so ~nu of the training points land outside",
    )
    parser.add_argument(
        "--max_sv", metavar="N", type=int, default=None,
        help="sparse model (Suykens' pruning): after training, iteratively "
             "drop the smallest-|alpha| support vectors and refit "
             "(warm-started) until at most N remain — the model file "
             "stores only the N survivors",
    )
    parser.add_argument(
        "--nystroem", metavar="M", type=int, default=None,
        help="fixed-size LS-SVM: direct primal fit in an M-landmark "
             "Nystroem basis — the model stores only the M landmarks and "
             "training streams the data once in row blocks (O(M^2) device "
             "memory, any n)",
    )
    parser.add_argument(
        "--streaming", action="store_true",
        help="with --nystroem: train from the file in windowed native-parse "
             "passes (landmark gather, then the normal-equation reduction) "
             "— host memory stays O(window * d + M * d + n) at any n",
    )
    parser.add_argument("--checkpoint", metavar="FILE", default=None,
                        help="CG-state checkpoint file: training state is saved "
                        "every --checkpoint_interval iterations and an "
                        "interrupted run resumes from it automatically")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-process training over a torch.distributed job "
                        "(torchrun's environment, one rank a process and device): "
                        "each process parses only its window of the training file; "
                        "rank 0 writes the model")
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


def _profiled(args, device, fit, rank=None):
    """``fit()``, under ``torch.profiler`` when ``--profile DIR`` is given:
    CPU activity, and CUDA activity on a CUDA device; the trace goes to
    DIR/plssvm-torch-train[.rank<r>].pt.trace.json (the reference's
    ``jax.profiler.trace(DIR)`` around its fit)."""
    if args.profile is None:
        return fit()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    with profile(activities=activities) as prof:
        model = fit()
    name = "plssvm-torch-train" + ("" if rank is None else f".rank{rank}")
    prof.export_chrome_trace(os.path.join(args.profile, f"{name}.pt.trace.json"))
    return model


def _flag_conflict(args):
    """plssvm_tpu's message for the first pair of flags that do not go
    together, in its order, or None."""
    if args.probability and args.multihost:
        return ("--probability is not supported together with --multihost "
                "(the cross-validation fits are single-host)!")
    if args.cross_validation is not None and args.multihost:
        return "--cross_validation is not supported together with --multihost!"
    message = _compact_conflict(args)
    if message is not None:
        return message
    if args.svm_type == "one_class":
        if not 0.0 < args.nu < 1.0:
            return f"nu must be in (0, 1), but is {args.nu}!"
        for flag, name in ((args.cross_validation, "--cross_validation"),
                           (args.probability, "--probability"),
                           (args.weight, "--weight")):
            if flag:
                return f"-s one_class is not supported together with {name}!"
    if args.cross_validation is not None:
        # svm-train -v mode: report CV metrics, write no model
        for flag, name in ((args.probability, "--probability"),
                           (args.warm_start, "--warm_start"),
                           (args.checkpoint, "--checkpoint"),
                           (args.profile, "--profile")):
            if flag:
                return f"--cross_validation is not supported together with {name}!"
        if args.cross_validation < 2:
            return (f"n-fold cross validation: n must >= 2, but is "
                    f"{args.cross_validation}!")
    return None


def _compact_conflict(args):
    """plssvm_tpu's messages for ``--max_sv`` / ``--nystroem`` /
    ``--streaming`` against the other flags, in its order, or None.
    ``--nystroem --multihost`` passes here: they compose
    (``nystroem_fit_multihost``)."""
    if args.max_sv is not None or args.nystroem is not None:
        which = "--max_sv" if args.max_sv is not None else "--nystroem"
        if args.max_sv is not None and args.nystroem is not None:
            return "--max_sv and --nystroem are mutually exclusive!"
        rejects = [(args.warm_start, "--warm_start"), (args.checkpoint, "--checkpoint")]
        if args.max_sv is not None or args.svm_type == "one_class":
            rejects.append((args.multihost, "--multihost"))
        for flag, name in rejects:
            if flag:
                return f"{which} is not supported together with {name}!"
        if str(args.classification).lower() == "oao":
            return f"{which} supports binary/one-vs-all training only (--classification oaa)!"
        if (args.max_sv if args.max_sv is not None else args.nystroem) < 1:
            return f"{which} must be at least 1!"
    if args.streaming:
        if args.nystroem is None:
            return "--streaming requires --nystroem!"
        if args.multihost:
            return ("--streaming is not supported together with --multihost (the "
                    "multihost ingest is already windowed per host)!")
        for flag, name in ((args.probability, "--probability"), (args.weight, "--weight"),
                           (args.cross_validation, "--cross_validation")):
            # the calibration's and the CV's refits need the data in memory,
            # which --streaming never loads
            if flag:
                return f"--streaming is not supported together with {name}!"
    return None


def _compact_fit_fn(args, svm):
    """The fold fit of the calibration and the cross-validation of a
    compact model (``sparse.compact_fold_fit_fn``), or None."""
    if args.max_sv is None and args.nystroem is None:
        return None
    return compact_fold_fit_fn(svm, n_landmarks=args.nystroem, max_sv=args.max_sv,
                               epsilon=args.epsilon, max_iter=args.max_iter)


def _run_fit(args, svm, data, fit_kwargs, regression: bool, one_class: bool):
    """The fit the flags ask for: the streamed, Nystroem or pruned compact
    fits (sparse.py), the one-class fit, or ``CSVM.fit``."""
    if args.streaming:
        if one_class:
            return nystroem_fit_one_class_from_file(
                svm, args.input, n_landmarks=args.nystroem, nu=args.nu)
        return nystroem_fit_from_file(
            svm, args.input, n_landmarks=args.nystroem,
            label_type=resolve_label_type(args), regression=regression)
    if one_class:
        if args.nystroem is not None:
            return nystroem_fit_one_class(svm, data, n_landmarks=args.nystroem, nu=args.nu)
        if args.max_sv is not None:
            return pruned_fit_one_class(svm, data, n_sv=args.max_sv, nu=args.nu,
                                        epsilon=args.epsilon, max_iter=args.max_iter)
        oc_kwargs = {k: fit_kwargs[k] for k in ("initial_model", "checkpoint_path",
                                                 "checkpoint_interval")
                     if k in fit_kwargs}
        return fit_one_class(svm, data, nu=args.nu, epsilon=args.epsilon,
                             max_iter=args.max_iter, **oc_kwargs)
    if args.nystroem is not None:
        return nystroem_fit(svm, data, n_landmarks=args.nystroem,
                            sample_weight=fit_kwargs.get("sample_weight"))
    if args.max_sv is not None:
        return pruned_fit(svm, data, n_sv=args.max_sv, epsilon=args.epsilon,
                          max_iter=args.max_iter,
                          sample_weight=fit_kwargs.get("sample_weight"))
    return svm.fit(data, **fit_kwargs)


def _parse_class_weights(specs):
    """``--weight LABEL=W`` specs -> ``({label: W}, None)``, or ``(None,
    message)`` with plssvm_tpu's message for the first invalid one."""
    weights = {}
    for spec in specs:
        if "=" not in spec:
            return None, f"--weight expects LABEL=W, got '{spec}'!"
        lab, w = spec.split("=", 1)
        try:
            weight_value = float(w)
        except ValueError:
            return None, f"--weight expects a numeric W, got '{w}'!"
        if weight_value <= 0.0:
            # LIBSVM requires -wi weight > 0; w=0 would produce an inf
            # per-point regularizer and a silent NaN model
            return None, f"--weight values must be positive, got {weight_value}!"
        weights[lab.strip()] = weight_value
    return weights, None


def _expand_class_weights(per_class_weights, labels_arr) -> np.ndarray:
    """-wi per-class weights -> the per-point sample_weight vector.

    LIBSVM prints a warning for a -wi label matching no training class;
    unlisted classes get weight 1.0 (libsvm's -wi semantics).
    """
    present = {str(lab) for lab in labels_arr}
    for lab in per_class_weights:
        if lab not in present:
            print(
                f"WARNING: class label {lab} specified in "
                "weight is not found",
                file=sys.stderr,
            )
    return np.asarray(
        [per_class_weights.get(str(lab), 1.0) for lab in labels_arr],
        dtype=np.float64,
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
        regression = args.svm_type in ("epsilon_svr", "svr")
        one_class = args.svm_type == "one_class"
        per_class_weights = None
        if args.weight:
            if args.svm_type != "c_svc":
                print("--weight is only supported for classification training!",
                      file=sys.stderr)
                return 1
            per_class_weights, message = _parse_class_weights(args.weight)
            if message is not None:
                print(message, file=sys.stderr)
                return 1
        message = _flag_conflict(args)
        if message is not None:
            print(message, file=sys.stderr)
            return 1
        kernel = KernelFunctionType.from_string(args.kernel_type)
        log(
            VerbosityLevel.FULL,
            "\ntask: training\n{}\n\n",
            _format_params(args, kernel, model_filename),
        )
        add_tracking_entry("parameter", "kernel_type", str(kernel))
        add_tracking_entry("parameter", "epsilon", args.epsilon)
        if args.multihost:
            return _main_multihost(args, kernel, per_class_weights, model_filename, start)
        # --streaming never loads the data set: the fit parses windows of
        # the file
        data = None if args.streaming else DataSet(
            args.input,
            # LS-SVR: the label column holds continuous targets; a one-class
            # file may carry one label class or none, which are ignored
            label_type=float if (regression or one_class) else resolve_label_type(args),
            dtype=resolve_dtype(args),
            regression=regression or one_class,
        )
        svm = CSVM(
            backend=args.backend,
            target=args.target_platform,
            dtype=resolve_dtype(args),
            preconditioner=args.preconditioner,
            gram_precision=args.gram_precision,
            solver=args.solver,
            debug=args.debug,
            kernel_type=kernel,
            degree=args.degree,
            gamma=args.gamma,
            coef0=args.coef0,
            cost=args.cost,
        )
        fit_kwargs = dict(epsilon=args.epsilon, max_iter=args.max_iter,
                          classification=args.classification)
        if per_class_weights is not None:
            fit_kwargs["sample_weight"] = _expand_class_weights(
                per_class_weights, np.asarray(data.labels)
            )
        if (args.max_sv is not None and not regression and not one_class
                and data.has_labels() and args.max_sv < data.num_different_labels):
            # pruned_fit's class floor, checked before the first fit
            print(f"--max_sv ({args.max_sv}) must be at least the number of classes "
                  f"({data.num_different_labels})!", file=sys.stderr)
            return 1
        if args.cross_validation is not None:
            return _cross_validation(args, svm, data, fit_kwargs, start)
        if args.warm_start is not None:
            fit_kwargs["initial_model"] = Model.load(
                args.warm_start, label_type=resolve_label_type(args),
                dtype=resolve_dtype(args),
            )
        if args.checkpoint is not None:
            fit_kwargs["checkpoint_path"] = args.checkpoint
            fit_kwargs["checkpoint_interval"] = args.checkpoint_interval
        model = _profiled(args, svm.device, lambda: _run_fit(
            args, svm, data, fit_kwargs, regression, one_class))
        if args.probability:
            # the -wi weights stay in the CV subproblems, as LIBSVM's
            # svm_binary_svc_probability keeps them; a compact model
            # calibrates on compact folds
            calibrate_model(svm, model, data, epsilon=args.epsilon, max_iter=args.max_iter,
                            sample_weight=fit_kwargs.get("sample_weight"),
                            fit_fn=_compact_fit_fn(args, svm))
        model.save(model_filename)
    except NumericCheckError as exc:
        # the --debug guard: report the located failure as plssvm_tpu does
        print(f"numeric check failed: {exc}", file=sys.stderr)
        return 1
    except PLSSVMError as exc:
        print(exc, file=sys.stderr)
        return 1

    total_ms = (time.perf_counter() - start) * 1000.0
    log(VerbosityLevel.FULL | VerbosityLevel.TIMING, "\nTotal runtime: {:.2f}ms\n", total_ms)
    add_tracking_entry("", "total_time", total_ms)
    if args.performance_tracking is not None:
        global_tracker.save(args.performance_tracking)
    return 0


def _main_multihost(args, kernel, per_class_weights, model_filename, start) -> int:
    """``--multihost``: the fit over the job's processes (plssvm_tpu's
    multihost branch).  The process group comes up first, so that the
    CSVM lies on the rank's device; every rank fits the same model, and
    rank 0 alone writes it and the tracker's file."""
    from ..one_class import fit_one_class_multihost
    from ..parallel.multihost import RankGroup, _FileWindows, initialize_distributed
    from ..sparse import nystroem_fit_multihost

    initialize_distributed()
    svm = CSVM(
        backend=args.backend, target=args.target_platform, dtype=resolve_dtype(args),
        preconditioner=args.preconditioner, gram_precision=args.gram_precision,
        solver=args.solver, debug=args.debug, kernel_type=kernel, degree=args.degree,
        gamma=args.gamma, coef0=args.coef0, cost=args.cost,
    )
    rank = RankGroup(svm.device).rank
    writer = rank == 0
    regression = args.svm_type in ("epsilon_svr", "svr")
    fit_kwargs = dict(epsilon=args.epsilon, max_iter=args.max_iter)
    if per_class_weights is not None:
        # the label column is metadata: every process reads it whole
        raw = _FileWindows(args.input, np.float64, with_spans=False).raw_labels
        if raw is None:
            print("--weight with --multihost needs a labeled training file!",
                  file=sys.stderr)
            return 1
        from ..data_set import _infer_label_array

        fit_kwargs["sample_weight"] = _expand_class_weights(
            per_class_weights,
            np.asarray(_infer_label_array(list(raw), resolve_label_type(args))))
    if args.warm_start is not None:
        fit_kwargs["initial_model"] = Model.load(
            args.warm_start, label_type=resolve_label_type(args), dtype=resolve_dtype(args))
    if args.checkpoint is not None:
        fit_kwargs["checkpoint_path"] = args.checkpoint
        fit_kwargs["checkpoint_interval"] = args.checkpoint_interval

    def fit():
        if args.nystroem is not None:
            return nystroem_fit_multihost(
                svm, args.input, n_landmarks=args.nystroem,
                label_type=resolve_label_type(args), regression=regression,
                sample_weight=fit_kwargs.get("sample_weight"))
        if args.svm_type == "one_class":
            # (--weight is refused with -s one_class)
            return fit_one_class_multihost(svm, args.input, nu=args.nu, **fit_kwargs)
        return svm.fit_multihost(args.input, label_type=resolve_label_type(args),
                                 regression=regression,
                                 classification=args.classification, **fit_kwargs)

    model = _profiled(args, svm.device, fit, rank)
    if writer:
        model.save(model_filename)
    total_ms = (time.perf_counter() - start) * 1000.0
    log(VerbosityLevel.FULL | VerbosityLevel.TIMING, "\nTotal runtime: {:.2f}ms\n", total_ms)
    add_tracking_entry("", "total_time", total_ms)
    if args.performance_tracking is not None and writer:
        global_tracker.save(args.performance_tracking)
    return 0


def _cross_validation(args, svm, data, fit_kwargs, start) -> int:
    """svm-train's ``-v n`` mode: the N-fold CV accuracy (classification)
    or MSE and squared correlation coefficient (regression), logged at
    plssvm_tpu's levels; no model file is written."""
    result = cross_validate(
        svm, data, n_folds=args.cross_validation, epsilon=args.epsilon,
        max_iter=args.max_iter, classification=args.classification,
        sample_weight=fit_kwargs.get("sample_weight"),
        # compact fits report their own accuracy
        fit_fn=_compact_fit_fn(args, svm),
    )
    if "accuracy" in result:
        log(VerbosityLevel.FULL | VerbosityLevel.LIBSVM,
            "Cross Validation Accuracy = {}%\n", result["accuracy"] * 100.0)
    else:
        log(VerbosityLevel.FULL | VerbosityLevel.LIBSVM,
            "Cross Validation Mean squared error = {}\n"
            "Cross Validation Squared correlation coefficient = {}\n",
            result["mse"], result["scc"])
    if args.performance_tracking is not None:
        add_tracking_entry("", "total_time", (time.perf_counter() - start) * 1000.0)
        global_tracker.save(args.performance_tracking)
    return 0


if __name__ == "__main__":
    sys.exit(main())
