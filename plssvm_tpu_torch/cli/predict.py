"""plssvm-predict equivalent: predict labels with a trained model file.

reference: src/main_predict.cpp:29-103 + detail/cmd/parser_predict.cpp.
Usage: ``python -m plssvm_tpu_torch.cli.predict [options] test_file model_file [output_file]``

One-class models predict +1 / -1 per point.  ``--probability`` writes
LIBSVM's ``svm-predict -b 1`` layout for a calibrated model (a ``labels``
header, then each point's label and its class probabilities in the
header's order); on a calibrated regression model it prints the Laplace
noise line and writes the predicted values.  ``--multihost`` predicts over
the processes of a ``torch.distributed`` job: each scores its window of the
test file, and rank 0 writes the output and prints the accuracy.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..csvm import CSVM
from ..data_set import DataSet
from ..exceptions import PLSSVMError
from ..model import Model
from ..probability import predict_probabilities
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
        prog="plssvm-torch-predict",
        description="LS-SVM prediction (PyTorch + hand-written CUDA kernels)",
    )
    parser.add_argument("-b", "--backend", default="automatic",
                        help="choose the backend: automatic|torch|cuda")
    parser.add_argument("-p", "--target_platform", default="automatic",
                        help="choose the target platform: automatic|cpu|gpu; "
                             "automatic takes the GPU and fails without one, "
                             "-p cpu is the only way to the CPU")
    parser.add_argument("--probability", action="store_true",
                        help="output class probabilities (svm-predict's -b 1); "
                        "the model must be trained with --probability")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-process prediction over a torch.distributed job: "
                        "each process reads and scores only its window of the test "
                        "file; rank 0 writes the output file")
    add_sycl_compat_options(parser)
    add_common_options(parser)
    parser.add_argument("test", metavar="test_file")
    parser.add_argument("model", metavar="model_file")
    parser.add_argument("output", metavar="output_file", nargs="?", default=None)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    resolve_verbosity(args)
    warn_ignored_sycl_options(args)

    predict_filename = args.output
    if predict_filename is None:
        # default: <test basename>.predict (parser_predict.cpp:156-159)
        predict_filename = os.path.basename(args.test) + ".predict"

    # reference: src/main_predict.cpp:38 + parser_predict.cpp operator<<
    log(
        VerbosityLevel.FULL,
        "\ntask: prediction\n"
        "label_type: {}\n"
        "real_type: {}\n"
        "input file (data set): '{}'\n"
        "input file (model): '{}'\n"
        "output file (prediction): '{}'\n\n",
        "str" if args.use_strings_as_labels else "int (default)",
        "float64" if args.use_double_as_real_type else "float32 (default)",
        args.test, args.model, predict_filename,
    )

    if args.multihost and args.probability:
        print("--probability is not supported together with --multihost!",
              file=sys.stderr)
        return 1

    start = time.perf_counter()
    try:
        if args.multihost:
            return _main_multihost(args, predict_filename, start)
        model = Model.load(
            args.model,
            label_type=resolve_label_type(args),
            dtype=resolve_dtype(args),
        )
        data = DataSet(
            args.test,
            label_type=resolve_label_type(args),
            dtype=resolve_dtype(args),
            # a regression model's test file holds continuous targets, and
            # a one-class file one label class or none: no label mapping
            regression=model.is_regression or model.is_one_class,
        )
        svm = CSVM(
            backend=args.backend,
            target=args.target_platform,
            dtype=resolve_dtype(args),
        )
        probabilities = None
        if args.probability and model.prob_a is None:
            print("Model does not support probability estimates — train "
                  "with plssvm-train --probability!", file=sys.stderr)
            return 1
        if args.probability and model.is_regression:
            # svm-predict -b 1 on an SVR model: the predicted values and
            # the Laplace noise model line
            log(
                VerbosityLevel.FULL | VerbosityLevel.LIBSVM,
                "Prob. model for test data: target value = predicted value "
                "+ z,\nz: Laplace distribution e^(-|z|/sigma)/(2sigma), "
                "sigma={}\n",
                float(model.prob_a[0]),
            )
            predicted = svm.predict(model, data)
        elif args.probability:
            values = svm.predict_values(model, data)
            # svm-predict -b 1's columns: the model's class order (its
            # file's label header); the label is the argmax of the
            # calibrated probabilities (it may differ from sign(f) near 0.5)
            probabilities = predict_probabilities(model, values, columns="layout")
            typed = {str(c): c for c in model.data.different_labels}
            classes = np.asarray([typed[str(c)] for c in model.class_order()])
            predicted = classes[np.argmax(probabilities, axis=1)]
        else:
            predicted = svm.predict(model, data)
    except PLSSVMError as exc:
        print(exc, file=sys.stderr)
        return 1

    write_start = time.perf_counter()
    with open(predict_filename, "w", encoding="utf-8") as fh:
        # one label (regression: one predicted value) per line, each
        # terminated by '\n' (src/main_predict.cpp:53-84)
        if model.is_regression:
            for v in predicted:
                fh.write(format(v, ".10g") + "\n")
        elif probabilities is None:
            for lab in predicted:
                fh.write(str(lab) + "\n")
        else:
            # svm-predict -b 1: a 'labels <classes>' header, then 'label
            # P(c1) P(c2) ...' per point in the header's class order
            fh.write("labels " + " ".join(str(c) for c in model.class_order()) + "\n")
            for lab, row in zip(predicted, probabilities):
                fh.write(str(lab) + " " + " ".join(format(p, ".10g") for p in row) + "\n")
    write_ms = (time.perf_counter() - write_start) * 1000.0
    log(
        VerbosityLevel.FULL | VerbosityLevel.TIMING,
        "Write {} predictions in {:.2f}ms to the file '{}'.\n",
        len(predicted), write_ms, predict_filename,
    )
    add_tracking_entry("predictions_write", "num_predictions", len(predicted))
    add_tracking_entry("predictions_write", "filename", predict_filename)

    # print achieved accuracy if the test data is labeled (main_predict.cpp:70-85)
    if data.has_labels():
        _log_metrics(model, predicted, data.labels)

    total_ms = (time.perf_counter() - start) * 1000.0
    log(VerbosityLevel.FULL | VerbosityLevel.TIMING, "\nTotal runtime: {:.2f}ms\n", total_ms)
    add_tracking_entry("", "total_time", total_ms)
    if args.performance_tracking is not None:
        global_tracker.save(args.performance_tracking)
    return 0


def _log_metrics(model, predicted, labels) -> None:
    """svm-predict's accuracy line, or its regression metrics."""
    if model.is_regression:
        targets = np.asarray(labels, dtype=np.float64)
        values = np.asarray(predicted, dtype=np.float64)
        mse = float(np.mean((values - targets) ** 2))
        vt = targets - targets.mean()
        vv = values - values.mean()
        denom = float(np.sum(vt * vt) * np.sum(vv * vv))
        scc = float(np.sum(vt * vv)) ** 2 / denom if denom > 0 else 0.0
        log(
            VerbosityLevel.FULL | VerbosityLevel.LIBSVM,
            "Mean squared error = {} (regression)\n"
            "Squared correlation coefficient = {} (regression)\n",
            mse, scc,
        )
        return
    correct = int(np.sum(np.asarray(predicted) == np.asarray(labels)))
    log(
        VerbosityLevel.FULL | VerbosityLevel.LIBSVM,
        "Accuracy = {}% ({}/{}) (classification)\n",
        correct / len(predicted) * 100.0, correct, len(predicted),
    )


def _main_multihost(args, predict_filename: str, start: float) -> int:
    """``--multihost``: each rank predicts its window of the test file
    (``parallel/multihost.py::predict_multihost``); rank 0 writes the
    output file and prints the metrics (plssvm_tpu's ``_main_multihost``)."""
    from ..data_set import _infer_label_array
    from ..parallel.multihost import RankGroup, initialize_distributed, predict_multihost

    initialize_distributed()
    model = Model.load(args.model, label_type=resolve_label_type(args),
                       dtype=resolve_dtype(args))
    svm = CSVM(backend=args.backend, target=args.target_platform, dtype=resolve_dtype(args))
    predicted, raw_labels, n = predict_multihost(svm, model, args.test)
    if RankGroup(svm.device).rank != 0:
        return 0
    write_start = time.perf_counter()
    with open(predict_filename, "w", encoding="utf-8") as fh:
        if model.is_regression:
            for v in predicted:
                fh.write(format(v, ".10g") + "\n")
        else:
            for lab in predicted:
                fh.write(str(lab) + "\n")
    log(
        VerbosityLevel.FULL | VerbosityLevel.TIMING,
        "Write {} predictions in {:.2f}ms to the file '{}'.\n",
        len(predicted), (time.perf_counter() - write_start) * 1000.0, predict_filename,
    )
    if raw_labels is not None:
        label_type = (float if model.is_regression
                      else int if model.is_one_class else resolve_label_type(args))
        _log_metrics(model, predicted, _infer_label_array(list(raw_labels), label_type))
    total_ms = (time.perf_counter() - start) * 1000.0
    log(VerbosityLevel.FULL | VerbosityLevel.TIMING, "\nTotal runtime: {:.2f}ms\n", total_ms)
    add_tracking_entry("", "total_time", total_ms)
    if args.performance_tracking is not None:
        global_tracker.save(args.performance_tracking)
    return 0


if __name__ == "__main__":
    sys.exit(main())
