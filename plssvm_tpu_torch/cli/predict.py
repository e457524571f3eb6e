"""plssvm-predict equivalent: predict labels with a trained model file.

reference: src/main_predict.cpp:29-103 + detail/cmd/parser_predict.cpp.
Usage: ``python -m plssvm_tpu_torch.cli.predict [options] test_file model_file [output_file]``
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..csvm import CSVM
from ..data_set import DataSet
from ..exceptions import NotPortedError, PLSSVMError
from ..model import Model
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
                        help="output class probabilities (not ported yet)")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host prediction (not ported yet)")
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

    start = time.perf_counter()
    try:
        if args.multihost:
            raise NotPortedError(
                "--multihost is not ported yet (ROADMAP Queue 1, item 10: "
                "multihost on torch.distributed)"
            )
        if args.probability:
            raise NotPortedError(
                "--probability is not ported yet (ROADMAP Queue 1, item 7: "
                "calibration and CV)"
            )
        model = Model.load(
            args.model,
            label_type=resolve_label_type(args),
            dtype=resolve_dtype(args),
        )
        data = DataSet(
            args.test,
            label_type=resolve_label_type(args),
            dtype=resolve_dtype(args),
        )
        svm = CSVM(
            backend=args.backend,
            target=args.target_platform,
            dtype=resolve_dtype(args),
        )
        predicted = svm.predict(model, data)
    except PLSSVMError as exc:
        print(exc, file=sys.stderr)
        return 1

    write_start = time.perf_counter()
    with open(predict_filename, "w", encoding="utf-8") as fh:
        # one label per line, each terminated by '\n'
        # (src/main_predict.cpp:53-84)
        for lab in predicted:
            fh.write(str(lab) + "\n")
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
        correct = int(np.sum(np.asarray(predicted) == np.asarray(data.labels)))
        log(
            VerbosityLevel.FULL | VerbosityLevel.LIBSVM,
            "Accuracy = {}% ({}/{}) (classification)\n",
            correct / data.num_data_points * 100.0,
            correct,
            data.num_data_points,
        )

    total_ms = (time.perf_counter() - start) * 1000.0
    log(VerbosityLevel.FULL | VerbosityLevel.TIMING, "\nTotal runtime: {:.2f}ms\n", total_ms)
    add_tracking_entry("", "total_time", total_ms)
    if args.performance_tracking is not None:
        global_tracker.save(args.performance_tracking)
    return 0


if __name__ == "__main__":
    sys.exit(main())
