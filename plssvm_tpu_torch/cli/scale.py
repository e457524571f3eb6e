"""plssvm-scale equivalent: min-max scale a data set to an interval.

Counterpart of plssvm_tpu/cli/scale.py, with the same flags, messages and
output files; the files go through the native writer (native/) where it
is available.

reference: src/main_scale.cpp:25-85 + detail/cmd/parser_scale.cpp.
Usage: ``python -m plssvm_tpu_torch.cli.scale [options] input_file [scaled_file]``
If no scaled_file is given, the scaled data is written to stdout (the
LIBSVM svm-scale default behavior).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..data_set import DataSet, Scaling
from ..exceptions import PLSSVMError
from ..io import libsvm as libsvm_io
from ..parameter import FileFormatType
from ..utils.logger import VerbosityLevel, log
from ..utils.tracker import add_tracking_entry, global_tracker
from .common import (
    add_common_options,
    resolve_dtype,
    resolve_label_type,
    resolve_verbosity,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="plssvm-torch-scale",
        description="LS-SVM data scaling",
    )
    parser.add_argument("-l", "--lower", type=float, default=-1.0,
                        help="lower is the lowest (minimal) value allowed in each dimension")
    parser.add_argument("-u", "--upper", type=float, default=+1.0,
                        help="upper is the highest (maximal) value allowed in each dimension")
    parser.add_argument("-f", "--format", default="libsvm",
                        help="the file format to output the scaled data set to (libsvm|arff)")
    parser.add_argument("-s", "--save_filename", default=None,
                        help="the file to which the scaling factors should be saved")
    parser.add_argument("-r", "--restore_filename", default=None,
                        help="the file from which previous scaling factors should be loaded")
    add_common_options(parser)
    parser.add_argument("input", metavar="input_file")
    parser.add_argument("scaled", metavar="scaled_file", nargs="?", default=None)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    resolve_verbosity(args)

    if args.save_filename and args.restore_filename:
        # matches the reference's mutual-exclusion check (parser_scale.cpp)
        print("Error cannot use -s (--save_filename) and -r (--restore_filename) simultaneously!",
              file=sys.stderr)
        return 1
    if args.restore_filename is None and args.lower >= args.upper:
        print(f"Error invalid scaling range [lower, upper] with [{args.lower}, {args.upper}]!",
              file=sys.stderr)
        return 1

    # reference: src/main_scale.cpp:34 + parser_scale.cpp operator<<
    log(
        VerbosityLevel.FULL,
        "\ntask: scaling\n"
        "lower: {}\nupper: {}\n"
        "label_type: {}\n"
        "real_type: {}\n"
        "output file format: {}\n"
        "input file: '{}'\n"
        "scaled file: '{}'\n"
        "save file (scaling factors): '{}'\n"
        "restore file (scaling factors): '{}'\n\n",
        args.lower, args.upper,
        "str" if args.use_strings_as_labels else "int (default)",
        "float64" if args.use_double_as_real_type else "float32 (default)",
        args.format, args.input, args.scaled or "",
        args.save_filename or "", args.restore_filename or "",
    )

    start = time.perf_counter()
    try:
        if args.restore_filename is not None:
            scaling = Scaling(restore_filename=args.restore_filename)
        else:
            scaling = Scaling(args.lower, args.upper)
        try:
            data = DataSet(
                args.input,
                scaling=scaling,
                label_type=resolve_label_type(args),
                dtype=resolve_dtype(args),
            )
        except PLSSVMError as exc:
            if "At least two different labels" not in str(exc):
                raise
            # single-class files (e.g. one-class training data, all '+1')
            # scale fine under svm-scale — bypass the >=2-classes label
            # mapping; numeric labels round-trip through float inference
            try:
                data = DataSet(
                    args.input,
                    scaling=scaling,
                    dtype=resolve_dtype(args),
                    regression=True,
                )
            except ValueError:
                # non-numeric single-class labels: report the original
                # label-mapping error cleanly instead of a float() trace
                print(exc, file=sys.stderr)
                return 1
        if args.scaled is not None:
            data.save(args.scaled, file_format=args.format)
        else:
            # dump to stdout like LIBSVM's svm-scale (main_scale.cpp:38-61)
            fmt = FileFormatType.from_string(args.format)
            if fmt == FileFormatType.ARFF:
                import os
                import tempfile

                with tempfile.NamedTemporaryFile(
                    mode="r", suffix=".arff", delete=False
                ) as tmp:
                    tmp_name = tmp.name
                try:
                    data.save(tmp_name, file_format="arff")
                    with open(tmp_name) as fh:
                        sys.stdout.write(fh.read())
                finally:
                    os.unlink(tmp_name)
            else:
                for line in libsvm_io.write_libsvm_lines(data.data, data.labels):
                    print(line)
        if args.save_filename is not None:
            data.scaling_factors.save(args.save_filename)
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
