"""Shared CLI plumbing for the three tools.

reference: src/plssvm/detail/cmd/parser_{train,predict,scale}.cpp — the
flags and their semantics are reproduced 1:1 (argparse replaces cxxopts).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils.logger import VerbosityLevel, set_verbosity
from ..version import DESCRIPTION, __version__


def add_sycl_compat_options(parser: argparse.ArgumentParser) -> None:
    """Accept the reference's SYCL-backend flags as warn-and-ignore no-ops.

    plssvm-train/-predict take --sycl_kernel_invocation_type and
    --sycl_implementation_type (parser_train.cpp:60-61); the reference
    itself warns and ignores them when the backend is not SYCL
    (parser_train.cpp:168-183).  There is no SYCL backend here, so a
    migrated invocation always gets that warning path rather than an
    argparse error."""
    parser.add_argument(
        "--sycl_kernel_invocation_type", default="automatic",
        help="accepted for PLSSVM command-line compatibility; ignored "
        "(this framework has no SYCL backend)",
    )
    parser.add_argument(
        "--sycl_implementation_type", default="automatic",
        help="accepted for PLSSVM command-line compatibility; ignored "
        "(this framework has no SYCL backend)",
    )


def warn_ignored_sycl_options(args) -> None:
    """Reference-style warning when a SYCL flag was explicitly set
    (parser_train.cpp:168-183)."""
    import sys

    for flag in ("sycl_kernel_invocation_type", "sycl_implementation_type"):
        value = getattr(args, flag, "automatic")
        if value != "automatic":
            print(
                f"WARNING: explicitly set a SYCL {flag.split('sycl_')[1].replace('_', ' ')} "
                f"but this backend isn't SYCL; ignoring --{flag}={value}",
                file=sys.stderr,
            )


def add_common_options(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--performance_tracking",
        metavar="FILE",
        default=None,
        help="the output YAML file where the performance tracking results are "
        "written to; if not provided, the results are dumped to stderr",
    )
    parser.add_argument(
        "--use_strings_as_labels",
        action="store_true",
        help="use strings as labels instead of plane numbers",
    )
    parser.add_argument(
        "--use_float_as_real_type",
        action="store_true",
        help="use floats as real types instead of doubles "
        "(float32 is already the default)",
    )
    parser.add_argument(
        "--use_double_as_real_type",
        action="store_true",
        help="use doubles as real types (CPU and GPU)",
    )
    parser.add_argument(
        "--verbosity",
        choices=["full", "timing", "libsvm", "quiet"],
        default=None,
        help="choose the level of verbosity",
    )
    parser.add_argument(
        "-q", "--quiet",
        action="store_true",
        help="quiet mode (no outputs regardless the provided verbosity level!)",
    )
    parser.add_argument(
        "-v", "--version", action="version",
        version=f"%(prog)s {__version__} — {DESCRIPTION}",
    )


def resolve_verbosity(args: argparse.Namespace) -> None:
    """-q/--quiet has precedence over --verbosity (parser_train.cpp:194-210)."""
    if args.quiet:
        if args.verbosity and args.verbosity != "quiet":
            print(
                "WARNING: explicitly set the -q/--quiet flag, but the provided "
                f"verbosity level isn't \"quiet\"; setting --verbosity={args.verbosity} "
                "to --verbosity=quiet",
                file=sys.stderr,
            )
        set_verbosity(VerbosityLevel.QUIET)
    elif args.verbosity:
        set_verbosity(args.verbosity)


def resolve_dtype(args: argparse.Namespace):
    """Pick the real type.

    The reference defaults to float64 with ``--use_float_as_real_type``
    opting into float32 (parser_train.cpp:67).  The default here is
    float32, as in plssvm_tpu; ``--use_double_as_real_type`` restores the
    reference behavior (the H100 runs float64 natively).
    """
    if args.use_double_as_real_type:
        return np.float64
    return np.float32


def resolve_label_type(args: argparse.Namespace):
    return str if args.use_strings_as_labels else None
