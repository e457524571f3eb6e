"""The devices torch sees here, and the backend and target settings to use.

    python -m plssvm_tpu_torch.tools.plssvm_target_platforms [--quiet]

The counterpart of tools/plssvm_target_platforms.py, with its argument:
torch's version and CUDA build, each CUDA device with its name, compute
capability and memory, the CPU, then the settings the CLIs take:
``--target_platform=gpu --backend=cuda`` where a CUDA device is there (the
hand-written kernels), else ``--target_platform=cpu --backend=torch`` (the
plain versions).  ``--quiet`` prints the settings alone.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.plssvm_target_platforms",
        description="List torch's devices and suggest the backend and target.",
    )
    ap.add_argument("--quiet", action="store_true", help="only output the final target string")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cuda = torch.cuda.is_available()
    if not args.quiet:
        print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
        for i in range(torch.cuda.device_count() if cuda else 0):
            props = torch.cuda.get_device_properties(i)
            print(f"  cuda:{i}: {props.name} (compute capability "
                  f"{props.major}.{props.minor}, {props.total_memory / 2**30:.1f} GiB, "
                  f"{props.multi_processor_count} SMs)")
        print(f"  cpu: {os.cpu_count()} logical cores")
        print()
        print("suggested settings:")
    target, backend = ("gpu", "cuda") if cuda else ("cpu", "torch")
    print(f"--target_platform={target} --backend={backend}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
