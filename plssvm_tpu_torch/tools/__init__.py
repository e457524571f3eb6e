"""Command-line measurement tools of the port, each run as
``python -m plssvm_tpu_torch.tools.<name>``: ``exp_banded_distance`` (kernel
I) and ``bench_matvec`` (the kernel matvecs side by side)."""

from __future__ import annotations

import sys
import time
from typing import Optional

import torch


def tool_device(cpu: bool, tool: str) -> Optional[torch.device]:
    """The CPU when the caller asks for it (``--cpu``), else the GPU; None,
    after saying why on stderr, where there is no GPU."""
    if cpu:
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda")
    print(f"{tool} runs on a CUDA device, and none is available; --cpu runs "
          "it on the CPU", file=sys.stderr)
    return None


def seconds(fn, device: torch.device) -> float:
    """Seconds one call of ``fn()`` takes: CUDA events around it on the
    card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1000.0
