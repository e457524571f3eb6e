"""Command-line measurement tools of the port, each run as
``python -m plssvm_tpu_torch.tools.<name>``: ``exp_banded_distance`` (kernel
I), ``bench_matvec`` (the kernel matvecs side by side),
``bench_gram_f64`` (kernels A and C, or J and K, in float64 on the DMMA
tiles, one checkout's tiles at a time), ``bench_highest`` (kernels A-D and
K at "highest" on the tensor cores beside their FFMA tiles, one
checkout's tiles at a time), ``bench_kernel_matrix`` (kernel N's
symmetric walk, one checkout at a time) and ``bench_explicit`` (the
explicit solver's build and product beside the implicit product: the Gram
crossover of ``solver="automatic"``); and the counterparts of the JAX
package's root tools, with their arguments: ``bench_matmat`` (kernel C),
``bench_distance`` (kernel E), ``bench_solver`` (the explicit against the
implicit iteration), ``scaling_sweep`` (the row-sharded fit over device
counts, and over the processes of a job), ``scaling_projection`` (the
ring's transfers a CG iteration, counted on CPU ranks, and a projection
over cards), ``performance_analysis`` (tracked fits of one generated data
set), ``performance_tracker_yaml_parser`` (the tracker's YAML as a table)
and ``plssvm_target_platforms`` (torch's devices and the settings to
use).  Each runs on the card unless given ``--cpu`` (the parser, the
platforms and ``scaling_projection``'s count take no card)."""

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
