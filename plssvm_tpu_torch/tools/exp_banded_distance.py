"""Time kernel I, the laplacian matvec split on 128-row bands.

    python -m plssvm_tpu_torch.tools.exp_banded_distance [--m 32768] [--d 128]
        [--iters 4] [--check] [--cpu]

The counterpart of tools/exp_banded_distance.py.  ``X`` (m, d) holds the
absolute values of seeded normal draws, float32, handed over transposed as
``XT`` (d, m); gamma = 1/d.  The timed loop runs ``iters`` normalised
products ``v <- (out_r + out_c) / |out_r + out_c|`` and prints the seconds
per product and TOP/s under the JAX tool's op model, 3 m^2 d / 2 (a
subtract, an absolute value and an add per pair and feature over half the
square).  On the card the loop is timed with CUDA events after one untimed
run, which also builds the kernels.

``--check`` instead compares ``out_r + out_c`` at m <= 512 with a float64
NumPy golden and exits 1 above a relative error of 1e-4.  ``--cpu`` runs
the plain version on the CPU; without it the tool runs on the GPU, and
fails where there is none.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.banded import banded_matvec
from . import seconds, tool_device

CHECK_MAX_M = 512
CHECK_TOL = 1e-4


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.exp_banded_distance",
        description="Time the banded laplacian matvec (kernel I).",
    )
    ap.add_argument("--m", type=int, default=32768, help="rows (default 32768)")
    ap.add_argument("--d", type=int, default=128, help="features (default 128)")
    ap.add_argument("--iters", type=int, default=4,
                    help="normalised products in the timed loop (default 4)")
    ap.add_argument("--check", action="store_true",
                    help=f"check against a float64 NumPy golden at m <= "
                         f"{CHECK_MAX_M} instead of timing")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain version on the CPU (default: the GPU)")
    return ap


def _data(rng, m, d):
    X = np.abs(rng.normal(size=(m, d))).astype(np.float32)
    v = rng.normal(size=(m,)).astype(np.float32)
    return X, v, float(np.float32(1.0 / d))


def _check(device, m, d) -> int:
    m = min(m, CHECK_MAX_M)
    X, v, gamma = _data(np.random.default_rng(0), m, d)
    out_r, out_c = banded_matvec(
        torch.as_tensor(np.ascontiguousarray(X.T), device=device),
        torch.as_tensor(v, device=device), gamma,
    )
    got = (out_r + out_c).cpu().numpy().astype(np.float64)
    Xd = X.astype(np.float64)
    dist = np.abs(Xd[:, None, :] - Xd[None, :, :]).sum(-1)
    want = np.exp(-gamma * dist) @ v.astype(np.float64)
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    print(f"check on {device.type} m={m} d={d}: rel err {err:.3e}", flush=True)
    return 0 if err < CHECK_TOL else 1


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = tool_device(args.cpu, "exp_banded_distance")
    if device is None:
        return 1
    if args.check:
        return _check(device, args.m, args.d)

    m, d = args.m, args.d
    X, v, gamma = _data(np.random.default_rng(0), m, d)
    XT = torch.as_tensor(np.ascontiguousarray(X.T), device=device)
    v0 = torch.as_tensor(v, device=device)

    def run():
        vv = v0
        for _ in range(args.iters):
            out_r, out_c = banded_matvec(XT, vv, gamma)
            out = out_r + out_c
            vv = out / torch.linalg.norm(out)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"first run on {name} (kernel build included): "
          f"{seconds(run, device):.1f}s", flush=True)
    dt = seconds(run, device) / args.iters
    tops = 3.0 * m * m * d / 2 / dt / 1e12  # the JAX tool's op model
    print(f"banded: {dt:.4f} s/matvec, {tops:.2f} TOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
