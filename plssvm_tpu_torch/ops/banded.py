"""Wrapper of the hand-written CUDA banded laplacian matvec (csrc/banded.cu).

Kernel I, :func:`banded_matvec` — the laplacian ``K(X, X) @ v`` from the
transposed operand ``XT`` (d, m), returned as two halves ``(out_r, out_c)``
split on 128-row bands — replaces tools/exp_banded_distance.py
``banded_matvec``.  With ``b(i) = i // 128``:

- ``symmetric=True``: ``out_r[i]`` sums ``k(i, j) v[j]`` over the j with
  ``b(j) >= b(i)`` and ``out_c[j]`` sums ``k(i, j) v[i]`` over the i with
  ``b(i) < b(j)``, so ``out_r + out_c = K @ v``;
- ``symmetric=False``: ``out_r = K @ v`` and ``out_c = K.T @ v``.

As the other wrappers (ops/gram_matvec.py): CPU tensors take the plain
PyTorch version (ops/matvec.py ``banded_matvec_plain``), and only they; a
CUDA tensor launches the kernel or raises.  ``launches`` counts the
launches.  float32 and float64, any m and d: the TPU's ``m % 128 == 0``
and ``d % 8 == 0`` layout rules are not ported, the band split is.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from . import matvec as _plain
from .gram_matvec import _check_tensors, _require_cuda, call_entry

#: kernel launches of banded_matvec
launches = 0


def reset_counts() -> None:
    """Zero the launch count of kernel I and the call count of its plain
    version."""
    global launches
    launches = 0
    _plain.banded_plain_calls = 0


def banded_matvec(
    XT: torch.Tensor, v: torch.Tensor, gamma: float, *, symmetric: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out_r, out_c)`` of the laplacian kernel over the columns of ``XT``
    (d, m) against ``v`` (m,) (kernel I)."""
    if XT.device.type == "cpu":
        return _plain.banded_matvec_plain(XT, v, gamma, symmetric=symmetric)
    _require_cuda(XT, "banded_matvec")
    if XT.ndim != 2:
        raise ValueError(f"XT must be (d, m), not of shape {tuple(XT.shape)}")
    d, m = XT.shape
    suffix = _check_tensors([("XT", XT), ("v", v)], [(d, m), (m,)])
    out_r = torch.zeros((m,), dtype=XT.dtype, device=XT.device)
    out_c = torch.zeros((m,), dtype=XT.dtype, device=XT.device)
    if m == 0:
        return out_r, out_c
    lib = _build.load()
    call_entry(lib, getattr(lib, f"plssvm_banded_matvec_{suffix}"), XT.device, (
        XT.data_ptr(), v.data_ptr(), out_r.data_ptr(), out_c.data_ptr(),
        m, d, int(bool(symmetric)), float(gamma),
    ), "banded_matvec")
    global launches
    launches += 1
    return out_r, out_c
