"""Wrapper of kernel O (csrc/pairs.cu): the batched pair-machine matvec of
one-vs-one training.

:func:`pairs_matvec` computes, for every machine p of a (P, m_pad, d) stack
``Xb`` with ``lens[p]`` real rows, ``out[p, :lens[p]] = K(X_p, X_p) @
V[p, :lens[p]]`` with ``X_p = Xb[p, :lens[p]]``, and 0 past ``lens[p]``:
the product of the batched pairs CG (solver/cg.py ``solve_ls_svm_pairs``),
one launch per iteration for all C(C-1)/2 machines.  No Pallas kernel is
replaced: plssvm_tpu computes this product in XLA, a vmapped row-scan
matvec (plssvm_tpu/solver/cg.py:1104-1105).  The source note in
csrc/pairs.cu says how it is built and what bounds it.

As in ops/gram_matvec.py and ops/distance.py: the wrapper takes its plain
PyTorch version (:func:`pairs_matvec_plain`, one plain matvec of
ops/matvec.py per machine) for tensors that lie on the CPU, and only then;
for a CUDA tensor it launches kernel O or raises, never falls back.  It
counts its launches (and the plain version its calls) in plain
module-level ints.  float32 and float64, each computed in its own type at
full precision (FP32 FFMA, or float64): O takes no Gram tier.  The linear
kernel is not O's: its factored product is two ``torch.bmm`` calls
(:func:`linear_pairs_matvec`), the reference's XLA product.
"""

from __future__ import annotations

import torch

from ..kernel_functions import DISTANCE_KERNELS
from ..parameter import KernelFunctionType
from . import _build
from . import matvec as _plain
from .gram_matvec import _check_tensors, _raise_on_error, _require_cuda

#: kernel O's launches
launches = 0
#: calls of the plain version (CPU tensors)
plain_calls = 0
#: the most machines one launch takes (the grid's y extent)
MAX_MACHINES = 65535


def reset_counts() -> None:
    """Zero kernel O's launch count and the plain version's call count."""
    global launches, plain_calls
    launches = plain_calls = 0


def _check_kind(kind) -> None:
    if kind == KernelFunctionType.LINEAR:
        raise ValueError(
            "the linear kernel takes the factored Xb (Xb^T v) product "
            "(linear_pairs_matvec), not kernel O"
        )


def linear_pairs_matvec(Xb: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``Xb (Xb^T v)`` per machine: two ``torch.bmm`` calls, O(P m d).
    Padded rows of ``Xb`` are zero, so their outputs are 0."""
    return torch.bmm(Xb, torch.bmm(Xb.transpose(1, 2), V.unsqueeze(-1))).squeeze(-1)


def pairs_matvec_plain(
    Xb: torch.Tensor,
    sq_b,
    V: torch.Tensor,
    lens: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
) -> torch.Tensor:
    """Kernel O's function, one plain matvec per machine: the port's
    ``kernel_matvec_plain`` (full precision) or ``distance_matvec_plain``
    over the machine's ``lens[p]`` rows; 0 past them."""
    _check_kind(kind)
    global plain_calls
    plain_calls += 1
    out = torch.zeros(V.shape, dtype=V.dtype, device=V.device)
    for p, n in enumerate(lens.tolist()):
        if n == 0:
            continue
        X = Xb[p, :n]
        if kind in DISTANCE_KERNELS:
            out[p, :n] = _plain.distance_matvec_plain(X, V[p, :n], kind=kind, gamma=gamma)
        else:
            out[p, :n] = _plain.kernel_matvec_plain(
                X, sq_b[p, :n], V[p, :n], kind=kind, gamma=gamma, coef0=coef0,
                degree=degree, precision="highest")
    return out


def pairs_matvec(
    Xb: torch.Tensor,
    sq_b,
    V: torch.Tensor,
    lens: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma,
    coef0,
    degree: int,
) -> torch.Tensor:
    """``out[p, i] = sum_{j < lens[p]} k(Xb[p, i], Xb[p, j]) V[p, j]`` for
    ``i < lens[p]``, 0 past it (kernel O).

    ``Xb`` (P, m_pad, d), ``sq_b`` (P, m_pad) the rows' squared norms (None
    for laplacian and chi-squared, which read none), ``V`` (P, m_pad),
    ``lens`` (P,) int64 on Xb's device, each in [0, m_pad].  Polynomial,
    RBF, sigmoid, laplacian and chi-squared; P <= 65535.
    """
    _check_kind(kind)
    if Xb.device.type == "cpu":
        return pairs_matvec_plain(Xb, sq_b, V, lens, kind=kind, gamma=gamma,
                                  coef0=coef0, degree=degree)
    _require_cuda(Xb, "pairs_matvec")
    P, m_pad, d = Xb.shape
    named = [("Xb", Xb), ("V", V)]
    shapes = [(P, m_pad, d), (P, m_pad)]
    if kind not in DISTANCE_KERNELS:
        named.append(("sq_b", sq_b))
        shapes.append((P, m_pad))
    suffix = _check_tensors(named, shapes)
    if lens.dtype != torch.int64 or tuple(lens.shape) != (P,) or lens.device != Xb.device \
            or not lens.is_contiguous():
        raise ValueError(f"lens must be a contiguous ({P},) int64 tensor on {Xb.device}")
    if P > MAX_MACHINES:
        raise ValueError(f"kernel O takes at most {MAX_MACHINES} machines, not {P}")
    out = torch.zeros((P, m_pad), dtype=Xb.dtype, device=Xb.device)
    if P == 0 or m_pad == 0:
        return out
    lib = _build.load()
    fn = getattr(lib, f"plssvm_pairs_matvec_{suffix}")
    with torch.cuda.device(Xb.device):
        err = fn(
            Xb.data_ptr(), None if kind in DISTANCE_KERNELS else sq_b.data_ptr(),
            V.data_ptr(), lens.data_ptr(), out.data_ptr(), P, m_pad, d, int(kind),
            int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "pairs_matvec")
    global launches
    launches += 1
    return out
