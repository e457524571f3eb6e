"""Wrapper of kernel O: the batched pair-machine matvec of one-vs-one
training (csrc/pairs.cu, csrc/pairs_tc.cu).

:func:`pairs_matvec` computes, for every machine p of a (P, m_pad, d) stack
``Xb`` with ``lens[p]`` real rows, ``out[p, :lens[p]] = K(X_p, X_p) @
V[p, :lens[p]]`` with ``X_p = Xb[p, :lens[p]]``, and 0 past ``lens[p]``:
the product of the batched pairs CG (solver/cg.py ``solve_ls_svm_pairs``),
one launch per iteration for all C(C-1)/2 machines.  No Pallas kernel is
replaced: plssvm_tpu computes this product in XLA, a vmapped row-scan
matvec (plssvm_tpu/solver/cg.py:1104-1105) whose dot takes the TPU's
default precision, one bf16 MXU pass: the reference's "f32" tier.  The
source notes in csrc/pairs.cu and csrc/pairs_tc.cu say how the walks are
built and what bounds them.

``precision`` is the fit's Gram tier, as for kernels A-D.  On CUDA tensors
the polynomial, RBF and sigmoid kernels take the tensor-core walk of
csrc/pairs_tc.cu: float32 at "f32" on TF32 operands and at "bf16" on bf16
operands, f32 accumulation in both (``tc_launches``), float64 on the FP64
tensor cores at every tier (``dmma_launches``).  Float32 at "highest", and
laplacian and chi-squared in either type, take the FFMA walk of
csrc/pairs.cu (``launches``), full precision: each machine's upper
triangle of tiles once, its row and column partials written to a
workspace and summed per row by a second launch in an order fixed by the
machine's own length, so a product is two launches and one count.  The
workspace is uninitialised and made per product, as ``out`` is; its size
is the C side's (``plssvm_pairs_workspace_elements``), which alone holds
its layout.  The tensor-core walks read an operand copy of the stack
(:func:`pairs_operand`: TF32-rounded or bf16, or float64 with an even
feature axis), which a solve makes once and hands to every product;
without it the wrapper makes one per call.

As in ops/gram_matvec.py: the wrapper takes its plain PyTorch version
(:func:`pairs_matvec_plain`, one plain matvec of ops/matvec.py per machine)
for tensors that lie on the CPU, and only then, at full precision whatever
the tier (the CPU tests hold it against plssvm_tpu's XLA product); for a
CUDA tensor it launches a walk or raises, never falls back.  It counts its
launches (and the plain version its calls) in plain module-level ints.  The
linear kernel is not O's: its factored product is two ``torch.bmm`` calls
(:func:`linear_pairs_matvec`), the reference's XLA product.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernel_functions import DISTANCE_KERNELS
from ..parameter import KernelFunctionType
from . import _build
from . import matvec as _plain
from .gram_matvec import (
    ONE_PASS_TIERS, _TC_TIERS, _check_tensors, _raise_on_error, _require_cuda, dmma_operand,
    tier_operand,
)

#: kernel O's launches on the FFMA walk (csrc/pairs.cu), on the TF32 / bf16
#: tensor-core walk and on the float64 DMMA walk (csrc/pairs_tc.cu)
launches = 0
tc_launches = 0
dmma_launches = 0
#: calls of the plain version (CPU tensors)
plain_calls = 0
#: the most machines one launch takes (the grid's y extent)
MAX_MACHINES = 65535


def reset_counts() -> None:
    """Zero kernel O's launch counts and the plain version's call count."""
    global launches, tc_launches, dmma_launches, plain_calls
    launches = tc_launches = dmma_launches = plain_calls = 0


def _check_kind(kind) -> None:
    if kind == KernelFunctionType.LINEAR:
        raise ValueError(
            "the linear kernel takes the factored Xb (Xb^T v) product "
            "(linear_pairs_matvec), not kernel O"
        )


def walk(Xb: torch.Tensor, kind, precision: str) -> str:
    """Which of kernel O's walks a stack takes: "plain" on the CPU, "ffma"
    (csrc/pairs.cu, the triangle walk and its reduction) for the distance
    kinds and for float32 at "highest", "dmma" for the Gram kinds in
    float64, "tc" for them in float32 at "f32" and "bf16"
    (csrc/pairs_tc.cu)."""
    _plain.check_precision(precision)
    if Xb.device.type == "cpu":
        return "plain"
    if kind in DISTANCE_KERNELS:
        return "ffma"
    if Xb.dtype == torch.float64:
        return "dmma"
    return "tc" if precision in ONE_PASS_TIERS else "ffma"


def pairs_operand(Xb: torch.Tensor, kind, precision: str) -> Optional[torch.Tensor]:
    """The operand copy the tensor-core walks read, ``(P m_pad, d_pad)``:
    ``tier_operand``'s TF32-rounded or bf16 rows in float32, ``dmma_operand``'s
    rows (Xb itself when d is even and aligned) in float64; None where the
    stack takes another walk.  The squared norms stay those of ``Xb``."""
    route = walk(Xb, kind, precision)
    if route == "tc":
        return tier_operand(Xb.reshape(-1, Xb.shape[2]), precision)
    if route == "dmma":
        return dmma_operand(Xb.reshape(-1, Xb.shape[2]))
    return None


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
    precision: str = "f32",
) -> torch.Tensor:
    """Kernel O's function, one plain matvec per machine: the port's
    ``kernel_matvec_plain`` at the tier ``precision`` (as it takes it: "bf16"
    on bf16-rounded float32 rows with the float32 norms, else full
    precision) or ``distance_matvec_plain`` over the machine's ``lens[p]``
    rows; 0 past them."""
    _check_kind(kind)
    _plain.check_precision(precision)
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
                degree=degree, precision=precision)
    return out


def _check_operand(op: torch.Tensor, Xb: torch.Tensor, kind, precision: str) -> None:
    """``op`` must be what :func:`pairs_operand` makes of ``Xb``: its rows,
    type and padded feature axis."""
    P, m_pad, d = Xb.shape
    if walk(Xb, kind, precision) == "tc":
        dtype, multiple = _TC_TIERS[precision][1:]
    else:
        dtype, multiple = torch.float64, 2
    d_pad = d + (-d % multiple)
    if (op.dtype != dtype or op.device != Xb.device or not op.is_contiguous()
            or op.ndim != 2 or op.shape[0] != P * m_pad or op.shape[1] not in (d, d_pad)
            or op.shape[1] % multiple):
        raise ValueError(
            f"the operand copy must be pairs_operand's ({P * m_pad}, {d_pad}) {dtype} "
            f"rows of the stack, not {tuple(op.shape)} {op.dtype}")


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
    precision: str = "f32",
    operand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[p, i] = sum_{j < lens[p]} k(Xb[p, i], Xb[p, j]) V[p, j]`` for
    ``i < lens[p]``, 0 past it (kernel O).

    ``Xb`` (P, m_pad, d), ``sq_b`` (P, m_pad) the rows' squared norms (None
    for laplacian and chi-squared, which read none), ``V`` (P, m_pad),
    ``lens`` (P,) int64 on Xb's device, each in [0, m_pad].  Polynomial,
    RBF, sigmoid, laplacian and chi-squared; P <= 65535.  ``precision`` the
    Gram tier (:func:`walk` says which walk it takes); ``operand`` the
    tensor-core walks' copy of the stack (:func:`pairs_operand`),
    made here when not given and ignored by the FFMA walk.
    """
    _check_kind(kind)
    route = walk(Xb, kind, precision)
    if route == "plain":
        return pairs_matvec_plain(Xb, sq_b, V, lens, kind=kind, gamma=gamma,
                                  coef0=coef0, degree=degree, precision="highest")
    suffix = _check_stack(Xb, sq_b, V, lens, kind, "pairs_matvec")
    P, m_pad, _ = Xb.shape
    out = torch.zeros((P, m_pad), dtype=Xb.dtype, device=Xb.device)
    if P == 0 or m_pad == 0:
        return out
    if route == "ffma":
        return _launch_ffma(Xb, sq_b, V, lens, out, suffix, kind, gamma, coef0, degree)
    if operand is None:
        operand = pairs_operand(Xb, kind, precision)
    else:
        _check_operand(operand, Xb, kind, precision)
    name = _TC_TIERS[precision][0] if route == "tc" else "dmma"
    lib = _build.load()
    with torch.cuda.device(Xb.device):
        err = getattr(lib, f"plssvm_pairs_matvec_{name}")(
            operand.data_ptr(), sq_b.data_ptr(), V.data_ptr(), lens.data_ptr(),
            out.data_ptr(), P, m_pad, operand.shape[1], int(kind), int(degree),
            float(gamma), float(coef0), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, f"pairs_matvec ({name})")
    global tc_launches, dmma_launches
    if route == "tc":
        tc_launches += 1
    else:
        dmma_launches += 1
    return out


def _check_stack(Xb, sq_b, V, lens, kind, name: str) -> str:
    """Validate a CUDA stack and its lengths; return the entry-point
    suffix."""
    _require_cuda(Xb, name)
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
    return suffix


def _launch_ffma(Xb, sq_b, V, lens, out, suffix, kind, gamma, coef0, degree):
    """Kernel O's FFMA walk (csrc/pairs.cu) and its reduction into the
    zeroed ``out``, on a workspace of the size the C side gives (under 17
    (m_pad + 16 x 128) values a machine: 17 / d of the stack plus a few MB,
    which ``_use_oao_batched``'s budget, the stack alone as plssvm_tpu's,
    does not count)."""
    lib = _build.load()
    fn = getattr(lib, f"plssvm_pairs_matvec_{suffix}")
    P, m_pad, d = Xb.shape
    n = lib.plssvm_pairs_workspace_elements(P, m_pad, int(kind), int(suffix == "f64"))
    workspace = torch.empty(n, dtype=Xb.dtype, device=Xb.device)
    with torch.cuda.device(Xb.device):
        err = fn(
            Xb.data_ptr(), None if kind in DISTANCE_KERNELS else sq_b.data_ptr(),
            V.data_ptr(), lens.data_ptr(), out.data_ptr(), workspace.data_ptr(), P, m_pad,
            d, int(kind), int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "pairs_matvec")
    global launches
    launches += 1
    return out


def ffma_pairs_matvec(
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
    """Kernel O's FFMA walk (csrc/pairs.cu) on CUDA tensors whatever the
    kind's route: the float64 Gram triangle walk that the DMMA walk
    replaced, kept to be timed beside it.
    Counted in ``launches``."""
    _check_kind(kind)
    suffix = _check_stack(Xb, sq_b, V, lens, kind, "ffma_pairs_matvec")
    P, m_pad, _ = Xb.shape
    out = torch.zeros((P, m_pad), dtype=Xb.dtype, device=Xb.device)
    if P == 0 or m_pad == 0:
        return out
    return _launch_ffma(Xb, sq_b, V, lens, out, suffix, kind, gamma, coef0, degree)
