"""Wrappers of the hand-written CUDA Gram matvecs (csrc/gram_matvec.cu).

Kernel A, :func:`gram_matvec_sym` — ``K(X, X) @ v``, every CG iteration —
replaces plssvm_tpu/ops/pallas_matvec.py ``kernel_matvec_pallas_dual``
with ``symmetric=True`` (through ``kernel_matvec_pallas_big``).  Kernel B,
:func:`gram_matvec_rect` — ``K(P, S) @ a``, binary predict — replaces the
non-symmetric branch of ``kernel_matvec_pallas_rect``.  The source notes in
csrc/gram_matvec.cu and csrc/gram_tc.cuh say how they are built and what
bounds them.  :func:`kernel_matvec` replaces ``kernel_matvec_pallas`` (K6),
the JAX package's thin wrapper that routes ``K(X, X) @ v`` to the same
symmetric kernel; here it is one launch of kernel A.  Kernel J,
:func:`gram_matvec_dual` — ``(K(Xr, Xc) @ v_c, K(Xr, Xc)^T @ v_r)``, the
row-sharded ring's off-diagonal block (parallel/sharded.py) — replaces
``kernel_matvec_pallas_dual`` with ``symmetric=False`` (the matvec walk of
csrc/dual.cu at "highest", the dual tensor-core tile of csrc/gram_tc.cuh
at "f32" and "bf16", the dual DMMA tile of csrc/gram_dmma.cu in float64).

``precision`` is the Gram precision tier, as the reference's
(``gram_precision``).  On float32 CUDA tensors kernels A and B run on the
tensor-core tiles at every tier (csrc/gram_tc.cuh: the symmetric one for
A, the rectangular one for B): at "f32" with TF32 operands, at "bf16" with
bf16 operands, at "highest" in three TF32 passes over the split operand
(hi hi^T + hi lo^T + lo hi^T, :func:`tier_operand`'s (2, rows, d_pad)
stack of ``split_tf32``), f32 accumulation in all.  Kernel J takes the
dual tensor-core tile at "f32" and "bf16" and the FFMA matvec walk of
csrc/dual.cu at "highest" (kernel K, ops/gram_matmat.py, takes the dual
tile at every tier).  float64 is full precision at every tier:
kernels A, B and J run on the FP64 tensor cores (the symmetric, the rect
and the dual DMMA tile of csrc/gram_dmma.cu, :func:`uses_dmma`; an odd d,
or a view that is not 16-byte aligned, takes :func:`dmma_operand`'s copy).
The tensor-core tiles take operand copies (:func:`tier_operand`:
TF32-rounded, bf16 or the split stack, the feature axis padded to a
16-byte row) of X, of P and S, or of Xr and Xc, which the wrapper makes
per call unless the caller hands it X's (``operand``: the CG solve makes
it once per solve) or the pair of Xr's and Xc's (``operand``: the ring
makes each shard's once per solve); for kernel A at MNIST's width a TF32
copy takes under 4 % of the kernel's time on an H100.  The FFMA register
tiles of kernels A and B (csrc/gram_matvec.cu) and K's FFMA tile
(csrc/dual.cu) are on no wrapper's path: :func:`gram_ffma` launches them
for the card tests and chip_smoke.py.

Each wrapper takes its plain PyTorch version (ops/matvec.py) at the same
tier for tensors that lie on the CPU, and only then.  For a CUDA tensor it
launches its kernel or raises; it never falls back.  Each counts its
launches in a plain module-level int (``sym_tc_launches``,
``rect_tc_launches`` for the tensor-core tiles at every tier,
``sym_dmma_launches`` and ``rect_dmma_launches`` for kernels A and B on
the DMMA tiles, ``dual_launches``, ``dual_tc_launches`` and
``dual_dmma_launches`` for kernel J on the FFMA, tensor-core and DMMA
tiles; ``kernel_matvec_launches`` counts kernel A's launches made for
:func:`kernel_matvec`; ``sym_launches`` and ``rect_launches`` those of
:func:`gram_ffma` on the FFMA tiles).  The kernels allocate nothing: the
wrapper allocates the zeroed output and launches on PyTorch's current
stream, and :func:`call_entry` hands each entry point the workspace of its
fixed-order sums (csrc/fixed_sum.cuh), which it asks for first: the
kernels sum across blocks in an order fixed by the shapes, so two
launches on the same inputs give equal bits.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict, Optional

import torch

from ..exceptions import KernelLaunchError
from ..kernel_functions import DISTANCE_KERNELS
from ..parameter import KernelFunctionType
from . import _build
from . import matvec as _plain

#: launches of kernels A and B's FFMA tiles (gram_ffma, on no wrapper's path)
sym_launches = 0
rect_launches = 0
#: kernel A's / kernel B's launches on the tensor-core tiles ("f32" as
#: TF32, "bf16", "highest" as three TF32 passes)
sym_tc_launches = 0
rect_tc_launches = 0
#: kernel A's / kernel B's launches on the FP64 tensor-core (DMMA) tiles,
#: float64
sym_dmma_launches = 0
rect_dmma_launches = 0
#: kernel A's launches made by kernel_matvec
kernel_matvec_launches = 0
#: kernel J's launches (gram_matvec_dual) on the FFMA matvec walk, on the
#: tensor-core tile and, float64, on the DMMA tile
dual_launches = 0
dual_tc_launches = 0
dual_dmma_launches = 0

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: per tier of the tensor-core tile: the entry points' suffix, the operand
#: copy's type and the feature multiple of a 16-byte row
_TC_TIERS = {"f32": ("tf32", torch.float32, 4), "bf16": ("bf16", torch.bfloat16, 8),
             "highest": ("tf32x3", torch.float32, 4)}
#: the tiers of one tensor-core pass, at which kernel J takes the dual tile
#: and kernel O its tensor-core walk; at "highest" those keep their FFMA
#: walks (kernel K takes the dual tile at every tier)
ONE_PASS_TIERS = ("f32", "bf16")


def reset_counts() -> None:
    """Zero the launch counts of both kernels and the call counts of their
    plain versions."""
    global sym_launches, rect_launches, sym_tc_launches, rect_tc_launches
    global sym_dmma_launches, rect_dmma_launches, kernel_matvec_launches
    global dual_launches, dual_tc_launches, dual_dmma_launches
    sym_launches = 0
    rect_launches = 0
    sym_tc_launches = 0
    rect_tc_launches = 0
    sym_dmma_launches = 0
    rect_dmma_launches = 0
    kernel_matvec_launches = 0
    dual_launches = 0
    dual_tc_launches = 0
    dual_dmma_launches = 0
    _plain.sym_plain_calls = 0
    _plain.rect_plain_calls = 0
    _plain.dual_plain_calls = 0
    fixed_sum_launches(reset=True)


def _check_gram_kind(kind) -> None:
    """The Gram wrappers take polynomial / RBF / sigmoid only, on every
    device."""
    if kind in DISTANCE_KERNELS:
        raise ValueError(
            f"the {kind} kernel is a distance kernel: ops/distance.py "
            "(kernels E-H) computes it, not the Gram kernels"
        )


def _check_operands(kind, named_tensors, shapes) -> None:
    """Refuse the linear kernel and validate the operands."""
    if kind == KernelFunctionType.LINEAR:
        raise ValueError(
            "the linear kernel takes the factored X (X^T v) product, not a "
            "Gram kernel"
        )
    _check_tensors(named_tensors, shapes)


def _check_tensors(named_tensors, shapes) -> str:
    """Validate device, dtype, shape and contiguity; return the entry-point
    suffix."""
    first = named_tensors[0][1]
    suffix = _SUFFIX.get(first.dtype)
    if suffix is None:
        raise TypeError(f"the CUDA kernels take float32 or float64, not {first.dtype}")
    for (name, t), shape in zip(named_tensors, shapes):
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, expected {first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {first.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return suffix


def ffma_entry(lib, name: str, dtype: torch.dtype):
    """The FFMA tile's entry point ``plssvm_gram_<name>_f32`` (J's walk at
    "highest"; kernels A-D and K through :func:`gram_ffma`), which the
    library holds for float32 only: float64 CUDA operands take the DMMA
    tiles (:func:`uses_dmma`), so any other type raises here."""
    if dtype != torch.float32:
        raise TypeError(f"the FFMA tile of gram_{name} takes float32, not {dtype}")
    return getattr(lib, f"plssvm_gram_{name}_f32")


def _raise_on_error(lib, err: int, name: str) -> None:
    if err != 0:
        message = lib.plssvm_cuda_error_string(err).decode()
        raise KernelLaunchError(f"{name} launch failed: {message} ({err})")


#: per entry point, the most workspace bytes a call asked for (the slots of
#: its fixed-order sums, csrc/fixed_sum.cuh) since it was last cleared
workspace_peak: Dict[str, int] = {}


def fixed_sum_launches(reset: bool = False) -> int:
    """The launches of the fixed-order sums' reduction (csrc/fixed_sum.cuh),
    counted where the library launches it, since the library was loaded or
    the last reset (0 while it is not loaded); ``reset`` sets the count to 0
    after reading it.  :func:`reset_counts` resets it."""
    if _build._lib is None:
        return 0
    return int(_build._lib.plssvm_fixed_sum_launches(int(reset)))


def fixed_sum(slots: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` plus the sum of ``slots`` (S, ...) over its first axis, the
    slots added in order from 0, in place on a CUDA ``out``: the reduction
    of every walk's fixed-order sums (csrc/fixed_sum.cuh), which the entry
    points launch themselves; here alone, for chip_smoke.py's check and
    timing.  CPU tensors take ``matvec.fixed_sum_plain``."""
    if out.device.type == "cpu":
        return _plain.fixed_sum_plain(slots, out)
    _require_cuda(out, "fixed_sum")
    suffix = _check_tensors([("slots", slots[0]), ("out", out)], [tuple(out.shape)] * 2)
    if not slots.is_contiguous():
        raise ValueError("slots must be contiguous")
    lib = _build.load()
    with torch.cuda.device(out.device):
        err = getattr(lib, f"plssvm_fixed_sum_{suffix}")(
            slots.data_ptr(), slots.shape[0], out.numel(), out.numel(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "fixed_sum")
    return out


def call_entry(lib, fn, device, args, name: str) -> None:
    """Call entry point ``fn(*args, workspace, workspace_bytes, stream)`` on
    ``device``'s current stream: first without a workspace, which asks for
    the bytes of its fixed-order sums (csrc/fixed_sum.cuh) and launches
    nothing, then with that many bytes from PyTorch's caching allocator,
    released to it (stream-ordered) on return.  Raises on a failed
    launch."""
    need = ctypes.c_int64(0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, None, ctypes.byref(need), stream)
        if err == 0:
            workspace = torch.empty((max(need.value, 1),), dtype=torch.uint8,
                                    device=device)
            err = fn(*args, workspace.data_ptr(), ctypes.byref(need), stream)
    _raise_on_error(lib, err, name)
    entry = getattr(fn, "__name__", name)
    workspace_peak[entry] = max(workspace_peak.get(entry, 0), need.value)


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(
            f"{name} runs on CUDA tensors (or its plain version on CPU "
            f"tensors), not on {t.device}"
        )


def uses_tensor_cores(X: torch.Tensor, precision: str) -> bool:
    """Whether kernels A-D and K take the tensor-core tiles for X at this
    tier: float32 CUDA operands at every tier ("highest" as three TF32
    passes).  J takes the dual tile only at the :data:`ONE_PASS_TIERS`."""
    return (X.device.type == "cuda" and X.dtype == torch.float32
            and precision in _TC_TIERS)


def uses_dmma(X: torch.Tensor) -> bool:
    """Whether kernels A-D, J and K take the FP64 tensor-core (DMMA) tiles
    for X: float64 CUDA operands, at every tier (float64 is full precision
    at each)."""
    return X.device.type == "cuda" and X.dtype == torch.float64


def dmma_operand(X: torch.Tensor) -> torch.Tensor:
    """The DMMA tile's operand for float64 ``X`` (m, d): X itself when a
    row is a multiple of 16 bytes (d even) and X starts on a 16-byte
    boundary, as TMA requires; else a contiguous copy with the feature axis
    padded with one zero (odd d).  Zero features change no inner product,
    so the squared norms of X stay valid."""
    pad = X.shape[1] % 2
    if pad == 0 and X.data_ptr() % 16 == 0:
        return X
    return torch.nn.functional.pad(X, (0, pad)).contiguous()


def launch_sym_dmma(lib, op, X, sq, V, out, classes, kind, gamma, coef0,
                    degree) -> None:
    """Launch kernel A (``op`` "matvec", ``classes`` ()) or C ("matmat",
    ``classes`` (C,)) on the DMMA tile on :func:`dmma_operand`'s operand.
    Raises on a failed launch; counts nothing."""
    X_op = dmma_operand(X)
    call_entry(lib, getattr(lib, f"plssvm_gram_{op}_sym_dmma"), X.device, (
        X_op.data_ptr(), sq.data_ptr(), V.data_ptr(), out.data_ptr(),
        X.shape[0], X_op.shape[1], *classes, int(kind), int(degree),
        float(gamma), float(coef0),
    ), f"gram_{op}_sym (FP64 tensor cores)")


def tier_operand(X: torch.Tensor, precision: str) -> torch.Tensor:
    """The tensor-core tiles' operand copy of float32 ``X`` (m, d): rounded
    to TF32 (``round_to_tf32``) for "f32", cast to bf16 for "bf16", and for
    "highest" the split stack (2, m, d_pad) of ``split_tf32``'s [hi; lo];
    its feature axis padded with zeros to a multiple of 4 (TF32) or 8
    (bf16), so that a row is a multiple of 16 bytes as TMA requires."""
    _, dtype, multiple = _TC_TIERS[precision]
    m, d = X.shape
    pad = -d % multiple
    if precision == "highest":
        op = X.new_zeros((2, m, d + pad)) if pad else X.new_empty((2, m, d))
        op[0, :, :d], op[1, :, :d] = _plain.split_tf32(X)
        return op
    op = _plain.round_to_tf32(X) if precision == "f32" else X.to(dtype)
    if pad:
        op = torch.nn.functional.pad(op, (0, pad))
    return op.contiguous()


def _given_operand(operand, X: torch.Tensor, precision: str) -> torch.Tensor:
    """``operand``, checked to be what :func:`tier_operand` makes of X at
    this tier, or that copy made here when None."""
    if operand is None:
        return tier_operand(X, precision)
    _, dtype, multiple = _TC_TIERS[precision]
    m, d = X.shape
    shape = ((2,) if precision == "highest" else ()) + (m, d + (-d % multiple))
    if (operand.dtype != dtype or operand.device != X.device
            or tuple(operand.shape) != shape or not operand.is_contiguous()):
        raise ValueError(
            f"the operand copy must be tier_operand's {shape} {dtype} of X at "
            f"{precision!r}, not {tuple(operand.shape)} {operand.dtype}")
    return operand


def gram_ffma(op: str, operands, sq, weights, *, kind: KernelFunctionType,
              gamma: float, coef0: float, degree: int):
    """Kernels A-D and K on their FFMA register tiles (csrc/gram_matvec.cu,
    gram_matmat.cu, dual.cu), full float32, which no wrapper launches since
    "highest" runs on the tensor cores: ``op`` "matvec_sym" (A),
    "matmat_sym" (C), "matvec_rect" (B), "matmat_rect" (D) or
    "matmat_dual" (K); ``operands`` (X,), (P, S) or (Xr, Xc), float32
    CUDA; ``sq`` their squared norms, a tuple of as many; ``weights`` v, V,
    a or A, or for K the pair (V_c, V_r), whose outputs (out_r, out_c) it
    returns.  For the card tests and chip_smoke.py's before-and-after
    timing.  Counts its launches in ``sym_launches`` / ``rect_launches`` /
    ``dual_launches`` of this module ("matvec") or of gram_matmat
    ("matmat")."""
    from . import gram_matmat

    _check_gram_kind(kind)
    rows, d = operands[0].shape
    cols = operands[-1].shape[0]
    dual = op.endswith("dual")
    weights = tuple(weights) if dual else (weights,)
    classes = () if weights[0].ndim == 1 else (weights[0].shape[1],)
    two = op.endswith(("rect", "dual"))
    named = ([("P", operands[0]), ("S", operands[1])] if two else [("X", operands[0])]) + [
        (f"sq{i}", t) for i, t in enumerate(sq)] + [
        (f"weights{i}", t) for i, t in enumerate(weights)]
    shapes = ([(rows, d), (cols, d)] if two else [(rows, d)]) + [
        (t.shape[0],) for t in operands] + [(cols,) + classes, (rows,) + classes][:len(weights)]
    _require_cuda(operands[0], f"gram_{op}")
    _check_operands(kind, named, shapes)
    outs = tuple(torch.zeros((n,) + classes, dtype=weights[0].dtype, device=weights[0].device)
                 for n in ((rows, cols) if dual else (rows,)))
    lib = _build.load()
    call_entry(lib, ffma_entry(lib, op, operands[0].dtype), operands[0].device, (
        *(t.data_ptr() for t in operands), *(t.data_ptr() for t in sq),
        *(t.data_ptr() for t in weights), *(t.data_ptr() for t in outs),
        *(t.shape[0] for t in operands), d, *classes, int(kind), int(degree),
        float(gamma), float(coef0),
    ), f"gram_{op} (FFMA tile)")
    module = sys.modules[__name__] if op.startswith("matvec") else gram_matmat
    counter = "dual_launches" if dual else "rect_launches" if two else "sym_launches"
    setattr(module, counter, getattr(module, counter) + 1)
    return outs if dual else outs[0]


def gram_matvec_sym(
    X: torch.Tensor,
    sq: torch.Tensor,
    v: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
    coef0: float,
    degree: int,
    precision: str = "f32",
    operand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``K(X, X) @ v`` for a poly / RBF / sigmoid kernel (kernel A).

    ``X`` (m, d), ``sq`` (m,) its squared row norms, ``v`` (m,);
    ``precision`` the tier; ``operand`` the tensor-core tile's copy of X
    (:func:`tier_operand` at this tier), made here when not given and
    ignored where X takes no tensor-core tile.
    """
    _check_gram_kind(kind)
    _plain.check_precision(precision)
    if X.device.type == "cpu":
        return _plain.kernel_matvec_plain(
            X, sq, v, kind=kind, gamma=gamma, coef0=coef0, degree=degree,
            precision=precision,
        )
    _require_cuda(X, "gram_matvec_sym")
    m, d = X.shape
    _check_operands(
        kind, [("X", X), ("sq", sq), ("v", v)], [(m, d), (m,), (m,)]
    )
    out = torch.zeros((m,), dtype=X.dtype, device=X.device)
    if m == 0:
        return out
    lib = _build.load()
    if uses_dmma(X):
        launch_sym_dmma(lib, "matvec", X, sq, v, out, (), kind, gamma, coef0, degree)
        global sym_dmma_launches
        sym_dmma_launches += 1
        return out
    launch_sym_tc(lib, "matvec", X, sq, v, out, (), kind, gamma, coef0, degree,
                  precision, operand)
    global sym_tc_launches
    sym_tc_launches += 1
    return out


def launch_sym_tc(lib, op, X, sq, V, out, classes, kind, gamma, coef0, degree,
                  precision, operand) -> None:
    """Launch kernel A (``op`` "matvec", ``classes`` ()) or C ("matmat",
    ``classes`` (C,)) on the symmetric tensor-core tile at the tier: the
    tier's operand copy of X (``operand``, or made here), the float32
    norms.  Raises on a failed launch; counts nothing."""
    X_op = _given_operand(operand, X, precision)
    fn = getattr(lib, f"plssvm_gram_{op}_sym_{_TC_TIERS[precision][0]}")
    call_entry(lib, fn, X.device, (
        X_op.data_ptr(), sq.data_ptr(), V.data_ptr(), out.data_ptr(), X.shape[0],
        X_op.shape[-1], *classes, int(kind), int(degree), float(gamma),
        float(coef0),
    ), f"gram_{op}_sym (tensor cores, {precision})")


def gram_matvec_rect(
    P: torch.Tensor,
    S: torch.Tensor,
    sq_p: torch.Tensor,
    sq_s: torch.Tensor,
    a: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
    coef0: float,
    degree: int,
    precision: str = "f32",
) -> torch.Tensor:
    """``K(P, S) @ a`` for a poly / RBF / sigmoid kernel (kernel B).

    ``P`` (n_p, d) points, ``S`` (n_s, d) support vectors, ``sq_p`` /
    ``sq_s`` their squared row norms, ``a`` (n_s,) the weights;
    ``precision`` the tier: float32 CUDA tensors take the rectangular
    tensor-core tile at every tier ("highest" as three TF32 passes);
    float64 CUDA tensors the rect DMMA tile at every tier, on
    :func:`dmma_operand`'s operands.
    """
    _check_gram_kind(kind)
    _plain.check_precision(precision)
    if P.device.type == "cpu":
        return _plain.kernel_matvec_rect_plain(
            P, S, sq_p, sq_s, a, kind=kind, gamma=gamma, coef0=coef0,
            degree=degree, precision=precision,
        )
    _require_cuda(P, "gram_matvec_rect")
    n_p, d = P.shape
    n_s = S.shape[0]
    _check_operands(
        kind,
        [("P", P), ("S", S), ("sq_p", sq_p), ("sq_s", sq_s), ("a", a)],
        [(n_p, d), (n_s, d), (n_p,), (n_s,), (n_s,)],
    )
    out = torch.zeros((n_p,), dtype=P.dtype, device=P.device)
    if n_p == 0 or n_s == 0:
        return out
    lib = _build.load()
    if uses_dmma(P):
        launch_rect_dmma(lib, "matvec", P, S, sq_p, sq_s, a, out, (), kind,
                         gamma, coef0, degree)
        global rect_dmma_launches
        rect_dmma_launches += 1
        return out
    launch_rect_tc(lib, "matvec", P, S, sq_p, sq_s, a, out, (), kind,
                   gamma, coef0, degree, precision)
    global rect_tc_launches
    rect_tc_launches += 1
    return out


def launch_rect_tc(lib, op, P, S, sq_p, sq_s, weights, out, classes, kind,
                   gamma, coef0, degree, precision) -> None:
    """Launch kernel B (``op`` "matvec", ``classes`` ()) or D ("matmat",
    ``classes`` (C,)) on the rectangular tensor-core tile: the tier's
    operand copies of P and S, the float32 norms.  Raises on a failed
    launch; counts nothing."""
    P_op, S_op = tier_operand(P, precision), tier_operand(S, precision)
    fn = getattr(lib, f"plssvm_gram_{op}_rect_tc_{_TC_TIERS[precision][0]}")
    call_entry(lib, fn, P.device, (
        P_op.data_ptr(), S_op.data_ptr(), sq_p.data_ptr(), sq_s.data_ptr(),
        weights.data_ptr(), out.data_ptr(), P.shape[0], S.shape[0],
        P_op.shape[-1], *classes, int(kind), int(degree), float(gamma),
        float(coef0),
    ), f"gram_{op}_rect (tensor cores, {precision})")


def launch_rect_dmma(lib, op, P, S, sq_p, sq_s, weights, out, classes, kind,
                     gamma, coef0, degree) -> None:
    """Launch kernel B (``op`` "matvec", ``classes`` ()) or D ("matmat",
    ``classes`` (C,)) on the rect DMMA tile on :func:`dmma_operand`'s
    operands of P and S.  Raises on a failed launch; counts nothing."""
    P_op, S_op = dmma_operand(P), dmma_operand(S)
    call_entry(lib, getattr(lib, f"plssvm_gram_{op}_rect_dmma"), P.device, (
        P_op.data_ptr(), S_op.data_ptr(), sq_p.data_ptr(), sq_s.data_ptr(),
        weights.data_ptr(), out.data_ptr(), P.shape[0], S.shape[0],
        P_op.shape[1], *classes, int(kind), int(degree), float(gamma),
        float(coef0),
    ), f"gram_{op}_rect (FP64 tensor cores)")


def kernel_matvec(
    X: torch.Tensor,
    sq_norms: torch.Tensor,
    v: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
    coef0: float,
    degree: int,
    precision: str = "f32",
) -> torch.Tensor:
    """``K(X, X) @ v`` for a poly / RBF / sigmoid kernel through kernel A,
    one launch; the counterpart of ``kernel_matvec_pallas``.

    ``precision`` as :func:`gram_matvec_sym`: float32 CUDA tensors take the
    tensor-core tile at every tier ("highest" as three TF32 passes);
    float64 CUDA tensors the DMMA tile at every tier.  Any m and d >= 1.
    """
    _plain.check_precision(precision)
    global kernel_matvec_launches
    before = sym_tc_launches + sym_dmma_launches
    out = gram_matvec_sym(
        X, sq_norms, v, kind=kind, gamma=gamma, coef0=coef0, degree=degree,
        precision=precision,
    )
    kernel_matvec_launches += sym_tc_launches + sym_dmma_launches - before
    return out


def gram_matvec_dual(
    Xr: torch.Tensor,
    Xc: torch.Tensor,
    sq_r: torch.Tensor,
    sq_c: torch.Tensor,
    v_c: torch.Tensor,
    v_r: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
    coef0: float,
    degree: int,
    precision: str = "f32",
    operand=None,
):
    """``(K @ v_c, K.T @ v_r)`` with ``K = K(Xr, Xc)`` for a poly / RBF /
    sigmoid kernel (kernel J), one walk of the block.

    ``Xr`` (mr, d) rows, ``Xc`` (mc, d) columns, ``sq_r`` / ``sq_c`` their
    squared row norms, ``v_c`` (mc,), ``v_r`` (mr,); ``precision`` the
    tier: on float32 CUDA tensors "f32" and "bf16" take the dual
    tensor-core tile on :func:`tier_operand`'s copies of Xr and Xc with the
    given norms, "highest" the FFMA matvec walk of ``csrc/dual.cu`` (kernel
    L's persistent walk with the Gram product, on Xr and Xc as they are);
    float64 CUDA tensors the dual DMMA tile at every tier, on
    :func:`dmma_operand`'s operands.  ``operand`` the pair of the
    tensor-core tile's copies of Xr and Xc (:func:`tier_operand` at this
    tier), made here when not given and ignored where J takes no
    tensor-core tile.
    """
    _check_gram_kind(kind)
    _plain.check_precision(precision)
    if Xr.device.type == "cpu":
        return _plain.kernel_matvec_dual_plain(
            Xr, Xc, sq_r, sq_c, v_c, v_r, kind=kind, gamma=gamma,
            coef0=coef0, degree=degree, precision=precision,
        )
    _require_cuda(Xr, "gram_matvec_dual")
    mr, d = Xr.shape
    mc = Xc.shape[0]
    _check_operands(
        kind,
        [("Xr", Xr), ("Xc", Xc), ("sq_r", sq_r), ("sq_c", sq_c),
         ("v_c", v_c), ("v_r", v_r)],
        [(mr, d), (mc, d), (mr,), (mc,), (mc,), (mr,)],
    )
    out_r = torch.zeros((mr,), dtype=Xr.dtype, device=Xr.device)
    out_c = torch.zeros((mc,), dtype=Xr.dtype, device=Xr.device)
    if mr == 0 or mc == 0:
        return out_r, out_c
    lib = _build.load()
    if uses_dmma(Xr):
        launch_dual_dmma(lib, "matvec", Xr, Xc, sq_r, sq_c, v_c, v_r, out_r, out_c,
                         (), kind, gamma, coef0, degree)
        global dual_dmma_launches
        dual_dmma_launches += 1
        return out_r, out_c
    if uses_tensor_cores(Xr, precision) and precision in ONE_PASS_TIERS:
        launch_dual_tc(lib, "matvec", Xr, Xc, sq_r, sq_c, v_c, v_r, out_r, out_c,
                       (), kind, gamma, coef0, degree, precision, operand)
        global dual_tc_launches
        dual_tc_launches += 1
        return out_r, out_c
    call_entry(lib, ffma_entry(lib, "matvec_dual", Xr.dtype), Xr.device, (
        Xr.data_ptr(), Xc.data_ptr(), sq_r.data_ptr(), sq_c.data_ptr(),
        v_c.data_ptr(), v_r.data_ptr(), out_r.data_ptr(), out_c.data_ptr(),
        mr, mc, d, int(kind), int(degree), float(gamma), float(coef0),
    ), "gram_matvec_dual")
    global dual_launches
    dual_launches += 1
    return out_r, out_c


def launch_dual_tc(lib, op, Xr, Xc, sq_r, sq_c, w_c, w_r, out_r, out_c, classes,
                   kind, gamma, coef0, degree, precision, operand=None) -> None:
    """Launch kernel J (``op`` "matvec", ``classes`` ()) or K ("matmat",
    ``classes`` (C,)) on the dual tensor-core tile: the tier's operand
    copies of Xr and Xc (the pair ``operand``, or made here; "highest"
    their split stacks, K only), the float32 norms.  Raises on a failed
    launch; counts nothing."""
    given = (None, None) if operand is None else operand
    Xr_op = _given_operand(given[0], Xr, precision)
    Xc_op = _given_operand(given[1], Xc, precision)
    fn = getattr(lib, f"plssvm_gram_{op}_dual_tc_{_TC_TIERS[precision][0]}")
    call_entry(lib, fn, Xr.device, (
        Xr_op.data_ptr(), Xc_op.data_ptr(), sq_r.data_ptr(), sq_c.data_ptr(),
        w_c.data_ptr(), w_r.data_ptr(), out_r.data_ptr(), out_c.data_ptr(),
        Xr.shape[0], Xc.shape[0], Xr_op.shape[-1], *classes, int(kind),
        int(degree), float(gamma), float(coef0),
    ), f"gram_{op}_dual (tensor cores, {precision})")


def launch_dual_dmma(lib, op, Xr, Xc, sq_r, sq_c, w_c, w_r, out_r, out_c, classes,
                     kind, gamma, coef0, degree) -> None:
    """Launch kernel J (``op`` "matvec", ``classes`` ()) or K ("matmat",
    ``classes`` (C,)) on the dual DMMA tile on :func:`dmma_operand`'s
    operands of Xr and Xc.  Raises on a failed launch; counts nothing."""
    Xr_op, Xc_op = dmma_operand(Xr), dmma_operand(Xc)
    call_entry(lib, getattr(lib, f"plssvm_gram_{op}_dual_dmma"), Xr.device, (
        Xr_op.data_ptr(), Xc_op.data_ptr(), sq_r.data_ptr(), sq_c.data_ptr(),
        w_c.data_ptr(), w_r.data_ptr(), out_r.data_ptr(), out_c.data_ptr(),
        Xr.shape[0], Xc.shape[0], Xr_op.shape[1], *classes, int(kind),
        int(degree), float(gamma), float(coef0),
    ), f"gram_{op}_dual (FP64 tensor cores)")
