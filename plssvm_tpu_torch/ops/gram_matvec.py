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
``kernel_matvec_pallas_dual`` with ``symmetric=False`` (csrc/dual.cu at
"highest", the dual tensor-core tile of csrc/gram_tc.cuh at "f32" and
"bf16", the dual DMMA tile of csrc/gram_dmma.cu in float64).

``precision`` is the Gram precision tier, as the reference's
(``gram_precision``).  On float32 CUDA tensors kernels A and B at "f32" run
on the tensor-core tiles (csrc/gram_tc.cuh: the symmetric one for A, the
rectangular one for B, the dual one for J) with TF32 operands, at "bf16" on
the same tiles with bf16 operands, f32 accumulation in both; at "highest"
on the FFMA register tiles (csrc/gram_tile.cuh, csrc/dual.cu), full
float32.  float64 is full precision at every tier: kernels A, B and J run
on the FP64 tensor cores (the symmetric, the rect and the dual DMMA tile of
csrc/gram_dmma.cu, :func:`uses_dmma`; an odd d, or a view that is not
16-byte aligned, takes :func:`dmma_operand`'s copy).  The TF32 / bf16 tensor-core tiles take operand
copies (:func:`tier_operand`: TF32-rounded or bf16, the feature axis
padded to a 16-byte row) of X, of P and S, or of Xr and Xc, which the
wrapper makes per call: for kernel A at MNIST's width they take under 4 %
of the kernel's time on an H100.

Each wrapper takes its plain PyTorch version (ops/matvec.py) at the same
tier for tensors that lie on the CPU, and only then.  For a CUDA tensor it
launches its kernel or raises; it never falls back.  Each counts its
launches in a plain module-level int (``sym_launches``, ``rect_launches``
for the FFMA tile, ``sym_tc_launches``, ``rect_tc_launches`` for the
tensor-core tiles, ``sym_dmma_launches`` and ``rect_dmma_launches`` for
kernels A and B on the DMMA tiles, ``dual_launches``, ``dual_tc_launches`` and ``dual_dmma_launches`` for
kernel J on the FFMA, tensor-core and DMMA tiles;
``kernel_matvec_launches`` counts kernel A's launches made for
:func:`kernel_matvec`).  The kernels allocate nothing: the wrapper
allocates the zeroed output and launches on PyTorch's current stream.
"""

from __future__ import annotations

import torch

from ..exceptions import KernelLaunchError
from ..kernel_functions import DISTANCE_KERNELS
from ..parameter import KernelFunctionType
from . import _build
from . import matvec as _plain

#: kernel launches of gram_matvec_sym / gram_matvec_rect on the FFMA tile
sym_launches = 0
rect_launches = 0
#: kernel A's / kernel B's launches on the tensor-core tiles ("f32" as
#: TF32, "bf16")
sym_tc_launches = 0
rect_tc_launches = 0
#: kernel A's / kernel B's launches on the FP64 tensor-core (DMMA) tiles,
#: float64
sym_dmma_launches = 0
rect_dmma_launches = 0
#: kernel A's launches made by kernel_matvec
kernel_matvec_launches = 0
#: kernel J's launches (gram_matvec_dual) on the FFMA tile, on the
#: tensor-core tile and, float64, on the DMMA tile
dual_launches = 0
dual_tc_launches = 0
dual_dmma_launches = 0

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: per tier of the tensor-core tile: the entry points' suffix, the operand
#: copy's type and the feature multiple of a 16-byte row
_TC_TIERS = {"f32": ("tf32", torch.float32, 4), "bf16": ("bf16", torch.bfloat16, 8)}


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
    """The FFMA tile's entry point ``plssvm_gram_<name>_f32`` (kernels A-D
    and the walks of J and K at "highest"), which the library holds for
    float32 only: float64 CUDA operands take the DMMA tiles
    (:func:`uses_dmma`), so any other type raises here."""
    if dtype != torch.float32:
        raise TypeError(f"the FFMA tile of gram_{name} takes float32, not {dtype}")
    return getattr(lib, f"plssvm_gram_{name}_f32")


def _raise_on_error(lib, err: int, name: str) -> None:
    if err != 0:
        message = lib.plssvm_cuda_error_string(err).decode()
        raise KernelLaunchError(f"{name} launch failed: {message} ({err})")


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(
            f"{name} runs on CUDA tensors (or its plain version on CPU "
            f"tensors), not on {t.device}"
        )


def uses_tensor_cores(X: torch.Tensor, precision: str) -> bool:
    """Whether kernels A-D take the tensor-core tiles for X at this tier:
    float32 CUDA operands at "f32" or "bf16"."""
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
    fn = getattr(lib, f"plssvm_gram_{op}_sym_dmma")
    with torch.cuda.device(X.device):
        err = fn(
            X_op.data_ptr(), sq.data_ptr(), V.data_ptr(), out.data_ptr(),
            X.shape[0], X_op.shape[1], *classes, int(kind), int(degree),
            float(gamma), float(coef0), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, f"gram_{op}_sym (FP64 tensor cores)")


def tier_operand(X: torch.Tensor, precision: str) -> torch.Tensor:
    """The tensor-core tiles' operand copy of float32 ``X`` (m, d): rounded
    to TF32 (``round_to_tf32``) for "f32", cast to bf16 for "bf16"; its
    feature axis padded with zeros to a multiple of 4 (TF32) or 8 (bf16),
    so that a row is a multiple of 16 bytes as TMA requires."""
    _, dtype, multiple = _TC_TIERS[precision]
    op = _plain.round_to_tf32(X) if precision == "f32" else X.to(dtype)
    pad = -X.shape[1] % multiple
    if pad:
        op = torch.nn.functional.pad(op, (0, pad))
    return op.contiguous()


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
) -> torch.Tensor:
    """``K(X, X) @ v`` for a poly / RBF / sigmoid kernel (kernel A).

    ``X`` (m, d), ``sq`` (m,) its squared row norms, ``v`` (m,);
    ``precision`` the tier.
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
    if uses_tensor_cores(X, precision):
        op = tier_operand(X, precision)
        fn = getattr(lib, f"plssvm_gram_matvec_sym_{_TC_TIERS[precision][0]}")
        with torch.cuda.device(X.device):
            err = fn(
                op.data_ptr(), sq.data_ptr(), v.data_ptr(), out.data_ptr(), m,
                op.shape[1], int(kind), int(degree), float(gamma),
                float(coef0), torch.cuda.current_stream().cuda_stream,
            )
        _raise_on_error(lib, err, "gram_matvec_sym (tensor cores)")
        global sym_tc_launches
        sym_tc_launches += 1
        return out
    fn = ffma_entry(lib, "matvec_sym", X.dtype)
    with torch.cuda.device(X.device):
        err = fn(
            X.data_ptr(), sq.data_ptr(), v.data_ptr(), out.data_ptr(), m, d,
            int(kind), int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "gram_matvec_sym")
    global sym_launches
    sym_launches += 1
    return out


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
    ``precision`` the tier: on float32 CUDA tensors "f32" and "bf16" take
    the rectangular tensor-core tile, "highest" the FFMA tile; float64
    CUDA tensors the rect DMMA tile at every tier, on
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
    if uses_tensor_cores(P, precision):
        launch_rect_tc(lib, "matvec", P, S, sq_p, sq_s, a, out, (), kind,
                       gamma, coef0, degree, precision)
        global rect_tc_launches
        rect_tc_launches += 1
        return out
    fn = ffma_entry(lib, "matvec_rect", P.dtype)
    with torch.cuda.device(P.device):
        err = fn(
            P.data_ptr(), S.data_ptr(), sq_p.data_ptr(), sq_s.data_ptr(),
            a.data_ptr(), out.data_ptr(), n_p, n_s, d,
            int(kind), int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "gram_matvec_rect")
    global rect_launches
    rect_launches += 1
    return out


def launch_rect_tc(lib, op, P, S, sq_p, sq_s, weights, out, classes, kind,
                   gamma, coef0, degree, precision) -> None:
    """Launch kernel B (``op`` "matvec", ``classes`` ()) or D ("matmat",
    ``classes`` (C,)) on the rectangular tensor-core tile: the tier's
    operand copies of P and S, the float32 norms.  Raises on a failed
    launch; counts nothing."""
    P_op, S_op = tier_operand(P, precision), tier_operand(S, precision)
    fn = getattr(lib, f"plssvm_gram_{op}_rect_tc_{_TC_TIERS[precision][0]}")
    with torch.cuda.device(P.device):
        err = fn(
            P_op.data_ptr(), S_op.data_ptr(), sq_p.data_ptr(), sq_s.data_ptr(),
            weights.data_ptr(), out.data_ptr(), P.shape[0], S.shape[0],
            P_op.shape[1], *classes, int(kind), int(degree), float(gamma),
            float(coef0), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, f"gram_{op}_rect (tensor cores)")


def launch_rect_dmma(lib, op, P, S, sq_p, sq_s, weights, out, classes, kind,
                     gamma, coef0, degree) -> None:
    """Launch kernel B (``op`` "matvec", ``classes`` ()) or D ("matmat",
    ``classes`` (C,)) on the rect DMMA tile on :func:`dmma_operand`'s
    operands of P and S.  Raises on a failed launch; counts nothing."""
    P_op, S_op = dmma_operand(P), dmma_operand(S)
    fn = getattr(lib, f"plssvm_gram_{op}_rect_dmma")
    with torch.cuda.device(P.device):
        err = fn(
            P_op.data_ptr(), S_op.data_ptr(), sq_p.data_ptr(), sq_s.data_ptr(),
            weights.data_ptr(), out.data_ptr(), P.shape[0], S.shape[0],
            P_op.shape[1], *classes, int(kind), int(degree), float(gamma),
            float(coef0), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, f"gram_{op}_rect (FP64 tensor cores)")


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

    ``precision`` as :func:`gram_matvec_sym`: on float32 CUDA tensors "f32"
    and "bf16" take the tensor-core tile, "highest" the FFMA tile; float64
    CUDA tensors the DMMA tile at every tier.  Any m and d >= 1.
    """
    _plain.check_precision(precision)
    global kernel_matvec_launches
    before = sym_launches + sym_tc_launches + sym_dmma_launches
    out = gram_matvec_sym(
        X, sq_norms, v, kind=kind, gamma=gamma, coef0=coef0, degree=degree,
        precision=precision,
    )
    kernel_matvec_launches += sym_launches + sym_tc_launches + sym_dmma_launches - before
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
):
    """``(K @ v_c, K.T @ v_r)`` with ``K = K(Xr, Xc)`` for a poly / RBF /
    sigmoid kernel (kernel J), one walk of the block.

    ``Xr`` (mr, d) rows, ``Xc`` (mc, d) columns, ``sq_r`` / ``sq_c`` their
    squared row norms, ``v_c`` (mc,), ``v_r`` (mr,); ``precision`` the
    tier: on float32 CUDA tensors "f32" and "bf16" take the dual
    tensor-core tile on :func:`tier_operand`'s copies of Xr and Xc with the
    given norms, "highest" the FFMA tile; float64 CUDA tensors the dual
    DMMA tile at every tier, on :func:`dmma_operand`'s operands.
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
    if uses_tensor_cores(Xr, precision):
        launch_dual_tc(lib, "matvec", Xr, Xc, sq_r, sq_c, v_c, v_r, out_r, out_c,
                       (), kind, gamma, coef0, degree, precision)
        global dual_tc_launches
        dual_tc_launches += 1
        return out_r, out_c
    fn = ffma_entry(lib, "matvec_dual", Xr.dtype)
    with torch.cuda.device(Xr.device):
        err = fn(
            Xr.data_ptr(), Xc.data_ptr(), sq_r.data_ptr(), sq_c.data_ptr(),
            v_c.data_ptr(), v_r.data_ptr(), out_r.data_ptr(), out_c.data_ptr(),
            mr, mc, d, int(kind), int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, "gram_matvec_dual")
    global dual_launches
    dual_launches += 1
    return out_r, out_c


def launch_dual_tc(lib, op, Xr, Xc, sq_r, sq_c, w_c, w_r, out_r, out_c, classes,
                   kind, gamma, coef0, degree, precision) -> None:
    """Launch kernel J (``op`` "matvec", ``classes`` ()) or K ("matmat",
    ``classes`` (C,)) on the dual tensor-core tile: the tier's operand
    copies of Xr and Xc, the float32 norms.  Raises on a failed launch;
    counts nothing."""
    Xr_op, Xc_op = tier_operand(Xr, precision), tier_operand(Xc, precision)
    fn = getattr(lib, f"plssvm_gram_{op}_dual_tc_{_TC_TIERS[precision][0]}")
    with torch.cuda.device(Xr.device):
        err = fn(
            Xr_op.data_ptr(), Xc_op.data_ptr(), sq_r.data_ptr(), sq_c.data_ptr(),
            w_c.data_ptr(), w_r.data_ptr(), out_r.data_ptr(), out_c.data_ptr(),
            Xr.shape[0], Xc.shape[0], Xr_op.shape[1], *classes, int(kind),
            int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, f"gram_{op}_dual (tensor cores)")


def launch_dual_dmma(lib, op, Xr, Xc, sq_r, sq_c, w_c, w_r, out_r, out_c, classes,
                     kind, gamma, coef0, degree) -> None:
    """Launch kernel J (``op`` "matvec", ``classes`` ()) or K ("matmat",
    ``classes`` (C,)) on the dual DMMA tile on :func:`dmma_operand`'s
    operands of Xr and Xc.  Raises on a failed launch; counts nothing."""
    Xr_op, Xc_op = dmma_operand(Xr), dmma_operand(Xc)
    fn = getattr(lib, f"plssvm_gram_{op}_dual_dmma")
    with torch.cuda.device(Xr.device):
        err = fn(
            Xr_op.data_ptr(), Xc_op.data_ptr(), sq_r.data_ptr(), sq_c.data_ptr(),
            w_c.data_ptr(), w_r.data_ptr(), out_r.data_ptr(), out_c.data_ptr(),
            Xr.shape[0], Xc.shape[0], Xr_op.shape[1], *classes, int(kind),
            int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, f"gram_{op}_dual (FP64 tensor cores)")
