"""Wrappers of the hand-written CUDA Gram matvecs (csrc/gram_matvec.cu).

Kernel A, :func:`gram_matvec_sym` — ``K(X, X) @ v``, every CG iteration —
replaces plssvm_tpu/ops/pallas_matvec.py ``kernel_matvec_pallas_dual``
with ``symmetric=True`` (through ``kernel_matvec_pallas_big``).  Kernel B,
:func:`gram_matvec_rect` — ``K(P, S) @ a``, binary predict — replaces the
non-symmetric branch of ``kernel_matvec_pallas_rect``.  The source note in
csrc/gram_matvec.cu says how they are built and what bounds them.
:func:`kernel_matvec` replaces ``kernel_matvec_pallas`` (K6), the JAX
package's thin wrapper that routes ``K(X, X) @ v`` to the same symmetric
kernel; here it is one launch of kernel A.

Each wrapper takes its plain PyTorch version (ops/matvec.py) for tensors
that lie on the CPU, and only then.  For a CUDA tensor it launches its
kernel or raises; it never falls back.  Each counts its launches in a plain
module-level int (``sym_launches``, ``rect_launches``;
``kernel_matvec_launches`` counts kernel A's launches made for
:func:`kernel_matvec`).

Both kernels take float32 and float64, with full-precision FMA in either:
``gram_precision`` "f32" and "highest" both map here.  They allocate
nothing: the wrapper allocates the zeroed output and launches on PyTorch's
current stream.
"""

from __future__ import annotations

import torch

from ..exceptions import KernelLaunchError, NotPortedError
from ..kernel_functions import DISTANCE_KERNELS
from ..parameter import KernelFunctionType
from . import _build
from . import matvec as _plain

#: kernel launches of gram_matvec_sym / gram_matvec_rect
sym_launches = 0
rect_launches = 0
#: kernel A's launches made by kernel_matvec
kernel_matvec_launches = 0

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_counts() -> None:
    """Zero the launch counts of both kernels and the call counts of their
    plain versions."""
    global sym_launches, rect_launches, kernel_matvec_launches
    sym_launches = 0
    rect_launches = 0
    kernel_matvec_launches = 0
    _plain.sym_plain_calls = 0
    _plain.rect_plain_calls = 0


def _check_gram_kind(kind) -> None:
    """The Gram wrappers take polynomial / RBF / sigmoid only, on every
    device."""
    if kind in DISTANCE_KERNELS:
        raise ValueError(
            f"the {kind} kernel is a distance kernel: ops/distance.py "
            "(kernels E-H) computes it, not the Gram kernels"
        )


def _check_operands(kind, named_tensors, shapes) -> str:
    """Refuse the linear kernel and validate the operands; return the
    entry-point suffix."""
    if kind == KernelFunctionType.LINEAR:
        raise ValueError(
            "the linear kernel takes the factored X (X^T v) product, not a "
            "Gram kernel"
        )
    return _check_tensors(named_tensors, shapes)


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


def gram_matvec_sym(
    X: torch.Tensor,
    sq: torch.Tensor,
    v: torch.Tensor,
    *,
    kind: KernelFunctionType,
    gamma: float,
    coef0: float,
    degree: int,
) -> torch.Tensor:
    """``K(X, X) @ v`` for a poly / RBF / sigmoid kernel (kernel A).

    ``X`` (m, d), ``sq`` (m,) its squared row norms, ``v`` (m,).
    """
    _check_gram_kind(kind)
    if X.device.type == "cpu":
        return _plain.kernel_matvec_plain(
            X, sq, v, kind=kind, gamma=gamma, coef0=coef0, degree=degree
        )
    _require_cuda(X, "gram_matvec_sym")
    m, d = X.shape
    suffix = _check_operands(
        kind, [("X", X), ("sq", sq), ("v", v)], [(m, d), (m,), (m,)]
    )
    out = torch.zeros((m,), dtype=X.dtype, device=X.device)
    if m == 0:
        return out
    lib = _build.load()
    fn = getattr(lib, f"plssvm_gram_matvec_sym_{suffix}")
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
) -> torch.Tensor:
    """``K(P, S) @ a`` for a poly / RBF / sigmoid kernel (kernel B).

    ``P`` (n_p, d) points, ``S`` (n_s, d) support vectors, ``sq_p`` /
    ``sq_s`` their squared row norms, ``a`` (n_s,) the weights.
    """
    _check_gram_kind(kind)
    if P.device.type == "cpu":
        return _plain.kernel_matvec_rect_plain(
            P, S, sq_p, sq_s, a, kind=kind, gamma=gamma, coef0=coef0,
            degree=degree,
        )
    _require_cuda(P, "gram_matvec_rect")
    n_p, d = P.shape
    n_s = S.shape[0]
    suffix = _check_operands(
        kind,
        [("P", P), ("S", S), ("sq_p", sq_p), ("sq_s", sq_s), ("a", a)],
        [(n_p, d), (n_s, d), (n_p,), (n_s,), (n_s,)],
    )
    out = torch.zeros((n_p,), dtype=P.dtype, device=P.device)
    if n_p == 0 or n_s == 0:
        return out
    lib = _build.load()
    fn = getattr(lib, f"plssvm_gram_matvec_rect_{suffix}")
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

    ``precision`` "f32" and "highest" both take kernel A's full-precision
    FMA; "bf16" is not ported.  No padding: any m and d >= 1.
    """
    if precision not in ("f32", "bf16", "highest"):
        raise ValueError(
            f"precision must be 'f32', 'bf16' or 'highest', not {precision!r}"
        )
    if precision == "bf16":
        raise NotPortedError(
            "precision='bf16' is not ported to the CUDA kernels yet (ROADMAP "
            "Queue 4: bf16 operands with f32 accumulation)"
        )
    global kernel_matvec_launches
    before = sym_launches
    out = gram_matvec_sym(
        X, sq_norms, v, kind=kind, gamma=gamma, coef0=coef0, degree=degree
    )
    kernel_matvec_launches += sym_launches - before
    return out
