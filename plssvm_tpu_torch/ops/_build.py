"""Build and load the hand-written CUDA kernels (csrc/*.cu).

At first use ``nvcc`` compiles every source under ``csrc/`` into an object
file, one process per source and all of them at once, and links the objects
into one shared library with a plain C interface, which ctypes loads.  The
library lives in ``plssvm_tpu_torch/_build/`` under a name keyed on a hash
of the sources (headers included) and the flags, so a second run with
unchanged sources skips nvcc.  Beside it, ``<library>.ptxas.txt`` keeps
what ``-Xptxas -v`` reported for each kernel (registers, spills, shared
memory); :func:`kernel_resources` reads it.  Nothing is built when the
package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

from ..exceptions import KernelLaunchError

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"

#: no --use_fast_math: the epilogue's expf/tanhf must be the accurate ones.
#: -Xptxas -v only reports; it changes no code
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise KernelLaunchError(
            "nvcc not found: the CUDA kernels are built at first use and "
            "need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libplssvm_gram_{digest.hexdigest()[:16]}.so"


def build() -> Tuple[Path, float]:
    """Compile the kernels unless the library for these sources exists.

    Returns the library path and the seconds nvcc took (0.0 when skipped).
    """
    target = library_path()
    if target.is_file():
        return target, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{target.stem}.{os.getpid()}"
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    start = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src, obj in zip(sources, objects)
    ]
    reports, failures = [], []
    for src, proc in zip(sources, procs):
        out, err = proc.communicate()
        reports.append(f"== {src.name}\n{out}{err}")
        if proc.returncode != 0:
            failures.append(f"nvcc {src.name} failed ({proc.returncode}):\n{out}{err}")
    try:
        if failures:
            raise KernelLaunchError("\n".join(failures))
        partial = target.with_name(f"{tag}.tmp")
        proc = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(partial), *map(str, objects)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise KernelLaunchError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    _ptxas_log(target).write_text("".join(reports), encoding="utf-8")
    # rename last, so a build that was cut off never passes for a library
    os.replace(partial, target)
    return target, time.perf_counter() - start


def _ptxas_log(library: Path) -> Path:
    return library.with_name(library.name + ".ptxas.txt")


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SHORT = re.compile(
    r"((?:gram|distance)_mat(?:vec|mat)_(?:sym|rect)|banded_matvec)"
    r"_kernelI([fd])(?:Li(\d)E)?"
)
#: the tensor-core tiles (gram_tc.cuh), templates of the tier and the kind
_TC = re.compile(r"(gram_tc_(?:sym|rect|dual))_kernelI\w*?(Tf32x3|Tf32|Bf16)TierELi(\d)E")
#: the dual walks (dual.cu), one template for the Gram and distance kinds
_DUAL = re.compile(r"(mat(?:vec|mat))_dual_kernelI([fd])Li(\d)E")
#: the FP64 tensor-core tiles (gram_dmma.cu), templates of the kind
_DMMA = re.compile(r"(gram_dmma_(?:sym|dual|rect))_kernelILi(\d)E")
#: kernel N (kernel_matrix.cu), templates of the type, the stored type and
#: the kind
_MATRIX = re.compile(r"(kernel_matrix_(?:sym|rect))_kernelI([fd])([fd]|\d+__nv_bfloat16)Li(\d)E")
#: kernel O's FFMA walk (pairs.cu), templates of the type and the kind, and
#: its reduction, of the type and the tile edge
_PAIRS = re.compile(r"(pairs_matvec)_kernelI([fd])Li(\d)E")
_PAIRS_REDUCE = re.compile(r"(pairs_reduce)_kernelI([fd])Li(\d+)E")
#: kernel O's tensor-core walks (pairs_tc.cu), of the tier and the kind, and
#: of the kind in float64
_PAIRS_TC = re.compile(r"(pairs_tc)_kernelI\w*?(Tf32|Bf16)TierELi(\d)E")
_PAIRS_DMMA = re.compile(r"(pairs_dmma)_kernelILi(\d)E")
#: the fixed-order sums of the walks' slots (fixed_sum.cuh), of the type
_FIXED_SUM = re.compile(r"(fixed_sum)_kernelI([fd])E")
_KINDS = {"1": "poly", "2": "rbf", "3": "sigmoid", "4": "laplacian", "5": "chi_squared"}


def kernel_resources() -> Dict[str, Dict[str, int]]:
    """Per kernel instantiation, what ``-Xptxas -v`` reported when the
    current library was built: ``{"gram_matmat_sym f32 rbf": {"registers":
    .., "spill_bytes": .., "smem_bytes": ..}, ...}``.  Empty when the
    library has not been built here."""
    log = _ptxas_log(library_path())
    if not log.is_file():
        return {}
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.read_text(encoding="utf-8").splitlines():
        entry = _ENTRY.search(line)
        if entry:
            short = _SHORT.search(entry.group(1))
            tc = _TC.search(entry.group(1))
            dual = _DUAL.search(entry.group(1))
            dmma = _DMMA.search(entry.group(1))
            matrix = _MATRIX.search(entry.group(1))
            pairs = _PAIRS.search(entry.group(1))
            pairs_tc = _PAIRS_TC.search(entry.group(1))
            pairs_dmma = _PAIRS_DMMA.search(entry.group(1))
            pairs_reduce = _PAIRS_REDUCE.search(entry.group(1))
            fixed_sum = _FIXED_SUM.search(entry.group(1))
            name = None
            if short is not None:
                # kernel I (banded_matvec) is laplacian only: no kind parameter
                kind = short.group(3) or "4"
                name = (
                    f"{short.group(1)} {'f32' if short.group(2) == 'f' else 'f64'} "
                    f"{_KINDS.get(kind, kind)}"
                )
            elif tc is not None:
                # A and C share the sym tile, B and D the rect tile, J and K
                # the dual tile: one name for all copies
                name = f"{tc.group(1)} {tc.group(2).lower()} {_KINDS.get(tc.group(3))}"
            elif dmma is not None:
                # A and C share the sym tile, B and D the rect one, J and K
                # the dual one, each compiled once per kind
                name = f"{dmma.group(1)} f64 {_KINDS.get(dmma.group(2))}"
            elif matrix is not None:
                stored = "bf16" if matrix.group(3).endswith("bfloat16") else None
                name = (f"{matrix.group(1)} {'f32' if matrix.group(2) == 'f' else 'f64'} "
                        f"{_KINDS.get(matrix.group(4))}" + (f" {stored}" if stored else ""))
            elif pairs is not None:
                name = (f"{pairs.group(1)} {'f32' if pairs.group(2) == 'f' else 'f64'} "
                        f"{_KINDS.get(pairs.group(3))}")
            elif pairs_tc is not None:
                name = (f"{pairs_tc.group(1)} {pairs_tc.group(2).lower()} "
                        f"{_KINDS.get(pairs_tc.group(3))}")
            elif pairs_dmma is not None:
                name = f"{pairs_dmma.group(1)} f64 {_KINDS.get(pairs_dmma.group(2))}"
            elif pairs_reduce is not None:
                name = (f"{pairs_reduce.group(1)} "
                        f"{'f32' if pairs_reduce.group(2) == 'f' else 'f64'} "
                        f"edge {pairs_reduce.group(3)}")
            elif fixed_sum is not None:
                # one copy per source that includes fixed_sum.cuh
                name = f"fixed_sum {'f32' if fixed_sum.group(2) == 'f' else 'f64'}"
            elif dual is not None:
                family = "gram" if dual.group(3) in "123" else "distance"
                name = (f"{family}_{dual.group(1)}_dual "
                        f"{'f32' if dual.group(2) == 'f' else 'f64'} "
                        f"{_KINDS.get(dual.group(3))}")
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out.setdefault(name, {})["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out.setdefault(name, {})["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once."""
    global _lib
    if _lib is not None:
        return _lib
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    f32, f64 = ctypes.c_float, ctypes.c_double
    # every product with sums across blocks ends in (workspace,
    # int64_t* workspace_bytes, stream): ops/gram_matvec.py call_entry
    ws = [ptr, ptr]
    # kernels A-D on the FFMA tile (gram_matvec.gram_ffma) and the FFMA
    # walks of J and K, float32 only (float64 takes the DMMA tiles): (X, sq, v / V, out, m, d, [C,]
    # ...), (P, S, sq_p, sq_s, a / A, out, n_p, n_s, d, [C,] ...), (Xr, Xc,
    # sq_r, sq_c, v_c / V_c, v_r / V_r, out_r, out_c, mr, mc, d, [C,] ...),
    # each ending in (kind, degree, gamma, coef0, workspace, workspace_bytes,
    # stream)
    tail = [cint, cint, f32, f32] + ws + [ptr]
    lib.plssvm_gram_matvec_sym_f32.argtypes = [ptr] * 4 + [i64] * 2 + tail
    lib.plssvm_gram_matmat_sym_f32.argtypes = [ptr] * 4 + [i64] * 3 + tail
    lib.plssvm_gram_matvec_rect_f32.argtypes = [ptr] * 6 + [i64] * 3 + tail
    lib.plssvm_gram_matmat_rect_f32.argtypes = [ptr] * 6 + [i64] * 4 + tail
    lib.plssvm_gram_matvec_dual_f32.argtypes = [ptr] * 8 + [i64] * 3 + tail
    lib.plssvm_gram_matmat_dual_f32.argtypes = [ptr] * 8 + [i64] * 4 + tail
    for name in ("matvec_sym", "matvec_rect", "matmat_sym", "matmat_rect", "matvec_dual",
                 "matmat_dual"):
        getattr(lib, f"plssvm_gram_{name}_f32").restype = cint
    for suffix, real in (("f32", f32), ("f64", f64)):
        # kernels E-H: (operands..., out, sizes..., kind, gamma, workspace,
        # workspace_bytes, stream)
        for name, n_operands, n_sizes in (
            ("matvec_sym", 2, 2),    # X, v; m, d
            ("matvec_rect", 3, 3),   # P, S, a; n_p, n_s, d
            ("matmat_sym", 2, 3),    # X, V; m, d, C
            ("matmat_rect", 3, 4),   # P, S, A; n_p, n_s, d, C
        ):
            fn = getattr(lib, f"plssvm_distance_{name}_{suffix}")
            fn.argtypes = [ptr] * (n_operands + 1) + [i64] * n_sizes + [cint, real] + ws + [ptr]
            fn.restype = cint
        # kernel I: (XT, v, out_r, out_c, m, d, symmetric, gamma, workspace,
        # workspace_bytes, stream)
        banded = getattr(lib, f"plssvm_banded_matvec_{suffix}")
        banded.argtypes = [ptr] * 4 + [i64, i64, cint, real] + ws + [ptr]
        banded.restype = cint
        # kernels L and M (the distance dual walks): (Xr, Xc, v_c / V_c,
        # v_r / V_r, out_r, out_c, mr, mc, d, [C,] kind, gamma, workspace,
        # workspace_bytes, stream)
        for op, n_sizes in (("matvec", 3), ("matmat", 4)):
            fn = getattr(lib, f"plssvm_distance_{op}_dual_{suffix}")
            fn.argtypes = [ptr] * 6 + [i64] * n_sizes + [cint, real] + ws + [ptr]
            fn.restype = cint
    for tier in ("tf32", "bf16", "tf32x3"):
        # kernels A and C on the tensor-core tile: (X copy, sq, v / V, out,
        # m, d_pad, [C,] kind, degree, gamma, coef0, workspace,
        # workspace_bytes, stream); tf32x3 (the "highest" tier) takes the
        # split stack (2, m, d_pad)
        getattr(lib, f"plssvm_gram_matvec_sym_{tier}").argtypes = [
            ptr, ptr, ptr, ptr, i64, i64, cint, cint, f32, f32] + ws + [ptr]
        getattr(lib, f"plssvm_gram_matmat_sym_{tier}").argtypes = [
            ptr, ptr, ptr, ptr, i64, i64, i64, cint, cint, f32, f32] + ws + [ptr]
        # kernels B and D: (P copy, S copy, sq_p, sq_s, a / A, out, n_p, n_s,
        # d_pad, [C,] kind, degree, gamma, coef0, workspace, workspace_bytes,
        # stream)
        getattr(lib, f"plssvm_gram_matvec_rect_tc_{tier}").argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, cint, cint, f32, f32,
        ] + ws + [ptr]
        getattr(lib, f"plssvm_gram_matmat_rect_tc_{tier}").argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, cint, cint, f32,
            f32] + ws + [ptr]
        for name in ("matvec_sym", "matmat_sym", "matvec_rect_tc", "matmat_rect_tc"):
            getattr(lib, f"plssvm_gram_{name}_{tier}").restype = cint
    for tier in ("tf32", "bf16", "tf32x3"):
        # kernels J and K: (Xr copy, Xc copy, sq_r, sq_c, v_c / V_c, v_r /
        # V_r, out_r, out_c, mr, mc, d_pad, [C,] kind, degree, gamma, coef0,
        # workspace, workspace_bytes, stream); at tf32x3 (the "highest"
        # tier) K alone, on the split stacks (2, mr, d_pad) and (2, mc,
        # d_pad)
        names = ("matmat_dual_tc",) if tier == "tf32x3" else ("matvec_dual_tc",
                                                               "matmat_dual_tc")
        for name in names:
            fn = getattr(lib, f"plssvm_gram_{name}_{tier}")
            fn.argtypes = [ptr] * 8 + [i64] * (3 if name.startswith("matvec") else 4) + [
                cint, cint, f32, f32] + ws + [ptr]
            fn.restype = cint
    # kernels A and C on the DMMA tile, float64: (X, sq, v / V, out, m,
    # d_pad, [C,] kind, degree, gamma, coef0, workspace, workspace_bytes,
    # stream)
    dmma_tail = [cint, cint, f64, f64] + ws + [ptr]
    lib.plssvm_gram_matvec_sym_dmma.argtypes = [ptr] * 4 + [i64] * 2 + dmma_tail
    lib.plssvm_gram_matmat_sym_dmma.argtypes = [ptr] * 4 + [i64] * 3 + dmma_tail
    lib.plssvm_gram_matvec_sym_dmma.restype = cint
    lib.plssvm_gram_matmat_sym_dmma.restype = cint
    # kernels J and K on the dual DMMA tile: (Xr, Xc, sq_r, sq_c, v_c / V_c,
    # v_r / V_r, out_r, out_c, mr, mc, d_pad, [C,] kind, degree, gamma, coef0,
    # workspace, workspace_bytes, stream)
    lib.plssvm_gram_matvec_dual_dmma.argtypes = [ptr] * 8 + [i64] * 3 + dmma_tail
    lib.plssvm_gram_matmat_dual_dmma.argtypes = [ptr] * 8 + [i64] * 4 + dmma_tail
    lib.plssvm_gram_matvec_dual_dmma.restype = cint
    lib.plssvm_gram_matmat_dual_dmma.restype = cint
    # kernels B and D on the rect DMMA tile: (P, S, sq_p, sq_s, a / A, out,
    # n_p, n_s, d_pad, [C,] kind, degree, gamma, coef0, workspace,
    # workspace_bytes, stream)
    lib.plssvm_gram_matvec_rect_dmma.argtypes = [ptr] * 6 + [i64] * 3 + dmma_tail
    lib.plssvm_gram_matmat_rect_dmma.argtypes = [ptr] * 6 + [i64] * 4 + dmma_tail
    lib.plssvm_gram_matvec_rect_dmma.restype = cint
    lib.plssvm_gram_matmat_rect_dmma.restype = cint
    # (kind, int* blocks): the DMMA tiles' blocks per SM
    for name in ("plssvm_gram_dmma_blocks_per_sm", "plssvm_gram_dmma_dual_blocks_per_sm",
                 "plssvm_gram_dmma_rect_blocks_per_sm"):
        getattr(lib, name).argtypes = [cint, ptr]
        getattr(lib, name).restype = cint
    # (tier: 0 TF32, 1 bf16, 2 the split tier; kind, int* blocks): the dual
    # tensor-core tile's blocks per SM
    lib.plssvm_gram_dual_tc_blocks_per_sm.argtypes = [cint, cint, ptr]
    lib.plssvm_gram_dual_tc_blocks_per_sm.restype = cint
    # (f64, kind, int* blocks): the matvec walk's (J at "highest", L) blocks
    # per SM
    lib.plssvm_dual_walk_blocks_per_sm.argtypes = [cint, cint, ptr]
    lib.plssvm_dual_walk_blocks_per_sm.restype = cint
    for suffix, real in (("f32", f32), ("f64", f64)):
        # kernel N: (X, K, m, d, kind, gamma, out_bf16, stream) and (Xr, Xc,
        # K, mr, mc, d, kind, gamma, out_bf16, stream)
        sym = getattr(lib, f"plssvm_kernel_matrix_sym_{suffix}")
        sym.argtypes = [ptr, ptr, i64, i64, cint, real, cint, ptr]
        rect = getattr(lib, f"plssvm_kernel_matrix_rect_{suffix}")
        rect.argtypes = [ptr, ptr, ptr, i64, i64, i64, cint, real, cint, ptr]
        sym.restype = rect.restype = cint
    for suffix, real in (("f32", f32), ("f64", f64)):
        # kernel O's FFMA walk: (Xb, sq_b, V, len, out, workspace, P, m_pad,
        # d, kind, degree, gamma, coef0, stream)
        fn = getattr(lib, f"plssvm_pairs_matvec_{suffix}")
        fn.argtypes = [ptr] * 6 + [i64] * 3 + [cint, cint, real, real, ptr]
        fn.restype = cint
    # kernel O's tensor-core walks: (operand copy, sq_b, V, len, out, P,
    # m_pad, d_pad, kind, degree, gamma, coef0, stream)
    for name, real in (("tf32", f32), ("bf16", f32), ("dmma", f64)):
        fn = getattr(lib, f"plssvm_pairs_matvec_{name}")
        fn.argtypes = [ptr] * 5 + [i64] * 3 + [cint, cint, real, real, ptr]
        fn.restype = cint
    # (P, m_pad, kind, is_double): the FFMA walk's workspace in values
    lib.plssvm_pairs_workspace_elements.argtypes = [i64, i64, cint, cint]
    lib.plssvm_pairs_workspace_elements.restype = i64
    # (walk: 0 TF32, 1 bf16, 2 float64; kind, int* blocks)
    lib.plssvm_pairs_blocks_per_sm.argtypes = [cint, cint, ptr]
    lib.plssvm_pairs_blocks_per_sm.restype = cint
    # the fixed-order sums (fixed_sum.cuh): (ws, slots, stride, n, out,
    # stream), and (reset) -> the launches so far
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"plssvm_fixed_sum_{suffix}")
        fn.argtypes = [ptr, i64, i64, i64, ptr, ptr]
        fn.restype = cint
    lib.plssvm_fixed_sum_launches.argtypes = [cint]
    lib.plssvm_fixed_sum_launches.restype = i64
    lib.plssvm_cuda_error_string.argtypes = [cint]
    lib.plssvm_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
