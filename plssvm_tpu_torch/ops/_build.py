"""Build and load the hand-written CUDA kernels (csrc/*.cu).

At first use ``nvcc`` compiles every source under ``csrc/`` into one shared
library with a plain C interface, which ctypes loads.  The library lives in
``plssvm_tpu_torch/_build/`` under a name keyed on a hash of the sources
and the flags, so a second run with unchanged sources skips nvcc.  Nothing
is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

from ..exceptions import KernelLaunchError

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"

#: no --use_fast_math: the epilogue's expf/tanhf must be the accurate ones
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    sources = [str(p) for p in sorted(SOURCE_DIR.glob("*.cu"))]
    partial = target.with_name(f"{target.stem}.{os.getpid()}.tmp")
    start = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(partial), *sources],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise KernelLaunchError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    # rename last, so a build that was cut off never passes for a library
    os.replace(partial, target)
    return target, time.perf_counter() - start


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once."""
    global _lib
    if _lib is not None:
        return _lib
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        sym = getattr(lib, f"plssvm_gram_matvec_sym_{suffix}")
        sym.argtypes = [ptr, ptr, ptr, ptr, i64, i64, cint, cint, real, real, ptr]
        sym.restype = cint
        rect = getattr(lib, f"plssvm_gram_matvec_rect_{suffix}")
        rect.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, cint, cint, real,
            real, ptr,
        ]
        rect.restype = cint
    lib.plssvm_cuda_error_string.argtypes = [cint]
    lib.plssvm_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
