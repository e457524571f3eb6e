"""Kernels A and C (the symmetric tile), B and D (the rect tile) and J and
K (the dual tile) in float64 on the FP64 tensor-core (DMMA) tiles
(csrc/gram_dmma.cu).

CPU cases: the float64 bounds ``chip_smoke.py`` holds the tiles' times to
(DMMA at 67 TFLOP/s, the FFMA tiles at 17 T DFMA/s), the names
``_build.kernel_resources()`` gives the tiles' instantiations, the ctypes
signatures of their entry points against the C source, the routing
predicate (float64 CUDA tensors take the DMMA tiles at every tier; float32
keeps its routes), the odd-d operand copy against the unpadded plain
version, the ring's shard views as the tiles' operands, and the tool.

Card cases (marked ``cuda``, skipped without a GPU): the three tiles
against the plain versions on ragged shapes within 1e-10 of max|plain|
(the float64 tolerance of tests/test_torch_cuda.py), the launch counters
of float64 fits and predicts and of a float64 ring fit, and a small
float64 fit against
``backend="torch"``.  The file
imports neither jax nor plssvm_tpu, so the card cases run where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_dmma.py
"""

import ctypes
import importlib.util
import os
import re
import types

import numpy as np
import pytest
import torch

from plssvm_tpu_torch.ops import _build, gram_matmat, gram_matvec, matvec
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COEF0 = {"polynomial": 1.0, "rbf": 0.0, "sigmoid": -0.5}
TIERS = ("f32", "bf16", "highest")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_dmma_bounds", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("m,d,columns,exp,dmma_ms,dfma_ms", [
    (59999, 784, 10, True, 42.1247, 85.1280),  # kernel C, MNIST width
    (49999, 500, 1, False, 18.6563, 36.9110),  # kernel A, config 3's width
    (32768, 512, 1, True, 8.2056, 16.2329),    # kernel A, the timing shape
    (32768, 512, 10, True, 8.2056, 16.8014),   # kernel C, the timing shape
    (9999, 200, 1, True, 0.29848, 0.59406),    # kernel A, config 2
])
def test_float64_sym_bounds(m, d, columns, exp, dmma_ms, dfma_ms):
    """2 pairs d flops at 67 TFLOP/s on the DMMA tile (the DFMAs of the
    contraction and the exps lie below it at these widths); pairs d + m^2 C
    DFMAs at 17 T/s on the FFMA tile; both bound by operations."""
    chip_smoke = _chip_smoke()
    ms, by = chip_smoke._sym_bound(m, d, columns, "gram", 8, 1, "dmma", exp=exp)
    assert ms == pytest.approx(dmma_ms, rel=1e-4) and by == "operations"
    ms, by = chip_smoke._sym_bound(m, d, columns, "gram", 8, 1, "fp64")
    assert ms == pytest.approx(dfma_ms, rel=1e-4) and by == "operations"


def test_dmma_bound_counts_the_fp64_pipe_beside_the_product():
    """At d = 3 the exps and the class DFMAs on the FP64 pipe bound the DMMA
    tile: pairs (2 C + EXP_F64_OPS) DFMAs at 17 T/s."""
    chip_smoke = _chip_smoke()
    m, d, columns = 4096, 3, 10
    pairs = m * (m + 1) / 2
    ms, _ = chip_smoke._sym_bound(m, d, columns, "gram", 8, 1, "dmma", exp=True)
    want = (m * m * columns + chip_smoke.EXP_F64_OPS * pairs) / chip_smoke.FP64_INSTR_PER_S
    assert ms == pytest.approx(want * 1e3, rel=1e-12)
    assert ms > 2 * pairs * d / chip_smoke.DMMA_FLOP_PER_S * 1e3


@pytest.mark.parametrize("cost,per_pair_feature", [("gram", 1), ("laplacian", 2),
                                                   ("chi_squared", 11)])
def test_float64_dual_bounds(cost, per_pair_feature):
    """The FFMA walks in float64 (J-M): their instructions per pair and
    feature over 17 T/s, 2 DFMAs per pair and column."""
    chip_smoke = _chip_smoke()
    mr, d, columns = 2500, 200, 10
    ms, by = chip_smoke._dual_bound(mr, mr, d, columns, cost, 8, 0, "fp64")
    pairs = float(mr) * mr
    want = (per_pair_feature * pairs * d + 2 * pairs * columns) / 17e12 * 1e3
    assert ms == pytest.approx(want, rel=1e-12) and by == "operations"


@pytest.mark.parametrize("mr,d,columns,dmma_ms", [
    (12500, 500, 1, 2.33209),   # kernel J, the config-3 ring's block
    (15000, 784, 10, 5.26567),  # kernel K, the MNIST-width ring's block
])
def test_float64_dual_dmma_bounds(mr, d, columns, dmma_ms):
    """The dual DMMA tile at the ring's blocks: 2 mr mc d flops at 67
    TFLOP/s (every pair of the block), by operations; the DFMAs of both
    contractions and the exps lie below it."""
    chip_smoke = _chip_smoke()
    ms, by = chip_smoke._dual_bound(mr, mr, d, columns, "gram", 8, 1, "dmma", exp=True)
    assert ms == pytest.approx(2.0 * mr * mr * d / 67e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(dmma_ms, rel=1e-5) and by == "operations"


def test_dual_dmma_bound_counts_the_fp64_pipe_at_d_3():
    """At d = 3 the FP64 pipe bounds the dual tile: pairs (2 C +
    EXP_F64_OPS) DFMAs at 17 T/s, both contractions and one exp a pair."""
    chip_smoke = _chip_smoke()
    mr, mc, d, columns = 4097, 129, 3, 10
    pairs = float(mr) * mc
    ms, _ = chip_smoke._dual_bound(mr, mc, d, columns, "gram", 8, 1, "dmma", exp=True)
    want = (2 * pairs * columns + chip_smoke.EXP_F64_OPS * pairs) / chip_smoke.FP64_INSTR_PER_S
    assert ms == pytest.approx(want * 1e3, rel=1e-12)
    assert ms > 2 * pairs * d / chip_smoke.DMMA_FLOP_PER_S * 1e3


def test_kernel_resources_names_the_dmma_tile(tmp_path, monkeypatch):
    """kernel_resources() names the DMMA tile by kind (one instantiation per
    kind, all in gram_dmma.cu) beside the other tiles' names."""
    library = tmp_path / "libplssvm_gram_0.so"
    library.with_name(library.name + ".ptxas.txt").write_text(
        "== gram_dmma.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120gram_dmma_sym_kernelILi2EEEv14CUtensorMap_stPKdS3_Pdllilidd' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 232 registers, 30784 bytes smem, 800 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120gram_dmma_sym_kernelILi3EEEv14CUtensorMap_stPKdS3_Pdllilidd' "
        "for 'sm_90a'\n"
        "    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 30784 bytes smem, 800 bytes cmem[0]\n"
        "== gram_matmat.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_122gram_matmat_sym_kernelIdLi1EEEvPKT_S3_S3_PS1_llliS1_S1_' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 90 registers, 33280 bytes smem, 428 bytes cmem[0]\n",
        encoding="utf-8",
    )
    monkeypatch.setattr(_build, "library_path", lambda: library)
    assert _build.kernel_resources() == {
        "gram_dmma_sym f64 rbf": {"spill_bytes": 0, "registers": 232, "smem_bytes": 30784},
        "gram_dmma_sym f64 sigmoid": {"spill_bytes": 16, "registers": 255,
                                      "smem_bytes": 30784},
        "gram_matmat_sym f64 poly": {"spill_bytes": 0, "registers": 90, "smem_bytes": 33280},
    }


def test_kernel_resources_names_the_dual_dmma_tile(tmp_path, monkeypatch):
    """kernel_resources() names the dual DMMA tile by kind beside the
    symmetric one and the FFMA walks of dual.cu."""
    library = tmp_path / "libplssvm_gram_0.so"
    library.with_name(library.name + ".ptxas.txt").write_text(
        "== gram_dmma.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_121gram_dmma_dual_kernelILi1EEEv14CUtensorMap_stS1_PKdS3_S3_S3_PdS4_"
        "llliiiiiidd' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 222 registers, 30784 bytes smem, 900 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120gram_dmma_sym_kernelILi1EEEv14CUtensorMap_stPKdS3_Pdllilidd' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 204 registers, 30784 bytes smem, 800 bytes cmem[0]\n"
        "== dual.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118matmat_dual_kernelIdLi3EEEvPKT_S3_S3_S3_S3_S3_PS1_S4_llllliS1_S1_' "
        "for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 50688 bytes smem, 472 bytes cmem[0]\n",
        encoding="utf-8",
    )
    monkeypatch.setattr(_build, "library_path", lambda: library)
    assert _build.kernel_resources() == {
        "gram_dmma_dual f64 poly": {"spill_bytes": 0, "registers": 222, "smem_bytes": 30784},
        "gram_dmma_sym f64 poly": {"spill_bytes": 0, "registers": 204, "smem_bytes": 30784},
        "gram_matmat_dual f64 sigmoid": {"spill_bytes": 8, "registers": 128,
                                         "smem_bytes": 50688},
    }


#: the C types of the entry points' parameters and the ctypes they take
_CTYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "double": ctypes.c_double}


def _c_signature(name):
    """The ctypes of ``extern "C" int name(...)``'s parameters in
    csrc/gram_dmma.cu: c_void_p for a pointer."""
    source = open(os.path.join(REPO, "plssvm_tpu_torch", "csrc", "gram_dmma.cu")).read()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', source).group(1)
    return [ctypes.c_void_p if "*" in p else _CTYPES[p.split()[-2]]
            for p in (" ".join(q.split()) for q in params.split(","))]


@pytest.mark.parametrize("name", [
    "plssvm_gram_matvec_sym_dmma", "plssvm_gram_matmat_sym_dmma",
    "plssvm_gram_matvec_dual_dmma", "plssvm_gram_matmat_dual_dmma",
    "plssvm_gram_dmma_blocks_per_sm", "plssvm_gram_dmma_dual_blocks_per_sm",
    "plssvm_gram_matvec_rect_dmma", "plssvm_gram_matmat_rect_dmma",
    "plssvm_gram_dmma_rect_blocks_per_sm",
])
def test_dmma_entry_points_argtypes_match_the_source(monkeypatch, name):
    """What _build.load() declares for each DMMA entry point is its C
    signature, parameter by parameter: a wrong width would cut a pointer or
    a size silently."""

    class FakeLibrary:
        def __getattr__(self, attr):
            fn = types.SimpleNamespace()
            setattr(self, attr, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: (None, 0.0))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLibrary())
    lib = _build.load()
    assert getattr(lib, name).argtypes == _c_signature(name)
    assert getattr(lib, name).restype is ctypes.c_int


def _like(dtype, device):
    """What the routing predicates read of a tensor: its device and dtype
    (a CUDA device is named without a GPU present)."""
    return types.SimpleNamespace(dtype=dtype, device=torch.device(device))


@pytest.mark.parametrize("precision", TIERS)
def test_float64_cuda_takes_the_dmma_tile_at_every_tier(precision):
    X = _like(torch.float64, "cuda")
    assert gram_matvec.uses_dmma(X)
    assert not gram_matvec.uses_tensor_cores(X, precision)


@pytest.mark.parametrize("precision", TIERS)
def test_float32_keeps_its_routes(precision):
    """float32 CUDA: the tensor-core tiles at every tier (TF32 / bf16 at
    "f32" / "bf16", three TF32 passes at "highest"), never the DMMA tile;
    CPU tensors of either type neither."""
    X = _like(torch.float32, "cuda")
    assert not gram_matvec.uses_dmma(X)
    assert gram_matvec.uses_tensor_cores(X, precision)
    for dtype in (torch.float32, torch.float64):
        assert not gram_matvec.uses_dmma(_like(dtype, "cpu"))


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("name", ["gram_matvec_dual", "gram_matmat_dual"])
def test_float64_cuda_dual_takes_the_dual_dmma_tile_at_every_tier(name, precision):
    """J and K on float64 CUDA tensors take the dual DMMA tile at every tier
    and count on ``dual_dmma_launches``; float32 keeps the TF32 / bf16 dual
    tile at "f32" / "bf16" (the one-pass tiers), and at "highest" J its
    matvec walk and K the dual tile in three TF32 passes."""
    chip_smoke = _chip_smoke()
    X64, X32 = _like(torch.float64, "cuda"), _like(torch.float32, "cuda")
    assert gram_matvec.uses_dmma(X64) and not gram_matvec.uses_tensor_cores(X64, precision)
    assert not gram_matvec.uses_dmma(X32)
    assert gram_matvec.uses_tensor_cores(X32, precision)
    assert (precision in gram_matvec.ONE_PASS_TIERS) == (precision != "highest")
    module = gram_matvec if name == "gram_matvec_dual" else gram_matmat
    assert chip_smoke._dual_counter(name, torch.float64, precision) == (
        module, "dual_dmma_launches")
    walk = precision == "highest" and name == "gram_matvec_dual"
    assert chip_smoke._dual_counter(name, torch.float32, precision) == (
        module, "dual_launches" if walk else "dual_tc_launches")


def test_reset_counts_zeroes_the_dual_dmma_counters(monkeypatch):
    monkeypatch.setattr(gram_matvec, "dual_dmma_launches", 3)
    monkeypatch.setattr(gram_matmat, "dual_dmma_launches", 5)
    gram_matvec.reset_counts()
    gram_matmat.reset_counts()
    assert gram_matvec.dual_dmma_launches == gram_matmat.dual_dmma_launches == 0


@pytest.mark.parametrize("m,d,P", [(50000, 500, 4), (60000, 784, 4), (1001, 23, 3),
                                   (53, 2, 4), (53, 7, 3)])
def test_ring_shard_views_reach_the_dmma_tiles(m, d, P):
    """The ring's row shards of a contiguous float64 X (``shard_rows``) are
    views; with an even d each starts on a 16-byte boundary and passes to
    TMA as it is, with an odd d each takes dmma_operand's padded copy."""
    from plssvm_tpu_torch.parallel import sharded

    X = torch.zeros(m, d, dtype=torch.float64)
    bounds = sharded.shard_bounds(m, P)
    for (lo, _), shard in zip(bounds, sharded.shard_rows(X, bounds, ["cpu"] * P)):
        assert shard.data_ptr() == X.data_ptr() + 8 * lo * d
        op = gram_matvec.dmma_operand(shard)
        if d % 2 == 0:
            assert shard.data_ptr() % 16 == 0 and op.data_ptr() == shard.data_ptr()
        else:
            assert op.shape == (shard.shape[0], d + 1) and op.data_ptr() % 16 == 0


@pytest.mark.parametrize("d", [1, 2, 3, 37, 784])
def test_dmma_operand_pads_odd_d_only(d):
    """An odd d gets one zero feature (a 16-byte row, as TMA requires); an
    even d is passed as it is, no copy.  Through the plain versions the
    padded operand gives the unpadded product, with X's own norms."""
    rng = np.random.default_rng(80 + d)
    X = torch.from_numpy(rng.normal(size=(45, d)) * 0.3)
    v = torch.from_numpy(rng.normal(size=(45,)))
    V = torch.from_numpy(rng.normal(size=(45, 7)))
    sq = (X * X).sum(-1)
    op = gram_matvec.dmma_operand(X)
    assert op.shape == (45, d + d % 2) and op.is_contiguous()
    if d % 2 == 0:
        assert op.data_ptr() == X.data_ptr()
    else:
        assert not op[:, d:].any()
        torch.testing.assert_close(op[:, :d], X, rtol=0, atol=0)
    for name, coef0 in COEF0.items():
        kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d, coef0=coef0, degree=3)
        torch.testing.assert_close(matvec.kernel_matvec_plain(op, sq, v, **kw),
                                   matvec.kernel_matvec_plain(X, sq, v, **kw),
                                   rtol=1e-13, atol=1e-13)
        torch.testing.assert_close(matvec.kernel_matmat_plain(op, sq, V, **kw),
                                   matvec.kernel_matmat_plain(X, sq, V, **kw),
                                   rtol=1e-13, atol=1e-13)


def test_dmma_operand_copies_a_misaligned_even_view():
    """A view that starts 8 bytes into its storage cannot feed TMA: the
    operand is a 16-byte aligned copy."""
    base = torch.zeros(41 * 4 + 1, dtype=torch.float64)
    X = base[1:].view(41, 4)
    X.copy_(torch.arange(164, dtype=torch.float64).view(41, 4))
    assert X.data_ptr() % 16 == 8
    op = gram_matvec.dmma_operand(X)
    assert op.data_ptr() % 16 == 0 and op.shape == (41, 4)
    torch.testing.assert_close(op, X, rtol=0, atol=0)


@pytest.mark.parametrize("precision", TIERS)
def test_cpu_float64_takes_the_plain_versions(precision):
    """On the CPU the wrappers run the plain versions at every tier and
    count no launch."""
    gram_matvec.reset_counts()
    gram_matmat.reset_counts()
    rng = np.random.default_rng(84)
    X = torch.from_numpy(rng.normal(size=(60, 9)))
    v = torch.from_numpy(rng.normal(size=(60,)))
    sq = (X * X).sum(-1)
    kw = dict(kind=TKind.RBF, gamma=0.1, coef0=0.0, degree=3, precision=precision)
    torch.testing.assert_close(gram_matvec.gram_matvec_sym(X, sq, v, **kw),
                               matvec.kernel_matvec_plain(X, sq, v, **kw), rtol=0, atol=0)
    torch.testing.assert_close(gram_matmat.gram_matmat_sym(X, sq, v[:, None], **kw),
                               matvec.kernel_matmat_plain(X, sq, v[:, None], **kw),
                               rtol=0, atol=0)
    assert gram_matvec.sym_dmma_launches == gram_matmat.sym_dmma_launches == 0
    gram_matvec.reset_counts()
    gram_matmat.reset_counts()


@pytest.mark.parametrize("n_p,n_s,d,columns,dmma_ms,dfma_ms", [
    (12500, 12500, 500, 1, 2.33209, 4.60478),     # kernel B, the config-3 ring's rows-only walk
    (15000, 15000, 784, 10, 5.26567, 10.50882),   # kernel D, the MNIST-width ring's
    (2000, 10000, 200, 1, 0.119403, 0.236471),    # kernel B, phase 4's predict
    (32768, 32768, 512, 1, 16.41062, 32.40174),   # kernel B, the timing shape
    (32768, 32768, 512, 10, 16.41062, 32.97019),  # kernel D, the timing shape
])
def test_float64_rect_dmma_bounds(n_p, n_s, d, columns, dmma_ms, dfma_ms):
    """The rect DMMA tile: 2 n_p n_s d flops at 67 TFLOP/s (every pair, rows
    only), by operations; the DFMAs of the contraction and the exps lie
    below it.  Beside it the FFMA tile's float64 bound: n_p n_s (d + C)
    DFMAs at 17 T/s."""
    chip_smoke = _chip_smoke()
    ms, by = chip_smoke._rect_bound(n_p, n_s, d, columns, "gram", 8, 1, "dmma", exp=True)
    assert ms == pytest.approx(2.0 * n_p * n_s * d / 67e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(dmma_ms, rel=1e-5) and by == "operations"
    ms, by = chip_smoke._rect_bound(n_p, n_s, d, columns, "gram", 8, 1, "fp64")
    assert ms == pytest.approx(dfma_ms, rel=1e-5) and by == "operations"


def test_rect_dmma_bound_counts_the_fp64_pipe_at_d_3():
    """At d = 3 the FP64 pipe bounds the rect tile: pairs (C +
    EXP_F64_OPS) DFMAs at 17 T/s, one contraction and one exp a pair."""
    chip_smoke = _chip_smoke()
    n_p, n_s, d, columns = 4097, 129, 3, 10
    pairs = float(n_p) * n_s
    ms, _ = chip_smoke._rect_bound(n_p, n_s, d, columns, "gram", 8, 1, "dmma", exp=True)
    want = (pairs * columns + chip_smoke.EXP_F64_OPS * pairs) / chip_smoke.FP64_INSTR_PER_S
    assert ms == pytest.approx(want * 1e3, rel=1e-12)
    assert ms > 2 * pairs * d / chip_smoke.DMMA_FLOP_PER_S * 1e3


def test_kernel_resources_names_the_rect_dmma_tile(tmp_path, monkeypatch):
    """kernel_resources() names the rect DMMA tile by kind beside the
    symmetric and the dual one, and apart from the FFMA rect tile."""
    library = tmp_path / "libplssvm_gram_0.so"
    library.with_name(library.name + ".ptxas.txt").write_text(
        "== gram_dmma.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_121gram_dmma_rect_kernelILi3EEEv14CUtensorMap_stS1_PKdS3_S3_Pdllliiiidd' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 196 registers, 28736 bytes smem, 900 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_121gram_dmma_dual_kernelILi3EEEv14CUtensorMap_stS1_PKdS3_S3_S3_PdS4_"
        "llliiiiiidd' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 202 registers, 30784 bytes smem, 900 bytes cmem[0]\n"
        "== gram_matvec.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_123gram_matvec_rect_kernelIdLi3EEEvPKT_S3_S3_S3_S3_PS1_llliS1_S1_' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 94 registers, 33280 bytes smem, 428 bytes cmem[0]\n",
        encoding="utf-8",
    )
    monkeypatch.setattr(_build, "library_path", lambda: library)
    assert _build.kernel_resources() == {
        "gram_dmma_rect f64 sigmoid": {"spill_bytes": 0, "registers": 196, "smem_bytes": 28736},
        "gram_dmma_dual f64 sigmoid": {"spill_bytes": 0, "registers": 202, "smem_bytes": 30784},
        "gram_matvec_rect f64 sigmoid": {"spill_bytes": 0, "registers": 94,
                                         "smem_bytes": 33280},
    }


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("classes", [None, 10])
def test_float64_cuda_rect_takes_the_rect_dmma_tile_at_every_tier(classes, precision):
    """B and D on float64 CUDA tensors take the rect DMMA tile at every tier
    (chip_smoke.py names it ``*_rect_dmma``); float32 keeps the rect
    tensor-core tile at every tier (``*_rect_tc``; "highest" in three TF32
    passes), and chip_smoke.py names the FFMA tile ``*_rect`` beside it."""
    chip_smoke = _chip_smoke()
    P64, P32 = _like(torch.float64, "cuda"), _like(torch.float32, "cuda")
    assert gram_matvec.uses_dmma(P64) and not gram_matvec.uses_tensor_cores(P64, precision)
    assert not gram_matvec.uses_dmma(P32)
    assert gram_matvec.uses_tensor_cores(P32, precision)
    base = "gram_matvec" if classes is None else "gram_matmat"
    tail = () if classes is None else (classes,)
    name, _, _ = chip_smoke._pairs(torch.zeros(3, *tail), precision, ffma=True)[1]
    assert name == f"{base}_rect"
    for dtype, tile in ((torch.float64, "_dmma"), (torch.float32, "_tc")):
        name, _, _ = chip_smoke._pairs(torch.zeros(3, *tail, dtype=dtype), precision)[1]
        assert name == f"{base}_rect{tile}"


def test_reset_counts_zeroes_the_rect_dmma_counters(monkeypatch):
    monkeypatch.setattr(gram_matvec, "rect_dmma_launches", 2)
    monkeypatch.setattr(gram_matmat, "rect_dmma_launches", 7)
    gram_matvec.reset_counts()
    gram_matmat.reset_counts()
    assert gram_matvec.rect_dmma_launches == gram_matmat.rect_dmma_launches == 0


@pytest.mark.parametrize("m,d", [(50000, 500), (60000, 784)])
def test_ring_rows_only_pairs_reach_the_rect_dmma_tile_uncopied(m, d):
    """The float64 ring's rows-only walk (P = 4: shard p against shard p -
    2) passes both shard views of a contiguous X to the rect tile as they
    are: dmma_operand copies neither."""
    from plssvm_tpu_torch.parallel import sharded

    X = torch.zeros(m, d, dtype=torch.float64)
    shards = sharded.shard_rows(X, sharded.shard_bounds(m, 4), ["cpu"] * 4)
    for p in range(4):
        for shard in (shards[p], shards[(p - 2) % 4]):
            assert gram_matvec.dmma_operand(shard).data_ptr() == shard.data_ptr()


@pytest.mark.parametrize("precision", TIERS)
def test_cpu_float64_rect_takes_the_plain_versions(precision):
    """On the CPU kernels B and D run their plain versions at every tier and
    count no launch on any rect tile."""
    gram_matvec.reset_counts()
    gram_matmat.reset_counts()
    rng = np.random.default_rng(87)
    P = torch.from_numpy(rng.normal(size=(31, 9)))
    S = torch.from_numpy(rng.normal(size=(50, 9)))
    A = torch.from_numpy(rng.normal(size=(50, 4)))
    args = (P, S, (P * P).sum(-1), (S * S).sum(-1))
    kw = dict(kind=TKind.POLYNOMIAL, gamma=0.1, coef0=1.0, degree=3, precision=precision)
    b = gram_matvec.gram_matvec_rect(*args, A[:, 0], **kw)
    d = gram_matmat.gram_matmat_rect(*args, A, **kw)
    for module in (gram_matvec, gram_matmat):
        assert module.rect_dmma_launches == module.rect_launches == module.rect_tc_launches == 0
    assert matvec.rect_plain_calls == matvec.rect_matmat_plain_calls == 1
    torch.testing.assert_close(b, matvec.kernel_matvec_rect_plain(*args, A[:, 0], **kw),
                               rtol=0, atol=0)
    torch.testing.assert_close(d, matvec.kernel_matmat_rect_plain(*args, A, **kw),
                               rtol=0, atol=0)
    gram_matvec.reset_counts()
    gram_matmat.reset_counts()


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels build and run only there)")
    return torch.device("cuda")


#: m across the 128-row tile's edge and its multiples, d from 1 to 1279
#: (odd ones take the padded copy), 1 to 37 classes (across the 8-class
#: staging chunk)
RAGGED = [(1, 1), (127, 2), (128, 16), (129, 3), (257, 17), (1037, 203), (2100, 1),
          (300, 1279), (4097, 784)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("n_classes", [None, 1, 8, 9, 37])
@pytest.mark.parametrize("m,d", RAGGED)
def test_dmma_against_plain(cuda_device, m, d, n_classes, name, precision):
    """Kernel A (n_classes None) and C on the DMMA tile against the plain
    version within 1e-10 of max|plain|, one launch each on the DMMA tile
    and none on the FFMA or tensor-core tiles."""
    g = torch.Generator().manual_seed(81)
    X = (torch.randn(m, d, generator=g, dtype=torch.float64) * 0.3).to(cuda_device)
    tail = () if n_classes is None else (n_classes,)
    V = torch.randn(m, *tail, generator=g, dtype=torch.float64).to(cuda_device)
    sq = (X * X).sum(-1)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d, coef0=COEF0[name], degree=3,
              precision=precision)
    module = gram_matvec if n_classes is None else gram_matmat
    kernel = gram_matvec.gram_matvec_sym if n_classes is None else gram_matmat.gram_matmat_sym
    plain = matvec.kernel_matvec_plain if n_classes is None else matvec.kernel_matmat_plain
    module.reset_counts()
    got = kernel(X, sq, V, **kw)
    want = plain(X, sq, V, **kw)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-10 * want.abs().max()
    assert (module.sym_dmma_launches, module.sym_launches, module.sym_tc_launches) == (1, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_labels", [2, 4])
def test_float64_fit_takes_the_dmma_tile(cuda_device, n_labels):
    """A float64 CUDA fit runs every symmetric product on the DMMA tile (1 +
    iterations + every 50th) and none on the FFMA sym tile; its predict
    goes through the rect DMMA tile, none through the FFMA rect tile; and
    its model and decision values
    agree with ``backend="torch"`` on the card within 1e-6 (the kernels
    sum in other orders and CG amplifies the rounding, as chip_smoke.py's
    small-fit check allows)."""
    import plssvm_tpu_torch as port

    rng = np.random.default_rng(83)
    y = rng.integers(0, n_labels, 400)
    X = rng.normal(size=(400, 10)) + 0.6 * rng.normal(size=(n_labels, 10))[y]
    train = port.DataSet(X[:300], y[:300], scaling=(-1.0, 1.0))
    test = port.DataSet(X[300:], y[300:], scaling=train.scaling_factors)
    module = gram_matvec if n_labels == 2 else gram_matmat
    results = []
    for backend in ("cuda", "torch"):
        svm = port.CSVM(backend=backend, device="cuda", dtype=np.float64,
                        kernel_type="rbf", cost=1.0)
        gram_matvec.reset_counts()
        gram_matmat.reset_counts()
        model = svm.fit(train, epsilon=1e-10)
        if backend == "cuda":
            assert module.sym_dmma_launches == 1 + model.n_iter + model.n_iter // 50
            assert gram_matvec.sym_launches == gram_matmat.sym_launches == 0
            assert module.sym_tc_launches == 0
        values = svm.predict_values(model, test)
        if backend == "cuda":
            assert module.rect_dmma_launches >= 1
            assert gram_matvec.rect_launches == gram_matmat.rect_launches == 0
        results.append((np.asarray(model.rho), values))
    (rho, f), (rho_plain, f_plain) = results
    assert np.all(np.isfinite(f))
    assert np.max(np.abs(rho - rho_plain)) <= 1e-6
    assert np.max(np.abs(f - f_plain)) <= 1e-6


#: mr != mc on both sides of the 128-row tile, d from 1 to 785 (odd ones
#: take the padded copies), 33 column tiles (4097 rows)
DUAL_RAGGED = [(1, 129, 1), (127, 4097, 3), (129, 127, 16), (4097, 1, 785), (4097, 129, 2),
               (129, 4097, 37), (300, 1100, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("n_classes", [None, 1, 8, 9, 17, 37])
@pytest.mark.parametrize("mr,mc,d", DUAL_RAGGED)
def test_dual_dmma_against_plain(cuda_device, mr, mc, d, n_classes, name, precision):
    """Kernel J (n_classes None) and K on the dual DMMA tile, both outputs,
    against the plain version within 1e-10 of max|plain|; one launch each
    on the dual DMMA tile and none on the FFMA walk or the tensor-core
    tile.  9, 17 and 37 classes cross the 8-class staging chunk."""
    g = torch.Generator().manual_seed(85)
    Xr = (torch.randn(mr, d, generator=g, dtype=torch.float64) * 0.3).to(cuda_device)
    Xc = (torch.randn(mc, d, generator=g, dtype=torch.float64) * 0.3).to(cuda_device)
    tail = () if n_classes is None else (n_classes,)
    v_c = torch.randn(mc, *tail, generator=g, dtype=torch.float64).to(cuda_device)
    v_r = torch.randn(mr, *tail, generator=g, dtype=torch.float64).to(cuda_device)
    sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d, coef0=COEF0[name], degree=3,
              precision=precision)
    module, kernel, plain = (
        (gram_matvec, gram_matvec.gram_matvec_dual, matvec.kernel_matvec_dual_plain)
        if n_classes is None else
        (gram_matmat, gram_matmat.gram_matmat_dual, matvec.kernel_matmat_dual_plain))
    module.reset_counts()
    got = kernel(Xr, Xc, sq_r, sq_c, v_c, v_r, **kw)
    want = plain(Xr, Xc, sq_r, sq_c, v_c, v_r, **kw)
    for out, ref in zip(got, want):
        assert out.shape == ref.shape and torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-10 * ref.abs().max()
    assert (module.dual_dmma_launches, module.dual_launches, module.dual_tc_launches) == (1, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("name", list(COEF0))
@pytest.mark.parametrize("n_classes", [None, 1, 8, 9, 17, 37])
@pytest.mark.parametrize("n_p,n_s,d", DUAL_RAGGED)
def test_rect_dmma_against_plain(cuda_device, n_p, n_s, d, n_classes, name, precision):
    """Kernel B (n_classes None) and D on the rect DMMA tile against the
    plain version within 1e-10 of max|plain|, n_p != n_s on both sides of
    the 128-row tile; one launch each on the rect DMMA tile and none on the
    FFMA or the tensor-core rect tile."""
    g = torch.Generator().manual_seed(88)
    P = (torch.randn(n_p, d, generator=g, dtype=torch.float64) * 0.3).to(cuda_device)
    S = (torch.randn(n_s, d, generator=g, dtype=torch.float64) * 0.3).to(cuda_device)
    tail = () if n_classes is None else (n_classes,)
    A = torch.randn(n_s, *tail, generator=g, dtype=torch.float64).to(cuda_device)
    args = (P, S, (P * P).sum(-1), (S * S).sum(-1), A)
    kw = dict(kind=getattr(TKind, name.upper()), gamma=1.0 / d, coef0=COEF0[name], degree=3,
              precision=precision)
    module, kernel, plain = (
        (gram_matvec, gram_matvec.gram_matvec_rect, matvec.kernel_matvec_rect_plain)
        if n_classes is None else
        (gram_matmat, gram_matmat.gram_matmat_rect, matvec.kernel_matmat_rect_plain))
    module.reset_counts()
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-10 * want.abs().max()
    assert (module.rect_dmma_launches, module.rect_launches, module.rect_tc_launches) == (1, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_labels", [2, 4])
def test_float64_ring_fit_takes_the_dual_dmma_tile(cuda_device, n_labels):
    """A float64 fit on four shards of one card (``devices=["cuda:0"] *
    4``): per shard and product one symmetric, one dual and one rows-only
    walk on the DMMA tiles, nothing on the FFMA tiles; its predict per
    shard one launch of the rect DMMA tile; its decision values agree with
    the single-device fit within 1e-6 (both at epsilon 1e-10)."""
    import plssvm_tpu_torch as port

    rng = np.random.default_rng(86)
    y = rng.integers(0, n_labels, 900)
    X = rng.normal(size=(900, 12)) + 0.6 * rng.normal(size=(n_labels, 12))[y]
    train = port.DataSet(X[:700], y[:700], scaling=(-1.0, 1.0))
    test = port.DataSet(X[700:], y[700:], scaling=train.scaling_factors)
    module = gram_matvec if n_labels == 2 else gram_matmat
    values = []
    for devices in (["cuda:0"] * 4, None):
        where = dict(devices=devices) if devices else dict(device="cuda")
        svm = port.CSVM(backend="cuda", dtype=np.float64, kernel_type="rbf", cost=1.0, **where)
        gram_matvec.reset_counts()
        gram_matmat.reset_counts()
        model = svm.fit(train, epsilon=1e-10)
        if devices:
            products = 1 + model.n_iter + model.n_iter // 50
            assert module.sym_dmma_launches == 4 * products
            assert module.dual_dmma_launches == 4 * products  # (4 - 1) // 2 steps
            assert module.rect_dmma_launches == 4 * products
            assert gram_matvec.dual_launches == gram_matmat.dual_launches == 0
            assert gram_matvec.rect_launches == gram_matmat.rect_launches == 0
            assert module.dual_tc_launches == module.sym_launches == 0
        values.append(svm.predict_values(model, test))
        if devices:
            assert module.rect_dmma_launches == 4 * products + 4
            assert gram_matvec.rect_launches == gram_matmat.rect_launches == 0
    assert np.all(np.isfinite(values[0]))
    assert np.max(np.abs(values[0] - values[1])) <= 1e-6


# -- the tool ------------------------------------------------------------------

@pytest.mark.parametrize("classes", [1, 4])
def test_bench_gram_f64_on_the_cpu(capsys, classes):
    """On the CPU the tool times the wrapper's plain version (the ``dmma``
    line, rel_err 0)."""
    from plssvm_tpu_torch.tools import bench_gram_f64

    rc = bench_gram_f64.main(["70", "5", str(classes), "sigmoid", "--repeats", "1", "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert lines[0] == f"bench_gram_f64 on cpu: m=70 d=5 classes={classes} kernel=sigmoid"
    assert len(lines) == 2 and lines[1].startswith("dmma ")
    assert lines[1].endswith("rel_err=0.00e+00")


def test_bench_gram_f64_refuses_what_it_does_not_time(capsys, monkeypatch):
    from plssvm_tpu_torch.tools import bench_gram_f64

    assert bench_gram_f64.main(["8", "2", "1", "laplacian", "--cpu"]) == 2
    assert bench_gram_f64.main(["8", "2", "1", "linear", "--cpu"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_gram_f64.main(["8", "2"]) == 1
    assert "none is available" in capsys.readouterr().err


@pytest.mark.parametrize("classes", [1, 3])
def test_bench_gram_f64_dual_on_the_cpu(capsys, classes):
    """``--dual`` times kernel J or K: on the CPU the wrappers' plain
    versions (the ``dual`` line, rel_err 0)."""
    from plssvm_tpu_torch.tools import bench_gram_f64

    rc = bench_gram_f64.main(["40", "3", str(classes), "rbf", "--repeats", "1", "--dual",
                              "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert lines[0] == f"bench_gram_f64 on cpu: m=40 d=3 classes={classes} kernel=rbf dual"
    assert len(lines) == 2 and lines[1].startswith("dual ")
    assert lines[1].endswith("rel_err=0.00e+00")


@pytest.mark.parametrize("classes", [1, 3])
def test_bench_gram_f64_rect_on_the_cpu(capsys, classes):
    """``--rect`` times kernel B or D: on the CPU the wrappers' plain
    versions (the ``rect`` line, rel_err 0)."""
    from plssvm_tpu_torch.tools import bench_gram_f64

    rc = bench_gram_f64.main(["40", "3", str(classes), "polynomial", "--repeats", "1",
                              "--rect", "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert lines[0] == f"bench_gram_f64 on cpu: m=40 d=3 classes={classes} kernel=polynomial rect"
    assert len(lines) == 2 and lines[1].startswith("rect ")
    assert lines[1].endswith("rel_err=0.00e+00")
