"""The row-sharded ring (plssvm_tpu_torch/parallel/sharded.py) and the plain
versions of its dual walks (kernels J-M) against plssvm_tpu on the CPU.

- (a) ``kernel_matvec_dual_plain``, ``kernel_matmat_dual_plain``,
  ``distance_matvec_dual_plain`` and ``distance_matmat_dual_plain`` against
  the Pallas kernels they stand for, ``*_pallas_dual(symmetric=False)``
  under ``pltpu.force_tpu_interpret_mode()``, in float32 at each Gram tier
  (rtol = atol = 2e-5, as tests/test_torch_rect_tc.py: only the float32
  summation order differs).  The Pallas kernels compute in float32 whatever
  they are given, so the float64 versions are held at 1e-12 relative
  against the reference ring's float64 block, ``kernel_block`` both ways
  (its XLA ``cross_dual``).
- (b) ``ring_kernel_matvec`` / ``ring_kernel_matmat`` for P in {2, 3, 4, 8}
  against the reference's ring over a mesh of P CPU devices (the 8 virtual
  devices of tests/conftest.py), float64, 1e-12 relative: odd P has no
  rows-only step, even P one.
- (c) ``CSVM(devices=["cpu"] * 4)`` against ``plssvm_tpu.CSVM(devices=
  jax.devices("cpu")[:4])`` in float64 at epsilon 1e-10: equal iteration
  counts, rho within 1e-9, the alphas within 1e-9 (binary) and 1e-8
  (one-vs-all), the same labels and decision values within 1e-8; and in
  float32 at ``gram_precision="highest"`` (epsilon 1e-5): the same labels,
  iterations within one, rho within 1e-3.  The
  one-vs-all set's seed is one where plssvm_tpu's own sharded and
  single-device fits agree (alphas within 4.3e-10; on other seeds they
  differ by up to 1.5e-8, the CG noise of ROADMAP Queue 3).
- (d) the refusals: a device list that mixes cpu and cuda or names cpu
  under the cuda backend, and each combination not ported yet.

Inputs are made with numpy from a seed and handed to both packages.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu_torch.exceptions import (
    InvalidParameterError,
    UnsupportedBackendError,
)
from plssvm_tpu_torch.ops import _build, distance, gram_matmat, gram_matvec, matvec
from plssvm_tpu_torch.parallel import sharded
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind

COEF0 = {"polynomial": 1.0, "rbf": 0.0, "sigmoid": -0.5, "laplacian": 0.0,
         "chi_squared": 0.0}
DISTANCE = ("laplacian", "chi_squared")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-5
F64_REL = 1e-12


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def _kinds(name):
    return getattr(JKind, name.upper()), getattr(TKind, name.upper())


def _block(seed, mr, mc, d, n_classes, dtype):
    """Non-negative rows Xr (mr, d) and Xc (mc, d) (chi-squared's domain,
    about a quarter of the entries 0), their squared norms, and v_c (mc,) /
    v_r (mr,) or V_c (mc, C) / V_r (mr, C)."""
    rng = np.random.default_rng(seed)
    Xr = rng.random((mr, d))
    Xc = rng.random((mc, d))
    Xr[Xr < 0.25] = 0.0
    Xc[Xc < 0.25] = 0.0
    tail = () if n_classes is None else (n_classes,)
    v_c = rng.normal(size=(mc,) + tail)
    v_r = rng.normal(size=(mr,) + tail)
    Xr, Xc, v_c, v_r = (a.astype(dtype) for a in (Xr, Xc, v_c, v_r))
    return Xr, Xc, (Xr * Xr).sum(1), (Xc * Xc).sum(1), v_c, v_r


def _class_major(V):
    cp = -(-V.shape[1] // 8) * 8
    out = np.zeros((cp, V.shape[0]), V.dtype)
    out[: V.shape[1]] = V.T
    return out


def _pallas_dual(name, Xr, Xc, sq_r, sq_c, v_c, v_r, tier):
    """The reference's dual walk with symmetric=False, interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_distance import (
        distance_matmat_pallas_dual,
        distance_matvec_pallas_dual,
    )
    from plssvm_tpu.ops.pallas_matvec import (
        kernel_matmat_pallas_dual,
        kernel_matvec_pallas_dual,
    )

    jkind, _ = _kinds(name)
    d = Xr.shape[1]
    matmat = v_c.ndim == 2
    vc = _class_major(v_c) if matmat else v_c
    vr = _class_major(v_r) if matmat else v_r
    args = [jnp.asarray(a) for a in (Xr, Xc)]
    with pltpu.force_tpu_interpret_mode():
        if name in DISTANCE:
            fn = distance_matmat_pallas_dual if matmat else distance_matvec_pallas_dual
            r, c = fn(*args, jnp.asarray(vc), jnp.asarray(vr), kind=jkind,
                      gamma=jnp.float32(1.0 / d), symmetric=False)
        else:
            fn = kernel_matmat_pallas_dual if matmat else kernel_matvec_pallas_dual
            r, c = fn(*args, jnp.asarray(sq_r), jnp.asarray(sq_c), jnp.asarray(vc),
                      jnp.asarray(vr), kind=jkind, gamma=jnp.float32(1.0 / d),
                      coef0=jnp.float32(COEF0[name]), degree=3, precision=tier,
                      symmetric=False)
    r, c = np.asarray(r), np.asarray(c)
    if matmat:
        n = v_c.shape[1]
        return r[:n].T, c[:n].T
    return r, c


def _plain_dual(name, Xr, Xc, sq_r, sq_c, v_c, v_r, tier):
    """The port's plain dual version of the kind, on torch copies."""
    _, tkind = _kinds(name)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (Xr, Xc, sq_r, sq_c, v_c, v_r)]
    gamma = 1.0 / Xr.shape[1]
    if name in DISTANCE:
        fn = matvec.distance_matmat_dual_plain if v_c.ndim == 2 else matvec.distance_matvec_dual_plain
        out = fn(t[0], t[1], t[4], t[5], kind=tkind, gamma=gamma)
    else:
        fn = matvec.kernel_matmat_dual_plain if v_c.ndim == 2 else matvec.kernel_matvec_dual_plain
        out = fn(*t, kind=tkind, gamma=gamma, coef0=COEF0[name], degree=3,
                 precision=tier)
    return tuple(o.numpy() for o in out)


# -- (a) the plain dual versions against the TPU kernels -------------------


@pytest.mark.parametrize("tier", ["f32", "bf16", "highest"])
@pytest.mark.parametrize("name", ["rbf", "polynomial"])
def test_gram_matvec_dual_plain_against_k1(name, tier):
    """kernel_matvec_dual_plain against K1 with symmetric=False on a 256 x
    128 block (the Pallas tile needs 128-row multiples; the port does not)."""
    block = _block(81, 256, 128, 16, None, np.float32)
    for got, want in zip(_plain_dual(name, *block, tier), _pallas_dual(name, *block, tier)):
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("name,n_classes,tier", [
    ("rbf", 1, "f32"), ("rbf", 3, "f32"), ("rbf", 10, "f32"),
    ("polynomial", 1, "f32"), ("polynomial", 3, "f32"), ("polynomial", 10, "f32"),
    ("rbf", 3, "bf16"), ("rbf", 3, "highest"),
])
def test_gram_matmat_dual_plain_against_k4(name, n_classes, tier):
    """kernel_matmat_dual_plain against K4 with symmetric=False."""
    block = _block(82, 128, 256, 16, n_classes, np.float32)
    for got, want in zip(_plain_dual(name, *block, tier), _pallas_dual(name, *block, tier)):
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("n_classes", [None, 1, 3, 10])
@pytest.mark.parametrize("name", DISTANCE)
def test_distance_dual_plain_against_k7_k9(name, n_classes):
    """distance_matvec_dual_plain against K7 and distance_matmat_dual_plain
    against K9, both with symmetric=False, on zero-rich rows."""
    block = _block(83, 256, 128, 16, n_classes, np.float32)
    for got, want in zip(_plain_dual(name, *block, "f32"), _pallas_dual(name, *block, "f32")):
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("n_classes", [None, 1, 3, 10, 37])
@pytest.mark.parametrize("name", ["rbf", "polynomial", "sigmoid", "laplacian", "chi_squared"])
def test_dual_plain_f64_against_the_reference_block(name, n_classes):
    """In float64 on ragged shapes: both outputs against the reference's
    float64 kernel block contracted both ways (its ring's XLA cross_dual).
    The second block has the dual DMMA tile's edges: one row past the
    128-row tile against one short of it, an odd d."""
    from plssvm_tpu.kernel_functions import kernel_block

    jkind, _ = _kinds(name)
    for mr, mc, d in ((77, 130, 9), (129, 127, 13)):
        Xr, Xc, sq_r, sq_c, v_c, v_r = _block(84, mr, mc, d, n_classes, np.float64)
        K = np.asarray(kernel_block(jnp.asarray(Xr), jnp.asarray(Xc), jnp.asarray(sq_r),
                                    jnp.asarray(sq_c), jkind, 1.0 / d, COEF0[name], 3))
        got = _plain_dual(name, Xr, Xc, sq_r, sq_c, v_c, v_r, "f32")
        for g, w in zip(got, (K @ v_c, K.T @ v_r)):
            assert np.abs(g - w).max() <= F64_REL * np.abs(w).max()


def test_cpu_wrappers_take_the_dual_plain_versions():
    """On CPU tensors the four dual wrappers return their plain versions at
    the tier exactly and launch nothing."""
    Xr, Xc, sq_r, sq_c, v_c, v_r = (torch.from_numpy(a) for a in
                                    _block(85, 9, 13, 5, None, np.float32))
    V_c, V_r = v_c[:, None].repeat(1, 3), v_r[:, None].repeat(1, 3)
    kw = dict(kind=TKind.RBF, gamma=0.2, coef0=0.0, degree=3, precision="bf16")
    for module in (gram_matvec, gram_matmat, distance):
        module.reset_counts()
    pairs = [
        (gram_matvec.gram_matvec_dual(Xr, Xc, sq_r, sq_c, v_c, v_r, **kw),
         matvec.kernel_matvec_dual_plain(Xr, Xc, sq_r, sq_c, v_c, v_r, **kw)),
        (gram_matmat.gram_matmat_dual(Xr, Xc, sq_r, sq_c, V_c, V_r, **kw),
         matvec.kernel_matmat_dual_plain(Xr, Xc, sq_r, sq_c, V_c, V_r, **kw)),
        (distance.distance_matvec_dual(Xr, Xc, v_c, v_r, kind=TKind.LAPLACIAN, gamma=0.2),
         matvec.distance_matvec_dual_plain(Xr, Xc, v_c, v_r, kind=TKind.LAPLACIAN, gamma=0.2)),
        (distance.distance_matmat_dual(Xr, Xc, V_c, V_r, kind=TKind.CHI_SQUARED, gamma=0.2),
         matvec.distance_matmat_dual_plain(Xr, Xc, V_c, V_r, kind=TKind.CHI_SQUARED, gamma=0.2)),
    ]
    for got, want in pairs:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (gram_matvec.dual_launches, gram_matmat.dual_launches,
            distance.matvec_dual_launches, distance.matmat_dual_launches) == (0, 0, 0, 0)
    assert matvec.dual_plain_calls == 2 and matvec.dist_dual_plain_calls == 2


def test_kernel_resources_names_the_dual_walks(tmp_path, monkeypatch):
    """kernel_resources() names kernels J-M by family, type and kind."""
    library = tmp_path / "libplssvm_gram_0.so"
    library.with_name(library.name + ".ptxas.txt").write_text(
        "== dual.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118matvec_dual_kernelIfLi2EEEvPKT_S3_S3_S3_S3_S3_PS1_S4_lllliS1_S1_' "
        "for 'sm_90a'\n"
        "ptxas info    : Used 96 registers, 24832 bytes smem, 460 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118matmat_dual_kernelIdLi5EEEvPKT_S3_S3_S3_S3_S3_PS1_S4_llllliS1_S1_' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 64 registers, 16384 bytes smem, 468 bytes cmem[0]\n",
        encoding="utf-8",
    )
    monkeypatch.setattr(_build, "library_path", lambda: library)
    assert _build.kernel_resources() == {
        "gram_matvec_dual f32 rbf": {"registers": 96, "smem_bytes": 24832},
        "distance_matmat_dual f64 chi_squared": {
            "spill_bytes": 16, "registers": 64, "smem_bytes": 16384},
    }


@pytest.mark.parametrize("mangled,name", [
    ("IfLi1EEEvPKT_S3_S3_S3_S3_S3_PS1_S4_llllliS1_S1_", "gram_matvec_dual f32 poly"),
    ("IfLi4EEEvPKT_S3_S3_S3_S3_S3_PS1_S4_llllliS1_S1_", "distance_matvec_dual f32 laplacian"),
    ("IdLi4EEEvPKT_S3_S3_S3_S3_S3_PS1_S4_llllliS1_S1_", "distance_matvec_dual f64 laplacian"),
    ("IdLi5EEEvPKT_S3_S3_S3_S3_S3_PS1_S4_llllliS1_S1_", "distance_matvec_dual f64 chi_squared"),
])
def test_kernel_resources_names_the_persistent_matvec_walk(mangled, name, tmp_path,
                                                            monkeypatch):
    """kernel_resources() names the matvec walk of J and L, whose persistent
    grid takes the strips and units (one more size than the 2-D grid's
    column tiles), by family, type and kind; its shared memory is dynamic,
    so ptxas reports none."""
    library = tmp_path / "libplssvm_gram_0.so"
    library.with_name(library.name + ".ptxas.txt").write_text(
        "== dual.cu\n"
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118matvec_dual_kernel{mangled}' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 476 bytes cmem[0]\n",
        encoding="utf-8",
    )
    monkeypatch.setattr(_build, "library_path", lambda: library)
    assert _build.kernel_resources() == {
        name: {"spill_bytes": 0, "registers": 128, "smem_bytes": 0}}


@pytest.mark.parametrize("tier,mangled", [("tf32", "Tf32"), ("bf16", "Bf16")])
def test_kernel_resources_names_the_dual_tensor_core_tile(tier, mangled, tmp_path,
                                                          monkeypatch):
    """kernel_resources() names the dual tensor-core tile of J and K by tier
    and kind, apart from the FFMA dual walks and the other tiles."""
    library = tmp_path / "libplssvm_gram_0.so"
    library.with_name(library.name + ".ptxas.txt").write_text(
        "== dual.cu\n"
        "ptxas info    : Compiling entry function "
        f"'_ZN12_GLOBAL__N_119gram_tc_dual_kernelINS_8{mangled}TierELi2EEEv14CUtensorMap_stS2_"
        "PKfS4_S4_S4_PfS5_iiiiiiiifff' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 15408 bytes smem, 952 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        f"'_ZN12_GLOBAL__N_119gram_tc_dual_kernelINS_8{mangled}TierELi3EEEv14CUtensorMap_stS2_"
        "PKfS4_S4_S4_PfS5_iiiiiiiifff' for 'sm_90a'\n"
        "    32 bytes stack frame, 32 bytes spill stores, 32 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 15408 bytes smem, 952 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118matvec_dual_kernelIfLi2EEEvPKT_S3_S3_S3_S3_S3_PS1_S4_lllliS1_S1_' "
        "for 'sm_90a'\n"
        "ptxas info    : Used 96 registers, 24832 bytes smem, 460 bytes cmem[0]\n",
        encoding="utf-8",
    )
    monkeypatch.setattr(_build, "library_path", lambda: library)
    assert _build.kernel_resources() == {
        f"gram_tc_dual {tier} rbf": {"spill_bytes": 0, "registers": 128, "smem_bytes": 15408},
        f"gram_tc_dual {tier} sigmoid": {
            "spill_bytes": 64, "registers": 128, "smem_bytes": 15408},
        "gram_matvec_dual f32 rbf": {"registers": 96, "smem_bytes": 24832},
    }


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_dual_bounds", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("cost,columns", [("gram", 1), ("gram", 10), ("laplacian", 1),
                                          ("chi_squared", 10)])
def test_dual_bound_counts_every_pair(cost, columns):
    """chip_smoke.py's bound of a dual walk: mr mc pairs (not m (m + 1) /
    2), 2 mr mc FFMAs per column (both contractions), Xr, Xc, both
    right-hand sides and both outputs moved once."""
    chip_smoke = _chip_smoke()
    mr, mc, d = 15000, 15000, 784
    ms, by = chip_smoke._dual_bound(mr, mc, d, columns, cost, 4)
    fp32, sfu = chip_smoke.PAIR_FEATURE_COST[cost]
    ops_s = max((fp32 * mr * mc * d + 2.0 * mr * mc * columns) / chip_smoke.FP32_INSTR_PER_S,
                sfu * mr * mc * d / chip_smoke.SFU_OPS_PER_S)
    bytes_s = 4 * (mr + mc) * (d + 2 * columns) / chip_smoke.HBM_BYTES_PER_S
    assert by == "operations"
    assert ms == pytest.approx(max(ops_s, bytes_s) * 1e3, rel=1e-12)
    sym_ms, _ = chip_smoke._sym_bound(mr, d, columns, cost, 4)
    assert ms > 1.9 * sym_ms


@pytest.mark.parametrize("columns", [1, 10])
@pytest.mark.parametrize("tier", ["tf32", "bf16"])
def test_dual_bound_on_the_tensor_cores(tier, columns):
    """chip_smoke.py's bound of J and K on the dual tensor-core tile: 2 mr
    mc d flops at the tier's peak beside 2 mr mc FFMAs per column and one
    SFU exp per pair (RBF), the largest of the three; the operand copies at
    the tier's size and the rest at float32 moved once."""
    chip_smoke = _chip_smoke()
    mr, mc, d = 15000, 12500, 784
    ms, by = chip_smoke._dual_bound(mr, mc, d, columns, "gram", 4, 1, tier, exp=True)
    peak, itemsize = chip_smoke.TC_TIERS[tier]
    ops_s = max(2.0 * mr * mc * d / peak,
                2.0 * mr * mc * columns / chip_smoke.FP32_INSTR_PER_S,
                mr * mc / chip_smoke.SFU_OPS_PER_S)
    bytes_s = (itemsize * (mr + mc) * d + 4 * (mr + mc) * (2 * columns + 1)) / \
        chip_smoke.HBM_BYTES_PER_S
    assert by == "operations"
    assert ms == pytest.approx(max(ops_s, bytes_s) * 1e3, rel=1e-12)
    # the products bound it, and the FFMA tile's bound is far above
    assert ms == pytest.approx(2e3 * mr * mc * d / peak, rel=1e-12)
    assert chip_smoke._dual_bound(mr, mc, d, columns, "gram", 4, 1)[0] > 7 * ms


# -- (b) the ring against the reference's ring ------------------------------


def _reference_ring(X, v, kind, P):
    """The reference's ring over a mesh of P CPU devices (impl "xla")."""
    from jax.sharding import NamedSharding, PartitionSpec

    from plssvm_tpu.parallel.sharded import (
        ROW_AXIS,
        make_row_mesh,
        ring_kernel_matmat,
        ring_kernel_matvec,
    )

    mesh = make_row_mesh(jax.devices("cpu")[:P])
    matmat = v.ndim == 2
    ring = ring_kernel_matmat if matmat else ring_kernel_matvec
    vspec = PartitionSpec(ROW_AXIS, None) if matmat else PartitionSpec(ROW_AXIS)
    fn = jax.jit(jax.shard_map(
        lambda Xl, sql, vl: ring(
            Xl, sql, vl, 1.0 / X.shape[1], COEF0[str(kind)], kind=kind, degree=3,
            axis_name=ROW_AXIS, num_devices=P, impl="xla"),
        mesh=mesh,
        in_specs=(PartitionSpec(ROW_AXIS, None), PartitionSpec(ROW_AXIS), vspec),
        out_specs=vspec,
    ))
    place = [
        jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
        for a, spec in ((X, PartitionSpec(ROW_AXIS, None)),
                        ((X * X).sum(1), PartitionSpec(ROW_AXIS)), (v, vspec))
    ]
    return np.asarray(jax.device_get(fn(*place)))


@pytest.mark.parametrize("name", ["rbf", "laplacian"])
@pytest.mark.parametrize("matmat", [False, True])
@pytest.mark.parametrize("P", [2, 3, 4, 8])
def test_ring_against_the_reference_ring(P, matmat, name):
    """The port's ring (kernels' CPU route and the torch plain route) over P
    shards on one CPU against the reference's ring over P CPU devices."""
    jkind, tkind = _kinds(name)
    rng = np.random.default_rng(90 + P)
    m, d = P * 24, 7
    X = rng.random((m, d))
    v = rng.normal(size=(m, 3) if matmat else (m,))
    want = _reference_ring(X, v, jkind, P)
    bounds = sharded.shard_bounds(m, P)
    devices = ["cpu"] * P
    Xt, vt = torch.from_numpy(X), torch.from_numpy(v)
    X_shards = sharded.shard_rows(Xt, bounds, devices)
    sq_shards = (None if name in DISTANCE
                 else sharded.shard_rows((Xt * Xt).sum(1), bounds, devices))
    ring = sharded.ring_kernel_matmat if matmat else sharded.ring_kernel_matvec
    for impl in ("cuda", "torch"):
        outs = ring(X_shards, sq_shards, sharded.shard_rows(vt, bounds, devices),
                    1.0 / d, COEF0[name], kind=tkind, degree=3, impl=impl)
        got = torch.cat(outs).numpy()
        assert np.abs(got - want).max() <= F64_REL * np.abs(want).max()


@pytest.mark.parametrize("P", [2, 3, 4, 5])
@pytest.mark.parametrize("name", ["polynomial", "sigmoid", "chi_squared"])
def test_ragged_ring_against_the_whole_product(P, name):
    """Shards of unequal height (m = 53): the ring equals K @ v, and for
    P >= 3 it ran the dual walks (their plain versions on the CPU)."""
    _, tkind = _kinds(name)
    rng = np.random.default_rng(91)
    X = torch.from_numpy(rng.random((53, 6)))
    v = torch.from_numpy(rng.normal(size=(53,)))
    sq = (X * X).sum(1)
    bounds = sharded.shard_bounds(53, P)
    assert {hi - lo for lo, hi in bounds} == ({53 // P, 53 // P + 1} if 53 % P else {53 // P})
    devices = ["cpu"] * P
    before = matvec.dual_plain_calls + matvec.dist_dual_plain_calls
    outs = sharded.ring_kernel_matvec(
        sharded.shard_rows(X, bounds, devices),
        None if name in DISTANCE else sharded.shard_rows(sq, bounds, devices),
        sharded.shard_rows(v, bounds, devices), 0.2, COEF0[name], kind=tkind,
        degree=3, impl="cuda", precision="highest")
    if name in DISTANCE:
        want = matvec.distance_matvec_plain(X, v, kind=tkind, gamma=0.2)
    else:
        want = matvec.kernel_matvec_plain(X, sq, v, kind=tkind, gamma=0.2,
                                          coef0=COEF0[name], degree=3)
    assert torch.allclose(torch.cat(outs), want, rtol=0, atol=F64_REL * float(want.abs().max()))
    duals = matvec.dual_plain_calls + matvec.dist_dual_plain_calls - before
    assert duals == P * ((P - 1) // 2)


def test_linear_sharded_matvec_is_the_factored_product():
    rng = np.random.default_rng(92)
    X = torch.from_numpy(rng.normal(size=(41, 5)))
    v = torch.from_numpy(rng.normal(size=(41, 2)))
    bounds = sharded.shard_bounds(41, 3)
    outs = sharded.linear_sharded_matvec(sharded.shard_rows(X, bounds, ["cpu"] * 3),
                                         sharded.shard_rows(v, bounds, ["cpu"] * 3))
    torch.testing.assert_close(torch.cat(outs), X @ (X.T @ v), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,P", [(1, 1), (7, 7), (10, 3), (10, 4)])
def test_shard_bounds(m, P):
    bounds = sharded.shard_bounds(m, P)
    assert bounds[0][0] == 0 and bounds[-1][1] == m and len(bounds) == P
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert max(hi - lo for lo, hi in bounds) - min(hi - lo for lo, hi in bounds) <= 1
    with pytest.raises(ValueError):
        sharded.shard_bounds(m, m + 1)


# -- (c) CSVM with devices against the reference's sharded CSVM -------------


def _blobs(seed, n=240, d=10, n_classes=2):
    rng = np.random.default_rng(seed)
    if n_classes == 2:
        y = np.where(rng.random(n) < 0.5, -1, 1)
        X = rng.normal(size=(n, d)) + 0.4 * y[:, None]
    else:
        y = rng.integers(0, n_classes, n)
        X = rng.normal(size=(n, d)) + rng.normal(size=(n_classes, d))[y]
    return X[:200], y[:200], X[200:], y[200:]


#: the float32 "highest" cases: epsilon, and the largest rho difference
#: allowed (two float32 CG solves summed in other orders; 5.0e-5 binary and
#: 2.4e-4 with three classes measured at this epsilon on these seeds)
F32_HIGHEST_EPSILON, F32_HIGHEST_RHO = 1e-5, 1e-3


@pytest.mark.parametrize("kernel,n_classes,alpha_tol,dtype", [
    pytest.param("rbf", 2, 1e-9, np.float64, id="rbf-2-1e-09"),
    pytest.param("laplacian", 2, 1e-9, np.float64, id="laplacian-2-1e-09"),
    pytest.param("rbf", 3, 1e-8, np.float64, id="rbf-3-1e-08"),
    pytest.param("rbf", 2, None, np.float32, id="rbf-2-float32-highest"),
    pytest.param("rbf", 3, None, np.float32, id="rbf-3-float32-highest"),
])
def test_sharded_csvm_against_the_reference(kernel, n_classes, alpha_tol, dtype):
    """Four shards on one CPU against the reference's four CPU devices:
    fit, then the SV-sharded predict.  float64 at epsilon 1e-10 (equal
    iterations, rho within 1e-9, the alphas within ``alpha_tol``, decision
    values within 1e-8, the same labels); float32 at
    ``gram_precision="highest"`` and epsilon ``F32_HIGHEST_EPSILON``: the
    same labels on the held-out points, the iterations within one, rho
    within ``F32_HIGHEST_RHO``."""
    Xtr, ytr, Xte, yte = _blobs(7 if n_classes > 2 else 0, n_classes=n_classes)
    typed = {} if dtype == np.float64 else dict(dtype=dtype)
    j_train = plssvm_tpu.DataSet(Xtr, ytr, scaling=(-1.0, 1.0), **typed)
    t_train = plssvm_tpu_torch.DataSet(Xtr, ytr, scaling=(-1.0, 1.0), **typed)
    j_test = plssvm_tpu.DataSet(Xte, yte, scaling=j_train.scaling_factors, **typed)
    t_test = plssvm_tpu_torch.DataSet(Xte, yte, scaling=t_train.scaling_factors, **typed)
    tier = "f32" if dtype == np.float64 else "highest"
    j_svm = plssvm_tpu.CSVM(backend="xla", solver="cg_implicit", dtype=dtype,
                            gram_precision=tier, kernel_type=kernel,
                            devices=jax.devices("cpu")[:4])
    t_svm = plssvm_tpu_torch.CSVM(devices=["cpu"] * 4, dtype=dtype, gram_precision=tier,
                                  kernel_type=kernel, solver="cg_implicit")
    assert len(t_svm.devices) == 4
    epsilon = 1e-10 if dtype == np.float64 else F32_HIGHEST_EPSILON
    j_model, t_model = j_svm.fit(j_train, epsilon=epsilon), t_svm.fit(t_train, epsilon=epsilon)
    rho = np.abs(np.asarray(t_model.rho) - np.asarray(j_model.rho)).max()
    np.testing.assert_array_equal(t_svm.predict(t_model, t_test),
                                  j_svm.predict(j_model, j_test))
    if dtype == np.float32:
        assert abs(t_model.n_iter - j_model.n_iter) <= 1 and rho <= F32_HIGHEST_RHO
        return
    assert t_model.n_iter == j_model.n_iter
    assert rho <= 1e-9
    assert np.abs(t_model.alpha - j_model.alpha).max() <= alpha_tol
    np.testing.assert_allclose(t_svm.predict_values(t_model, t_test),
                               j_svm.predict_values(j_model, j_test), rtol=0, atol=1e-8)


@pytest.mark.parametrize("matmat", [False, True])
@pytest.mark.parametrize("P", [3, 4])
def test_ring_makes_the_shard_operands_once(monkeypatch, P, matmat):
    """The ring's product makes each shard's tensor-core operand copy once,
    when the solve builds it, and hands the same copies to every product:
    shard p's to its symmetric product, the pair (p's, q's) to each dual
    walk of p against q; the rows-only walk takes none.  The wrappers are
    stand-ins that record what they are handed."""
    made, sym_seen, dual_seen = [], [], []

    def tier_operand(X, precision):
        made.append((X.data_ptr(), X.shape[0], precision))
        return torch.full((1,), float(len(made)))

    def sym(X, sq, V, *, operand=None, precision, **kw):
        sym_seen.append(float(operand))
        return torch.zeros_like(V)

    def dual(Xr, Xc, sq_r, sq_c, V_c, V_r, *, operand=None, precision, **kw):
        dual_seen.append(tuple(float(t) for t in operand))
        return torch.zeros_like(V_r), torch.zeros_like(V_c)

    def rows(P_, S, sq_p, sq_s, A, *, precision, **kw):
        return torch.zeros((P_.shape[0],) + A.shape[1:])

    module = gram_matmat if matmat else gram_matvec
    op = "matmat" if matmat else "matvec"
    monkeypatch.setattr(sharded, "uses_tensor_cores", lambda X, precision: True)
    monkeypatch.setattr(sharded, "tier_operand", tier_operand)
    monkeypatch.setattr(module, f"gram_{op}_sym", sym)
    monkeypatch.setattr(module, f"gram_{op}_dual", dual)
    monkeypatch.setattr(module, f"gram_{op}_rect", rows)
    X = torch.zeros(23, 3)
    bounds = sharded.shard_bounds(23, P)
    product = sharded._sharded_product(X, bounds, ["cpu"] * P, TKind.RBF, 3, "cuda",
                                       "highest")
    assert [(ptr, rows_) for ptr, rows_, _ in made] == [
        (X[lo:hi].data_ptr(), hi - lo) for lo, hi in bounds]
    assert {tier for _, _, tier in made} == {"highest"}
    v = torch.zeros(23, 2) if matmat else torch.zeros(23)
    for _ in range(3):
        product(X, None, v, 0.5, 0.0)
    assert len(made) == P
    assert sym_seen == [float(p + 1) for p in range(P)] * 3
    steps = [(p, (p - s) % P) for s in range(1, (P - 1) // 2 + 1) for p in range(P)]
    assert dual_seen == [(float(p + 1), float(q + 1)) for p, q in steps] * 3


def test_ring_operands_only_where_a_tile_takes_them():
    """``shard_operands``: None for the plain versions (``impl="torch"``),
    the distance and linear kernels and shards that take no tensor-core
    tile (CPU or float64 tensors); else ``tier_operand`` of each shard."""
    shards = [torch.randn(5, 3), torch.randn(4, 3)]
    assert sharded.shard_operands(shards, TKind.RBF, "cuda", "highest") is None  # CPU
    assert sharded.shard_operands(shards, TKind.RBF, "torch", "highest") is None
    assert sharded.shard_operands(shards, TKind.LAPLACIAN, "cuda", "f32") is None
    assert sharded.shard_operands(shards, TKind.LINEAR, "cuda", "f32") is None


def test_sharded_csvm_goes_through_the_ring(monkeypatch):
    """A 4-shard fit and predict run the ring and the SV-sharded predict
    (dual walks called), agree with the single-device port, and report 4
    devices."""
    Xtr, ytr, Xte, yte = _blobs(5)
    train = plssvm_tpu_torch.DataSet(Xtr, ytr, scaling=(-1.0, 1.0))
    test = plssvm_tpu_torch.DataSet(Xte, yte, scaling=train.scaling_factors)
    calls = []
    predict = sharded.predict_values_sharded
    monkeypatch.setattr("plssvm_tpu_torch.csvm.predict_values_sharded",
                        lambda *a, **k: calls.append(k["devices"]) or predict(*a, **k))
    single = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64, kernel_type="rbf")
    four = plssvm_tpu_torch.CSVM(devices=["cpu"] * 4, dtype=np.float64, kernel_type="rbf")
    entries = plssvm_tpu_torch.global_tracker.entries()["backend"]
    assert ("num_devices", 4) in entries and ("device", "cpu, cpu, cpu, cpu") in entries
    before = matvec.dual_plain_calls
    a, b = single.fit(train, epsilon=1e-10), four.fit(train, epsilon=1e-10)
    assert matvec.dual_plain_calls - before == 4 * (1 + b.n_iter + b.n_iter // 50)
    assert a.n_iter == b.n_iter and abs(a.rho - b.rho) <= 1e-8
    np.testing.assert_array_equal(single.predict(a, test), four.predict(b, test))
    assert len(calls) == 1 and len(calls[0]) == 4


@pytest.mark.parametrize("devices,expect", [
    (None, None), (["cpu"], None), (["cpu", "cpu"], 2), (("cpu",) * 3, 3),
])
def test_devices_resolve(devices, expect):
    svm = plssvm_tpu_torch.CSVM(device="cpu" if devices is None else None, devices=devices)
    assert (None if svm.devices is None else len(svm.devices)) == expect
    assert svm.device == torch.device("cpu")


# -- (d) the refusals --------------------------------------------------------


@pytest.mark.parametrize("kwargs,error", [
    (dict(devices=["cpu", "cuda:0"]), InvalidParameterError),
    (dict(devices=["cpu"] * 2, backend="cuda"), InvalidParameterError),
    (dict(devices=["cpu"] * 2, device="cuda:0"), InvalidParameterError),
    (dict(devices=["cpu"] * 2, target="gpu"), InvalidParameterError),
    (dict(devices="every"), InvalidParameterError),
    (dict(devices=["meta", "meta"]), UnsupportedBackendError),
    (dict(devices=["cpu"] * 2, solver="explicit"), InvalidParameterError),
])
def test_device_lists_that_raise(kwargs, error):
    with pytest.raises(error):
        plssvm_tpu_torch.CSVM(**kwargs)


def test_devices_all_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for one without")
    with pytest.raises(UnsupportedBackendError, match="CUDA is not available"):
        plssvm_tpu_torch.CSVM(devices="all")


@pytest.mark.parametrize("what", ["oao", "regression", "initial_model", "sample_weight",
                                  "checkpoint_path", "multihost"])
def test_not_ported_with_devices(what, tmp_path):
    """Each combination the port once refused is ported now.  Item 4's
    extras: with ``devices`` they fit as plssvm_tpu's four-device fit does
    (tests/test_torch_solver_extras.py holds every layout and type).
    One-vs-one (item 6: the batched machines split over the devices) and
    LS-SVR (item 7: the ring's binary solve): with ``devices`` each fits as
    on one device: the same iterations, rho within 1e-8 (the ring sums in
    another order).  ``fit_multihost`` (item 10): a rank holds one shard on
    one device, so a CSVM with ``devices`` is refused, and at one process
    the fit of the file is the one-device fit of its data set, within the
    same rule (tests/test_torch_multiprocess.py runs the ranks)."""
    svm = plssvm_tpu_torch.CSVM(devices=["cpu"] * 2, dtype=np.float64)
    Xtr, ytr, _, _ = _blobs(6, n_classes=3)
    data = plssvm_tpu_torch.DataSet(Xtr, ytr)
    if what in ("initial_model", "sample_weight", "checkpoint_path"):
        _extras_with_devices(what, Xtr, ytr, tmp_path)
        return
    if what in ("oao", "regression"):
        one = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64)
        if what == "oao":
            models = [s.fit(plssvm_tpu_torch.DataSet(Xtr, ytr), classification="oao",
                            epsilon=1e-10) for s in (svm, one)]
        else:
            rbf = [plssvm_tpu_torch.CSVM(dtype=np.float64, kernel_type="rbf", **where)
                   for where in (dict(devices=["cpu"] * 2), dict(device="cpu"))]
            target = np.tanh(Xtr[:, 0] + Xtr[:, 2])
            models = [s.fit(plssvm_tpu_torch.DataSet(Xtr, target, regression=True),
                            epsilon=1e-10) for s in rbf]
        assert models[0].n_iter == models[1].n_iter
        np.testing.assert_allclose(np.asarray(models[0].rho), np.asarray(models[1].rho),
                                   rtol=0, atol=1e-8)
        return
    path = os.path.join(tmp_path, "train.libsvm")
    data.save(path)
    with pytest.raises(InvalidParameterError, match="one shard a process"):
        svm.fit_multihost(path)
    one = plssvm_tpu_torch.CSVM(device="cpu", dtype=np.float64)
    models = [one.fit_multihost(path, epsilon=1e-10),
              one.fit(plssvm_tpu_torch.DataSet(path), epsilon=1e-10)]
    assert models[0].n_iter == models[1].n_iter
    np.testing.assert_allclose(np.asarray(models[0].rho), np.asarray(models[1].rho),
                               rtol=0, atol=1e-8)


def _extras_with_devices(what, X, y, tmp_path):
    """An item 4 extra on two CPU shards against plssvm_tpu's fit on four
    CPU devices: one-vs-all, float64, epsilon 1e-10."""
    models = []
    for package, where in ((plssvm_tpu_torch, dict(devices=["cpu"] * 2)),
                           (plssvm_tpu, dict(backend="xla", solver="cg_implicit",
                                             devices=jax.devices("cpu")[:4]))):
        svm = package.CSVM(dtype=np.float64, kernel_type="rbf", **where)
        train = package.DataSet(X, y, scaling=(-1.0, 1.0))
        kw = {"initial_model": lambda: dict(initial_model=svm.fit(train, epsilon=1e-4)),
              "sample_weight": lambda: dict(sample_weight=np.linspace(0.5, 2.0, len(y))),
              "checkpoint_path": lambda: dict(
                  checkpoint_path=os.path.join(tmp_path, f"{package.__name__}.ckpt"),
                  checkpoint_interval=4)}[what]()
        models.append(svm.fit(train, epsilon=1e-10, **kw))
    got, want = models
    assert got.n_iter == want.n_iter
    np.testing.assert_allclose(got.rho, want.rho, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=0,
                               atol=1e-8 * np.max(np.abs(want.alpha)))
