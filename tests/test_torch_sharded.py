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
  (one-vs-all), the same labels and decision values within 1e-8.  The
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
    NotPortedError,
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


@pytest.mark.parametrize("n_classes", [None, 1, 3, 10])
@pytest.mark.parametrize("name", ["rbf", "polynomial", "sigmoid", "laplacian", "chi_squared"])
def test_dual_plain_f64_against_the_reference_block(name, n_classes):
    """In float64 on ragged shapes: both outputs against the reference's
    float64 kernel block contracted both ways (its ring's XLA cross_dual)."""
    from plssvm_tpu.kernel_functions import kernel_block

    jkind, _ = _kinds(name)
    Xr, Xc, sq_r, sq_c, v_c, v_r = _block(84, 77, 130, 9, n_classes, np.float64)
    K = np.asarray(kernel_block(jnp.asarray(Xr), jnp.asarray(Xc), jnp.asarray(sq_r),
                                jnp.asarray(sq_c), jkind, 1.0 / 9, COEF0[name], 3))
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


@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_dual_operand_is_an_exact_factor(tier):
    """The dual kernels' operand at "f32" / "bf16": TF32 / bf16 values in
    float32, so a product of two is exact in float32; "highest" and float64
    take X itself."""
    rng = np.random.default_rng(86)
    X = torch.from_numpy(rng.normal(size=(50, 7)).astype(np.float32))
    op = gram_matvec.dual_operand(X, tier)
    bits = 13 if tier == "f32" else 16
    assert op.dtype == torch.float32 and op.shape == X.shape
    assert not (op.view(torch.int32) & ((1 << bits) - 1)).any()
    prod = op[:, None, :] * op[None, :, :]
    assert torch.equal(prod.double(), op.double()[:, None, :] * op.double()[None, :, :])
    assert gram_matvec.dual_operand(X, "highest") is X
    assert gram_matvec.dual_operand(X.double(), tier).dtype == torch.float64


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


@pytest.mark.parametrize("kernel,n_classes,alpha_tol", [
    ("rbf", 2, 1e-9), ("laplacian", 2, 1e-9), ("rbf", 3, 1e-8),
])
def test_sharded_csvm_against_the_reference(kernel, n_classes, alpha_tol):
    """Four shards on one CPU against the reference's four CPU devices:
    fit, then the SV-sharded predict."""
    Xtr, ytr, Xte, yte = _blobs(7 if n_classes > 2 else 0, n_classes=n_classes)
    j_train = plssvm_tpu.DataSet(Xtr, ytr, scaling=(-1.0, 1.0))
    t_train = plssvm_tpu_torch.DataSet(Xtr, ytr, scaling=(-1.0, 1.0))
    j_test = plssvm_tpu.DataSet(Xte, yte, scaling=j_train.scaling_factors)
    t_test = plssvm_tpu_torch.DataSet(Xte, yte, scaling=t_train.scaling_factors)
    j_svm = plssvm_tpu.CSVM(backend="xla", solver="cg_implicit", dtype=np.float64,
                            kernel_type=kernel, devices=jax.devices("cpu")[:4])
    t_svm = plssvm_tpu_torch.CSVM(devices=["cpu"] * 4, dtype=np.float64,
                                  kernel_type=kernel)
    assert len(t_svm.devices) == 4
    j_model, t_model = j_svm.fit(j_train, epsilon=1e-10), t_svm.fit(t_train, epsilon=1e-10)
    assert t_model.n_iter == j_model.n_iter
    assert np.abs(np.asarray(t_model.rho) - np.asarray(j_model.rho)).max() <= 1e-9
    assert np.abs(t_model.alpha - j_model.alpha).max() <= alpha_tol
    np.testing.assert_allclose(t_svm.predict_values(t_model, t_test),
                               j_svm.predict_values(j_model, j_test), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(t_svm.predict(t_model, t_test),
                                  j_svm.predict(j_model, j_test))


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
    (dict(devices=["cpu"] * 2, solver="cg_explicit"), NotPortedError),
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
    """Each combination the port does not carry yet names its ROADMAP item."""
    svm = plssvm_tpu_torch.CSVM(devices=["cpu"] * 2, dtype=np.float64)
    Xtr, ytr, _, _ = _blobs(6, n_classes=3)
    data = plssvm_tpu_torch.DataSet(Xtr, ytr)
    item = {"oao": "item 6", "regression": "item 7", "multihost": "item 10"}.get(what, "item 4")
    with pytest.raises(NotPortedError, match=item):
        if what == "oao":
            svm.fit(data, classification="oao")
        elif what == "regression":
            svm.fit(plssvm_tpu_torch.DataSet(Xtr, Xtr[:, 0], regression=True))
        elif what == "multihost":
            path = os.path.join(tmp_path, "train.libsvm")
            data.save(path)
            svm.fit_multihost(path)
        else:
            value = {"initial_model": object(), "sample_weight": np.ones(200),
                     "checkpoint_path": os.path.join(tmp_path, "cg.ckpt")}[what]
            svm.fit(data, **{what: value})
