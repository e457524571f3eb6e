"""One-vs-one (OAO) training of the port against plssvm_tpu's, on the CPU.

The sequential pair machines (each a binary fit through ``CSVM.fit``) and
the batched pairs CG (``solver/cg.py::solve_ls_svm_pairs``, whose product
is kernel O on the card and ``ops/pairs.py::pairs_matvec_plain`` here),
with its machine axis split over ``devices=["cpu"] * k``, each held against
``plssvm_tpu.CSVM(backend="xla", dtype=np.float64, oao_batch=...)`` on the
same seeded sets: sv_coef, rho and the iterations per machine.  Tolerances:

- float64 at epsilon 1e-10: the same iterations per machine, rho and
  sv_coef within ``TOL`` = 1e-8 (the sets are ones where plssvm_tpu's own
  sequential and batched fits agree on every machine's count: from x = 1 a
  1e-15 change of the inputs can move a count by one, ROADMAP Queue 3 item
  4);
- the port's batched fit against its sequential one: 1e-8 as well (the
  same algorithm per machine, the reductions in another order);
- the machine-axis split against the one-device batched fit: bit for bit
  (each machine's arithmetic is the same, its CG scalars folds along its
  own rows in a fixed order), and ``SPLIT_TOL`` = 1e-12 in the older
  cases;
- float32 (compensated scalars) at epsilon 1e-5: a working model (every
  training label right on separable blobs), as plssvm_tpu's own test holds
  it.

The plain product is held against plssvm_tpu's vmapped XLA row-scan matvec
(the batched solve's ``kernel_bmv``) for all five kinds at 1e-12.
"""

import ctypes
import importlib.util
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plssvm_tpu
import plssvm_tpu_torch
from plssvm_tpu import oao as j_oao
from plssvm_tpu.cli import predict as j_predict_cli
from plssvm_tpu.cli import train as j_train_cli
from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu.solver.cg import _make_kernel_matvec as j_make_kernel_matvec
from plssvm_tpu_torch import oao as t_oao
from plssvm_tpu_torch.cli import predict as t_predict_cli
from plssvm_tpu_torch.cli import train as t_train_cli
from plssvm_tpu_torch.exceptions import InvalidParameterError, NumericCheckError
from plssvm_tpu_torch.kernel_functions import kernel_block
from plssvm_tpu_torch.ops import _build, pairs
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind
from test_multiclass import make_multiclass_blobs

EPS = 1e-10
TOL = 1e-8
SPLIT_TOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def quiet():
    plssvm_tpu_torch.set_verbosity("quiet")
    plssvm_tpu.set_verbosity("quiet")


def _svms(strategy, kernel="rbf", gamma=0.3, dtype=np.float64, **kw):
    """(plssvm_tpu CSVM, port CSVM) with the same parameters."""
    params = dict(kernel_type=kernel, oao_batch=strategy, **kw)
    if gamma is not None and kernel != "linear":
        params["gamma"] = gamma
    return (plssvm_tpu.CSVM(backend="xla", dtype=dtype, **params),
            plssvm_tpu_torch.CSVM(device="cpu", dtype=dtype, **params))


def _fit_both(X, y, strategy, kernel="rbf", gamma=0.3, svm_kw=None, **fit_kw):
    j_svm, t_svm = _svms(strategy, kernel, gamma, **(svm_kw or {}))
    want = j_svm.fit(plssvm_tpu.DataSet(X, y), classification="oao", epsilon=EPS, **fit_kw)
    got = t_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=EPS,
                    **fit_kw)
    return t_svm, got, want


def _assert_same_model(got, want, tol=TOL, iterations=True):
    assert got.classification == plssvm_tpu_torch.ClassificationType.OAO
    assert np.asarray(got.alpha).shape == np.asarray(want.alpha).shape
    np.testing.assert_allclose(np.asarray(got.rho), np.asarray(want.rho), rtol=0, atol=tol)
    np.testing.assert_allclose(np.asarray(got.alpha), np.asarray(want.alpha), rtol=0,
                               atol=tol)
    if iterations:
        assert got.n_iter_per_machine == want.n_iter_per_machine
        assert got.n_iter == want.n_iter


def _unbalanced(seed, sizes=(10, 40, 110), d=5):
    rng = np.random.default_rng(seed)
    X = np.vstack([rng.normal(loc=3.0 * c, size=(s, d)) for c, s in enumerate(sizes)])
    y = np.concatenate([np.full(s, c) for c, s in enumerate(sizes)])
    return X, y


class TestPairLayout:
    def test_scatter_pair_alphas_is_the_reference(self):
        rng = np.random.default_rng(0)
        idx = rng.integers(0, 4, 40)
        for i, j in t_oao.class_pairs(4):
            rows = np.flatnonzero((idx == i) | (idx == j))
            is_first = idx[rows] == i
            alpha = rng.normal(size=len(rows))
            got, want = np.zeros((40, 3)), np.zeros((40, 3))
            t_oao.scatter_pair_alphas(got, rows, is_first, alpha, i, j)
            j_oao.scatter_pair_alphas(want, rows, is_first, alpha, i, j)
            np.testing.assert_array_equal(got, want)

    def test_scatter_then_weight_matrix_round_trip(self):
        rng = np.random.default_rng(1)
        idx = np.repeat(np.arange(3), 5)
        sv_coef = np.zeros((15, 2))
        machines = {}
        for m, (i, j) in enumerate(t_oao.class_pairs(3)):
            rows = np.flatnonzero((idx == i) | (idx == j))
            machines[m] = (rows, rng.normal(size=len(rows)))
            t_oao.scatter_pair_alphas(sv_coef, rows, idx[rows] == i, machines[m][1], i, j)
        W = t_oao.weight_matrix(sv_coef, idx, 3)
        for m, (rows, alpha) in machines.items():
            np.testing.assert_array_equal(W[rows, m], alpha)


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_exp():
    """The first multithreaded ``torch.exp`` of a process can come out
    ~1e-4 off in the CPU build of torch these tests run on (a race in its
    first dispatch); one exp before the comparisons keeps that out of
    them."""
    torch.exp(torch.rand(300, 300)).sum()


# -- the batched product's plain version ------------------------------------

KINDS = [("polynomial", 1.0), ("rbf", 0.0), ("sigmoid", -0.5), ("laplacian", 0.0),
         ("chi_squared", 0.0)]


@pytest.mark.parametrize("name,coef0", KINDS)
@pytest.mark.parametrize("lens", [(7, 0, 13, 1), (20, 20)])
def test_pairs_matvec_plain_against_the_reference(name, coef0, lens):
    """``pairs_matvec_plain`` against plssvm_tpu's vmapped XLA row-scan
    matvec, on zero-padded machines with a zero right-hand side past each
    machine's rows (as the pairs CG gives it): 1e-12 of max|reference| on
    the real rows, exactly 0 past them."""
    rng = np.random.default_rng(len(lens))
    P, m_pad, d = len(lens), max(lens), 6
    mask = np.arange(m_pad)[None, :] < np.asarray(lens)[:, None]
    X = rng.random((P, m_pad, d)) if name == "chi_squared" else rng.normal(size=(P, m_pad, d))
    X = X * mask[..., None]
    V = rng.normal(size=(P, m_pad)) * mask
    sq = (X * X).sum(-1)
    kv = j_make_kernel_matvec(getattr(JKind, name.upper()), 3, "xla", 8)
    want = np.asarray(jax.vmap(kv, in_axes=(0, 0, 0, None, None))(
        jnp.asarray(X), jnp.asarray(sq), jnp.asarray(V), 0.2, coef0)) * mask
    before = pairs.plain_calls
    got = pairs.pairs_matvec_plain(
        torch.as_tensor(X), torch.as_tensor(sq), torch.as_tensor(V),
        torch.as_tensor(lens, dtype=torch.int64), kind=getattr(TKind, name.upper()),
        gamma=0.2, coef0=coef0, degree=3).numpy()
    assert pairs.plain_calls == before + 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    assert np.all(got[~mask] == 0.0)


def test_linear_pairs_matvec_against_the_reference():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3, 9, 4))
    X[1, 5:] = 0.0
    V = rng.normal(size=(3, 9))
    V[1, 5:] = 0.0
    kv = j_make_kernel_matvec(JKind.LINEAR, 3, "xla", 8)
    want = np.asarray(jax.vmap(kv, in_axes=(0, 0, 0, None, None))(
        jnp.asarray(X), jnp.asarray((X * X).sum(-1)), jnp.asarray(V), 0.0, 0.0))
    got = pairs.linear_pairs_matvec(torch.as_tensor(X), torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_pairs_matvec_takes_the_plain_version_only_on_the_cpu():
    """On CPU tensors the wrapper calls the plain version and launches
    nothing; the linear kernel is refused (its product is two bmm calls)."""
    X = torch.rand(2, 5, 3, dtype=torch.float64)
    V = torch.rand(2, 5, dtype=torch.float64)
    lens = torch.tensor([5, 3])
    pairs.reset_counts()
    out = pairs.pairs_matvec(X, None, V, lens, kind=TKind.LAPLACIAN, gamma=0.5,
                             coef0=0.0, degree=3)
    assert (pairs.launches, pairs.plain_calls) == (0, 1)
    assert out.shape == (2, 5) and bool((out[1, 3:] == 0).all())
    with pytest.raises(ValueError, match="linear"):
        pairs.pairs_matvec(X, None, V, lens, kind=TKind.LINEAR, gamma=0.5, coef0=0.0,
                           degree=3)


def test_pairs_entry_points_argtypes_match_the_source(monkeypatch):
    """What _build.load() declares for kernel O's entry points is their C
    signature, parameter by parameter: the FFMA walk's and its workspace
    size's (csrc/pairs.cu) and the tensor-core walks' (csrc/pairs_tc.cu)."""
    c_types = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "float": ctypes.c_float,
               "double": ctypes.c_double}
    csrc = os.path.join(REPO, "plssvm_tpu_torch", "csrc")
    source = "".join(open(os.path.join(csrc, name)).read()
                     for name in ("pairs.cu", "pairs_tc.cu"))

    class FakeLibrary:
        def __getattr__(self, attr):
            fn = types.SimpleNamespace()
            setattr(self, attr, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: (None, 0.0))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLibrary())
    lib = _build.load()
    names = [f"plssvm_pairs_matvec_{suffix}" for suffix in ("f32", "f64", "tf32", "bf16", "dmma")]
    extra = ["plssvm_pairs_blocks_per_sm", "plssvm_pairs_workspace_elements"]
    assert set(re.findall(r'extern "C" int(?:64_t)? (plssvm_pairs_\w+)\(', source)) == set(
        names + extra)
    for name in names + extra:
        ret, params = re.search(rf'extern "C" (int|int64_t) {name}\(([^)]*)\)',
                                source).groups()
        want = [ctypes.c_void_p if "*" in p else c_types[p.split()[-2]]
                for p in (" ".join(q.split()) for q in params.split(","))]
        assert getattr(lib, name).argtypes == want
        assert getattr(lib, name).restype == c_types[ret]
        # the FFMA walk takes its workspace after out, the tensor-core walks none
        names_in_order = [p.split()[-1].lstrip("*") for p in params.split(",")]
        if name.endswith(("_f32", "_f64")):
            assert names_in_order[4:6] == ["out", "workspace"]
        else:
            assert "workspace" not in names_in_order


def test_kernel_resources_names_kernel_o(monkeypatch, tmp_path):
    """ptxas's report of kernel O's instantiations reads as
    ``pairs_matvec f32 rbf`` / ``pairs_matvec f64 chi_squared``, and the FFMA
    walk's reduction as ``pairs_reduce f32 edge 128``."""
    library = tmp_path / "libplssvm_gram_test.so"
    (tmp_path / (library.name + ".ptxas.txt")).write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119pairs_matvec_kernelIfLi2EEEvPKT_S3_S3_PKlPS1_llS1_S1_' "
        "for 'sm_90a'\n"
        "ptxas info    : Used 96 registers, 16896 bytes smem, 0 bytes spill stores, "
        "0 bytes spill loads\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119pairs_matvec_kernelIdLi5EEEvPKT_S3_S3_PKlPS1_llS1_S1_' "
        "for 'sm_90a'\n"
        "ptxas info    : 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 16640 bytes smem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115pairs_tc_kernelINS_8Tf32TierELi2EEEv14CUtensorMap_stPKfS4_PKlPfliiff' "
        "for 'sm_90a'\n"
        "ptxas info    : Used 126 registers, 3120 bytes smem, 0 bytes spill stores, "
        "0 bytes spill loads\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115pairs_tc_kernelINS_8Bf16TierELi3EEEv14CUtensorMap_stPKfS4_PKlPfliiff' "
        "for 'sm_90a'\n"
        "ptxas info    : Used 120 registers, 3120 bytes smem, 0 bytes spill stores, "
        "0 bytes spill loads\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117pairs_dmma_kernelILi1EEEv14CUtensorMap_stPKdS4_PKlPdliiidd' "
        "for 'sm_90a'\n"
        "ptxas info    : Used 212 registers, 13360 bytes smem, 0 bytes spill stores, "
        "0 bytes spill loads\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119pairs_reduce_kernelIfLi128EEEvPKT_PKlPS1_ll' for 'sm_90a'\n"
        "ptxas info    : Used 18 registers, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119pairs_reduce_kernelIdLi64EEEvPKT_PKlPS1_ll' for 'sm_90a'\n"
        "ptxas info    : Used 20 registers, 0 bytes spill stores, 0 bytes spill loads\n")
    monkeypatch.setattr(_build, "library_path", lambda: library)
    res = _build.kernel_resources()
    assert res["pairs_matvec f32 rbf"] == {"registers": 96, "smem_bytes": 16896,
                                           "spill_bytes": 0}
    assert res["pairs_matvec f64 chi_squared"] == {"registers": 128, "smem_bytes": 16640,
                                                   "spill_bytes": 16}
    assert res["pairs_tc tf32 rbf"] == {"registers": 126, "smem_bytes": 3120, "spill_bytes": 0}
    assert res["pairs_tc bf16 sigmoid"] == {"registers": 120, "smem_bytes": 3120,
                                            "spill_bytes": 0}
    assert res["pairs_dmma f64 poly"] == {"registers": 212, "smem_bytes": 13360,
                                          "spill_bytes": 0}
    # the FFMA walk's reduction, one instantiation per type and tile edge
    assert res["pairs_reduce f32 edge 128"] == {"registers": 18, "smem_bytes": 0,
                                                "spill_bytes": 0}
    assert res["pairs_reduce f64 edge 64"] == {"registers": 20, "smem_bytes": 0,
                                               "spill_bytes": 0}
    assert len(res) == 7


# -- the FFMA walk's triangle schedule (csrc/pairs.cu) -------------------------

PAIRS_CU = os.path.join(REPO, "plssvm_tpu_torch", "csrc", "pairs.cu")


def test_pairs_cu_has_no_atomics():
    """The FFMA walk writes every slot and output once: no ``atomicAdd`` in
    pairs.cu, not even a ticket, and no other atomic in its code."""
    source = open(PAIRS_CU).read()
    assert "atomicAdd" not in source and "atomic" not in re.sub(r"//.*", "", source)


def _model_groups(length, edge, groups):
    """The walk's grouping of a machine of ``length`` rows (csrc/pairs.cu
    ``grouping``): (T tiles a side, S tiles a group, g groups a side)."""
    tiles = -(-length // edge)
    per_group = -(-tiles // groups)
    return tiles, per_group, -(-tiles // per_group) if per_group else 0


def _walk_model(X, sq, V, lens, kind, gamma, coef0, degree, edge, groups):
    """Kernel O's FFMA walk as csrc/pairs.cu schedules it, in torch on the
    CPU, at tile edge ``edge`` and ``groups`` groups a side at most: per
    machine the upper triangle of tile pairs of each group pair (I <= J),
    the row partials of tile a written once to slot (I, J), the column
    partials of tile b (b != a) written by the group pair's first tile row
    and added to by the later ones in slot (J, I), or (I, G) on the
    diagonal group (zero-initialised there by the first tile row's diagonal
    tile), then each row's g + 1 slots summed in group order and the
    diagonal column slot last.  The workspace starts as NaN, so a slot read
    before it was written shows."""
    P, m_pad, _ = X.shape
    G = groups
    width = _model_groups(m_pad, edge, G)[1] * edge
    ws = torch.full((P * G * (G + 1) * width,), float("nan"), dtype=X.dtype)

    def slot(p, i, j):
        return ((p * G + i) * (G + 1) + j) * width

    out = torch.zeros((P, m_pad), dtype=X.dtype)
    for p, m in enumerate(lens):
        T, S, g = _model_groups(m, edge, G)
        rows = torch.zeros((T * edge, X.shape[2]), dtype=X.dtype)
        rows[:m] = X[p, :m]
        norms = torch.zeros(T * edge, dtype=X.dtype)
        if sq is not None:
            norms[:m] = sq[p, :m]
        v = torch.zeros(T * edge, dtype=X.dtype)
        v[:m] = V[p, :m]
        real = torch.arange(T * edge) < m

        def tile(a, b):
            ra, rb = slice(a * edge, (a + 1) * edge), slice(b * edge, (b + 1) * edge)
            k = kernel_block(rows[ra], rows[rb], norms[ra], norms[rb], kind, gamma, coef0,
                             degree)
            return k * (real[ra][:, None] & real[rb][None, :])

        for i in range(g):
            for j in range(i, g):
                a_first, b_first = i * S, j * S
                col_base = slot(p, j, G if i == j else i)
                for a in range(a_first, min(a_first + S, T)):
                    row = torch.zeros(edge, dtype=X.dtype)
                    for b in range(a if i == j else b_first, min(b_first + S, T)):
                        k = tile(a, b)
                        row += k @ v[b * edge:(b + 1) * edge]
                        at = slice(col_base + (b - b_first) * edge,
                                   col_base + (b - b_first + 1) * edge)
                        if b != a:
                            col = k.T @ v[a * edge:(a + 1) * edge]
                            ws[at] = col if a == a_first else ws[at] + col
                        elif a == a_first:
                            ws[at] = 0.0
                    base = slot(p, i, j) + (a - a_first) * edge
                    ws[base:base + edge] = row
        # each row's slots in group order, the diagonal column slot last
        for i in range(g):
            local = torch.arange(min(S * edge, m - i * S * edge))
            total = torch.zeros(len(local), dtype=X.dtype)
            for j in range(g):
                total += ws[slot(p, i, j) + local]
            out[p, i * S * edge + local] = total + ws[slot(p, i, G) + local]
    return out


def _model_case(name, lens, d=5, seed=11):
    rng = np.random.default_rng(seed)
    P, m_pad = len(lens), max(lens)
    mask = np.arange(m_pad)[None, :] < np.asarray(lens)[:, None]
    X = rng.random((P, m_pad, d)) if name == "chi_squared" else rng.normal(size=(P, m_pad, d))
    X = torch.as_tensor(X * 0.5 * mask[..., None])
    V = torch.as_tensor(rng.normal(size=(P, m_pad)) * mask)
    kind = getattr(TKind, name.upper())
    sq = None if kind in (TKind.LAPLACIAN, TKind.CHI_SQUARED) else (X * X).sum(-1)
    return X, sq, V, kind, torch.as_tensor(mask)


@pytest.mark.parametrize("name,coef0", KINDS)
@pytest.mark.parametrize("groups,edge,lens", [
    (3, 4, (40, 0, 1, 13, 5, 12)),  # S up to 4, a short last group
    (16, 64, (1100, 2, 0, 1025)),   # the real group count: S = 2 at 1025 and 1100 rows
    (16, 128, (2200, 1, 1100)),     # the card tests' stack: 18 tiles, S = 2, g = 9
])
def test_pairs_walk_schedule_model(name, coef0, groups, edge, lens):
    """The triangle schedule with its slots and reduction (``_walk_model``)
    against ``pairs_matvec_plain`` at 1e-12 in float64, every kind, at a
    small group count and edge (several tiles a group, uneven last groups,
    empty and one-row machines) and at the walk's own (G = 16, edges 64 and
    128): every slot read was written, and rows past each machine stay 0."""
    X, sq, V, kind, mask = _model_case(name, lens)
    lens_t = torch.as_tensor(lens, dtype=torch.int64)
    got = _walk_model(X, sq, V, lens, kind, 0.2, coef0, 3, edge, groups)
    want = pairs.pairs_matvec_plain(X, sq, V, lens_t, kind=kind, gamma=0.2, coef0=coef0,
                                    degree=3, precision="highest")
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert bool((got[~mask] == 0).all())


@pytest.mark.parametrize("name,coef0", KINDS)
def test_pairs_walk_model_machine_alone_equals_inside_the_stack(name, coef0):
    """The schedule groups a machine's tiles by its own length alone: each
    machine of the stack gives bit for bit the same rows alone (its own
    length for m_pad, so narrower slots) as inside the stack, whose
    longest machine sets the slot width."""
    lens = (13, 40, 1, 29)
    X, sq, V, kind, _ = _model_case(name, lens)
    inside = _walk_model(X, sq, V, lens, kind, 0.2, coef0, 3, 4, 3)
    for p, m in enumerate(lens):
        alone = _walk_model(X[p:p + 1, :m], None if sq is None else sq[p:p + 1, :m],
                            V[p:p + 1, :m], (m,), kind, 0.2, coef0, 3, 4, 3)
        assert torch.equal(alone[0], inside[p, :m])


#: kernel O's walk by (type, kind, tier) on a card's tensors: the Gram kinds
#: on the tensor cores at "f32" / "bf16" (float32) and at every tier
#: (float64), "highest" float32 and the distance kinds on the FFMA walk
WALKS = [(dtype, kind, precision,
          "ffma" if kind in ("laplacian", "chi_squared")
          else "dmma" if dtype == torch.float64
          else "ffma" if precision == "highest" else "tc")
         for dtype in (torch.float32, torch.float64) for kind, _ in KINDS
         for precision in ("f32", "bf16", "highest")]


@pytest.mark.parametrize("dtype,kind,precision,want", WALKS)
def test_pairs_walk_by_kind_tier_and_type(dtype, kind, precision, want):
    """``pairs.walk`` on tensors off the CPU (the meta device stands in for
    the card: no data, the same routing) and the operand copy it reads:
    (P m_pad, d_pad) rows, TF32-rounded float32 padded to d % 4, bf16
    padded to d % 8, float64 padded to d % 2; none for the FFMA walk.  On
    CPU tensors every kind and tier takes the plain version."""
    tkind = getattr(TKind, kind.upper())
    Xb = torch.empty((3, 5, 7), dtype=dtype, device="meta")
    assert pairs.walk(Xb, tkind, precision) == want
    assert pairs.walk(torch.zeros((3, 5, 7), dtype=dtype), tkind, precision) == "plain"
    op = pairs.pairs_operand(Xb, tkind, precision)
    if want == "ffma":
        assert op is None
    else:
        # d = 7 pads to 8 in every walk: TF32 to d % 4, bf16 to d % 8, float64 to d % 2
        op_dtype = (torch.float64 if want == "dmma" else torch.bfloat16 if precision == "bf16"
                    else torch.float32)
        assert (tuple(op.shape), op.dtype) == ((15, 8), op_dtype)
    with pytest.raises(ValueError, match="precision"):
        pairs.walk(Xb, tkind, "tf32")


@pytest.mark.parametrize("kind", ["polynomial", "rbf", "sigmoid"])
def test_pairs_matvec_plain_takes_the_tier(kind):
    """The plain version takes the tier as ``kernel_matvec_plain`` does:
    "bf16" computes on the bf16-rounded float32 rows with the float32 rows'
    norms, "f32" and "highest" in full float32; float64 at every tier in
    float64.  The wrapper on CPU tensors takes full precision whatever the
    tier."""
    rng = np.random.default_rng(9)
    lens = torch.tensor([6, 2, 9])
    X = torch.as_tensor(rng.normal(size=(3, 9, 5)) * 0.5 * (np.arange(9)[None, :, None]
                                                            < lens.numpy()[:, None, None]))
    V = torch.as_tensor(rng.normal(size=(3, 9)) * (np.arange(9)[None, :] < lens.numpy()[:, None]))
    kw = dict(kind=getattr(TKind, kind.upper()), gamma=0.3, coef0=0.5, degree=2)
    for dtype in (torch.float32, torch.float64):
        Xt, Vt = X.to(dtype), V.to(dtype)
        sq = (Xt * Xt).sum(-1)
        full = pairs.pairs_matvec_plain(Xt, sq, Vt, lens, precision="highest", **kw)
        assert torch.equal(pairs.pairs_matvec_plain(Xt, sq, Vt, lens, precision="f32", **kw),
                           full)
        bf16 = pairs.pairs_matvec_plain(Xt, sq, Vt, lens, precision="bf16", **kw)
        if dtype == torch.float64:
            assert torch.equal(bf16, full)
        else:
            rounded = Xt.to(torch.bfloat16).to(torch.float32)
            assert torch.equal(bf16, pairs.pairs_matvec_plain(rounded, sq, Vt, lens,
                                                              precision="f32", **kw))
            assert not torch.equal(bf16, full)
        for precision in ("f32", "bf16", "highest"):
            assert torch.equal(pairs.pairs_matvec(Xt, sq, Vt, lens, precision=precision, **kw),
                               full)


def _record_pairs_precision(monkeypatch):
    """Wrap the solver's ``pairs_matvec`` so that each call's tier and
    operand are recorded, and the call goes on."""
    from plssvm_tpu_torch.solver import cg as t_cg

    seen = []
    real = t_cg.pairs_matvec

    def recording(*args, precision, operand, **kw):
        seen.append((precision, operand))
        return real(*args, precision=precision, operand=operand, **kw)

    monkeypatch.setattr(t_cg, "pairs_matvec", recording)
    return seen


@pytest.mark.parametrize("precision", ["f32", "bf16", "highest"])
@pytest.mark.parametrize("devices", [None, ["cpu"] * 3])
def test_batched_fit_passes_the_tier_to_kernel_o(monkeypatch, precision, devices):
    """A batched fit with the CUDA backend hands kernel O its
    ``gram_precision`` on every product, on one device and in every group
    of the machine split (here on CPU tensors, where the wrapper then takes
    the plain version at full precision)."""
    seen = _record_pairs_precision(monkeypatch)
    X, y = make_multiclass_blobs(90, 4, 4, seed=3)
    where = dict(device="cpu") if devices is None else dict(devices=devices)
    svm = plssvm_tpu_torch.CSVM(backend="torch", dtype=np.float64, kernel_type="rbf",
                                gamma=0.3, oao_batch="batched", gram_precision=precision,
                                **where)
    monkeypatch.setattr(svm, "_impl", lambda: "cuda")
    model = svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=1e-8)
    groups = 1 if devices is None else len(devices)
    # each group's solve: its initial residual and one product an iteration
    assert len(seen) >= groups + max(model.n_iter_per_machine)
    assert {p for p, _ in seen} == {precision}
    # on CPU tensors no walk takes an operand copy
    assert all(op is None for _, op in seen)


def test_cpu_batched_fit_ignores_the_tier():
    """On the CPU the batched fit's product is the plain version at full
    precision at every tier, for both backends: the models are bit for bit
    the same."""
    X, y = make_multiclass_blobs(90, 4, 4, seed=3)
    models = {}
    for backend in ("cuda", "torch"):
        for precision in ("f32", "bf16", "highest"):
            svm = plssvm_tpu_torch.CSVM(backend=backend, device="cpu", dtype=np.float32,
                                        kernel_type="rbf", gamma=0.3, oao_batch="batched",
                                        gram_precision=precision)
            models[backend, precision] = svm.fit(plssvm_tpu_torch.DataSet(X, y),
                                                 classification="oao", epsilon=1e-5)
    first = models["cuda", "f32"]
    for model in models.values():
        np.testing.assert_array_equal(np.asarray(model.alpha), np.asarray(first.alpha))
        np.testing.assert_array_equal(np.asarray(model.rho), np.asarray(first.rho))


# -- the fits ---------------------------------------------------------------

#: per kernel, a seed of ``test_every_kernel``'s blobs where plssvm_tpu's
#: sequential and batched fits agree on every machine's iterations (12 for
#: the others)
KERNEL_SEED = {"linear": 1, "sigmoid": 2}


class TestOAOFit:
    """plssvm_tpu's TestOAOFit, each fit held against plssvm_tpu's."""

    def _fit(self, C=4, n=100, d=6, kernel="rbf", strategy="sequential", seed=5):
        X, y = make_multiclass_blobs(n, d, n_classes=C, seed=seed)
        t_svm, got, want = _fit_both(X, y, strategy, kernel,
                                     0.3 if kernel != "linear" else None)
        return t_svm, got, want, X, y

    @pytest.mark.parametrize("strategy", ["sequential", "batched"])
    def test_shapes_and_the_reference_model(self, strategy):
        t_svm, got, want, X, y = self._fit(strategy=strategy)
        assert np.asarray(got.alpha).shape == (100, 3)
        assert np.asarray(got.rho).shape == (6,)
        assert got.n_iter > 0
        _assert_same_model(got, want)
        assert t_svm.score(got) == 1.0

    def test_decision_values_match_per_pair_golden(self):
        t_svm, model, _, X, y = self._fit(C=3, n=45, d=4, seed=1)
        idx = model.data.mapper.map_labels(np.asarray(model.data.labels), dtype=np.int64)
        pts = X[:9]
        vals = t_svm.predict_values(model, plssvm_tpu_torch.DataSet(pts))
        assert vals.shape == (9, 3)
        K = np.exp(-0.3 * ((pts[:, None, :] - np.asarray(model.data.data)[None]) ** 2).sum(-1))
        svc, rho = np.asarray(model.alpha), np.asarray(model.rho)
        for m, (i, j) in enumerate(t_oao.class_pairs(3)):
            coef = np.zeros(len(idx))
            coef[idx == i] = svc[idx == i, t_oao.coef_column(i, j)]
            coef[idx == j] = svc[idx == j, t_oao.coef_column(j, i)]
            np.testing.assert_allclose(vals[:, m], K @ coef - rho[m], rtol=1e-8, atol=1e-10)

    @pytest.mark.parametrize("strategy", ["sequential", "batched"])
    def test_pair_machine_equals_standalone_binary_fit(self, strategy):
        """Machine (i, j) is the binary LS-SVM on classes i and j: the same
        solve for the sequential loop, TOL for the batched one."""
        X, y = make_multiclass_blobs(45, 4, n_classes=3, seed=1)
        _, t_svm = _svms(strategy)
        model = t_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=EPS)
        idx = model.data.mapper.map_labels(np.asarray(model.data.labels), dtype=np.int64)
        i, j = 0, 2
        m = t_oao.class_pairs(3).index((i, j))
        rows = np.flatnonzero((idx == i) | (idx == j))
        binary = t_svm.fit(plssvm_tpu_torch.DataSet(
            np.asarray(model.data.data)[rows], np.where(idx[rows] == i, 1.0, -1.0)),
            epsilon=EPS)
        tol = 1e-12 if strategy == "sequential" else TOL
        assert abs(float(binary.rho) - np.asarray(model.rho)[m]) <= tol
        svc = np.asarray(model.alpha)
        got = np.where(idx[rows] == i, svc[rows, t_oao.coef_column(i, j)],
                       svc[rows, t_oao.coef_column(j, i)])
        np.testing.assert_allclose(got, np.asarray(binary.alpha), rtol=0, atol=tol)
        assert model.n_iter_per_machine[m] == binary.n_iter

    @pytest.mark.parametrize("strategy", ["sequential", "batched"])
    def test_float32_oao(self, strategy):
        """float32 with compensated scalars: every training label right, as
        plssvm_tpu's float32 fit."""
        X, y = make_multiclass_blobs(45, 4, n_classes=3, seed=13)
        j_svm, t_svm = _svms(strategy, dtype=np.float32)
        assert t_svm.scalar_precision == "compensated"
        model = t_svm.fit(plssvm_tpu_torch.DataSet(X.astype(np.float32), y),
                          classification="oao", epsilon=1e-5)
        want = j_svm.fit(plssvm_tpu.DataSet(X.astype(np.float32), y), classification="oao",
                         epsilon=1e-5)
        assert np.asarray(model.alpha).dtype == np.float32
        assert t_svm.score(model) == 1.0
        np.testing.assert_allclose(np.asarray(model.rho), np.asarray(want.rho), rtol=0,
                                   atol=1e-3)

    @pytest.mark.parametrize("kernel", ["laplacian", "chi_squared", "linear", "polynomial",
                                        "sigmoid"])
    @pytest.mark.parametrize("strategy", ["sequential", "batched"])
    def test_every_kernel(self, kernel, strategy):
        X, y = make_multiclass_blobs(45, 4, n_classes=3, seed=KERNEL_SEED.get(kernel, 12))
        X = np.abs(X) if kernel == "chi_squared" else X / 4.0
        gamma = {"linear": None, "polynomial": 0.3, "sigmoid": 0.05}.get(kernel, 0.2)
        t_svm, got, want = _fit_both(X, y, strategy, kernel, gamma)
        _assert_same_model(got, want)
        assert t_svm.score(got) == 1.0

    def test_binary_data_ignores_classification(self):
        X, y = make_multiclass_blobs(40, 4, n_classes=2, seed=2)
        _, t_svm = _svms("auto")
        m_oao = t_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=EPS)
        m_def = t_svm.fit(plssvm_tpu_torch.DataSet(X, y), epsilon=EPS)
        assert np.asarray(m_oao.alpha).ndim == 1
        np.testing.assert_array_equal(np.asarray(m_oao.alpha), np.asarray(m_def.alpha))

    def test_model_file_round_trip(self, tmp_path):
        """The port's OAO model file equals plssvm_tpu's line for line
        (header, rho and sv_coef to the writer's digits) and predicts the
        same labels when loaded."""
        t_svm, got, want, X, y = self._fit(C=3, n=45, d=4, seed=1)
        t_path, j_path = str(tmp_path / "t.model"), str(tmp_path / "j.model")
        got.save(t_path)
        want.save(j_path)
        t_lines = [ln for ln in open(t_path) if not ln.startswith("#")]
        j_lines = [ln for ln in open(j_path) if not ln.startswith("#")]
        assert t_lines[:6] == j_lines[:6]  # svm_type .. nr_class, total_sv
        loaded = plssvm_tpu_torch.Model.load(t_path)
        assert loaded.classification == plssvm_tpu_torch.ClassificationType.OAO
        np.testing.assert_array_equal(t_svm.predict(loaded, plssvm_tpu_torch.DataSet(X)), y)


class TestOAOBatched:
    """plssvm_tpu's TestOAOBatched: the batched pairs CG against the
    sequential machines, both packages."""

    def _parity(self, X, y, kernel="rbf", gamma=0.3, **fit_kw):
        """The port's batched fit against plssvm_tpu's batched one and
        against the port's sequential one."""
        t_svm, bat, want = _fit_both(X, y, "batched", kernel, gamma, **fit_kw)
        _assert_same_model(bat, want)
        _, seq, _ = _fit_both(X, y, "sequential", kernel, gamma, **fit_kw)
        _assert_same_model(bat, seq)
        return bat

    def test_parity_rbf(self):
        self._parity(*make_multiclass_blobs(100, 6, n_classes=4, seed=5))

    def test_parity_linear(self):
        self._parity(*make_multiclass_blobs(80, 5, n_classes=3, seed=22), kernel="linear",
                     gamma=None)

    def test_parity_distance_kernel(self):
        X, y = make_multiclass_blobs(60, 4, n_classes=3, seed=23)
        self._parity(np.abs(X), y, kernel="laplacian", gamma=0.2)

    def test_parity_unbalanced_classes(self):
        """Machines of 10 + 40, 10 + 110 and 40 + 110 rows: the padded block
        perturbs no small machine, and each stops at its own count."""
        model = self._parity(*_unbalanced(seed=18))
        assert len(set(model.n_iter_per_machine)) > 1

    def test_parity_weighted(self):
        X, y = make_multiclass_blobs(75, 5, n_classes=3, seed=25)
        sw = np.random.default_rng(25).uniform(0.5, 2.0, size=len(y))
        self._parity(X, y, sample_weight=sw)

    def test_per_machine_iteration_caps(self):
        X, y = make_multiclass_blobs(90, 6, n_classes=3, seed=26)
        model = self._parity(X, y, max_iter=3)
        assert model.n_iter_per_machine == [3, 3, 3]

    def test_jacobi_preconditioner(self):
        X, y = make_multiclass_blobs(60, 4, n_classes=3, seed=2)
        t_svm, got, want = _fit_both(X, y, "batched", svm_kw=dict(preconditioner="jacobi"))
        _assert_same_model(got, want)
        _, plain, _ = _fit_both(X, y, "batched")
        np.testing.assert_allclose(np.asarray(got.rho), np.asarray(plain.rho), rtol=0,
                                   atol=1e-6)

    def test_auto_picks_batched_and_tracks(self):
        X, y = make_multiclass_blobs(60, 4, n_classes=3, seed=27)
        _, t_svm = _svms("auto")
        assert t_svm.oao_batch == "auto"
        plssvm_tpu_torch.global_tracker.clear()
        t_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=1e-8)
        cg = dict(plssvm_tpu_torch.global_tracker.entries()["cg"])
        assert cg["oao_strategy"] == "batched"
        assert cg["classification"] == "oao"
        assert len(cg["iterations_per_machine"]) == 3

    @pytest.mark.parametrize("budget,batched", [("0", False), ("0.5", True)])
    def test_auto_respects_budget_env(self, monkeypatch, budget, batched):
        monkeypatch.setenv("PLSSVM_TPU_TORCH_OAO_BATCH_BUDGET_GB", budget)
        X, y = make_multiclass_blobs(60, 4, n_classes=3, seed=28)
        _, t_svm = _svms("auto")
        plssvm_tpu_torch.global_tracker.clear()
        t_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=1e-8)
        cg = dict(plssvm_tpu_torch.global_tracker.entries()["cg"])
        assert (cg["oao_strategy"] == "batched") == batched

    def test_auto_selects_as_the_reference_does(self):
        """The stack's bytes against the 2 GiB budget, per device: a stack
        of 2.01 GiB goes sequential, as plssvm_tpu's rule sends it."""
        _, t_svm = _svms("auto")
        pairs_ = t_oao.class_pairs(3)
        rows = [np.arange(1 + (1 << 20))] * 3
        X = np.zeros((4, 180))
        assert t_svm._use_oao_batched(pairs_, rows, X, None) == (3 * (1 << 20) * 180 * 8
                                                                 <= 2 << 30)
        assert not t_svm._use_oao_batched(pairs_, [np.arange(3)] * 3, X, "ck")
        assert not t_svm._use_oao_batched(pairs_[:1], [np.arange(3)], X, None)

    def test_forced_batched_rejects_checkpointing(self, tmp_path):
        X, y = make_multiclass_blobs(45, 4, n_classes=3, seed=29)
        _, t_svm = _svms("batched")
        with pytest.raises(InvalidParameterError, match="checkpoint"):
            t_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao",
                      checkpoint_path=str(tmp_path / "ck"))

    def test_invalid_strategy_rejected(self):
        with pytest.raises(InvalidParameterError, match="oao_batch"):
            plssvm_tpu_torch.CSVM(device="cpu", oao_batch="nope")

    def test_batched_f32_compensated(self):
        X, y = make_multiclass_blobs(60, 4, n_classes=3, seed=30)
        _, t_svm = _svms("batched", dtype=np.float32)
        assert t_svm.scalar_precision == "compensated"
        model = t_svm.fit(plssvm_tpu_torch.DataSet(X.astype(np.float32), y),
                          classification="oao", epsilon=1e-5)
        assert t_svm.score(model) == 1.0

    @pytest.mark.parametrize("strategy", ["sequential", "batched"])
    def test_warm_start_from_the_reference_model_takes_no_iteration(self, strategy):
        """The reference's converged OAO model, carried across with
        ``model_from_numpy``, warm-starts every machine of the port's fit at
        its solution: zero iterations, the same model."""
        X, y = make_multiclass_blobs(60, 4, n_classes=3, seed=31)
        j_svm, t_svm = _svms(strategy)
        j_model = j_svm.fit(plssvm_tpu.DataSet(X, y), classification="oao", epsilon=EPS)
        carried = plssvm_tpu_torch.model_from_numpy(
            j_model.params, j_model.support_vectors, j_model.alpha, j_model.rho,
            j_model.data.labels, classification=j_model.classification)
        got = t_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=EPS,
                        initial_model=carried)
        assert got.n_iter == 0 and got.n_iter_per_machine == [0, 0, 0]
        _assert_same_model(got, j_model, iterations=False)

    def test_warm_start_from_a_loaded_file_with_unsorted_labels(self, tmp_path):
        """A warm start from the port's own model file (support vectors
        class-grouped, labels re-aligned) takes no iteration either."""
        X, y = make_multiclass_blobs(60, 4, n_classes=3, seed=31, labels=[7, 2, 5])
        _, t_svm = _svms("batched")
        data = plssvm_tpu_torch.DataSet(X, y)
        model = t_svm.fit(data, classification="oao", epsilon=EPS)
        model.save(str(tmp_path / "m.model"))
        loaded = plssvm_tpu_torch.Model.load(str(tmp_path / "m.model"))
        warm = t_svm.fit(data, classification="oao", epsilon=EPS, initial_model=loaded)
        assert warm.n_iter == 0

    def test_warm_start_refuses_a_one_vs_all_model(self):
        X, y = make_multiclass_blobs(45, 4, n_classes=3, seed=31)
        _, t_svm = _svms("batched")
        data = plssvm_tpu_torch.DataSet(X, y)
        oaa = t_svm.fit(data, epsilon=1e-4)
        with pytest.raises(InvalidParameterError, match="one-vs-one model of 3 classes"):
            t_svm.fit(data, classification="oao", initial_model=oaa)

    @pytest.mark.parametrize("strategy", ["sequential", "batched"])
    def test_debug_guard(self, strategy):
        """``debug=True`` raises on a non-finite input with plssvm_tpu's
        message; a clean fit is unchanged."""
        X, y = make_multiclass_blobs(45, 4, n_classes=3, seed=33)
        _, t_svm = _svms(strategy, debug=True)
        clean = t_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=EPS)
        _, plain_svm = _svms(strategy)
        same = plain_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao",
                             epsilon=EPS)
        np.testing.assert_array_equal(np.asarray(clean.alpha), np.asarray(same.alpha))
        X[3, 1] = np.nan
        match = ("initial pair-CG residuals contain non-finite" if strategy == "batched"
                 else "non-finite")
        with pytest.raises(NumericCheckError, match=match):
            t_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=EPS)

    def test_sequential_checkpoints_per_machine(self, tmp_path):
        """The sequential strategy checkpoints each machine to
        ``{path}.pair{i}-{j}``, removes the files when done, and equals the
        fit without checkpoints."""
        X, y = make_multiclass_blobs(60, 4, n_classes=3, seed=34)
        _, t_svm = _svms("auto")
        path = str(tmp_path / "ck")
        plssvm_tpu_torch.global_tracker.clear()
        got = t_svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=EPS,
                        checkpoint_path=path, checkpoint_interval=3)
        assert dict(plssvm_tpu_torch.global_tracker.entries()["cg"])["oao_strategy"] == \
            "sequential"
        assert not [f for f in os.listdir(tmp_path) if f.startswith("ck")]
        want = _svms("sequential")[1].fit(plssvm_tpu_torch.DataSet(X, y),
                                          classification="oao", epsilon=EPS)
        _assert_same_model(got, want, tol=1e-12)


class TestOAOMeshBatched:
    """plssvm_tpu's TestOAOMeshBatched with ``devices=["cpu"] * k``: the
    batched solve's machine axis split over k entries, 28 machines (8
    classes), not a multiple of k = 3, so the groups differ in size."""

    def _data(self, C=8, n=320, d=10, seed=5):
        rng = np.random.default_rng(seed)
        centers = rng.normal(scale=3.0, size=(C, d))
        y = rng.integers(0, C, size=n)
        y[:C] = np.arange(C)
        return rng.normal(size=(n, d)) + centers[y], y

    def _fit(self, strategy, devices=None, **fit_kw):
        X, y = self._data()
        where = dict(device="cpu") if devices is None else dict(devices=devices)
        svm = plssvm_tpu_torch.CSVM(dtype=np.float64, kernel_type="rbf", gamma=0.2, cost=2.0,
                                    oao_batch=strategy, **where)
        return svm, svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao",
                            epsilon=1e-8, **fit_kw)

    @pytest.mark.parametrize("k", [2, 3, 4])
    def test_split_matches_single_device_batched(self, k):
        plssvm_tpu_torch.global_tracker.clear()
        _, split = self._fit("batched", ["cpu"] * k)
        assert dict(plssvm_tpu_torch.global_tracker.entries()["cg"])["oao_strategy"] == \
            "batched"
        _, one = self._fit("batched")
        _assert_same_model(split, one, tol=SPLIT_TOL)

    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    @pytest.mark.parametrize("k", [2, 3, 4])
    def test_split_is_the_single_device_fit_bit_for_bit(self, k, dtype):
        """Each machine's CG scalars sum its own rows in an order that does
        not depend on how many machines share its group
        (``solver/cg.py::machine_sums`` over the group padded to the
        stack's shape in float64, the compensated fold in float32), so the
        split fit is the one-device fit's bits, iterations per machine
        included."""
        X, y = self._data()
        fits = []
        for where in (dict(device="cpu"), dict(devices=["cpu"] * k)):
            svm = plssvm_tpu_torch.CSVM(dtype=dtype, kernel_type="rbf", gamma=0.2, cost=2.0,
                                        oao_batch="batched", **where)
            fits.append(svm.fit(plssvm_tpu_torch.DataSet(X, y, dtype=dtype),
                                classification="oao",
                                epsilon=1e-8 if dtype == np.float64 else 1e-5))
        one, split = fits
        assert split.n_iter_per_machine == one.n_iter_per_machine
        np.testing.assert_array_equal(np.asarray(split.alpha), np.asarray(one.alpha))
        np.testing.assert_array_equal(np.asarray(split.rho), np.asarray(one.rho))

    @pytest.mark.parametrize("m,P", [(1, 1), (2, 3), (7, 45), (1600, 12), (1601, 45)])
    def test_machine_sums_of_a_group_are_the_stacks(self, m, P):
        """The plain scalars' row sums: a group of machines padded to its
        stack's shape sums each machine to the bits it has in the whole
        stack, within a few ulps of math.fsum."""
        import math

        from plssvm_tpu_torch.parallel.sharded import machine_groups
        from plssvm_tpu_torch.solver.cg import machine_sums

        block = torch.as_tensor(np.random.default_rng(m + P).normal(size=(P, m)))
        sums = machine_sums(block)
        assert sums.shape == (P,)
        for lo, hi in machine_groups(P, 4):
            assert torch.equal(machine_sums(block[lo:hi], (P, lo)), sums[lo:hi])
        for p in (0, P // 2, P - 1):
            exact = math.fsum(block[p].tolist())
            assert abs(float(sums[p]) - exact) <= 1e-13 * float(block[p].abs().sum())

    def test_split_matches_the_reference(self):
        X, y = self._data()
        want = plssvm_tpu.CSVM(backend="xla", dtype=np.float64, kernel_type="rbf", gamma=0.2,
                               cost=2.0, oao_batch="batched").fit(
            plssvm_tpu.DataSet(X, y), classification="oao", epsilon=1e-8)
        _, got = self._fit("batched", ["cpu"] * 3)
        _assert_same_model(got, want, tol=1e-6, iterations=False)

    def test_sequential_on_the_ring_matches_batched(self):
        """The sequential strategy with ``devices`` fits each machine on the
        ring: CG tolerance of the batched split (epsilon 1e-8)."""
        _, seq = self._fit("sequential", ["cpu"] * 2)
        _, bat = self._fit("batched", ["cpu"] * 2)
        np.testing.assert_allclose(np.asarray(bat.rho), np.asarray(seq.rho), rtol=2e-4,
                                   atol=1e-6)

    def test_split_weighted_and_warm(self):
        X, y = self._data()
        sw = np.random.default_rng(0).uniform(0.5, 2.0, size=len(y))
        svm, split = self._fit("batched", ["cpu"] * 3, sample_weight=sw)
        _, one = self._fit("batched", sample_weight=sw)
        _assert_same_model(split, one, tol=SPLIT_TOL)
        warm = svm.fit(plssvm_tpu_torch.DataSet(X, y), classification="oao", epsilon=1e-8,
                       sample_weight=sw, initial_model=split)
        assert warm.n_iter == 0


class TestOAOCli:
    def test_train_predict_cli_against_the_reference(self, tmp_path):
        """``--classification oao`` through both packages' CLIs in float64:
        the same header and rho line count, rho within TOL, the same
        predictions, 100 % on separable blobs."""
        X, y = make_multiclass_blobs(45, 3, n_classes=3, seed=9)
        train_file = str(tmp_path / "mc.libsvm")
        plssvm_tpu_torch.DataSet(X, y).save(train_file)
        common = ["--classification", "oao", "-t", "2", "-e", str(EPS),
                  "--use_double_as_real_type", "-q"]
        rhos, predictions = {}, {}
        for name, train_cli, predict_cli, extra in (
                ("j", j_train_cli, j_predict_cli, ["-b", "xla", "-p", "cpu"]),
                ("t", t_train_cli, t_predict_cli, ["-p", "cpu"])):
            model_file = str(tmp_path / f"{name}.model")
            pred_file = str(tmp_path / f"{name}.predict")
            assert train_cli.main(common + extra + [train_file, model_file]) == 0
            content = open(model_file).read()
            assert "nr_class 3" in content
            rhos[name] = np.asarray(
                [ln for ln in content.splitlines() if ln.startswith("rho ")][0].split()[1:],
                dtype=np.float64)
            assert predict_cli.main(["-q"] + extra[-2:] + [train_file, model_file,
                                                           pred_file]) == 0
            predictions[name] = open(pred_file).read()
        assert len(rhos["t"]) == 3
        np.testing.assert_allclose(rhos["t"], rhos["j"], rtol=0, atol=TOL)
        assert predictions["t"] == predictions["j"]
        assert [int(v) for v in predictions["t"].split()] == list(y)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_pairs_bounds", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind,itemsize,per_pair_feature,rate,tier", [
    ("rbf", 4, 1, "FP32_INSTR_PER_S", None), ("laplacian", 4, 2, "FP32_INSTR_PER_S", None),
    ("chi_squared", 4, 1, "SFU_OPS_PER_S", None), ("chi_squared", 8, 11, "FP64_INSTR_PER_S", None),
    ("rbf", 8, 1, "FP64_INSTR_PER_S", None), ("rbf", 4, 2, "TF32_FLOP_PER_S", "tf32"),
    ("rbf", 4, 2, "BF16_FLOP_PER_S", "bf16"), ("polynomial", 4, 2, "TF32_FLOP_PER_S", "tf32"),
    ("rbf", 8, 2, "DMMA_FLOP_PER_S", "dmma"), ("sigmoid", 8, 2, "DMMA_FLOP_PER_S", "dmma")])
def test_chip_smoke_pairs_bound(kind, itemsize, per_pair_feature, rate, tier):
    """``chip_smoke.py``'s bound of kernel O: the machines' distinct pairs
    (the triangle) times d at the pair operation's unit, plus the
    contraction's FFMAs (one per pair of the full square) on the FP32 /
    FP64 pipe where that pipe bounds it; on the tensor cores (``tier``) 2
    flops per pair and feature at the tier's peak, beside which the FP32
    lanes take the FFMAs and, for RBF, the SFU (FP64 pipe on the DMMA walk)
    one exp per pair.  By operations at OAO's widths."""
    chip_smoke = _chip_smoke()
    lens, d = np.asarray([2104, 2, 1500]), 200
    ms, by = chip_smoke._pairs_bound(lens, d, kind, itemsize, tier)
    pairs = float(np.sum(lens * (lens + 1) / 2))
    fmas = float(np.sum(lens.astype(np.float64) ** 2))
    exp = pairs if kind == "rbf" else 0.0
    if tier in ("tf32", "bf16"):
        want = max(2 * pairs * d / getattr(chip_smoke, rate),
                   fmas / chip_smoke.FP32_INSTR_PER_S, exp / chip_smoke.SFU_OPS_PER_S)
    elif tier == "dmma":
        want = max(2 * pairs * d / chip_smoke.DMMA_FLOP_PER_S,
                   (fmas + chip_smoke.EXP_F64_OPS * exp) / chip_smoke.FP64_INSTR_PER_S)
    elif rate == "SFU_OPS_PER_S":
        want = max(pairs * d / chip_smoke.SFU_OPS_PER_S,
                   (4 * pairs * d + fmas) / chip_smoke.FP32_INSTR_PER_S)
    else:
        want = (per_pair_feature * pairs * d + fmas) / getattr(chip_smoke, rate)
    assert by == "operations"
    assert ms == pytest.approx(want * 1e3, rel=1e-12)
    if tier in ("tf32", "bf16"):
        # the rows move at the tier's operand size: the bytes stay far below
        rows = float(np.sum(lens))
        n_bytes = chip_smoke.TC_TIERS[tier][1] * rows * d + 12 * rows
        assert n_bytes / chip_smoke.HBM_BYTES_PER_S < want
