"""Kernel I (the banded laplacian matvec) and K6 (``kernel_matvec``) of the
port, and the two tools that run them, against the JAX package.

Inputs are made from a seed with numpy and handed to both packages.  The
JAX package's kernels run as its own tests run them on the CPU, in
interpret mode:

- ``ops.banded.banded_matvec`` on CPU tensors (its plain version) against
  tools/exp_banded_distance.py ``banded_matvec(..., interpret=True)``,
  imported by file path, at the tool's shapes (m a multiple of 128, d of
  8), both halves compared apart, both ``symmetric`` values: float32 at
  1e-5 of max|want| (the two sum in other orders), float64 (x64 is on, see
  conftest.py) at 1e-12;
- ragged shapes the TPU layout never took (m in {1, 127, 129, 300}, d in
  {1, 3}) against a float64 NumPy golden of the split's definition;
- ``ops.gram_matvec.kernel_matvec`` against ``kernel_matvec_pallas`` under
  ``pltpu.force_tpu_interpret_mode()`` at tests/test_ops.py's shapes and
  tolerance (rtol = atol = 2e-5, float32);
- both tools with ``--cpu`` at tiny sizes in a subprocess, and their
  refusal to run without a GPU unless asked.
"""

import importlib.util
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plssvm_tpu.parameter import KernelFunctionType as JKind
from plssvm_tpu_torch.ops import _build, banded, gram_matvec, matvec
from plssvm_tpu_torch.parameter import KernelFunctionType as TKind

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_exp():
    """The first multithreaded ``torch.exp`` of a process can come out
    ~1e-4 off in the CPU build of torch these tests run on (seen at 16
    threads: a race in its first dispatch); one exp before the comparisons
    keeps that out of them."""
    torch.exp(torch.rand(300, 300)).sum()


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_exp_banded_distance", os.path.join(REPO, "tools", "exp_banded_distance.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _golden(X, v, gamma, symmetric):
    """(out_r, out_c) of the definition in float64."""
    K = np.exp(-gamma * np.abs(X[:, None, :] - X[None, :, :]).sum(-1))
    band = np.arange(len(X)) // 128
    if symmetric:
        return ((K * (band[None, :] >= band[:, None])) @ v,
                (K * (band[:, None] < band[None, :])).T @ v)
    return K @ v, K.T @ v


# -- kernel I's split against the JAX tool's kernel --------------------------


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("m,d", [(256, 8), (384, 16)])
def test_banded_matches_the_jax_tool(m, d, symmetric, dtype, rtol):
    rng = np.random.default_rng(m + d)
    X = np.abs(rng.normal(size=(m, d))).astype(dtype)
    v = rng.normal(size=(m,)).astype(dtype)
    gamma = dtype(1.0 / d)
    want = _jax_tool().banded_matvec(
        jnp.asarray(X.T), jnp.asarray(v), gamma, symmetric=symmetric,
        interpret=True,
    )
    got = banded.banded_matvec(
        torch.from_numpy(np.ascontiguousarray(X.T)), torch.from_numpy(v),
        float(gamma), symmetric=symmetric,
    )
    for half, (g, w) in zip(("out_r", "out_c"), zip(got, want)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, half
        err = np.max(np.abs(g.numpy() - w))
        assert err <= rtol * np.max(np.abs(w)), (half, err)
    if symmetric:
        full = np.exp(-gamma * np.abs(
            X[:, None].astype(np.float64) - X[None]).sum(-1)) @ v
        np.testing.assert_allclose(
            (got[0] + got[1]).numpy(), full, rtol=0,
            atol=10 * rtol * np.max(np.abs(full)),
        )


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("m", [1, 127, 129, 300])
def test_banded_ragged_against_golden(m, d, symmetric, dtype, rtol):
    """No layout rule: a single row, a ragged last band, odd feature
    counts; the band still follows the row index."""
    rng = np.random.default_rng(7 * m + d)
    X = np.abs(rng.normal(size=(m, d)))
    v = rng.normal(size=(m,))
    gamma = 0.7 / d
    want = _golden(X, v, gamma, symmetric)
    got = banded.banded_matvec(
        torch.from_numpy(np.ascontiguousarray(X.T).astype(dtype)),
        torch.from_numpy(v.astype(dtype)), gamma, symmetric=symmetric,
    )
    scale = max(np.max(np.abs(want[0])), np.max(np.abs(want[1])))
    for half, g, w in zip(("out_r", "out_c"), got, want):
        assert g.shape == (m,)
        assert np.max(np.abs(g.numpy() - w)) <= rtol * scale, half


def test_banded_empty_and_launch_count():
    """m = 0 gives two empty halves; on CPU tensors the plain version
    runs and the kernel's count stays 0."""
    banded.reset_counts()
    out_r, out_c = banded.banded_matvec(torch.zeros(3, 0), torch.zeros(0), 0.5)
    assert out_r.shape == out_c.shape == (0,)
    banded.banded_matvec(torch.rand(2, 5), torch.rand(5), 0.5)
    assert banded.launches == 0 and matvec.banded_plain_calls == 2


def test_banded_wrapper_refuses_a_non_matrix_on_cuda_tensors():
    """The CUDA route checks its operands before it builds anything; a CPU
    tensor never reaches it."""
    class FakeCuda:
        ndim, shape, device = 1, (4,), torch.device("cuda")

    with pytest.raises(ValueError, match=r"XT must be \(d, m\)"):
        banded.banded_matvec(FakeCuda(), torch.zeros(4), 0.5)


def test_kernel_resources_reads_kernel_i(tmp_path, monkeypatch):
    """kernel_resources() names kernel I's instantiations, which carry no
    kind parameter (laplacian only)."""
    library = tmp_path / "libplssvm_gram_0.so"
    library.with_name(library.name + ".ptxas.txt").write_text(
        "== banded.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120banded_matvec_kernelIfEEvPKT_S3_PS1_S4_lllS1_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_120banded_matvec_kernelIfEEvPKT_S3_PS1_S4_lllS1_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 24832 bytes smem, 424 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120banded_matvec_kernelIdEEvPKT_S3_PS1_S4_lllS1_' for 'sm_90a'\n"
        "ptxas info    : Used 80 registers, 16896 bytes smem, 424 bytes cmem[0]\n",
        encoding="utf-8",
    )
    monkeypatch.setattr(_build, "library_path", lambda: library)
    assert _build.kernel_resources() == {
        "banded_matvec f32 laplacian": {
            "spill_bytes": 0, "registers": 128, "smem_bytes": 24832,
        },
        "banded_matvec f64 laplacian": {"registers": 80, "smem_bytes": 16896},
    }


# -- K6: kernel_matvec against kernel_matvec_pallas --------------------------


@pytest.mark.parametrize("shape", [(256, 128), (128, 1280)])
@pytest.mark.parametrize("name", ["rbf", "polynomial", "sigmoid"])
def test_kernel_matvec_matches_k6(name, shape):
    """tests/test_ops.py's interpret-mode check of K6, with the port in
    place of the XLA reference; (128, 1280) is its wide-feature path."""
    from jax.experimental.pallas import tpu as pltpu

    from plssvm_tpu.ops.pallas_matvec import kernel_matvec_pallas

    m, d = shape
    rng = np.random.default_rng(3)
    X = rng.normal(size=(m, d)).astype(np.float32)
    v = rng.normal(size=(m,)).astype(np.float32)
    sq = np.sum(X * X, axis=-1)
    gamma, coef0 = np.float32(1.0 / d), np.float32(1.0)
    with pltpu.force_tpu_interpret_mode():
        want = kernel_matvec_pallas(
            jnp.asarray(X), jnp.asarray(sq), jnp.asarray(v),
            kind=getattr(JKind, name.upper()), gamma=gamma, coef0=coef0,
            degree=3,
        )
    got = gram_matvec.kernel_matvec(
        torch.from_numpy(X), torch.from_numpy(sq), torch.from_numpy(v),
        kind=getattr(TKind, name.upper()), gamma=float(gamma),
        coef0=float(coef0), degree=3,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_kernel_matvec_precisions():
    """On CPU tensors "f32" and "highest" are one computation, full
    precision; "bf16" computes on bf16-rounded float32 X with the float32
    norms (float64 keeps full precision at every tier); anything else is
    refused."""
    g = torch.Generator().manual_seed(5)
    X = torch.randn(70, 9, generator=g, dtype=torch.float64)
    v = torch.randn(70, generator=g, dtype=torch.float64)
    sq = (X * X).sum(-1)
    kw = dict(kind=TKind.RBF, gamma=0.1, coef0=0.0, degree=3)
    f32 = gram_matvec.kernel_matvec(X, sq, v, precision="f32", **kw)
    assert torch.equal(f32, gram_matvec.kernel_matvec(X, sq, v, precision="highest", **kw))
    assert torch.equal(f32, matvec.kernel_matvec_plain(X, sq, v, **kw))
    assert torch.equal(f32, gram_matvec.kernel_matvec(X, sq, v, precision="bf16", **kw))
    X32, sq32, v32 = X.float(), sq.float(), v.float()
    bf16 = gram_matvec.kernel_matvec(X32, sq32, v32, precision="bf16", **kw)
    Xb = X32.to(torch.bfloat16).float()
    assert torch.equal(bf16, matvec.kernel_matvec_plain(Xb, sq32, v32, **kw))
    assert not torch.equal(bf16, gram_matvec.kernel_matvec(X32, sq32, v32, **kw))
    with pytest.raises(ValueError, match="precision"):
        gram_matvec.kernel_matvec(X, sq, v, precision="tf32", **kw)
    with pytest.raises(ValueError, match="distance kernel"):
        gram_matvec.kernel_matvec(X, sq, v, kind=TKind.LAPLACIAN, gamma=0.1,
                                  coef0=0.0, degree=3)


def test_kernel_matvec_counts_only_kernel_launches():
    gram_matvec.reset_counts()
    X = torch.randn(20, 3)
    gram_matvec.kernel_matvec(X, (X * X).sum(-1), torch.randn(20),
                              kind=TKind.RBF, gamma=0.3, coef0=0.0, degree=3)
    assert gram_matvec.kernel_matvec_launches == gram_matvec.sym_launches == 0
    assert matvec.sym_plain_calls == 1


# -- the tools ---------------------------------------------------------------


def _tool(name, *args, cuda_visible=None):
    """Run ``python -m plssvm_tpu_torch.tools.<name>``; one thread (the
    sizes are tiny)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    if cuda_visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = cuda_visible
    return subprocess.run(
        [sys.executable, "-m", f"plssvm_tpu_torch.tools.{name}", *map(str, args)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


def test_banded_tool_times_on_the_cpu():
    proc = _tool("exp_banded_distance", "--m", 256, "--d", 8, "--iters", 2, "--cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert re.fullmatch(r"first run on cpu \(kernel build included\): [\d.]+s", lines[0])
    assert re.fullmatch(r"banded: [\d.]+ s/matvec, [\d.]+ TOP/s", lines[1])


@pytest.mark.parametrize("m", [300, 4096])
def test_banded_tool_check_on_the_cpu(m):
    """--check caps m at 512 and passes on a ragged m."""
    proc = _tool("exp_banded_distance", "--m", m, "--d", 9, "--check", "--cpu")
    assert proc.returncode == 0, proc.stderr
    found = re.fullmatch(r"check on cpu m=(\d+) d=9: rel err (\S+)", proc.stdout.strip())
    assert found and int(found.group(1)) == min(m, 512)
    assert float(found.group(2)) < 1e-5


@pytest.mark.parametrize("kernel,variants", [
    ("rbf", ["plain_rb2048", "kernel_matvec", "kernel_matvec_hi", "kernel_matvec_bf16",
             "rect_full", "rect_full_hi"]),
    ("sigmoid", ["plain_rb2048", "kernel_matvec", "kernel_matvec_hi", "kernel_matvec_bf16",
                 "rect_full", "rect_full_hi"]),
    ("laplacian", ["plain_rb256", "sym_walk"]),
    ("chi_squared", ["plain_rb256", "sym_walk"]),
])
def test_bench_matvec_on_the_cpu(kernel, variants):
    proc = _tool("bench_matvec", 200, 24, 3, "all", kernel, "--cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == f"bench_matvec on cpu: m=200 d=24 iters=3 kernel={kernel}"
    timed = {}
    for line in lines[1:]:
        found = re.fullmatch(
            r"(\w+)\s+[\d.]+ TFLOP/s\s+[\d.]+ ms/matvec\s+rel_err=(\S+)", line
        )
        assert found, line
        timed[found.group(1)] = float(found.group(2))
    assert list(timed) == variants
    # bf16: 4 u gamma max|x|^2 on the tool's seeded rows (u = 2^-8), the
    # first-order bound of an entry's relative error; every other 1e-5
    Xt = np.random.default_rng(0).normal(size=(200, 24)).astype(np.float64)
    bf16_limit = 4 * 2.0 ** -8 * (Xt ** 2).sum(1).max() / 24
    for variant, err in timed.items():
        assert err < (bf16_limit if variant == "kernel_matvec_bf16" else 1e-5), timed


def test_bench_matvec_only_and_unknown_variants():
    proc = _tool("bench_matvec", 100, 8, 2, "kernel_matvec_bf16,rect_full", "rbf", "--cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()[1:]
    assert lines[0].startswith("kernel_matvec_bf16 ") and "rel_err=" in lines[0]
    assert lines[1].startswith("rect_full ") and len(lines) == 2
    proc = _tool("bench_matvec", 100, 8, 2, "sym_walk", "rbf", "--cpu")
    assert proc.returncode == 2 and "unknown variants" in proc.stderr


@pytest.mark.parametrize("name,args", [
    ("exp_banded_distance", ["--m", 128, "--d", 4]),
    ("bench_matvec", [100, 8, 2]),
])
def test_tools_refuse_to_run_on_the_cpu_unless_asked(name, args):
    proc = _tool(name, *args, cuda_visible="")
    assert proc.returncode == 1
    assert "none is available; --cpu runs it on the CPU" in proc.stderr
    assert proc.stdout == ""
