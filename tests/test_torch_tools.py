"""The port's counterparts of the JAX package's root tools, on the CPU.

Each runs with ``--cpu`` at a tiny size (its figures are the CPU's and say
nothing of a card); the tracker's YAML parser is held against the root
tool's parser on the file the port's tracker writes; ``scaling_projection``
counts the ring's transfers on CPU ranks; ``scaling_sweep --multihost``
runs on two gloo ranks as torchrun would start them.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from plssvm_tpu_torch.tools import (
    bench_distance,
    bench_matmat,
    bench_solver,
    performance_analysis,
    performance_tracker_yaml_parser,
    plssvm_target_platforms,
    scaling_projection,
    scaling_sweep,
)
from plssvm_tpu_torch.tools.multihost_rehearsal import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_matmat_on_the_cpu(capsys):
    assert bench_matmat.main(["150", "12", "3", "2", "--cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("bench_matmat on cpu: m=150 d=12 C=3")
    assert [line.split()[0] for line in lines[1:]] == ["plain_rb1024", "kernel_c"]
    assert all("TFLOP/s (Gram)" in line and "rel_err=" in line for line in lines[1:])
    assert bench_matmat.main(["150", "12", "3", "2", "nope", "--cpu"]) == 2
    if not torch.cuda.is_available():
        assert bench_matmat.main(["150", "12", "3", "2"]) == 1


def test_bench_distance_on_the_cpu(capsys):
    assert bench_distance.main(["--m", "120", "--d", "6", "--iters", "2", "--cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [list(row) for row in rows] == [["laplacian"], ["chi_squared"]]
    for row in rows:
        (cell,) = row.values()
        assert set(cell) == {"kernel", "plain", "speedup"}
        assert cell["kernel"]["s_per_matvec"] > 0 and cell["plain"]["top_per_s"] > 0
    assert bench_distance.main(["--kinds", "rbf", "--cpu"]) == 2


@pytest.mark.parametrize("kernel", ["rbf", "laplacian"])
def test_bench_solver_on_the_cpu(kernel, capsys):
    assert bench_solver.main(["120", "8", "2", kernel, "f32", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "K build (torch.float32" in out and "explicit K@v" in out
    assert ("implicit sym" if kernel == "laplacian" else "implicit dual") in out
    assert "build amortizes over" in out


def test_scaling_sweep_on_the_cpu(tmp_path, capsys):
    yaml_path = str(tmp_path / "sweep.yaml")
    assert scaling_sweep.main(["--n", "160", "--d", "6", "--iters", "3", "--devices", "cpu",
                               "--mesh-sizes", "1,2",
                               "--performance_tracking", yaml_path]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == ["devices=", "devices="]
    assert "scaling efficiency  100.0%" in lines[0]
    docs = performance_tracker_yaml_parser.parse_tracking_file(yaml_path)
    assert len(docs) == 1
    assert docs[0]["scaling.num_devices"] == 2  # the last entry of a key
    assert docs[0]["parameter.kernel_type"] == "rbf"


def test_scaling_sweep_multihost_rehearsal(tmp_path):
    """``scaling_sweep --multihost`` on two gloo ranks with torchrun's
    environment: rank 0 prints the line and writes the tracker's YAML (the
    efficiency of localhost gloo at this size means nothing)."""
    port = free_port()
    yaml_path = str(tmp_path / "sweep.yaml")
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PLSSVM_TPU_TORCH_RANK_DEVICE="cpu", PLSSVM_TPU_TORCH_DIST_BACKEND="gloo",
                   PLSSVM_TPU_TORCH_DIST_TIMEOUT="300", OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "plssvm_tpu_torch.tools.scaling_sweep", "--multihost",
             "--n", "300", "--d", "8", "--iters", "3"]
            + (["--performance_tracking", yaml_path] if rank == 0 else []),
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "processes=2" in outs[0] and "scaling efficiency" in outs[0]
    assert "scaling efficiency" not in outs[1]
    text = open(yaml_path, encoding="utf-8").read()
    for key in ("num_processes: 2", "num_devices: 2", "efficiency_percent:",
                "baseline_cg_iterations_per_second:", "cg_iterations_per_second:",
                "kernel_type: rbf"):
        assert key in text, key


def test_scaling_projection_transfer_inventory():
    """A CG iteration of the RBF fit over 4 CPU ranks rotates row chunks
    and sends transposed outputs back (point-to-point, ``exchange``) and
    gathers its scalars; the linear fit gathers only, as the reference's
    linear solve shows all-reduces and no collective-permute."""
    inventory = scaling_projection.measure_transfers(4, 40, 12)
    rbf, linear = inventory["rbf"], inventory["linear"]
    # W = 4: one dual step (rotate X, sq, v; send the transposed output
    # back) and the rows-only step's rotation: 3 + 1 + 3 messages
    assert rbf["exchange"]["count"] == 7
    assert rbf["exchange"]["bytes"] > 40 * 12 * 4
    assert rbf["all_gather"]["count"] > 0
    assert "exchange" not in linear
    assert linear["all_gather"]["count"] > rbf["all_gather"]["count"] - 1


def test_scaling_projection_model_and_json(capsys):
    """``--tflops`` gives the projection without a card; the ring's
    traffic over NVLink leaves the 1M x 1k RBF iteration compute-bound."""
    assert scaling_projection.main(["--devices", "2", "--m_per_dev", "24", "--d", "6",
                                    "--tflops", "100", "--json"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert set(result["transfers_per_cg_iteration"]) == {"rbf", "linear"}
    assert [row["cards"] for row in result["projection_1Mx1k_rbf"]] == [1, 2, 4, 8, 16]
    assert result["assumptions"]["link_bytes_per_s"] == scaling_projection.H100_NVLINK_BYTES_PER_S
    for row in result["projection_1Mx1k_rbf"][1:4]:
        assert row["scaling_efficiency_serialized"] >= 0.9


def test_performance_analysis_and_the_parsers(tmp_path, capsys, monkeypatch):
    """Two tracked fits on the CPU; the port's parser reads the port
    tracker's file into the rows the root tool's parser reads, and writes
    the same CSV."""
    monkeypatch.chdir(tmp_path)
    assert performance_analysis.main(["--num_data_points", "80", "--num_features", "5",
                                      "--num_repeats", "2", "--cpu"]) == 0
    assert os.path.isfile("train_data.libsvm")
    capsys.readouterr()
    ours = performance_tracker_yaml_parser.parse_tracking_file("tracking.yaml")
    theirs = _root_tool("performance_tracker_yaml_parser").parse_tracking_file("tracking.yaml")
    assert ours == theirs and len(ours) == 2
    assert [doc["parameter.repeat"] for doc in ours] == [0, 1]
    assert all(doc["total_time"] > 0 for doc in ours)
    assert performance_tracker_yaml_parser.main(["--tracking_file", "tracking.yaml",
                                                 "--csv"]) == 0
    port_csv = capsys.readouterr().out
    root = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                        "performance_tracker_yaml_parser.py"),
                           "--tracking_file", "tracking.yaml", "--csv"],
                          capture_output=True, text=True, timeout=120)
    assert root.returncode == 0 and port_csv == root.stdout
    if not torch.cuda.is_available():
        assert performance_analysis.main(["--num_data_points", "8", "--num_features", "2",
                                          "--num_repeats", "1"]) == 1


def test_target_platforms(capsys):
    assert plssvm_target_platforms.main([]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"torch {torch.__version__}")
    want = ("--target_platform=gpu --backend=cuda" if torch.cuda.is_available()
            else "--target_platform=cpu --backend=torch")
    assert lines[-1] == want
    assert plssvm_target_platforms.main(["--quiet"]) == 0
    assert capsys.readouterr().out.splitlines() == [want]


def test_bench_fixed_sum_on_the_cpu(capsys):
    """The before / after timer of the fixed-order sums' kernels: one
    JSON line a cell on the CPU's plain versions, no workspace there."""
    from plssvm_tpu_torch.tools import bench_fixed_sum

    assert bench_fixed_sum.main(["--cpu", "--calls", "1", "--repeats", "1",
                                 "--only", "A,E,L,I"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert {r["kernel"].split()[0] for r in rows} == {"A", "E", "L", "I"}
    assert all(r["ms"] > 0 and r["workspace_bytes"] == 0 for r in rows)
    if not torch.cuda.is_available():
        assert bench_fixed_sum.main([]) == 1
