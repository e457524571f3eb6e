"""plssvm_tpu_torch stands apart from JAX.

In a fresh interpreter (this process has imported jax and plssvm_tpu),
importing the port, its CLIs, its tools (the multi-process launcher
among them), its kernel wrappers, its ring over processes and its native
parser loads neither, nor sklearn (the facades of sklearn.py import
it only in ``__sklearn_tags__``), and builds no kernel and no parser.  No source file of the port imports them.
"""

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "plssvm_tpu_torch")

_PROBE = """
import json, sys
import plssvm_tpu_torch
import plssvm_tpu_torch.cli.train, plssvm_tpu_torch.cli.predict
import plssvm_tpu_torch.cli.scale, plssvm_tpu_torch.cli.generate_data
import plssvm_tpu_torch.native, plssvm_tpu_torch.solver.checkpoint
import plssvm_tpu_torch.ops.gram_matvec, plssvm_tpu_torch.ops.gram_matmat
import plssvm_tpu_torch.ops.distance, plssvm_tpu_torch.ops.banded
import plssvm_tpu_torch.parallel.sharded, plssvm_tpu_torch.parallel.multihost
import plssvm_tpu_torch.tools.multihost_rehearsal
import plssvm_tpu_torch.ops.kernel_matrix, plssvm_tpu_torch.solver.explicit
import plssvm_tpu_torch.tools.bench_explicit
import plssvm_tpu_torch.tools.exp_banded_distance
import plssvm_tpu_torch.tools.bench_matvec
import plssvm_tpu_torch.tools.bench_matmat, plssvm_tpu_torch.tools.bench_distance
import plssvm_tpu_torch.tools.bench_solver, plssvm_tpu_torch.tools.scaling_sweep
import plssvm_tpu_torch.tools.scaling_projection
import plssvm_tpu_torch.tools.performance_analysis
import plssvm_tpu_torch.tools.performance_tracker_yaml_parser
import plssvm_tpu_torch.tools.plssvm_target_platforms
import plssvm_tpu_torch.tools.bench_fixed_sum
import plssvm_tpu_torch.sparse, plssvm_tpu_torch.sklearn
from plssvm_tpu_torch.ops import _build
from plssvm_tpu_torch.native import loader
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "plssvm_tpu": sorted(
        m for m in sys.modules
        if m == "plssvm_tpu" or m.startswith("plssvm_tpu.")
    ),
    "triton": "triton" in sys.modules,
    "sklearn": sorted(m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")),
    "library_loaded": _build._lib is not None,
    "native_loaded": loader._lib is not None,
}))
"""


def _run(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_import_loads_no_jax_and_builds_nothing():
    proc = _run("-c", _PROBE)
    assert proc.returncode == 0, proc.stderr
    found = json.loads(proc.stdout.strip().splitlines()[-1])
    assert found == {
        "jax": [], "plssvm_tpu": [], "triton": False, "sklearn": [], "library_loaded": False,
        "native_loaded": False,
    }


def _sources():
    for root, _, names in os.walk(PACKAGE):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import plssvm_tpu\b|from plssvm_tpu\b)",
        re.MULTILINE,
    )
    offenders = [
        path for path in _sources()
        if pattern.search(open(path, encoding="utf-8").read())
    ]
    assert offenders == []


@pytest.mark.parametrize("cli", ["train", "predict"])
def test_cli_help(cli):
    proc = _run("-m", f"plssvm_tpu_torch.cli.{cli}", "--help")
    assert proc.returncode == 0, proc.stderr
    assert "usage: plssvm-torch-" + cli in proc.stdout


@pytest.mark.parametrize("tool", ["exp_banded_distance", "bench_matvec",
                                  "multihost_rehearsal", "bench_matmat", "bench_distance",
                                  "bench_solver", "scaling_sweep", "scaling_projection",
                                  "performance_analysis",
                                  "performance_tracker_yaml_parser",
                                  "plssvm_target_platforms", "bench_fixed_sum"])
def test_tool_help(tool):
    proc = _run("-m", f"plssvm_tpu_torch.tools.{tool}", "--help")
    assert proc.returncode == 0, proc.stderr
    assert f"usage: python -m plssvm_tpu_torch.tools.{tool}" in proc.stdout


@pytest.mark.parametrize("cli,prog", [("scale", "plssvm-torch-scale"),
                                      ("generate_data", "plssvm-torch-generate-data")])
def test_host_cli_help(cli, prog):
    proc = _run("-m", f"plssvm_tpu_torch.cli.{cli}", "--help")
    assert proc.returncode == 0, proc.stderr
    assert "usage: " + prog in proc.stdout
