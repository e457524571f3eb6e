"""plssvm_tpu_torch stands apart from JAX.

In a fresh interpreter (this process has imported jax and plssvm_tpu),
importing the port, its CLIs, its tools and its kernel wrappers loads
neither, and builds no kernel.  No source file of the port imports them.
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
import plssvm_tpu_torch.ops.gram_matvec, plssvm_tpu_torch.ops.gram_matmat
import plssvm_tpu_torch.ops.distance, plssvm_tpu_torch.ops.banded
import plssvm_tpu_torch.parallel.sharded
import plssvm_tpu_torch.tools.exp_banded_distance
import plssvm_tpu_torch.tools.bench_matvec
from plssvm_tpu_torch.ops import _build
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "plssvm_tpu": sorted(
        m for m in sys.modules
        if m == "plssvm_tpu" or m.startswith("plssvm_tpu.")
    ),
    "triton": "triton" in sys.modules,
    "library_loaded": _build._lib is not None,
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
        "jax": [], "plssvm_tpu": [], "triton": False, "library_loaded": False,
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


@pytest.mark.parametrize("tool", ["exp_banded_distance", "bench_matvec"])
def test_tool_help(tool):
    proc = _run("-m", f"plssvm_tpu_torch.tools.{tool}", "--help")
    assert proc.returncode == 0, proc.stderr
    assert f"usage: python -m plssvm_tpu_torch.tools.{tool}" in proc.stdout
