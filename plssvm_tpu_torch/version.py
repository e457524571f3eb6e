"""Version metadata (reference: include/plssvm/version/version.hpp +
version/git_metadata — branch/commit baked at configure time; here read
lazily from the working tree when available)."""

from __future__ import annotations

import os
import subprocess
from typing import Optional

__version__ = "0.1.0"
__version_info__ = (0, 1, 0)

NAME = "plssvm_tpu_torch"
DESCRIPTION = "Least Squares Support Vector Machine (PyTorch + CUDA port of plssvm_tpu)"

_git_cache: Optional[dict] = None


def git_metadata() -> dict:
    """{'commit': ..., 'branch': ..., 'dirty': ...} of the source checkout.

    Empty strings when not running from a git checkout (e.g. an installed
    wheel).  reference: include/plssvm/version/git_metadata/.
    """
    global _git_cache
    if _git_cache is not None:
        return _git_cache
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    meta = {"commit": "", "branch": "", "dirty": False}
    try:
        def run(*args):
            return subprocess.run(
                ["git", "-C", repo, *args],
                capture_output=True, text=True, timeout=5,
            ).stdout.strip()

        commit = run("rev-parse", "--short", "HEAD")
        if commit:
            meta["commit"] = commit
            meta["branch"] = run("rev-parse", "--abbrev-ref", "HEAD")
            meta["dirty"] = bool(run("status", "--porcelain"))
    except (OSError, subprocess.SubprocessError):
        pass
    _git_cache = meta
    return meta
