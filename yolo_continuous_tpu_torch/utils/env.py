"""Environment helpers (counterpart of ``yolo_continuous_tpu/utils/env.py``;
``utils/helper_io.py:29-41`` parity): ``date_modified`` and ``git_describe``.

JAX's ``setup_compile_cache`` (its persistent XLA compilation cache) has no
counterpart here: eager PyTorch compiles nothing a call, and the port's only
build products, the CUDA kernels, are cached by ``kernels/_build.py`` under
``yolo_continuous_tpu_torch/_build/``, keyed by a hash of their sources and
flags.
"""
from __future__ import annotations

import datetime
import subprocess
from pathlib import Path


def date_modified(path: str = __file__) -> str:
    """Human-readable mtime; helper_io.py:29-32."""
    t = datetime.datetime.fromtimestamp(Path(path).stat().st_mtime)
    return f"{t.year}-{t.month}-{t.day}"


def git_describe(path=None) -> str:
    """``git describe --tags --long --always`` of the repo at ``path`` (this
    package's by default), or "" outside one; helper_io.py:35-41."""
    path = path or Path(__file__).parent
    try:
        return subprocess.check_output(
            ["git", "-C", str(path), "describe", "--tags", "--long", "--always"],
            stderr=subprocess.STDOUT).decode()[:-1]
    except (subprocess.CalledProcessError, OSError):
        return ""
