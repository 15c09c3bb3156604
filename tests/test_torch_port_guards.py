"""The PyTorch port stands alone: no import of jax, flax or the JAX package.

Checked twice: an AST scan of every module of ``yolo_continuous_tpu_torch``
and of ``chip_smoke.py``, and a clean subprocess that imports the whole
port and then looks at ``sys.modules``. Importing the port must also leave
CUDA uninitialised and build nothing (kernels are built at first launch).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "yolo_continuous_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yolo_continuous_tpu")
FILES = sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_every_port_module_is_scanned():
    assert len(FILES) > 15 and "yolo_continuous_tpu_torch/detect_api.py" in FILES
    assert "yolo_continuous_tpu_torch/train/train_loop.py" in FILES
    for rel in ("data/dataset.py", "ops/augment.py", "ops/enhance.py",
                "eval/evaluator.py", "eval/validate.py", "train/__main__.py", "val.py",
                "nn/fuse.py", "nn/yolo_body.py", "losses/bin_loss.py", "nn/quant.py",
                "serve.py", "utils/timing.py", "parallel/mesh.py", "parallel/distributed.py",
                "tools/gen_anchors.py", "tools/gen_annotation.py", "tools/torch_import.py",
                "tools/torch_export.py", "utils/image.py", "utils/env.py",
                "data/native_loader.py", "kernels/staging.py"):
        assert f"yolo_continuous_tpu_torch/{rel}" in FILES


@pytest.mark.parametrize("rel", FILES)
def test_no_forbidden_import(rel):
    bad = sorted(set(_imported_roots(REPO / rel)) & set(FORBIDDEN))
    assert not bad, f"{rel} imports {bad}"


_PROBE = """
import sys
import yolo_continuous_tpu_torch
import yolo_continuous_tpu_torch.detect_api, yolo_continuous_tpu_torch.detect
import yolo_continuous_tpu_torch.tools.jax_weights
import yolo_continuous_tpu_torch.kernels.decode, yolo_continuous_tpu_torch.kernels.nms
import yolo_continuous_tpu_torch.kernels.bin_decode, yolo_continuous_tpu_torch.kernels.fused_conv
import yolo_continuous_tpu_torch.ops.sigmoid_bin, yolo_continuous_tpu_torch.ops.schedules
import yolo_continuous_tpu_torch.train.train_loop, yolo_continuous_tpu_torch.train.checkpoint
import yolo_continuous_tpu_torch.train.__main__, yolo_continuous_tpu_torch.val
import yolo_continuous_tpu_torch.data.dataset, yolo_continuous_tpu_torch.data.native_loader
import yolo_continuous_tpu_torch.kernels.staging
import yolo_continuous_tpu_torch.ops.augment, yolo_continuous_tpu_torch.ops.enhance
import yolo_continuous_tpu_torch.ops.preprocess
import yolo_continuous_tpu_torch.eval.evaluator, yolo_continuous_tpu_torch.eval.validate
import yolo_continuous_tpu_torch.nn.fuse, yolo_continuous_tpu_torch.nn.yolo_body
import yolo_continuous_tpu_torch.losses.bin_loss
import yolo_continuous_tpu_torch.nn.quant, yolo_continuous_tpu_torch.serve
import yolo_continuous_tpu_torch.utils.timing
import yolo_continuous_tpu_torch.parallel.mesh, yolo_continuous_tpu_torch.parallel.distributed
import yolo_continuous_tpu_torch.tools.gen_anchors, yolo_continuous_tpu_torch.tools.gen_annotation
import yolo_continuous_tpu_torch.tools.torch_import, yolo_continuous_tpu_torch.tools.torch_export
import yolo_continuous_tpu_torch.utils.image, yolo_continuous_tpu_torch.utils.env
import torch
from yolo_continuous_tpu_torch.kernels import _build
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r} or m == "triton")
print("BAD", bad, "CUDA_INIT", torch.cuda.is_initialized(), "LIBS", len(_build._libs))
"""


def test_port_import_pulls_in_no_jax_and_no_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "BAD [] CUDA_INIT False LIBS 0", p.stdout
