"""yolo_continuous_tpu_torch — the PyTorch / CUDA port of ``yolo_continuous_tpu``.

The JAX package beside it stays the reference. This package mirrors its
layout and names (``config/plan.py``, ``nn/builder.py``, ``ops/nms.py``,
...) so each counterpart is easy to find, imports ``torch`` and numpy only,
and never imports ``jax``, ``flax`` or ``yolo_continuous_tpu``.

Every Pallas kernel of the ported path is a hand-written CUDA kernel for
Hopper (``csrc/*.cu``, built by ``kernels/_build.py`` at first use). Each
kernel has a plain PyTorch version of the same function; a wrapper uses it
only for tensors on the CPU, and launches the kernel (or raises) for CUDA
tensors. Entry points (``Detector``, ``predict``, the ``detect`` CLI) run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
