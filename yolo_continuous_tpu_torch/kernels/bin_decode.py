"""K4: fused IBin (SigmoidBin) decode of the head levels, on CUDA tensors.

Wrapper of ``csrc/bin_decode.cu``, which replaces the TPU kernel
``yolo_continuous_tpu/kernels/bin_decode_pallas.py::decode_level_bin_pallas``.
Its plain PyTorch version is ``ops/decode.py::decode_level_bin``;
``ops/decode.py::decode_outputs_bin`` sends CPU tensors there and CUDA
tensors here.

As K3, the kernel reads each level as the IBin head gives it, the
``(bs, h, w, na, nc + 3 + 2 (bins + 1))`` fp32 view of the NCHW conv output,
through its strides, and writes the ``5 + nc`` decoded columns of all levels
into one ``(bs, rows, 5 + nc)`` buffer at their row offsets.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from .decode import check_head_maps


def decode_outputs_bin_cuda(preds: Sequence[torch.Tensor], anchors: Sequence,
                            strides: Sequence[float], bin_count: int = 21,
                            normalized: bool = True) -> torch.Tensor:
    """Raw IBin maps ``[(bs, h, w, na, no)]`` on one CUDA device ->
    ``(bs, sum(h*w*na), 5 + nc)`` fp32 rows in (level, h, w, na) order.

    ``anchors``: per level, ``na`` (w, h) pairs in input pixels."""
    check_head_maps(preds, anchors, strides, "bin decode")
    p0 = preds[0]
    bs, no = p0.shape[0], p0.shape[-1]
    nc = no - 3 - 2 * (bin_count + 1)
    if bin_count < 1 or nc < 0:
        raise ValueError(f"bin decode: {no} columns do not hold {bin_count} bins per value")
    rows = sum(p.shape[1] * p.shape[2] * p.shape[3] for p in preds)
    out = torch.empty((bs, rows, 5 + nc), device=p0.device, dtype=torch.float32)
    lib = _build.library("bin_decode")
    stream = torch.cuda.current_stream(p0.device).cuda_stream
    row0 = 0
    for p, a, s in zip(preds, anchors, strides):
        _, h, w, na, _ = p.shape
        anchors_wh = (ctypes.c_float * (2 * na))(*[float(v) for pair in a for v in pair])
        err = lib.decode_level_bin(p.data_ptr(), out.data_ptr(), bs, h, w, na, no, *p.stride(),
                                   out.stride(0), row0, anchors_wh, bin_count, int(normalized),
                                   float(s), stream)
        _build.check(err, "decode_level_bin")
        decode_outputs_bin_cuda.launches += 1
        row0 += h * w * na
    return out


decode_outputs_bin_cuda.launches = 0
