"""K3: fused grid/anchor decode of the head levels, on CUDA tensors.

Wrapper of ``csrc/decode.cu``, which replaces the TPU kernel
``yolo_continuous_tpu/kernels/decode_pallas.py::decode_level_pallas``. Its
plain PyTorch version is ``ops/decode.py::decode_level``; ``ops/decode.py::
decode_outputs`` sends CPU tensors there and CUDA tensors here.

The kernel reads each level as the head gives it: the ``(bs, h, w, na, no)``
fp32 view of the NCHW conv output, through its strides, with no
``.contiguous()`` copy. All levels are written into one ``(bs, rows, no)``
buffer at their row offsets, so no concatenation follows.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build


def check_head_maps(preds: Sequence[torch.Tensor], anchors: Sequence, strides: Sequence[float],
                    what: str) -> None:
    """Raise unless ``preds`` are fp32 ``(bs, h, w, na, no)`` maps on one CUDA
    device, with one set of 1..8 anchors and one stride per level."""
    if not preds or len(preds) != len(anchors) or len(preds) != len(strides):
        raise ValueError(f"{what} needs one anchor set and one stride per level")
    p0 = preds[0]
    bs, no = p0.shape[0], p0.shape[-1]
    for p, a in zip(preds, anchors):
        if p.device.type != "cuda" or p.device != p0.device:
            raise ValueError(f"{what} kernel takes tensors on one CUDA device, got {p.device}")
        if p.dtype != torch.float32:
            raise ValueError(f"{what} kernel takes float32 head maps, got {p.dtype}")
        if p.dim() != 5 or p.shape[0] != bs or p.shape[-1] != no or p.shape[3] != len(a):
            raise ValueError(f"head map {tuple(p.shape)} is not (bs, h, w, na={len(a)}, no={no})")
        if not 1 <= len(a) <= 8:
            raise ValueError(f"{what} kernel takes 1..8 anchors")


def decode_outputs_cuda(preds: Sequence[torch.Tensor], anchors: Sequence, strides: Sequence[float],
                        normalized: bool = True) -> torch.Tensor:
    """Raw head maps ``[(bs, h, w, na, no)]`` on one CUDA device ->
    ``(bs, sum(h*w*na), no)`` fp32 rows in (level, h, w, na) order.

    ``anchors``: per level, ``na`` (w, h) pairs in input pixels."""
    check_head_maps(preds, anchors, strides, "decode")
    p0 = preds[0]
    bs, no = p0.shape[0], p0.shape[-1]
    if no < 5:
        raise ValueError(f"decode kernel takes no >= 5, got {no}")
    rows = sum(p.shape[1] * p.shape[2] * p.shape[3] for p in preds)
    out = torch.empty((bs, rows, no), device=p0.device, dtype=torch.float32)
    lib = _build.library("decode")
    stream = torch.cuda.current_stream(p0.device).cuda_stream
    row0 = 0
    for p, a, s in zip(preds, anchors, strides):
        _, h, w, na, _ = p.shape
        # anchors in feature units, rounded as the plain version rounds them
        af = (torch.tensor(a, dtype=torch.float32) / float(s)).flatten().tolist()
        anchors_wh = (ctypes.c_float * (2 * na))(*af)
        err = lib.decode_level(p.data_ptr(), out.data_ptr(), bs, h, w, na, no, *p.stride(),
                               out.stride(0), row0, anchors_wh, int(normalized), float(s), stream)
        _build.check(err, "decode_level")
        decode_outputs_cuda.launches += 1
        row0 += h * w * na
    return out


decode_outputs_cuda.launches = 0
