"""K4: fused IBin (SigmoidBin) decode of the head levels, on CUDA tensors.

Wrapper of ``csrc/bin_decode.cu``, which replaces the TPU kernel
``yolo_continuous_tpu/kernels/bin_decode_pallas.py::decode_level_bin_pallas``.
Its plain PyTorch version is ``ops/decode.py::decode_level_bin``;
``ops/decode.py::decode_outputs_bin`` sends CPU tensors there and CUDA
tensors here.

As K3, the kernel reads each level as the IBin head gives it, the
``(bs, h, w, na, nc + 3 + 2 (bins + 1))`` fp32 view of the NCHW conv output,
with no copy, and writes the ``5 + nc`` decoded columns of all levels into
one ``(bs, rows, 5 + nc)`` buffer at their row offsets. Its two forms are
K3's ("tma": one launch for all levels; "strided": one a level), chosen by
``form_for`` before the launch; both give the same bits.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..utils.capture import count
from . import _build
from .decode import FORMS, check_head_maps, level_table, pack_levels
from .decode import form_for as _form_for


def form_for(preds: Sequence[torch.Tensor], bin_count: int = 21) -> str:
    """The form that ``decode_outputs_bin_cuda(preds, ..., bin_count)``
    launches: K3's rule (``kernels/decode.py::form_for``) at K4's output
    width."""
    no = preds[0].shape[-1] if preds else 0
    return _form_for(preds, no_out=max(no - 2 * (bin_count + 1) + 2, 1))


def decode_outputs_bin_cuda(preds: Sequence[torch.Tensor], anchors: Sequence,
                            strides: Sequence[float], bin_count: int = 21,
                            normalized: bool = True) -> torch.Tensor:
    """Raw IBin maps ``[(bs, h, w, na, no)]`` on one CUDA device ->
    ``(bs, sum(h*w*na), 5 + nc)`` fp32 rows in (level, h, w, na) order, in
    the form ``form_for`` picks.

    ``anchors``: per level, ``na`` (w, h) pairs in input pixels.
    ``launches`` as in ``kernels/decode.py::decode_outputs_cuda``."""
    return launch_form(preds, anchors, strides, bin_count, normalized, form_for(preds, bin_count))


def launch_form(preds: Sequence[torch.Tensor], anchors: Sequence, strides: Sequence[float],
                bin_count: int, normalized: bool, form: str) -> torch.Tensor:
    """K4 in the given form, as ``kernels/decode.py::launch_form`` is K3;
    counts on ``decode_outputs_bin_cuda.launches``."""
    check_head_maps(preds, anchors, strides, "bin decode")
    p0 = preds[0]
    bs, no = p0.shape[0], p0.shape[-1]
    nc = no - 3 - 2 * (bin_count + 1)
    if bin_count < 1 or nc < 0:
        raise ValueError(f"bin decode: {no} columns do not hold {bin_count} bins per value")
    if form not in FORMS or (form == "tma" and form_for(preds, bin_count) != "tma"):
        raise ValueError(f"bin decode: form {form!r} does not take these head maps")
    rows = sum(p.shape[1] * p.shape[2] * p.shape[3] for p in preds)
    out = torch.empty((bs, rows, 5 + nc), device=p0.device, dtype=torch.float32)
    lib = _build.library("bin_decode")
    stream = torch.cuda.current_stream(p0.device).cuda_stream
    table = level_table(preds, anchors, strides, feature_units=False)
    if form == "tma":
        err = lib.decode_levels_bin_tma(len(table), *pack_levels(table), out.data_ptr(), bs, no,
                                        out.stride(0), bin_count, int(normalized), stream)
        _build.check(err, "decode_levels_bin_tma")
        count(decode_outputs_bin_cuda, int(out.numel() > 0))
        return out
    for p, lv in zip(preds, table):
        anchors_wh = (ctypes.c_float * len(lv.anchors))(*lv.anchors)
        err = lib.decode_level_bin(p.data_ptr(), out.data_ptr(), bs, lv.h, lv.w, lv.na, no,
                                   *p.stride(), out.stride(0), lv.row0, anchors_wh, bin_count,
                                   int(normalized), lv.stride, stream)
        _build.check(err, "decode_level_bin")
        count(decode_outputs_bin_cuda, 1)
    return out


decode_outputs_bin_cuda.launches = 0
