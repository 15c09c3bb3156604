"""K1 and K2: class-aware greedy NMS keep-sets, on CUDA tensors.

Wrappers of ``csrc/nms.cu``, which replaces the TPU kernels of
``yolo_continuous_tpu/kernels/nms_pallas.py``: ``nms_suppress`` (K1) for
``pallas_suppress``, K <= 1024; ``nms_suppress_tiled`` (K2) for
``pallas_suppress_tiled``, K > 1024. Their plain PyTorch version is
``ops/nms.py::suppress_plain``; ``ops/nms.py::suppress`` sends CPU tensors
there and CUDA tensors here, split at K = 1024 as ``ops/nms.py:100-109``.

Both take a batch of score-sorted top-K candidates, one CTA per image:
boxes ``(B, K, 4)`` fp32 xyxy, classes ``(B, K)`` int32, valid ``(B, K)``
bool, and return keep ``(B, K)`` bool.
"""
from __future__ import annotations

import torch

from . import _build

K1_MAX = 1024   # K1 keeps a K x K bitmask in shared memory: 128 KB at 1024
K2_MAX = 8192   # K2 keeps K boxes in shared memory: 24 B each


def _check(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor, k_max: int, what: str):
    if boxes.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got {boxes.device}")
    if classes.device != boxes.device or valid.device != boxes.device:
        raise ValueError(f"{what}: boxes, classes and valid must share one device")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"{what}: boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    b, k = boxes.shape[:2]
    if tuple(classes.shape) != (b, k) or tuple(valid.shape) != (b, k):
        raise ValueError(f"{what}: classes and valid must be (B, K) = ({b}, {k})")
    if boxes.dtype != torch.float32 or classes.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"{what} takes float32 boxes, int32 classes and bool valid, got "
                         f"{boxes.dtype}, {classes.dtype}, {valid.dtype}")
    if not (boxes.is_contiguous() and classes.is_contiguous() and valid.is_contiguous()):
        raise ValueError(f"{what} takes contiguous tensors")
    if boxes.data_ptr() % 16:
        raise ValueError(f"{what}: boxes must be 16-byte aligned")
    if k > k_max:
        raise ValueError(f"{what} takes K <= {k_max}, got {k}")


def _launch(fn: str, boxes, classes, valid, iou_thres: float) -> torch.Tensor:
    keep = torch.empty(valid.shape, device=valid.device, dtype=torch.bool)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = getattr(_build.library("nms"), fn)(
        boxes.data_ptr(), classes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
        boxes.shape[0], boxes.shape[1], float(iou_thres), stream)
    _build.check(err, fn)
    return keep


def nms_suppress(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
                 iou_thres: float) -> torch.Tensor:
    """K1: bitmask in shared memory, one-warp greedy sweep (K <= 1024)."""
    _check(boxes, classes, valid, K1_MAX, "nms_suppress")
    keep = _launch("nms_suppress", boxes, classes, valid, iou_thres)
    nms_suppress.launches += int(boxes.numel() > 0)
    return keep


def nms_suppress_tiled(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
                       iou_thres: float) -> torch.Tensor:
    """K2: on-device fixpoint with IoUs recomputed per sweep (any K <= 8192)."""
    _check(boxes, classes, valid, K2_MAX, "nms_suppress_tiled")
    keep = _launch("nms_suppress_tiled", boxes, classes, valid, iou_thres)
    nms_suppress_tiled.launches += int(boxes.numel() > 0)
    return keep


nms_suppress.launches = 0
nms_suppress_tiled.launches = 0
