"""K1 and K2: class-aware greedy NMS keep-sets, on CUDA tensors.

Wrappers of ``csrc/nms.cu``, which replaces the TPU kernels of
``yolo_continuous_tpu/kernels/nms_pallas.py``: ``nms_suppress`` (K1) for
``pallas_suppress``, K <= 1024; ``nms_suppress_tiled`` (K2) for
``pallas_suppress_tiled``, K > 1024. Their plain PyTorch version is
``ops/nms.py::suppress_plain``; ``ops/nms.py::suppress`` sends CPU tensors
there and CUDA tensors here, split at K = 1024 as ``ops/nms.py:100-109``.

Both take a batch of score-sorted top-K candidates: boxes ``(B, K, 4)``
fp32 xyxy, classes ``(B, K)`` int32, valid ``(B, K)`` bool, and return keep
``(B, K)`` bool. K1 runs one CTA per image; K2 first builds the suppression
bitmask across all SMs into a scratch tensor that its wrapper allocates,
then sweeps it with one CTA per image.
"""
from __future__ import annotations

import torch

from . import _build

K1_MAX = 1024   # K1 keeps a K x K bitmask in shared memory: 128 KB at 1024
K2_MAX = 8192   # K2's sweep: 1 KB of keep words, 192 KB of mask rows; its mask is 8 MB an image


def mask_words(k: int) -> int:
    """uint32 words of one row of K2's mask: ceil(K/32), rounded up to 4
    (``csrc/nms.cu::mask_stride``)."""
    return ((k + 31) // 32 + 3) // 4 * 4


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


def _launch(fn: str, boxes, classes, valid, iou_thres: float, scratch=None) -> torch.Tensor:
    """One C entry point of ``csrc/nms.cu``; K2's take the mask ``scratch``."""
    keep = torch.empty(valid.shape, device=valid.device, dtype=torch.bool)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    ptrs = (boxes.data_ptr(), classes.data_ptr(), valid.data_ptr(), keep.data_ptr())
    if scratch is not None:
        ptrs += (scratch.data_ptr(), scratch.numel() * scratch.element_size())
    err = getattr(_build.library("nms"), fn)(*ptrs, boxes.shape[0], boxes.shape[1],
                                             float(iou_thres), stream)
    _build.check(err, fn)
    return keep


def tiled_scratch(boxes: torch.Tensor) -> torch.Tensor:
    """K2's mask: (B, K, mask_words(K)) uint32 words (as int32), 32 MB at
    K = 4096 x 16 images and 128 MB at K2_MAX x 16."""
    b, k = boxes.shape[:2]
    return torch.empty((b, k, mask_words(k)), device=boxes.device, dtype=torch.int32)


def nms_suppress(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
                 iou_thres: float) -> torch.Tensor:
    """K1: bitmask in shared memory, one-warp greedy sweep (K <= 1024)."""
    _check(boxes, classes, valid, K1_MAX, "nms_suppress")
    keep = _launch("nms_suppress", boxes, classes, valid, iou_thres)
    nms_suppress.launches += int(boxes.numel() > 0)
    return keep


def nms_suppress_tiled(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
                       iou_thres: float) -> torch.Tensor:
    """K2: the bitmask across all SMs, then a sweep of it, one CTA per image
    (any K <= 8192)."""
    _check(boxes, classes, valid, K2_MAX, "nms_suppress_tiled")
    keep = _launch("nms_suppress_tiled", boxes, classes, valid, iou_thres,
                   scratch=tiled_scratch(boxes))
    nms_suppress_tiled.launches += int(boxes.numel() > 0)
    return keep


nms_suppress.launches = 0
nms_suppress_tiled.launches = 0
