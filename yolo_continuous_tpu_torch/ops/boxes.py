"""Bounding-box math on torch tensors.

Counterpart of ``yolo_continuous_tpu/ops/boxes.py`` (``cvt_bbox``,
``box_area``, ``box_iou``). Boxes ride on the last axis, so every function
batches over leading axes.
"""
from __future__ import annotations

from enum import Enum

import torch


class CvtFlag(Enum):
    CVT_XXYY_XYXY = 0
    CVT_XXYY_XYWH = 1
    CVT_XYXY_XXYY = 2
    CVT_XYXY_XYWH = 3
    CVT_XYWH_XXYY = 4
    CVT_XYWH_XYXY = 5


def cvt_bbox(bbox: torch.Tensor, flag: CvtFlag) -> torch.Tensor:
    """Convert box format along the last axis. Mirrors ``utils/bbox.py:29-59``."""
    a, b, c, d = bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]
    if flag in (CvtFlag.CVT_XXYY_XYXY, CvtFlag.CVT_XYXY_XXYY):
        out = [a, c, b, d]
    elif flag == CvtFlag.CVT_XXYY_XYWH:
        w, h = b - a, d - c
        out = [a + w / 2, c + h / 2, w, h]
    elif flag == CvtFlag.CVT_XYXY_XYWH:
        w, h = c - a, d - b
        out = [a + w / 2, b + h / 2, w, h]
    elif flag == CvtFlag.CVT_XYWH_XXYY:
        out = [a - c / 2, a + c / 2, b - d / 2, b + d / 2]
    elif flag == CvtFlag.CVT_XYWH_XYXY:
        out = [a - c / 2, b - d / 2, a + c / 2, b + d / 2]
    else:  # pragma: no cover
        raise ValueError(f"bad flag {flag}")
    return torch.stack(out, dim=-1)


def box_area(box: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes along the last axis."""
    return (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])


def box_iou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes, ``(..., N, 4) x (..., M, 4) -> (..., N, M)``.

    No epsilon, as ``utils/bbox.py:62-72``: a pair of zero-area boxes gives
    0/0 = NaN, and NaN > threshold is false, so it never suppresses. The NMS
    kernels (``csrc/nms.cu``) evaluate this same formula in the same order.
    """
    area1 = box_area(box1)
    area2 = box_area(box2)
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:], box2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[..., :, None] + area2[..., None, :] - inter)
