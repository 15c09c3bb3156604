"""Bounding-box math on torch tensors.

Counterpart of ``yolo_continuous_tpu/ops/boxes.py`` (``cvt_bbox``,
``box_area``, ``box_iou``, ``bbox_iou``, ``make_grid``). Boxes ride on the
last axis, so every function batches over leading axes.
"""
from __future__ import annotations

import math
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


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, x1y1x2y2: bool = True,
             giou: bool = False, diou: bool = False, ciou: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU (or GIoU/DIoU/CIoU) of broadcast-compatible boxes,
    ``utils/bbox.py:75-118`` as the JAX ``bbox_iou``: the same epsilon
    placement (``h + eps`` only) and CIoU's alpha without gradient."""
    if x1y1x2y2:
        b1_x1, b1_y1, b1_x2, b1_y2 = (box1[..., i] for i in range(4))
        b2_x1, b2_y1, b2_x2, b2_y2 = (box2[..., i] for i in range(4))
    else:  # xywh -> xyxy
        b1_x1, b1_x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
        b1_y1, b1_y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
        b2_x1, b2_x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
        b2_y1, b2_y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2

    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0) * \
            (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0)

    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    if not (giou or diou or ciou):
        return iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if ciou or diou:
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 +
                (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
        if diou:
            return iou - rho2 / c2
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        alpha = (v / (v - iou + (1 + eps))).detach()
        return iou - (rho2 / c2 + v * alpha)
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area


def make_grid(nx: int = 20, ny: int = 20) -> torch.Tensor:
    """``(1, 1, ny, nx, 2)`` grid of (x, y) cell indices, ``utils/bbox.py:201-204``."""
    yv, xv = torch.meshgrid(torch.arange(ny), torch.arange(nx), indexing="ij")
    return torch.stack((xv, yv), 2).reshape(1, 1, ny, nx, 2).float()
