"""Plain detection post-processing: Detect decode, class-aware NMS, and the
letterbox inverse, written from upstream ``detect.py`` / ``utils/general.py``
(scores are objectness times the best class; boxes xywh -> xyxy; greedy NMS
per class over the top ``max_det`` candidates by score)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def decode(maps: Sequence[torch.Tensor], anchors, strides) -> torch.Tensor:
    """Raw maps ``(bs, h, w, na, no)`` -> rows ``(bs, N, no)``: box xywh as
    fractions of the input, then sigmoid objectness and class scores."""
    out = []
    for p, anc, s in zip(maps, anchors, strides):
        bs, h, w, na, no = p.shape
        y = torch.sigmoid(p.float())
        gy, gx = torch.meshgrid(torch.arange(h, device=p.device, dtype=torch.float32),
                                torch.arange(w, device=p.device, dtype=torch.float32),
                                indexing="ij")
        a = torch.tensor(anc, dtype=torch.float32, device=p.device) / s
        bx = (y[..., 0] * 2 - 0.5 + gx[None, :, :, None]) / w
        by = (y[..., 1] * 2 - 0.5 + gy[None, :, :, None]) / h
        bw = (y[..., 2] * 2) ** 2 * a[:, 0] / w
        bh = (y[..., 3] * 2) ** 2 * a[:, 1] / h
        rows = torch.cat([torch.stack([bx, by, bw, bh], -1), y[..., 4:]], -1)
        out.append(rows.reshape(bs, h * w * na, no))
    return torch.cat(out, 1)


def candidates(rows: torch.Tensor):
    """Every row as (boxes xyxy, score, class): ``(bs, N, 4)``, ``(bs, N)``,
    ``(bs, N)``."""
    conf, cls = rows[..., 5:].max(-1)
    score = rows[..., 4] * conf
    xy, wh = rows[..., :2], rows[..., 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2], -1), score, cls


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, 4) x (..., m, 4) xyxy -> (..., n, m)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def nms(rows: torch.Tensor, conf: float, iou: float, max_det: int):
    """The kept detections of each image: a list of (boxes xyxy (k, 4),
    scores (k,), classes (k,)), score-ordered."""
    boxes, score, cls = candidates(rows)
    out = []
    for b in range(rows.shape[0]):
        s = torch.where(score[b] >= conf, score[b], torch.full_like(score[b], -1.0))
        top_s, top_i = torch.topk(s, min(max_det, s.shape[0]))
        ok = top_s > 0
        bx, sc, cl = boxes[b][top_i][ok], top_s[ok], cls[b][top_i][ok]
        over = ((box_iou(bx, bx) > iou) & (cl[:, None] == cl[None, :])).cpu().numpy()
        keep_np = np.ones(len(sc), bool)
        for i in range(len(sc)):
            if keep_np[i]:
                keep_np[i + 1:] &= ~over[i, i + 1:]
        keep = torch.from_numpy(keep_np).to(rows.device)
        out.append((bx[keep], sc[keep], cl[keep]))
    return out


def unletterbox(boxes_xyxy: np.ndarray, size: int, shape) -> np.ndarray:
    """Fractions of the letterboxed input -> original-image pixels (x1, y1, x2,
    y2) of an image of ``shape`` (h, w)."""
    h, w = float(shape[0]), float(shape[1])
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    ox, oy = (size - nw) / 2 / size, (size - nh) / 2 / size
    b = np.asarray(boxes_xyxy, np.float64).copy()
    b[:, [0, 2]] = (b[:, [0, 2]] - ox) * size / nw * w
    b[:, [1, 3]] = (b[:, [1, 3]] - oy) * size / nh * h
    return b
