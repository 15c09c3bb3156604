"""Detection evaluation: VOC AP@0.5 and COCO-style mAP@[.5:.95].

Counterpart of ``yolo_continuous_tpu/eval/evaluator.py`` (numpy only; the
port keeps its own copy). The reference has no mAP evaluation (its
validation is loss-only, ``train.py:104-112``); the JAX package added it.

Inputs are plain numpy: per-image detections (boxes xyxy, scores,
classes) and ground truths (boxes xyxy, classes). AP follows the
standard precision/recall integration (VOC2010+ "integral" AP, plus the
VOC2007 11-point variant for reference comparisons).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def average_precision(recall: np.ndarray, precision: np.ndarray,
                      eleven_point: bool = False) -> float:
    if eleven_point:  # VOC2007
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    # integral AP (VOC2010+/COCO-style on the PR envelope)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


@dataclass
class DetectionRecord:
    boxes: np.ndarray      # (n, 4) xyxy
    scores: np.ndarray     # (n,)
    classes: np.ndarray    # (n,)


@dataclass
class GroundTruthRecord:
    boxes: np.ndarray      # (m, 4) xyxy
    classes: np.ndarray    # (m,)


class MAPEvaluator:
    """Accumulate per-image results, then compute AP per class / mAP."""

    def __init__(self, num_classes: int):
        self.nc = num_classes
        self.dets: List[DetectionRecord] = []
        self.gts: List[GroundTruthRecord] = []

    def add(self, det: DetectionRecord, gt: GroundTruthRecord):
        self.dets.append(det)
        self.gts.append(gt)

    def ap_per_class(self, iou_thres: float = 0.5,
                     eleven_point: bool = False) -> np.ndarray:
        aps = np.full(self.nc, np.nan)
        for c in range(self.nc):
            scores, matched = [], []
            n_gt = 0
            for det, gt in zip(self.dets, self.gts):
                gmask = gt.classes == c
                gboxes = gt.boxes[gmask]
                n_gt += len(gboxes)
                dmask = det.classes == c
                dboxes = det.boxes[dmask]
                dscores = det.scores[dmask]
                order = np.argsort(-dscores)
                dboxes, dscores = dboxes[order], dscores[order]
                iou = _iou_matrix(dboxes, gboxes)
                taken = np.zeros(len(gboxes), bool)
                for i in range(len(dboxes)):
                    scores.append(dscores[i])
                    j = int(iou[i].argmax()) if len(gboxes) else -1
                    if j >= 0 and iou[i, j] >= iou_thres and not taken[j]:
                        taken[j] = True
                        matched.append(1)
                    else:
                        matched.append(0)
            if n_gt == 0:
                continue
            if not scores:
                aps[c] = 0.0
                continue
            order = np.argsort(-np.asarray(scores))
            m = np.asarray(matched)[order]
            tp = np.cumsum(m)
            fp = np.cumsum(1 - m)
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1e-9)
            aps[c] = average_precision(recall, precision, eleven_point)
        return aps

    def map50(self, eleven_point: bool = False) -> float:
        aps = self.ap_per_class(0.5, eleven_point)
        return float(np.nanmean(aps)) if np.isfinite(aps).any() else 0.0

    def map50_95(self) -> float:
        vals = []
        for t in np.arange(0.5, 1.0, 0.05):
            aps = self.ap_per_class(float(t))
            if np.isfinite(aps).any():
                vals.append(np.nanmean(aps))
        return float(np.mean(vals)) if vals else 0.0

    def summary(self) -> Dict[str, float]:
        return {"mAP@0.5": self.map50(), "mAP@0.5:0.95": self.map50_95()}
