"""Dataset-level validation: batched inference -> mAP.

Counterpart of ``yolo_continuous_tpu/eval/validate.py`` (``validate.py:30-75``).
Drives the port's ``Detector`` over a val index file in fixed-size batches
(the last one padded, so every call has one shape), un-maps the
letterboxed boxes to original pixels and feeds the numpy evaluator. On
CUDA each batch runs the decode kernel K3 and the NMS kernel K1 (max_det
300); the detections come to the host once a batch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config.plan import TrainPlan
from ..data.dataset import Annotation, _read_rgb, load_annotation_file
from ..detect_api import Detector
from ..ops.nms import yolo_correct_boxes_np
from ..ops.preprocess import letterbox
from .evaluator import DetectionRecord, GroundTruthRecord, MAPEvaluator


def validate(plan: TrainPlan, detector: Optional[Detector] = None,
             annotations: Optional[Sequence[Annotation]] = None,
             conf_thres: float = 0.01, nms_thres: float = 0.4,
             max_det: int = 300, max_images: Optional[int] = None,
             log=print, device="cuda") -> dict:
    """mAP over ``plan.val_indexes`` (or ``annotations``) ->
    ``{"mAP@0.5", "mAP@0.5:0.95"}``. Without a ``detector``, the plan's
    ``Detector`` on ``device``."""
    det = detector or Detector(plan, device=device)
    anns = annotations if annotations is not None else \
        load_annotation_file(plan.val_indexes)
    if max_images:
        anns = anns[:max_images]
    size = (plan.image_size, plan.image_size)
    ev = MAPEvaluator(plan.num_labels)

    batch = max(int(plan.batch_size), 1)
    for start in range(0, len(anns), batch):
        chunk = anns[start:start + batch]
        imgs, shapes = [], []
        for ann in chunk:
            rgb = _read_rgb(ann.path)
            imgs.append(letterbox(rgb, size, (114, 114, 114))[0])
            shapes.append(rgb.shape[:2])
        # pad the final partial batch so every call has the same shape
        imgs += [imgs[-1]] * (batch - len(chunk))
        images = torch.from_numpy(np.stack(imgs)).to(det.device).float() / 255.0
        boxes, scores, classes, valid = (t.cpu().numpy() for t in
                                         det(images, conf_thres, nms_thres, max_det))
        mapped = yolo_correct_boxes_np(boxes[:len(chunk)], size, np.array(shapes))  # y1x1y2x2
        for i, ann in enumerate(chunk):
            m = valid[i]
            xyxy = mapped[i][:, [1, 0, 3, 2]]
            ev.add(DetectionRecord(xyxy[m], scores[i][m], classes[i][m]),
                   GroundTruthRecord(ann.boxes[:, :4], ann.boxes[:, 4].astype(np.int32)))
    summary = ev.summary()
    log(" ".join(f"{k}={v:.4f}" for k, v in summary.items()))
    return summary
