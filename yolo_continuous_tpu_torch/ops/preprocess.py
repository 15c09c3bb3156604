"""Predict-path letterbox (counterpart of ``yolo_continuous_tpu/ops/preprocess.py``).

Host-side numpy + OpenCV, as in the JAX package; only ``predict`` calls it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - only predict() needs it
    cv2 = None


def letterbox(img: np.ndarray, new_shape=(640, 640), color=(114, 114, 114),
              scale_fill: bool = False) -> Tuple[np.ndarray, Tuple[float, float],
                                                 Tuple[float, float]]:
    """Classic letterbox; mirrors image_enhance/letter_box.py:27-58.

    Returns (image, ratio (rx, ry), (dw, dh)); boxes map as
    ``x' = x * rx + dw``, ``y' = y * ry + dh``.
    """
    if cv2 is None:
        raise RuntimeError("letterbox needs OpenCV (cv2)")
    h0, w0 = img.shape[:2]
    new_w, new_h = (new_shape, new_shape) if isinstance(new_shape, int) else new_shape
    if scale_fill:
        img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        return img, (new_w / w0, new_h / h0), (0.0, 0.0)
    r = min(new_w / w0, new_h / h0)
    nw, nh = int(round(w0 * r)), int(round(h0 * r))
    dw, dh = (new_w - nw) / 2, (new_h - nh) / 2
    if (w0, h0) != (nw, nh):
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right,
                             cv2.BORDER_CONSTANT, value=color)
    return img, (r, r), (dw, dh)
