"""Host-side image preparation: the train pipeline's staging letterbox and
the predict path's letterbox (counterpart of
``yolo_continuous_tpu/ops/preprocess.py``).

Host-side numpy + OpenCV, as in the JAX package. ``stage_image`` puts a
decoded training image, centred, on a fixed gray (128) canvas and keeps
where it sits (``StagingMeta``), so the device augmentation
(``ops/augment.py``) can warp back through the original frame;
``letterbox`` serves ``predict`` and ``eval/validate``. Each resizes as the
JAX function does: ``stage_image`` with ``INTER_CUBIC``, ``letterbox`` with
``INTER_LINEAR``. ``prepare_test_image`` is the reference's ``detect.py``
input, BGR as it reads it (the ``Detector`` takes RGB).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - only the image paths need it
    cv2 = None


@dataclass
class StagingMeta:
    """How an original image sits inside its staging canvas."""
    iw: int       # original width
    ih: int       # original height
    scale: float  # r0 = min(S/iw, S/ih)
    ox: float     # x offset of the image inside the canvas
    oy: float     # y offset


def _need_cv2(what: str) -> None:
    if cv2 is None:
        raise RuntimeError(f"{what} needs OpenCV (cv2)")


def letterbox(img: np.ndarray, new_shape=(640, 640), color=(114, 114, 114),
              scale_fill: bool = False) -> Tuple[np.ndarray, Tuple[float, float],
                                                 Tuple[float, float]]:
    """Classic letterbox; mirrors image_enhance/letter_box.py:27-58.

    Returns (image, ratio (rx, ry), (dw, dh)); boxes map as
    ``x' = x * rx + dw``, ``y' = y * ry + dh``.
    """
    _need_cv2("letterbox")
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


def letterbox_boxes(boxes_xyxy: np.ndarray, ratio, offset) -> np.ndarray:
    """Apply the letterbox box remap (letter_box.py:56-58)."""
    out = np.array(boxes_xyxy, np.float32, copy=True)
    if out.size:
        out[:, [0, 2]] = out[:, [0, 2]] * ratio[0] + offset[0]
        out[:, [1, 3]] = out[:, [1, 3]] * ratio[1] + offset[1]
    return out


def stage_image(img_rgb: np.ndarray, size: int = 640,
                fill: int = 128) -> Tuple[np.ndarray, StagingMeta]:
    """Center-letterbox to the staging canvas (train-pipeline host step).

    Matches the geometry of yolo_dataset_git.py:118-131 (centered, gray
    128) but keeps the canvas + placement metadata so the device graph can
    warp back through the original frame.
    """
    _need_cv2("stage_image")
    ih, iw = img_rgb.shape[:2]
    r = min(size / iw, size / ih)
    nw, nh = int(iw * r), int(ih * r)
    ox, oy = (size - nw) // 2, (size - nh) // 2
    canvas = np.full((size, size, 3), fill, np.uint8)
    resized = cv2.resize(img_rgb, (nw, nh), interpolation=cv2.INTER_CUBIC)
    canvas[oy:oy + nh, ox:ox + nw] = resized
    return canvas, StagingMeta(iw=iw, ih=ih, scale=r, ox=float(ox), oy=float(oy))


def prepare_test_image(image_path: str, target_size=(640, 640)):
    """The reference's ``detect.py:16-26`` input: ``cv2.imread`` (BGR),
    ``letterbox`` with fill 114 and no stretch, /255 -> ((1, H, W, 3) fp32
    BGR, the image as read)."""
    _need_cv2("prepare_test_image")
    image = cv2.imread(image_path)
    if image is None:
        raise FileNotFoundError(image_path)
    img, _, _ = letterbox(image, target_size, color=(114, 114, 114), scale_fill=False)
    return (np.asarray(img, np.float32) / 255.0)[None], image
