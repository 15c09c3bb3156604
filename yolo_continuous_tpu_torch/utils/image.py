"""Image layout / resize helpers (counterpart of ``yolo_continuous_tpu/utils/image.py``).

Parity target: ``utils/helper_cv.py`` —
- ``hwc_to_chw`` / ``chw_to_hwc`` (``cvt_for_transform`` / ``cvt_for_cv``,
  ``:12-26``),
- ``resize_by_largeborder`` (``:31-39``),
- ``resize_and_padding`` (``:42-57``; the reference forgets the ``return``,
  fixed here as in the JAX package),
- ``generate_colors`` lives in ``detect_api`` next to its consumer.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def hwc_to_chw(image: np.ndarray) -> np.ndarray:
    """[H,W,C] -> [C,H,W]; helper_cv.py:12-18."""
    return np.transpose(image, (2, 0, 1))


def chw_to_hwc(image: np.ndarray) -> np.ndarray:
    """[C,H,W] -> [H,W,C]; helper_cv.py:21-28."""
    return np.transpose(image, (1, 2, 0))


def resize_by_largeborder(img: np.ndarray, target_size: int) -> np.ndarray:
    """Scale so the longest side hits target_size; helper_cv.py:31-39."""
    large = max(img.shape)
    h, w = img.shape[:2]
    f = target_size / large
    return cv2.resize(img, (int(w * f), int(h * f)), interpolation=cv2.INTER_AREA)


def resize_and_padding(image: np.ndarray, new_shape) -> np.ndarray:
    """Aspect-preserving resize into a zero-padded canvas (centred)."""
    new_shape = tuple(new_shape)
    imgh, imgw = image.shape[:2]
    h, w = new_shape
    f = min(w / imgw, h / imgh)
    neww, newh = int(imgw * f), int(imgh * f)
    if image.ndim == 2:
        canvas = np.zeros(new_shape, image.dtype)
    else:
        canvas = np.zeros(new_shape + (image.shape[2],), image.dtype)
    oh, ow = (h - newh) // 2, (w - neww) // 2
    resized = cv2.resize(image, (neww, newh), interpolation=cv2.INTER_NEAREST)
    canvas[oh:oh + newh, ow:ow + neww] = resized
    return canvas
