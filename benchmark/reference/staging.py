"""Plain staging of JPEG files onto letterboxed canvases, for the reference.

The training path stages each image as the JAX package's host library
``native/staging.cpp::stage_one`` does: a libjpeg decode (cv2, EXIF
orientation ignored), a bilinear resize in fp32 with that library's order of
operations, rounded half away from zero, centred on a canvas of ``fill``.
The serving path letterboxes as the upstream ``letter_box.py`` does (cv2's
linear resize, a border of 114). Both written from those descriptions; the
reference imports nothing of the port.
"""
from __future__ import annotations

from typing import Tuple

import cv2
import numpy as np
import torch


def decode_rgb(data: bytes) -> np.ndarray:
    """JPEG bytes -> (h, w, 3) RGB u8, as libjpeg decodes them."""
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if bgr is None:
        raise ValueError("undecodable image")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def geometry(iw: int, ih: int, size: int):
    """``(r, nw, nh, ox, oy)`` in fp32, as ``stage_one``."""
    f32 = np.float32
    r = min(f32(size) / f32(iw), f32(size) / f32(ih))
    nw, nh = max(int(f32(iw) * r), 1), max(int(f32(ih) * r), 1)
    return r, nw, nh, (size - nw) // 2, (size - nh) // 2


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(v)
    return t + (v - t >= 0.5).to(v.dtype)


def resize_bilinear(img: torch.Tensor, nw: int, nh: int) -> torch.Tensor:
    """(ih, iw, 3) u8 -> (nh, nw, 3) u8, pixel centres aligned, edges clamped."""
    ih, iw = img.shape[:2]
    f32, dev = torch.float32, img.device
    sx = torch.tensor(np.float32(iw) / np.float32(nw), dtype=f32, device=dev)
    sy = torch.tensor(np.float32(ih) / np.float32(nh), dtype=f32, device=dev)

    def axis(n, scale, limit):
        f = (torch.arange(n, dtype=f32, device=dev) + 0.5) * scale - 0.5
        i0 = torch.floor(f)
        w = f - i0
        i0 = i0.long()
        return i0.clamp(0, limit - 1), (i0 + 1).clamp(0, limit - 1), w

    y0, y1, wy = axis(nh, sy, ih)
    x0, x1, wx = axis(nw, sx, iw)
    src = img.to(f32)
    v00, v01 = src[y0][:, x0], src[y0][:, x1]
    v10, v11 = src[y1][:, x0], src[y1][:, x1]
    wy, wx = wy[:, None, None], wx[None, :, None]
    ay, ax = 1 - wy, 1 - wx
    v = v00 * ay * ax + v01 * ay * wx + v10 * wy * ax + v11 * wy * wx
    return _round_half_away(v).to(torch.uint8)


def stage(rgb: np.ndarray, size: int, fill: int = 128,
          device="cpu") -> Tuple[torch.Tensor, np.ndarray]:
    """One training canvas (size, size, 3) u8 and its meta [iw, ih, r, ox, oy]."""
    ih, iw = rgb.shape[:2]
    r, nw, nh, ox, oy = geometry(iw, ih, size)
    canvas = torch.full((size, size, 3), fill, dtype=torch.uint8, device=device)
    canvas[oy:oy + nh, ox:ox + nw] = resize_bilinear(torch.from_numpy(rgb).to(device), nw, nh)
    return canvas, np.array([iw, ih, r, ox, oy], np.float32)


def letterbox(rgb: np.ndarray, size: int, color=(114, 114, 114)) -> np.ndarray:
    """The serving letterbox: (size, size, 3) u8."""
    h0, w0 = rgb.shape[:2]
    r = min(size / w0, size / h0)
    nw, nh = int(round(w0 * r)), int(round(h0 * r))
    dw, dh = (size - nw) / 2, (size - nh) / 2
    img = rgb
    if (w0, h0) != (nw, nh):
        img = cv2.resize(rgb, (nw, nh), interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    return cv2.copyMakeBorder(img, top, bottom, left, right, cv2.BORDER_CONSTANT, value=color)
