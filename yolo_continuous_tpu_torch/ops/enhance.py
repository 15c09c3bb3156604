"""Image-enhance ops (counterpart of ``yolo_continuous_tpu/ops/enhance.py``).

The reference's ``image_enhance/`` layer as batched tensor ops on the
device: ``letter_box`` (letter_box.py:27-58, with the probabilistic
``scale_fill``), ``random_hsv`` (augment_hsv.py:16-27), ``random_flip``
(random_flip.py:20-37), ``equalize`` / ``random_equalize`` (torchvision's
``RandomEqualize`` as ``main/enhance_package.py:30`` uses it, bit-exact to
PIL's algorithm), ``random_perspective`` (random_perspective.py:27-101) with
``box_candidates``, and ``EnhancePackage`` (main/enhance_package.py:12-53),
the chain equalize -> hsv -> flip -> (perspective) -> letter_box.
``ops/augment._post_enhance`` runs the flip, equalize and perspective on the
train path when the plan enables them.

As in ``ops/augment.py``, each op has a draw step (an explicit
``torch.Generator`` on the CPU, a small record of parameters) and an apply
step that is deterministic given the draw. Ops take batched float images
(B, H, W, 3) in 0..255 and xyxy pixel boxes (B, MB, >=4) with a validity
mask (B, MB).

The perspective matrix, its inverse and the rotation scale ``sqrt|det|``
are computed in the draw step, in fp64 on the host from the 8 fp32
uniforms of a sample (JAX draws them in that order, ``split(key, 8)``, and
composes them in fp32), and reach the device rounded to fp32, so a card and
the CPU apply the same matrices. The warp is an inverse-map bilinear gather,
``map_coordinates(order=1, mode="constant", cval=114)`` of JAX:
``F.grid_sample`` of ``img - 114`` with zero padding, plus 114, gives the
same blend with the fill where a neighbour falls outside; pixels whose
source lies outside [-0.5, size - 0.5] take the fill.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

FILL = 114.0   # random_perspective.py / letter_box.py border colour


class PerspectiveCfg(NamedTuple):
    degrees: float = 10.0
    translate: float = 0.1
    scale: float = 0.1
    shear: float = 10.0
    perspective: float = 0.0


class PerspectiveDraw(NamedTuple):
    """The perspective of B samples: the forward matrix (boxes), its inverse
    (the warp's source map) and the rotation scale (``box_candidates``)."""
    matrix: torch.Tensor    # (B, 3, 3) fp32
    inverse: torch.Tensor   # (B, 3, 3) fp32
    scale: torch.Tensor     # (B,) fp32, sqrt|det(matrix[:2, :2])|


class EnhanceDraw(NamedTuple):
    """Draws of the enhance ops for B samples."""
    flip_lr: torch.Tensor    # (B,) bool
    flip_ud: torch.Tensor    # (B,) bool
    equalize: torch.Tensor   # (B,) bool
    perspective: Optional[PerspectiveDraw] = None


def draw_enhance(gen: torch.Generator, B: int, flip_lr: float, flip_ud: float,
                 equalize: float) -> EnhanceDraw:
    """Each op fires where a unit draw falls under its probability."""
    u = torch.rand((3, B), generator=gen, dtype=torch.float32, device=gen.device)
    return EnhanceDraw(u[0] < flip_lr, u[1] < flip_ud, u[2] < equalize)


# ---------------------------------------------------------------------------
# RandomPerspective
# ---------------------------------------------------------------------------

def perspective_ranges(cfg: PerspectiveCfg):
    """(lo, hi) of the 8 uniforms of ``_perspective_matrix``, in JAX's key
    order (random_perspective.py:40-66): the perspective terms x and y, the
    angle in degrees, the scale (note the 1.1, :53), the shears x and y in
    degrees, the translations x and y as fractions of the width and height."""
    p, d, s, sh, t = cfg.perspective, cfg.degrees, cfg.scale, cfg.shear, cfg.translate
    return [(-p, p), (-p, p), (-d, d), (1 - s, 1.1 + s), (-sh, sh), (-sh, sh),
            (0.5 - t, 0.5 + t), (0.5 - t, 0.5 + t)]


def perspective_from_uniforms(values: torch.Tensor, h: int, w: int) -> PerspectiveDraw:
    """The draw of the 8 uniforms ``values`` (B, 8) of an h x w image:
    center @ perspective @ rotation/scale @ shear @ translation composed as
    ``trans @ shear @ rot @ pers @ center`` (random_perspective.py:40-66), in
    fp64, then rounded to fp32."""
    v = values.detach().cpu().double().numpy()
    B = v.shape[0]
    eye = np.broadcast_to(np.eye(3), (B, 3, 3))
    center, pers, rot, shear, trans = (eye.copy() for _ in range(5))
    center[:, 0, 2], center[:, 1, 2] = -w / 2.0, -h / 2.0
    pers[:, 2, 0], pers[:, 2, 1] = v[:, 0], v[:, 1]
    a = v[:, 2] * math.pi / 180.0
    cos_a, sin_a = np.cos(a) * v[:, 3], np.sin(a) * v[:, 3]
    # cv2.getRotationMatrix2D(center=(0, 0), angle, scale) convention
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = cos_a, sin_a, -sin_a, cos_a
    shear[:, 0, 1] = np.tan(v[:, 4] * math.pi / 180.0)
    shear[:, 1, 0] = np.tan(v[:, 5] * math.pi / 180.0)
    trans[:, 0, 2], trans[:, 1, 2] = v[:, 6] * w, v[:, 7] * h
    m = trans @ shear @ rot @ pers @ center
    scale = np.sqrt(np.abs(np.linalg.det(m[:, :2, :2])))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return PerspectiveDraw(f32(m), f32(np.linalg.inv(m)), f32(scale))


def draw_perspective(gen: torch.Generator, B: int, h: int, w: int,
                     cfg: PerspectiveCfg) -> PerspectiveDraw:
    """8 uniforms a sample (``perspective_ranges``, each mapped from a unit
    draw as ``augment.uniform`` does), then ``perspective_from_uniforms``."""
    u = torch.rand((B, 8), generator=gen, dtype=torch.float32, device=gen.device)
    lo, hi = (torch.tensor(r, dtype=torch.float32) for r in zip(*perspective_ranges(cfg)))
    return perspective_from_uniforms(torch.maximum(u.cpu() * (hi - lo) + lo, lo), h, w)


def warp_image(img: torch.Tensor, inverse: torch.Tensor, fill: float = FILL) -> torch.Tensor:
    """Inverse-map bilinear warp of (B, H, W, C) images: ``out(p) =
    img(M^-1 p)``, JAX ``_warp_image``. A neighbour outside the image blends
    in as ``fill``; a pixel whose source lies outside [-0.5, W - 0.5] x
    [-0.5, H - 0.5] is ``fill``."""
    B, H, W, C = img.shape
    inv = inverse.to(img.device, torch.float32)
    yy = torch.arange(H, dtype=torch.float32, device=img.device)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=img.device)[None, None, :]

    def row(i):
        return (inv[:, i, 0, None, None] * xx + inv[:, i, 1, None, None] * yy
                + inv[:, i, 2, None, None])
    z = row(2)
    sx, sy = row(0) / z, row(1) / z                                         # (B, H, W)
    inside = (sx >= -0.5) & (sx <= W - 0.5) & (sy >= -0.5) & (sy <= H - 0.5)
    # grid_sample's align_corners=True maps -1..1 onto the pixel centres 0..size-1
    grid = torch.stack([sx * (2.0 / max(W - 1, 1)) - 1.0, sy * (2.0 / max(H - 1, 1)) - 1.0], -1)
    out = F.grid_sample((img - fill).permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True) + fill
    return torch.where(inside[..., None], out.permute(0, 2, 3, 1), fill)


def box_candidates(box1, box2, wh_thr=2.0, ar_thr=20.0, area_thr=0.1, eps=1e-16):
    """Area/aspect survivor filter; random_perspective.py:95-101.
    box1/box2: (..., 4) xyxy before and after the transform."""
    w1 = box1[..., 2] - box1[..., 0]
    h1 = box1[..., 3] - box1[..., 1]
    w2 = box2[..., 2] - box2[..., 0]
    h2 = box2[..., 3] - box2[..., 1]
    ar = torch.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def random_perspective(p: PerspectiveDraw, img, boxes, mask, perspective: float = 0.0):
    """Random perspective/affine of a batch (random_perspective.py:27-101):
    the image warped, each box's 4 corners transformed (divided by the third
    coordinate only when ``perspective`` is nonzero), clipped to the image,
    and kept where ``box_candidates`` passes against the original scaled by
    the draw's rotation scale (:91-92). Trailing box fields ride along."""
    h, w = img.shape[1], img.shape[2]
    out = warp_image(img, p.inverse)
    m = p.matrix.to(boxes.device, torch.float32)[:, :, :, None, None]     # (B, 3, 3, 1, 1)
    x1, y1, x2, y2 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    cx = torch.stack([x1, x2, x1, x2], -1)                                  # (B, MB, 4) corners
    cy = torch.stack([y1, y2, y2, y1], -1)

    def row(i):   # products and sums as separate ops: the same bits on every device
        return m[:, i, 0] * cx + m[:, i, 1] * cy + m[:, i, 2]
    x, y = row(0), row(1)
    if perspective != 0.0:
        z = row(2)
        x, y = x / z, y / z
    new = torch.stack([x.amin(2).clamp(0, w), y.amin(2).clamp(0, h),
                       x.amax(2).clamp(0, w), y.amax(2).clamp(0, h)], -1)
    new = torch.cat([new, boxes[..., 4:]], -1)
    s = p.scale.to(boxes.device, torch.float32)[:, None, None]
    keep = box_candidates(boxes[..., :4] * s, new[..., :4], area_thr=0.10)
    return out, new, mask & keep


# ---------------------------------------------------------------------------
# LetterBox, RandomHSV, RandomEqualize, RandomFlip
# ---------------------------------------------------------------------------

def letter_box(stretch: torch.Tensor, img, boxes, mask, new_shape: int = 640,
               color: float = FILL):
    """Aspect-preserving resize and centred pad to new_shape x new_shape, or a
    full stretch where ``stretch`` (B,) is set (the reference's probabilistic
    ``scale_fill``, letter_box.py:27-58), as JAX's device ``letter_box``: one
    antialiased linear warp (``augment.warp_canvas``) with ``color`` fill."""
    from .augment import warp_canvas
    h0, w0 = img.shape[1], img.shape[2]
    s = float(new_shape)
    r = min(s / w0, s / h0)
    dev = img.device
    stretch = stretch.to(dev)

    def pick(a: float, b: float) -> torch.Tensor:
        return torch.where(stretch, torch.tensor(a, dtype=torch.float32, device=dev),
                           torch.tensor(b, dtype=torch.float32, device=dev))
    kx, ky = pick(s / w0, r), pick(s / h0, r)
    tx, ty = pick(0.0, (s - w0 * r) / 2.0), pick(0.0, (s - h0 * r) / 2.0)
    out = warp_canvas(img, ky, kx, ty, tx, new_shape, fill=color)
    kx, ky, tx, ty = (v[:, None] for v in (kx, ky, tx, ty))
    nb = torch.stack([boxes[..., 0] * kx + tx, boxes[..., 1] * ky + ty,
                      boxes[..., 2] * kx + tx, boxes[..., 3] * ky + ty], -1)
    return out, torch.cat([nb, boxes[..., 4:]], -1), mask


def random_hsv(u: torch.Tensor, img, boxes, mask, hgain=0.015, sgain=0.7, vgain=0.4):
    """Per-image HSV gain jitter (augment_hsv.py:16-27), gains
    ``u * (hgain, sgain, vgain) + 1`` from the draws u (B, 3) in U(-1, 1);
    boxes unchanged."""
    from .augment import random_hsv as hsv
    return hsv(u, img, hgain, sgain, vgain), boxes, mask


def equalize(img: torch.Tensor) -> torch.Tensor:
    """Per-channel histogram equalization of (B, H, W, C) images, in the
    integer math of PIL's algorithm (JAX ``enhance.equalize``): per channel
    ``step = (total - last_nonzero_count) // 255`` and
    ``lut[i] = (step // 2 + sum_{j<i} hist[j]) // step``, the identity where
    ``step == 0``; values rounded half to even first."""
    B, H, W, C = img.shape
    q = torch.clamp(torch.round(img), 0, 255).long()
    flat = q.permute(0, 3, 1, 2).reshape(B * C, H * W)                      # (B*C, HW)
    hist = torch.zeros(B * C, 256, dtype=torch.long, device=img.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    bins = torch.arange(256, device=img.device)
    last = torch.where(hist > 0, bins, 0).amax(1, keepdim=True)              # last nonzero bin
    step = (hist.sum(1, keepdim=True) - torch.gather(hist, 1, last)) // 255
    cum_before = torch.cumsum(hist, 1) - hist
    lut = torch.clamp((step // 2 + cum_before) // torch.clamp(step, min=1), 0, 255)
    out = torch.where(step == 0, flat, torch.gather(lut, 1, flat))
    return out.reshape(B, C, H, W).permute(0, 2, 3, 1).float()


def random_equalize(do: torch.Tensor, img, boxes, mask):
    """``equalize`` where ``do`` (B,) is set; boxes unchanged."""
    return torch.where(do[:, None, None, None], equalize(img), img), boxes, mask


def random_flip(p: EnhanceDraw, img, boxes, mask):
    """LR/UD flips with box remap (random_flip.py:20-37), where the draw
    ``p`` sets them."""
    h, w = img.shape[1], img.shape[2]
    lr, ud = p.flip_lr, p.flip_ud
    img = torch.where(lr[:, None, None, None], img.flip(2), img)
    img = torch.where(ud[:, None, None, None], img.flip(1), img)
    x1, y1, x2, y2 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    lr, ud = lr[:, None], ud[:, None]
    nb = torch.stack([torch.where(lr, w - x2, x1), torch.where(ud, h - y2, y1),
                      torch.where(lr, w - x1, x2), torch.where(ud, h - y1, y2)], -1)
    return img, torch.cat([nb, boxes[..., 4:]], -1), mask


# ---------------------------------------------------------------------------
# EnhancePackage
# ---------------------------------------------------------------------------

class PackageDraw(NamedTuple):
    """Every draw of one ``EnhancePackage`` call on B images."""
    enhance: EnhanceDraw      # flips, equalize and (use_perspective) the perspective
    hsv: torch.Tensor         # (B, 3) U(-1, 1)
    stretch: torch.Tensor     # (B,) bool, letter_box's scale_fill

    def to(self, device) -> "PackageDraw":
        """The record on ``device``, every tensor of it in one copy."""
        from .augment import to_record_device
        return to_record_device(self, device)


class EnhancePackage:
    """Config-driven pipeline of an enhance YAML dict (main/enhance_package.py:12-53):
    equalize -> hsv -> flip -> letter_box, with the perspective before the
    letter box when ``use_perspective`` is set (the reference builds that op
    but never inserts it, :32-35; opt-in, as in JAX). ``draw`` makes a
    call's parameters, ``__call__`` applies them; ``enhance=False`` runs the
    letter box alone."""

    def __init__(self, target_shape, enhance_cfg: dict, use_perspective: bool = False):
        self.size = target_shape if isinstance(target_shape, int) else target_shape[0]
        self.cfg = dict(enhance_cfg)
        self.use_perspective = use_perspective

    def draw(self, gen: torch.Generator, B: int, h: int, w: int) -> PackageDraw:
        """The parameters of one call on B images of h x w."""
        c = self.cfg
        e = draw_enhance(gen, B, c.get("flip_lr", 0.5), c.get("flip_ud", 0.5),
                         c.get("equalize", 0.0))
        if self.use_perspective:
            pcfg = PerspectiveCfg(c.get("degrees", 10.0), c.get("translate", 0.1),
                                  c.get("scale", 0.1), c.get("shear", 10.0),
                                  c.get("perspective", 0.0))
            e = e._replace(perspective=draw_perspective(gen, B, h, w, pcfg))
        from .augment import uniform
        hsv = uniform(gen, (B, 3), -1.0, 1.0)
        return PackageDraw(e, hsv, uniform(gen, (B,), 0.0, 1.0) < c.get("scale_fill", 1.0))

    def __call__(self, p: PackageDraw, img, boxes, mask, enhance: bool = True):
        c = self.cfg
        if enhance:
            img, boxes, mask = random_equalize(p.enhance.equalize, img, boxes, mask)
            img, boxes, mask = random_hsv(p.hsv, img, boxes, mask, c.get("hsv_h", 0.015),
                                          c.get("hsv_s", 0.7), c.get("hsv_v", 0.4))
            img, boxes, mask = random_flip(p.enhance, img, boxes, mask)
            if self.use_perspective:
                img, boxes, mask = random_perspective(p.enhance.perspective, img, boxes, mask,
                                                      c.get("perspective", 0.0))
        return letter_box(p.stretch, img, boxes, mask, self.size)
