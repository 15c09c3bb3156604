"""Batched on-device augmentation (counterpart of ``yolo_continuous_tpu/ops/augment.py``).

The reference's per-worker CPU pipeline (``dataset/yolo_dataset_git.py:101-401``:
jitter-resize + paste, LR flip, HSV, 4-image mosaic with cut-line box
merging, 0.5/0.5 mixup) as batched tensor ops on the device, NHWC float as
in JAX: staged uint8 canvases ``(B, T, S, S, 3)`` in, images ``(B, S, S, 3)``
in 0..1, labels ``[cls, cx, cy, w, h]`` and their mask out.

- every geometric transform is one warp of a staging canvas, the
  ``jax.image.scale_and_translate(img - 128, ..., "linear", antialias=True)
  + 128`` of JAX, written as two separable weight matrices a warp (rows and
  columns, built on the device by ``weight_matrix``) applied by batched
  ``torch.matmul`` (TF32 stays off, as the ``Trainer`` sets it);
- HSV gains in cv2's HSV ranges (H in [0,180), S/V in [0,255]);
- mosaic = 4 warps + quadrant select + the reference's ``merge_bboxes``
  cut-line rules over a padded box tensor; only the samples whose mosaic
  flag is set compute it (JAX computes it for every sample and selects);
- mixup blends a sample with its batch neighbour's single-path augment;
- boxes ride as fixed-capacity (max_boxes, 5) [x1,y1,x2,y2,cls] pixel
  tensors with masks.

Randomness is split from the work. Each ``draw_*`` function takes an
explicit ``torch.Generator`` (on the CPU) and returns a small record of
parameters (``SingleDraw``, ``MosaicDraw``, ``enhance.EnhanceDraw``,
``BatchDraw``); each apply function is deterministic given its record.
``BatchDraw.to`` sends a whole record to the device in one non-blocking
copy. JAX's key stream cannot be reproduced here, so the tests replay
JAX's key splits in JAX and feed the values to the apply functions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .enhance import (EnhanceDraw, PerspectiveCfg, draw_enhance, draw_perspective,
                      random_equalize, random_flip, random_perspective)

GRAY = 128.0  # train-pipeline fill (yolo_dataset_git.py:129,167,327)
_INV_255 = float(np.float32(1.0 / 255.0))   # images to 0..1 (XLA's form of / 255)


class AugConfig(NamedTuple):
    size: int = 640
    jitter: float = 0.3        # yolo_dataset_git.py:101
    hue: float = 0.1           # yolo_dataset_git.py:101 (dataset defaults;
    sat: float = 0.7           #  overridden by enhance.yaml when the plan
    val: float = 0.4           #  plumbs it — see aug_config_from_plan)
    scale_min: float = 0.25    # single-image scale range (:153)
    scale_max: float = 2.0
    mosaic_scale_min: float = 0.4   # mosaic tile scale range (:302)
    mosaic_scale_max: float = 1.0
    min_offset_lo: float = 0.3      # mosaic cut position range (:264-265)
    min_offset_hi: float = 0.7
    # box-level copy-paste from the batch neighbour: declared by the
    # reference's enhance.yaml, implemented by the JAX package, off by default
    copy_paste: float = 0.0         # per-box paste probability
    # enhance.yaml-driven knobs (main/enhance_package.py:12-53)
    flip_lr: float = 0.5            # yolo_dataset_git.py:160-162
    flip_ud: float = 0.0            # enhance.yaml flip_ud
    equalize: float = 0.0           # enhance.yaml equalize
    # the perspective the reference builds but never inserts
    # (enhance_package.py:32-35): opt-in with the plan key use_perspective
    use_perspective: bool = False
    degrees: float = 10.0           # random_perspective.py:40-66 ranges
    translate: float = 0.1
    pscale: float = 0.1
    shear: float = 10.0
    perspective: float = 0.0


def aug_config_from_plan(plan) -> AugConfig:
    """The AugConfig of a TrainPlan, from its enhance YAML
    (``plan.enhance_dict``) when ``plan.enhance`` is set: HSV gains, flip
    and equalize probabilities, copy-paste and the perspective magnitudes."""
    c = dict(getattr(plan, "enhance_dict", None) or {})
    if not getattr(plan, "enhance", True):
        c = {}
    base = AugConfig(size=plan.image_size)
    return base._replace(
        hue=c.get("hsv_h", base.hue),
        sat=c.get("hsv_s", base.sat),
        val=c.get("hsv_v", base.val),
        flip_lr=c.get("flip_lr", base.flip_lr),
        flip_ud=c.get("flip_ud", 0.0),
        equalize=c.get("equalize", 0.0),
        copy_paste=c.get("copy_paste", 0.0),
        use_perspective=bool(getattr(plan, "use_perspective", False)),
        degrees=c.get("degrees", base.degrees),
        translate=c.get("translate", base.translate),
        pscale=c.get("scale", base.pscale),
        shear=c.get("shear", base.shear),
        perspective=c.get("perspective", base.perspective),
    )


# ---------------------------------------------------------------------------
# draws: parameter records from an explicit generator
# ---------------------------------------------------------------------------

def uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    """U[lo, hi) float32 on the generator's device, as ``jax.random.uniform``
    maps its unit draws (``max(lo, u * (hi - lo) + lo)``)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return torch.clamp(u * (hi - lo) + lo, min=lo)


class SingleDraw(NamedTuple):
    """Parameters of ``augment_single`` for B samples."""
    ar: torch.Tensor      # (B, 2) aspect-jitter factors, U(1 - jitter, 1 + jitter)
    scale: torch.Tensor   # (B,) U(scale_min, scale_max)
    dxy: torch.Tensor     # (B, 2) placement fractions, U(0, 1)
    flip: torch.Tensor    # (B,) bool, LR flip (prob flip_lr)
    hsv: torch.Tensor     # (B, 3) HSV gain draws, U(-1, 1)


class MosaicDraw(NamedTuple):
    """Parameters of ``augment_mosaic`` for B samples."""
    offset: torch.Tensor  # (B, 2) cut position fractions (x, y), U(min_offset_lo, _hi)
    ar: torch.Tensor      # (B, 4, 2) per quadrant, as SingleDraw.ar
    scale: torch.Tensor   # (B, 4) U(mosaic_scale_min, mosaic_scale_max)
    flip: torch.Tensor    # (B, 4) bool
    hsv: torch.Tensor     # (B, 3) HSV gain draws of the composite


class BatchDraw(NamedTuple):
    """Parameters of one ``augment_batch`` call and the batch's flags:
    everything the apply step reads besides the images, so that one copy
    sends it to the card."""
    single: SingleDraw
    partner: EnhanceDraw          # post-enhance of the single path (the mixup partner)
    mosaic: Optional[MosaicDraw]  # the mosaic samples' draws, rows of mosaic_idx; None if T == 1
    post: EnhanceDraw             # post-enhance of the composed sample
    paste: torch.Tensor           # (B, N) bool, copy-paste picks of the neighbour's N boxes
    mosaic_idx: Optional[torch.Tensor]  # (n,) int64, the samples whose mosaic flag is set
    mixup: torch.Tensor           # (B,) bool, the mixup flags

    @classmethod
    def of(cls, single, partner, mosaic, post, paste, mosaic_flag, mixup_flag) -> "BatchDraw":
        """The record from the draws of every sample and the batch's flags
        on the host (numpy or CPU tensors); of the mosaic draws it keeps the
        flagged samples' rows."""
        idx = None
        if mosaic is not None:
            idx = torch.from_numpy(np.flatnonzero(_host_flags(mosaic_flag)))
            mosaic = _select(mosaic, idx)
        return cls(single, partner, mosaic, post, paste, idx,
                   torch.from_numpy(_host_flags(mixup_flag)))

    def to(self, device) -> "BatchDraw":
        """The record on ``device``, sent in one copy (``to_record_device``)."""
        return to_record_device(self, device)


def to_record_device(rec, device):
    """A record of draws (nested NamedTuples of tensors and None) on
    ``device``, its tensors sent in one copy (``to_device``) as fp32 and cast
    back to their dtypes."""
    leaves = _leaves(rec)
    flat = to_device(torch.cat([t.reshape(-1).float() for t in leaves]), device)
    parts, at = [], 0
    for t in leaves:
        part = flat[at:at + t.numel()].reshape(t.shape)
        parts.append(part > 0.5 if t.dtype == torch.bool else part.to(t.dtype))
        at += t.numel()
    return _rebuild(rec, iter(parts))


def to_device(a, device) -> torch.Tensor:
    """A host array or tensor on ``device``. To CUDA it goes by a
    non-blocking copy from pinned memory, which the stream orders without
    making the host wait: a copy from pageable memory, or a blocking one,
    would wait for every kernel queued before it."""
    t = torch.as_tensor(a)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _leaves(rec):
    out = []
    for v in rec:
        if isinstance(v, tuple):
            out += _leaves(v)
        elif v is not None:
            out.append(v)
    return out


def _rebuild(rec, parts):
    vals = []
    for v in rec:
        if isinstance(v, tuple):
            vals.append(_rebuild(v, parts))
        else:
            vals.append(None if v is None else next(parts))
    return type(rec)(*vals)


def draw_single(gen: torch.Generator, cfg: AugConfig, B: int) -> SingleDraw:
    j = cfg.jitter
    return SingleDraw(ar=uniform(gen, (B, 2), 1 - j, 1 + j),
                      scale=uniform(gen, (B,), cfg.scale_min, cfg.scale_max),
                      dxy=uniform(gen, (B, 2), 0.0, 1.0),
                      flip=uniform(gen, (B,), 0.0, 1.0) < cfg.flip_lr,
                      hsv=uniform(gen, (B, 3), -1.0, 1.0))


def draw_mosaic(gen: torch.Generator, cfg: AugConfig, B: int) -> MosaicDraw:
    j = cfg.jitter
    return MosaicDraw(offset=uniform(gen, (B, 2), cfg.min_offset_lo, cfg.min_offset_hi),
                      ar=uniform(gen, (B, 4, 2), 1 - j, 1 + j),
                      scale=uniform(gen, (B, 4), cfg.mosaic_scale_min, cfg.mosaic_scale_max),
                      flip=uniform(gen, (B, 4), 0.0, 1.0) < cfg.flip_lr,
                      hsv=uniform(gen, (B, 3), -1.0, 1.0))


def perspective_cfg(cfg: AugConfig) -> PerspectiveCfg:
    return PerspectiveCfg(cfg.degrees, cfg.translate, cfg.pscale, cfg.shear, cfg.perspective)


def draw_post_enhance(gen: torch.Generator, cfg: AugConfig, B: int) -> EnhanceDraw:
    """``_post_enhance``'s draws: no LR flip (the train path flips LR before
    the paste), UD flip and equalize with the config's probabilities, and
    with ``use_perspective`` the perspective of a size x size sample (drawn
    only then, so that the other draws of a plan without it stay as they
    were)."""
    p = draw_enhance(gen, B, 0.0, cfg.flip_ud, cfg.equalize)
    if cfg.use_perspective:
        p = p._replace(perspective=draw_perspective(gen, B, cfg.size, cfg.size,
                                                    perspective_cfg(cfg)))
    return p


def paste_boxes(T: int, max_boxes: int) -> int:
    """Boxes of a composed sample after mixup: its own (4 tiles' for a
    mosaic batch), then the partner's padded to as many."""
    return 2 * (4 if T == 4 else 1) * max_boxes


def draw_batch(gen: torch.Generator, cfg: AugConfig, B: int, T: int, max_boxes: int,
               mosaic_flag, mixup_flag) -> BatchDraw:
    """Every draw of one ``augment_batch`` call of B samples of T tiles,
    with the batch's (B,) host flags."""
    return BatchDraw.of(single=draw_single(gen, cfg, B),
                        partner=draw_post_enhance(gen, cfg, B),
                        mosaic=draw_mosaic(gen, cfg, B) if T == 4 else None,
                        post=draw_post_enhance(gen, cfg, B),
                        paste=uniform(gen, (B, paste_boxes(T, max_boxes)), 0.0, 1.0)
                        < cfg.copy_paste,
                        mosaic_flag=mosaic_flag, mixup_flag=mixup_flag)


def _select(rec, idx: torch.Tensor):
    """The rows ``idx`` of every tensor of a record."""
    return type(rec)(*(v[idx] for v in rec))


# ---------------------------------------------------------------------------
# color: RGB <-> HSV in cv2 ranges (H in [0,180), S/V in [0,255])
# ---------------------------------------------------------------------------

def _remainder(x: torch.Tensor, y: float) -> torch.Tensor:
    """Floored modulo as ``jnp.remainder`` computes it: fmod, then + y where
    the sign differs from the divisor's."""
    m = torch.fmod(x, y)
    return torch.where((m != 0) & ((m < 0) != (y < 0)), m + y, m)


def _planes(img: torch.Tensor):
    """The channel planes of (..., 3) images, each contiguous: the HSV math
    then reads and writes whole planes instead of every third float."""
    return img.movedim(-1, 0).contiguous().unbind(0)


def _hsv_planes(r, g, b):
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    safe = torch.where(diff > 0, diff, 1.0)
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = _remainder(h * 30.0, 180.0)
    h = torch.where(diff > 0, h, 0.0)
    s = torch.where(mx > 0, diff / torch.where(mx > 0, mx, 1.0) * 255.0, 0.0)
    return h, s, mx


def _rgb_planes(h, s, v):
    h, s = h / 30.0, s / 255.0
    i = _remainder(torch.floor(h), 6.0)
    f = h - torch.floor(h)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))

    def select(*xs):  # jnp.select over i == 0..5, first match wins, default 0
        out = torch.zeros_like(v)
        for k in range(5, -1, -1):
            out = torch.where(i == k, xs[k], out)
        return out

    return select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)


def rgb_to_hsv_cv(img: torch.Tensor) -> torch.Tensor:
    """img float (..., 3) in 0..255 -> HSV with cv2's ranges."""
    return torch.stack(_hsv_planes(*_planes(img)), dim=-1)


def hsv_to_rgb_cv(hsv: torch.Tensor) -> torch.Tensor:
    return torch.stack(_rgb_planes(*_planes(hsv)), dim=-1)


def random_hsv(u: torch.Tensor, img: torch.Tensor, hue, sat, val) -> torch.Tensor:
    """HSV gain jitter (yolo_dataset_git.py:182-197 without the uint8 LUT):
    gains ``u * (hue, sat, val) + 1`` from the draws u (B, 3) in U(-1, 1),
    on images (B, H, W, 3) in 0..255."""
    # a gain per column times a Python float, in fp32: no tensor of the
    # gains is copied to the device
    r = [(u[:, i] * g + 1.0)[:, None, None] for i, g in enumerate((hue, sat, val))]
    h, s, v = _hsv_planes(*_planes(img))
    h = _remainder(h * r[0], 180.0)
    s = torch.clamp(s * r[1], 0.0, 255.0)
    v = torch.clamp(v * r[2], 0.0, 255.0)
    return torch.stack(_rgb_planes(h, s, v), dim=-1)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def weight_matrix(in_size: int, out_size: int, scale: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """(N, in_size, out_size) resampling weights of N warps along one axis:
    ``compute_weight_mat`` of ``jax.image.scale_and_translate`` with the
    linear (triangle) kernel and antialiasing, in its order of operations.
    Downscaling widens the kernel by 1/scale; each output's weights are
    normalised by their sum; an output whose sample lies outside
    [-0.5, in_size - 0.5] gets no weight (it reads as the fill)."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv_scale
                - translation[:, None] * inv_scale - 0.5)                      # (N, out)
    x = (sample_f[:, None, :] - torch.arange(in_size, dtype=torch.float32, device=dev)[:, None]
         ).abs() / kernel_scale[:, None]                                      # (N, in, out)
    weights = torch.clamp(1 - x.abs(), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def warp_canvas(img: torch.Tensor, ky, kx, ty, tx, size: int, fill: float = GRAY
                ) -> torch.Tensor:
    """img (N, H, W, 3) float -> (N, size, size, 3):
    out(y, x) = img((y - ty) / ky, (x - tx) / kx), ``fill`` outside."""
    N, H, W, C = img.shape
    wy = weight_matrix(H, size, ky, ty)                                      # (N, H, S)
    wx = weight_matrix(W, size, kx, tx)                                      # (N, W, S)
    # rows, then columns: one (S, H) x (H, W*C) and one (S*C, W) x (W, S)
    # product an image
    rows = torch.matmul(wy.transpose(1, 2), (img - fill).reshape(N, H, W * C))
    rows = rows.reshape(N, size, W, C).transpose(2, 3).reshape(N, size * C, W)
    out = torch.matmul(rows, wx).reshape(N, size, C, size)                   # (N, S, C, S)
    return (out + fill).transpose(2, 3).contiguous()


def _jitter_geometry(ar, scale, meta, cfg: AugConfig):
    """The jitter-resize geometry of yolo_dataset_git.py:152-159 from its
    draws (ar (N, 2), scale (N,)); meta (N, 5) = (iw, ih, r0, ox, oy).
    Returns (nw, nh) in output px."""
    iw, ih = meta[:, 0], meta[:, 1]
    new_ar = (iw / ih) * ar[:, 0] / ar[:, 1]
    s = float(cfg.size)
    nh_if = scale * s
    nw_if = nh_if * new_ar
    nw_else = scale * s
    nh_else = nw_else / new_ar
    lt1 = new_ar < 1
    return torch.where(lt1, nw_if, nw_else), torch.where(lt1, nh_if, nh_else)


def _place_tile(img, meta, nw, nh, dx, dy, cfg: AugConfig):
    """Warp staging canvases so each original occupies (nw, nh) at (dx, dy)."""
    iw, ih, r0, ox, oy = meta.unbind(-1)
    kx = nw / (iw * r0)
    ky = nh / (ih * r0)
    tx = dx - ox * kx
    ty = dy - oy * ky
    return warp_canvas(img, ky, kx, ty, tx, cfg.size)


def _transform_boxes(boxes, mask, iw, ih, nw, nh, dx, dy, flip, size):
    """Box remap + clip + min-size filter; yolo_dataset_git.py:202-212.

    boxes: (N, MB, 5) [x1,y1,x2,y2,cls] in original px; per-sample (N,)
    geometry; flip is the pre-resize horizontal flip (x -> iw - x)."""
    x1, y1, x2, y2, cls = boxes.unbind(-1)
    iw, ih, nw, nh, dx, dy, flip = (v[:, None] for v in (iw, ih, nw, nh, dx, dy, flip))
    fx1 = torch.where(flip, iw - x2, x1)
    fx2 = torch.where(flip, iw - x1, x2)
    sx, sy = nw / iw, nh / ih
    nx1 = torch.clamp(fx1 * sx + dx, min=0.0)
    nx2 = torch.clamp(fx2 * sx + dx, max=size)
    ny1 = torch.clamp(y1 * sy + dy, min=0.0)
    ny2 = torch.clamp(y2 * sy + dy, max=size)
    ok = mask & (nx2 - nx1 > 1.0) & (ny2 - ny1 > 1.0)
    return torch.stack([nx1, ny1, nx2, ny2, cls], dim=-1), ok


def _flip_where(flag: torch.Tensor, img: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.where(flag[:, None, None, None], img.flip(dim), img)


def augment_single(p: SingleDraw, img, meta, boxes, bmask, cfg: AugConfig):
    """Train-mode single-image augmentation; yolo_dataset_git.py:149-214.

    img: (B,S,S,3) staging canvases float 0..255; meta: (B,5)
    [iw,ih,r0,ox,oy]; boxes: (B,MB,5) original-px xyxy+cls.
    Returns (out_img, out_boxes, out_mask) in output px."""
    iw, ih = meta[:, 0], meta[:, 1]
    s = float(cfg.size)
    nw, nh = _jitter_geometry(p.ar, p.scale, meta, cfg)
    dx = p.dxy[:, 0] * (s - nw)   # rand(0, w-nw); negative ok (:165)
    dy = p.dxy[:, 1] * (s - nh)
    out = _place_tile(img, meta, nw, nh, dx, dy, cfg)
    out = _flip_where(p.flip, out, 2)
    out = random_hsv(p.hsv, out, cfg.hue, cfg.sat, cfg.val)
    # flip-after-paste == flip-before with mirrored placement:
    fdx = torch.where(p.flip, s - dx - nw, dx)
    nb, nm = _transform_boxes(boxes, bmask, iw, ih, nw, nh, fdx, dy, p.flip, s)
    return out, nb, nm


def _merge_mosaic_boxes(q, boxes, mask, cutx, cuty):
    """Cut-line clipping rules; yolo_dataset_git.py:216-260 (quadrant q);
    cutx, cuty (N,)."""
    x1, y1, x2, y2 = boxes.unbind(-1)[:4]
    cutx, cuty = cutx[:, None], cuty[:, None]
    spans_y = (y2 >= cuty) & (y1 <= cuty)
    spans_x = (x2 >= cutx) & (x1 <= cutx)
    if q == 0:      # top-left
        drop = (y1 > cuty) | (x1 > cutx)
        y2 = torch.where(spans_y, cuty, y2)
        x2 = torch.where(spans_x, cutx, x2)
    elif q == 1:    # bottom-left
        drop = (y2 < cuty) | (x1 > cutx)
        y1 = torch.where(spans_y, cuty, y1)
        x2 = torch.where(spans_x, cutx, x2)
    elif q == 2:    # bottom-right
        drop = (y2 < cuty) | (x2 < cutx)
        y1 = torch.where(spans_y, cuty, y1)
        x1 = torch.where(spans_x, cutx, x1)
    else:           # top-right
        drop = (y1 > cuty) | (x2 < cutx)
        y2 = torch.where(spans_y, cuty, y2)
        x1 = torch.where(spans_x, cutx, x1)
    return torch.stack([x1, y1, x2, y2, boxes[..., 4]], dim=-1), mask & ~drop


def augment_mosaic(p: MosaicDraw, tiles, metas, boxes, bmasks, cfg: AugConfig):
    """4-image mosaic; yolo_dataset_git.py:262-391.

    tiles: (N,4,S,S,3) float 0..255; metas: (N,4,5); boxes: (N,4,MB,5);
    bmasks: (N,4,MB). Returns (img, boxes (N,4*MB,5), mask (N,4*MB))."""
    N, S = tiles.shape[0], cfg.size
    s = float(S)
    cutx = torch.floor(s * p.offset[:, 0])
    cuty = torch.floor(s * p.offset[:, 1])
    geo, bxs, bms = [], [], []
    for q in range(4):
        meta = metas[:, q]
        nw, nh = _jitter_geometry(p.ar[:, q], p.scale[:, q], meta, cfg)
        # quadrant placement (:314-325)
        dx = cutx - nw if q in (0, 1) else cutx
        dy = cuty - nh if q in (0, 3) else cuty
        geo.append((nw, nh, dx, dy))
        nb, nm = _transform_boxes(boxes[:, q], bmasks[:, q], meta[:, 0], meta[:, 1], nw, nh,
                                  dx, dy, p.flip[:, q], s)
        nb, nm = _merge_mosaic_boxes(q, nb, nm, cutx, cuty)
        bxs.append(nb)
        bms.append(nm)
    # the flip happens on the original before the resize (:293-296): mirror
    # the staging canvas; then all 4N warps in one batch (quadrant-major)
    flip = p.flip.transpose(0, 1).reshape(-1)
    canvases = _flip_where(flip, tiles.transpose(0, 1).reshape(4 * N, S, S, 3), 2)
    nw, nh, dx, dy = (torch.cat(v) for v in zip(*geo))
    imgs = _place_tile(canvases, metas.transpose(0, 1).reshape(4 * N, 5), nw, nh, dx, dy, cfg)
    imgs = imgs.reshape(4, N, S, S, 3)

    pos = torch.arange(S, dtype=torch.float32, device=tiles.device)
    top = (pos[None, :] < cuty[:, None])[:, :, None, None]                    # (N, S, 1, 1)
    left = (pos[None, :] < cutx[:, None])[:, None, :, None]                   # (N, 1, S, 1)
    img = torch.where(top & left, imgs[0], torch.where(
        ~top & left, imgs[1], torch.where(~top & ~left, imgs[2], imgs[3])))  # (:355-362)
    img = random_hsv(p.hsv, img, cfg.hue, cfg.sat, cfg.val)  # (:369-384)
    return img, torch.cat(bxs, 1), torch.cat(bms, 1)


def copy_paste_batch(paste, imgs, boxes, bmasks):
    """Box-level copy-paste from the batch neighbour: each valid box of
    sample i-1 picked in ``paste`` (B, N) is pasted onto sample i at the
    same position (its rectangle of pixels) and its label appended."""
    S = imgs.shape[1]
    src_imgs = torch.roll(imgs, 1, 0)
    src_bx = torch.roll(boxes, 1, 0)
    take = paste & torch.roll(bmasks, 1, 0)
    pos = torch.arange(S, dtype=torch.float32, device=imgs.device)
    x1, y1, x2, y2 = (src_bx[..., i, None] for i in range(4))                 # (B, N, 1)
    rows = ((pos >= y1) & (pos < y2) & take[..., None]).float()               # (B, N, S)
    cols = ((pos >= x1) & (pos < x2)).float()
    # the union of the picked rectangles: a count per pixel, exact in fp32
    m = torch.matmul(rows.transpose(1, 2), cols) > 0                          # (B, S, S)
    imgs = torch.where(m[..., None], src_imgs, imgs)
    return imgs, torch.cat([boxes, src_bx], 1), torch.cat([bmasks, take], 1)


def _post_enhance(p: EnhanceDraw, img, bx, bm, cfg: AugConfig):
    """The enhance.yaml ops on a composed train sample (px xyxy boxes):
    perspective, UD flip, equalize, in that order; each only where the
    config enables it."""
    if cfg.use_perspective:
        img, bx, bm = random_perspective(p.perspective, img, bx, bm, cfg.perspective)
    if cfg.flip_ud > 0.0:
        img, bx, bm = random_flip(p, img, bx, bm)
    if cfg.equalize > 0.0:
        img, bx, bm = random_equalize(p.equalize, img, bx, bm)
    return img, bx, bm


def _cap_boxes(boxes, mask, cap: int):
    """Keep the first ``cap`` valid boxes of each sample, in order."""
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)     # valid first
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    return boxes[:, :cap], torch.gather(mask, 1, order)[:, :cap]


def boxes_to_labels(boxes, mask, size: int):
    """px xyxy+cls -> normalized [cls, cx, cy, w, h]; yolo_dataset_git.py:79-94."""
    x1, y1, x2, y2, cls = boxes.unbind(-1)
    s = float(size)
    w = (x2 - x1) / s
    h = (y2 - y1) / s
    cx = (x1 + x2) / 2.0 / s
    cy = (y1 + y2) / 2.0 / s
    return torch.stack([cls, cx, cy, w, h], dim=-1) * mask[..., None]


def _pad_boxes(bx, bm, n: int):
    pad = n - bx.shape[1]
    if pad <= 0:
        return bx, bm
    return (torch.nn.functional.pad(bx, (0, 0, 0, pad)),
            torch.nn.functional.pad(bm, (0, pad)))


def _host_flags(flags) -> np.ndarray:
    return np.asarray(flags.cpu() if torch.is_tensor(flags) else flags, bool)


def augment_batch(
    draw: Optional[BatchDraw],
    tiles: torch.Tensor,       # (B, T, S, S, 3) uint8 staging canvases
    metas: torch.Tensor,       # (B, T, 5) [iw, ih, r0, ox, oy]
    boxes: torch.Tensor,       # (B, T, MB, 5) original-px xyxy + cls
    bmasks: torch.Tensor,      # (B, T, MB)
    cfg: AugConfig = AugConfig(),
    max_gt: int = 128,
    train: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The train-batch pipeline -> (images (B,S,S,3) float 0..1, labels
    (B, max_gt, 5) [cls, cx, cy, w, h] normalized, mask (B, max_gt)), on the
    tiles' device, from the parameters and flags ``draw`` (``draw_batch``).

    Eval mode (train=False, no draw) is the deterministic letterbox branch
    (yolo_dataset_git.py:118-147): the staging canvas is that output."""
    T = tiles.shape[1]
    tiles_f = tiles.float()
    if not train:
        # the box map as one fused multiply-add (addcmul) and the scale to
        # 0..1 as a product with 1/255: the operations XLA emits for JAX's
        # ``x * r0 + o`` and ``/ 255``, so that this branch is exact
        iw, ih, r0, ox, oy = (metas[:, 0, i, None] for i in range(5))
        bx, bm = boxes[:, 0], bmasks[:, 0]
        x1, y1 = torch.addcmul(ox, bx[..., 0], r0), torch.addcmul(oy, bx[..., 1], r0)
        x2, y2 = torch.addcmul(ox, bx[..., 2], r0), torch.addcmul(oy, bx[..., 3], r0)
        ok = bm & (x2 - x1 > 1.0) & (y2 - y1 > 1.0)
        bx, bm = _cap_boxes(torch.stack([x1, y1, x2, y2, bx[..., 4]], -1), ok, max_gt)
        return tiles_f[:, 0] * _INV_255, boxes_to_labels(bx, bm, cfg.size), bm

    s_img, s_bx, s_bm = augment_single(draw.single, tiles_f[:, 0], metas[:, 0], boxes[:, 0],
                                       bmasks[:, 0], cfg)
    # the mixup partner also sees the enhance ops (its own draws)
    p_img, p_bx, p_bm = _post_enhance(draw.partner, s_img, s_bx, s_bm, cfg)
    img, bx, bm = s_img, s_bx, s_bm
    if T == 4:
        bx, bm = _pad_boxes(s_bx, s_bm, 4 * s_bx.shape[1])
        sel = draw.mosaic_idx
        if len(sel):   # the mosaic branch only where its flag selects it
            m_img, m_bx, m_bm = augment_mosaic(draw.mosaic, tiles_f[sel], metas[sel],
                                               boxes[sel], bmasks[sel], cfg)
            img = img.index_copy(0, sel, m_img)
            bx = bx.index_copy(0, sel, m_bx)
            bm = bm.index_copy(0, sel, m_bm)
    img, bx, bm = _post_enhance(draw.post, img, bx, bm, cfg)

    # mixup; yolo_dataset_git.py:393-401, with the batch neighbour's
    # single-path augment as the "one extra random image" (:59-62)
    mix = draw.mixup
    r_img = torch.roll(p_img, 1, 0)
    r_bx, r_bm = _pad_boxes(torch.roll(p_bx, 1, 0), torch.roll(p_bm, 1, 0), bx.shape[1])
    img = torch.where(mix[:, None, None, None], img * 0.5 + r_img * 0.5, img)
    bx = torch.cat([bx, r_bx], 1)
    bm = torch.cat([bm, r_bm & mix[:, None]], 1)

    if cfg.copy_paste > 0.0:
        img, bx, bm = copy_paste_batch(draw.paste, img, bx, bm)

    bx, bm = _cap_boxes(bx, bm, max_gt)
    return img * _INV_255, boxes_to_labels(bx, bm, cfg.size), bm


def augment_batch_from_pool(
    draw: Optional[BatchDraw],
    pool_tiles: torch.Tensor,   # (N, S, S, 3) uint8, every staged canvas
    pool_metas: torch.Tensor,   # (N, 5)
    pool_boxes: torch.Tensor,   # (N, MB, 5)
    pool_masks: torch.Tensor,   # (N, MB)
    tile_idx: torch.Tensor,     # (B, T) int into the pool, on the pool's device
    cfg: AugConfig = AugConfig(),
    max_gt: int = 128,
    train: bool = True,
):
    """``augment_batch`` fed from a device-resident staged-image pool
    (``YoloDataset.staged_pool``): a step ships only (B, T) tile indices
    beside the draws, not B*T*S*S*3 pixel bytes. Gather, then the same
    math as ``augment_batch`` on host-assembled tiles."""
    idx = tile_idx.long()
    return augment_batch(draw, pool_tiles[idx], pool_metas[idx], pool_boxes[idx],
                         pool_masks[idx], cfg=cfg, max_gt=max_gt, train=train)
