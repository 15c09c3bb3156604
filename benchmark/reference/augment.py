"""The plain reference of the training augmentation, written from the JAX
package's ``ops/augment.py`` and ``ops/enhance.py`` (``augment_batch``,
``augment_single``, ``augment_mosaic``, ``random_hsv``, ``random_flip``,
``boxes_to_labels``), which follow upstream ``yolo_dataset_git.py:101-401``.
It imports nothing of the port, and is written a sample at a time.

What it does to sample b of a batch of staged canvases (letterboxed tiles
with their meta ``[iw, ih, r0, ox, oy]`` and boxes ``[x1, y1, x2, y2, cls]``
in original pixels):

- the single path: a jitter-resize of tile 0 to ``(nw, nh)`` placed at
  ``(dx, dy)`` by one ``scale_and_translate`` warp (linear, antialiased,
  gray 128 outside), a left-right flip, an HSV gain; boxes mapped, clipped
  and kept where wider and taller than one pixel;
- the mosaic: four such warps (scale 0.4-1, the flip before the resize),
  each placed against the cut point ``floor(S * offset)``, composed by
  quadrant, boxes clipped by the cut-line rules; then one HSV gain;
- the enhance ops of the configuration after it (here an up-down flip);
- mixup with the single path of sample b - 1 (itself up-down flipped by its
  own draw) at one half, the partner's boxes appended;
- the first ``max_gt`` valid boxes as labels ``[cls, cx, cy, w, h] / S``.

The geometry (sizes, offsets, cut points, the warps' weights and the boxes)
is computed in fp32 in the order the JAX package states it, so that every
decision (a pixel inside the source or not, a box kept or dropped) is taken
on the same numbers; the pixels themselves are resampled, recoloured and
blended in fp64. The random draws are the program's stream, in the order
its trainer draws them from a CPU generator seeded from ``(seed, step)``:
they are the augmentation's inputs, as the seed is the weights'.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

AUG_SALT = 0x617567
GRAY = 128.0
JITTER = 0.3                    # yolo_dataset_git.py:101
SINGLE_SCALE = (0.25, 2.0)      # :153
MOSAIC_SCALE = (0.4, 1.0)       # :302
CUT = (0.3, 0.7)                # :264-265


class Params(NamedTuple):
    size: int
    hue: float
    sat: float
    val: float
    flip_lr: float
    flip_ud: float


def params(enhance: dict, size: int) -> Params:
    """The augmentation of a traffic mix's ``enhance`` keys. The cells use
    neither equalize nor copy-paste, and this reference refuses them."""
    for k in ("equalize", "copy_paste"):
        if enhance.get(k, 0.0):
            raise ValueError(f"the reference does not implement {k}")
    return Params(size, enhance.get("hsv_h", 0.1), enhance.get("hsv_s", 0.7),
                  enhance.get("hsv_v", 0.4), enhance.get("flip_lr", 0.5),
                  enhance.get("flip_ud", 0.0))


def draws(seed: int, step: int, B: int, p: Params) -> Dict[str, torch.Tensor]:
    """Step ``step``'s draws for B samples of four tiles, in the program's
    order: the single path, the partner's enhance flags, the mosaic, the
    composed sample's enhance flags (the copy-paste draws that follow are
    unused here)."""
    seq = np.random.SeedSequence([seed & 0x7FFFFFFF, AUG_SALT, step])
    gen = torch.Generator().manual_seed(int(seq.generate_state(1, np.uint64)[0]))

    def u(shape, lo=0.0, hi=1.0):
        x = torch.rand(shape, generator=gen, dtype=torch.float32)
        return torch.clamp(x * (hi - lo) + lo, min=lo)
    d = {"s_ar": u((B, 2), 1 - JITTER, 1 + JITTER), "s_scale": u((B,), *SINGLE_SCALE),
         "s_dxy": u((B, 2)), "s_flip": u((B,)) < p.flip_lr, "s_hsv": u((B, 3), -1.0, 1.0)}
    d["partner_ud"] = u((3, B))[1] < p.flip_ud
    d.update(m_cut=u((B, 2), *CUT), m_ar=u((B, 4, 2), 1 - JITTER, 1 + JITTER),
             m_scale=u((B, 4), *MOSAIC_SCALE), m_flip=u((B, 4)) < p.flip_lr,
             m_hsv=u((B, 3), -1.0, 1.0))
    d["post_ud"] = u((3, B))[1] < p.flip_ud
    return d


def warp_weights(n_in: int, n_out: int, scale: torch.Tensor, shift: torch.Tensor):
    """(n_out, n_in) weights of ``jax.image.scale_and_translate`` along one
    axis, linear kernel, antialiased, in fp32: output o samples the input at
    ``(o + 0.5) / scale - shift / scale - 0.5``; a downscale widens the
    triangle by ``1 / scale``; each output's weights sum to 1, and an output
    whose sample falls outside ``[-0.5, n_in - 0.5]`` has none."""
    dev = scale.device
    inv = 1.0 / scale
    at = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * inv - shift * inv - 0.5
    width = torch.clamp(inv, min=1.0)
    dist = (at[:, None] - torch.arange(n_in, dtype=torch.float32, device=dev)[None, :]).abs()
    w = torch.clamp(1.0 - (dist / width).abs(), min=0.0)
    tot = w.sum(1, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)), torch.zeros_like(w))
    inside = (at >= -0.5) & (at <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def place(canvas: torch.Tensor, meta, nw, nh, dx, dy, S: int) -> torch.Tensor:
    """A staged canvas (H, W, 3) fp64 warped so that the original image of
    ``meta`` fills ``(nw, nh)`` at ``(dx, dy)`` of an S x S output, gray
    outside; the weights in fp32, the sums in fp64."""
    iw, ih, r0, ox, oy = meta
    kx, ky = nw / (iw * r0), nh / (ih * r0)
    wy = warp_weights(canvas.shape[0], S, ky, dy - oy * ky).double()
    wx = warp_weights(canvas.shape[1], S, kx, dx - ox * kx).double()
    out = torch.einsum("yh,hwc,xw->yxc", wy, canvas - GRAY, wx)
    return out + GRAY


def hsv_gain(img: torch.Tensor, u: torch.Tensor, p: Params) -> torch.Tensor:
    """cv2's HSV (H in [0, 180), S and V in [0, 255]) of an RGB image in
    0..255, H, S and V times ``1 + u * (hue, sat, val)`` (H modulo 180, S
    and V clipped), back to RGB (yolo_dataset_git.py:182-197)."""
    g = 1.0 + u.double() * torch.tensor([p.hue, p.sat, p.val], dtype=torch.float64,
                                        device=u.device)
    r, gr, b = img.unbind(-1)
    v = torch.maximum(torch.maximum(r, gr), b)
    c = v - torch.minimum(torch.minimum(r, gr), b)
    cs = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(v == r, (gr - b) / cs, torch.where(v == gr, 2.0 + (b - r) / cs,
                                                        4.0 + (r - gr) / cs))
    h = torch.where(c > 0, torch.remainder(h * 30.0, 180.0), torch.zeros_like(h))
    s = torch.where(v > 0, c / torch.where(v > 0, v, torch.ones_like(v)) * 255.0,
                    torch.zeros_like(v))
    h = torch.remainder(h * g[0], 180.0) / 30.0
    s = torch.clamp(s * g[1], 0.0, 255.0) / 255.0
    v = torch.clamp(v * g[2], 0.0, 255.0)
    sector = torch.remainder(torch.floor(h), 6.0)
    f = h - torch.floor(h)
    pp, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    table = {0: (v, t, pp), 1: (q, v, pp), 2: (pp, v, t), 3: (pp, q, v), 4: (t, pp, v),
             5: (v, pp, q)}
    out = torch.zeros(img.shape, dtype=img.dtype, device=img.device)
    for k, rgb in table.items():
        out = torch.where((sector == k)[..., None], torch.stack(rgb, -1), out)
    return out


def jitter_size(meta, ar, scale, S: int):
    """The jitter-resize of yolo_dataset_git.py:152-159: ``(nw, nh)``."""
    new_ar = (meta[0] / meta[1]) * ar[0] / ar[1]
    if bool(new_ar < 1):
        nh = scale * float(S)
        return nh * new_ar, nh
    nw = scale * float(S)
    return nw, nw / new_ar


def map_boxes(boxes, mask, meta, nw, nh, dx, dy, flip, S: int):
    """Boxes of the original image (MB, 5) into the output: mirrored when
    ``flip``, scaled, shifted, clipped to [0, S]; kept where over a pixel
    wide and tall (yolo_dataset_git.py:202-212)."""
    iw, ih = meta[0], meta[1]
    x1, y1, x2, y2, cls = boxes.unbind(-1)
    if flip:
        x1, x2 = iw - x2, iw - x1
    sx, sy = nw / iw, nh / ih
    x1 = torch.clamp(x1 * sx + dx, min=0.0)
    x2 = torch.clamp(x2 * sx + dx, max=float(S))
    y1 = torch.clamp(y1 * sy + dy, min=0.0)
    y2 = torch.clamp(y2 * sy + dy, max=float(S))
    return torch.stack([x1, y1, x2, y2, cls], -1), mask & (x2 - x1 > 1.0) & (y2 - y1 > 1.0)


def single(d, b: int, canvas, meta, boxes, mask, p: Params):
    S = p.size
    nw, nh = jitter_size(meta, d["s_ar"][b], d["s_scale"][b], S)
    dx, dy = d["s_dxy"][b, 0] * (float(S) - nw), d["s_dxy"][b, 1] * (float(S) - nh)
    img = place(canvas, meta, nw, nh, dx, dy, S)
    flip = bool(d["s_flip"][b])
    if flip:        # the placed image mirrored: the boxes as if placed mirrored
        img, dx = img.flip(1), float(S) - dx - nw
    img = hsv_gain(img, d["s_hsv"][b], p)
    bx, bm = map_boxes(boxes, mask, meta, nw, nh, dx, dy, flip, S)
    return img, bx, bm


def mosaic(d, b: int, canvases, metas, boxes, masks, p: Params):
    S = p.size
    cx, cy = torch.floor(float(S) * d["m_cut"][b, 0]), torch.floor(float(S) * d["m_cut"][b, 1])
    pos = torch.arange(S, dtype=torch.float32, device=canvases.device)
    top, left = (pos < cy)[:, None], (pos < cx)[None, :]
    regions = (top & left, ~top & left, ~top & ~left, top & ~left)
    img = torch.zeros((S, S, 3), dtype=torch.float64, device=canvases.device)
    bxs, bms = [], []
    for q in range(4):          # top-left, bottom-left, bottom-right, top-right
        meta = metas[q]
        nw, nh = jitter_size(meta, d["m_ar"][b, q], d["m_scale"][b, q], S)
        dx = cx - nw if q in (0, 1) else cx
        dy = cy - nh if q in (0, 3) else cy
        flip = bool(d["m_flip"][b, q])
        canvas = canvases[q].flip(1) if flip else canvases[q]
        img = torch.where(regions[q][..., None], place(canvas, meta, nw, nh, dx, dy, S), img)
        bx, bm = map_boxes(boxes[q], masks[q], meta, nw, nh, dx, dy, flip, S)
        bxs.append(bx)
        bms.append(bm & cut_keep(q, bx, cx, cy))
        cut_boxes(q, bxs[-1], cx, cy)
    return hsv_gain(img, d["m_hsv"][b], p), torch.cat(bxs), torch.cat(bms)


def cut_keep(q: int, bx, cx, cy):
    """A box of quadrant q stays unless it lies past the cut lines on the
    far side (yolo_dataset_git.py:216-260)."""
    x1, y1, x2, y2 = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
    past_y = y1 > cy if q in (0, 3) else y2 < cy
    past_x = x1 > cx if q in (0, 1) else x2 < cx
    return ~(past_y | past_x)


def cut_boxes(q: int, bx, cx, cy):
    """In place: a box of quadrant q that spans a cut line ends at it."""
    x1, y1, x2, y2 = bx[:, 0].clone(), bx[:, 1].clone(), bx[:, 2].clone(), bx[:, 3].clone()
    span_y, span_x = (y2 >= cy) & (y1 <= cy), (x2 >= cx) & (x1 <= cx)
    if q in (0, 3):
        bx[:, 3] = torch.where(span_y, cy, y2)
    else:
        bx[:, 1] = torch.where(span_y, cy, y1)
    if q in (0, 1):
        bx[:, 2] = torch.where(span_x, cx, x2)
    else:
        bx[:, 0] = torch.where(span_x, cx, x1)


def flip_ud(img, bx, S: int):
    y1, y2 = bx[:, 1].clone(), bx[:, 3].clone()
    bx = bx.clone()
    bx[:, 1], bx[:, 3] = float(S) - y2, float(S) - y1
    return img.flip(0), bx


def augment(d, tiles, metas, boxes, masks, mosaic_flags, mixup_flags, p: Params, max_gt: int):
    """A batch of staged tiles ``(B, 4, S, S, 3)`` u8, metas ``(B, 4, 5)``,
    boxes ``(B, 4, MB, 5)`` and masks -> images ``(B, S, S, 3)`` fp32 in 0..1,
    labels ``(B, max_gt, 5)`` and their mask."""
    B, S, MB = tiles.shape[0], p.size, boxes.shape[2]
    # the draws beside the tiles: each operation of the geometry then takes
    # both operands on the tiles' device, as the program's do (a CUDA
    # division by a host scalar multiplies by its reciprocal instead)
    d = {k: v.to(tiles.device) for k, v in d.items()}
    singles, composed = [], []
    for b in range(B):
        canvases = tiles[b].double()
        s_img, s_bx, s_bm = single(d, b, canvases[0], metas[b, 0], boxes[b, 0], masks[b, 0], p)
        partner = (s_img, s_bx, s_bm)
        if p.flip_ud > 0 and bool(d["partner_ud"][b]):
            partner = (*flip_ud(s_img, s_bx, S), s_bm)
        singles.append(partner)
        if bool(mosaic_flags[b]):
            img, bx, bm = mosaic(d, b, canvases, metas[b], boxes[b], masks[b], p)
        else:
            pad = torch.zeros((3 * MB, 5), dtype=s_bx.dtype, device=s_bx.device)
            img, bx = s_img, torch.cat([s_bx, pad])
            bm = torch.cat([s_bm, torch.zeros(3 * MB, dtype=torch.bool, device=s_bm.device)])
        if p.flip_ud > 0 and bool(d["post_ud"][b]):
            img, bx = flip_ud(img, bx, S)
        composed.append((img, bx, bm))
    images, labels, lmask = [], [], []
    for b in range(B):
        img, bx, bm = composed[b]
        r_img, r_bx, r_bm = singles[(b - 1) % B]
        mix = bool(mixup_flags[b])
        if mix:
            img = img * 0.5 + r_img * 0.5
        pad = torch.zeros((bx.shape[0] - r_bx.shape[0], 5), dtype=bx.dtype, device=bx.device)
        bx = torch.cat([bx, r_bx, pad])
        bm = torch.cat([bm, r_bm & mix, torch.zeros(pad.shape[0], dtype=torch.bool,
                                                    device=bm.device)])
        keep = torch.nonzero(bm).flatten()[:max_gt]
        lab = torch.zeros((max_gt, 5), dtype=torch.float32, device=bx.device)
        x1, y1, x2, y2, cls = bx[keep].unbind(-1)
        s = float(S)
        lab[:len(keep)] = torch.stack([cls, (x1 + x2) / 2.0 / s, (y1 + y2) / 2.0 / s,
                                       (x2 - x1) / s, (y2 - y1) / s], -1)
        m = torch.zeros(max_gt, dtype=torch.bool, device=bx.device)
        m[:len(keep)] = True
        images.append((img / 255.0).float())
        labels.append(lab)
        lmask.append(m)
    return torch.stack(images), torch.stack(labels), torch.stack(lmask)
