"""Image-enhance ops of the train path (part of ``yolo_continuous_tpu/ops/enhance.py``).

Ported: the ops that ``ops/augment._post_enhance`` runs when the plan's
enhance YAML enables them (the shipped ``cfg/enhance/enhance.yaml`` sets
``flip_ud: 0.5``): ``random_flip`` (random_flip.py:20-37) and ``equalize``
/ ``random_equalize`` (torchvision's ``RandomEqualize`` as
``main/enhance_package.py:30`` uses it, bit-exact to PIL's algorithm). As in
``ops/augment.py``, each op has a draw step (``draw_enhance``, an explicit
``torch.Generator``) and an apply step that is deterministic given the draw.
Ops take batched float images (B, H, W, 3) in 0..255 and xyxy pixel boxes
(B, MB, >=4) with a validity mask.

Not ported yet (ROADMAP.md Queue 1 item 16): ``random_perspective`` (the
``use_perspective`` plan key, off by default), ``letter_box``, the enhance
variant of ``random_hsv`` and ``EnhancePackage``; each raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_ITEM16 = "is not ported yet (ROADMAP.md Queue 1 item 16)"


class EnhanceDraw(NamedTuple):
    """Draws of the enhance ops for B samples."""
    flip_lr: torch.Tensor    # (B,) bool
    flip_ud: torch.Tensor    # (B,) bool
    equalize: torch.Tensor   # (B,) bool


def draw_enhance(gen: torch.Generator, B: int, flip_lr: float, flip_ud: float,
                 equalize: float) -> EnhanceDraw:
    """Each op fires where a unit draw falls under its probability."""
    u = torch.rand((3, B), generator=gen, dtype=torch.float32, device=gen.device)
    return EnhanceDraw(u[0] < flip_lr, u[1] < flip_ud, u[2] < equalize)


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


def random_perspective(*args, **kwargs):
    raise NotImplementedError(f"random_perspective (plan key use_perspective) {_ITEM16}")


def letter_box(*args, **kwargs):
    raise NotImplementedError(f"the device letter_box {_ITEM16}; the host letterbox is "
                              "ops/preprocess.letterbox")


class EnhancePackage:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"EnhancePackage {_ITEM16}")
