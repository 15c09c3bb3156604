"""The plain reference of the training loss: YOLOv7's SimOTA loss as the JAX
package's ``losses/yolo_loss.py`` states it (upstream ``losses/yolo_loss.py``
``:21-387``), written again an image at a time. It imports nothing of the port.

- Candidates (``find_3_positive``): for each ground truth, anchor and one of
  five cells (its own and the two neighbours nearer than half a cell, grid
  indices clamped), where the box's ratio to the anchor is under
  ``threshold`` both ways; laid out as the JAX package's static capacity of
  ``5 x anchors x max_gt`` slots a level (offset, then anchor, then ground
  truth), slots that do not qualify included but masked.
- SimOTA: the IoU cost ``-log(IoU + 1e-8)`` and the class cost (BCE of
  ``sqrt(sigmoid(cls) sigmoid(obj))`` against the one-hot class) between each
  ground truth and every candidate of the image; ``k`` = the truncated sum of
  its 20 best IoUs (at least 1); cost = class + 3 IoU, plus 1e-6 times the
  candidate's slot; each ground truth takes the candidates whose cost is
  within its k smallest; a candidate taken twice goes to the ground truth
  of its least cost.
- The loss of each level: 1 - CIoU over the matched candidates (mean), the
  quality focal loss of objectness against the detached CIoU at the matched
  cells (the largest where cells repeat; mean over every cell, times the
  level's balance 4, 1, 0.4 for strides 8, 16, 32) and of the classes against
  the one-hot class (sum over matched candidates and classes / count / nc);
  summed over levels and weighted 0.05, H W / 640^2 and 0.5 nc / 80.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

BIG = 1e9
OFFSETS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))
BALANCE = {8: 4.0, 16: 1.0, 32: 0.4, 64: 0.1}


def bce_logits(x, t):
    return torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def qfocal(x, t, gamma: float, alpha: float):
    d = (t - torch.sigmoid(x)).abs()
    mod = torch.where(d > 0, torch.where(d > 0, d, torch.ones_like(d)) ** gamma,
                      torch.zeros_like(d))
    return bce_logits(x, t) * (t * alpha + (1 - t) * (1 - alpha)) * mod


def ciou_xywh(b1, b2, eps: float = 1e-7):
    """CIoU of (..., 4) xywh boxes, its alpha detached (utils/bbox.py:75-118)."""
    a_x1, a_x2 = b1[..., 0] - b1[..., 2] / 2, b1[..., 0] + b1[..., 2] / 2
    a_y1, a_y2 = b1[..., 1] - b1[..., 3] / 2, b1[..., 1] + b1[..., 3] / 2
    b_x1, b_x2 = b2[..., 0] - b2[..., 2] / 2, b2[..., 0] + b2[..., 2] / 2
    b_y1, b_y2 = b2[..., 1] - b2[..., 3] / 2, b2[..., 1] + b2[..., 3] / 2
    inter = (torch.clamp(torch.minimum(a_x2, b_x2) - torch.maximum(a_x1, b_x1), min=0)
             * torch.clamp(torch.minimum(a_y2, b_y2) - torch.maximum(a_y1, b_y1), min=0))
    w1, h1 = a_x2 - a_x1, a_y2 - a_y1 + eps
    w2, h2 = b_x2 - b_x1, b_y2 - b_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(a_x2, b_x2) - torch.minimum(a_x1, b_x1)
    ch = torch.maximum(a_y2, b_y2) - torch.minimum(a_y1, b_y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b_x1 + b_x2 - a_x1 - a_x2) ** 2 + (b_y1 + b_y2 - a_y1 - a_y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


def pair_iou(a, b):
    """(G, 4) x (N, 4) xyxy -> (G, N)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = torch.clamp(rb - lt, min=0).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def candidates(t, m, h: int, w: int, anchors, threshold: float, g: float = 0.5):
    """One image's candidate slots at one level: (gt, anchor, gi, gj, ok),
    each (5 * na * G,), in the order offset, anchor, ground truth."""
    G, na, dev = t.shape[0], anchors.shape[0], t.device
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    gxy, gwh = t[:, 1:3] * size, t[:, 3:5] * size
    r = gwh[None] / anchors[:, None]
    fits = torch.maximum(r, 1.0 / r).amax(-1) < threshold                     # (na, G)
    back = size - gxy
    near = (torch.remainder(gxy, 1.0) < g) & (gxy > 1.0)                      # left, up
    far = (torch.remainder(back, 1.0) < g) & (back > 1.0)                     # right, down
    cells = torch.stack([torch.ones_like(near[:, 0]), near[:, 0], near[:, 1], far[:, 0],
                         far[:, 1]])                                           # (5, G)
    off = torch.tensor(OFFSETS, dtype=torch.float32, device=dev)
    gij = torch.floor(gxy[None] - g * off[:, None]).long()                     # (5, G, 2)
    gi, gj = gij[..., 0].clamp(0, w - 1), gij[..., 1].clamp(0, h - 1)
    ok = cells[:, None, :] & fits[None] & m[None, None, :]                    # (5, na, G)
    shape = (5, na, G)
    gt = torch.arange(G, device=dev).expand(shape)
    an = torch.arange(na, device=dev)[None, :, None].expand(shape)
    return (gt.reshape(-1), an.reshape(-1), gi[:, None, :].expand(shape).reshape(-1),
            gj[:, None, :].expand(shape).reshape(-1), ok.reshape(-1))


def simota(tbox, tcls, tmask, pbox, pobj, pcls, ok, topk: int = 20):
    """One image: which candidates are foreground, and the ground truth of
    each."""
    G, N = tbox.shape[0], pbox.shape[0]
    pairs = tmask[:, None] & ok[None, :]
    iou = torch.where(pairs, pair_iou(tbox, pbox), 0.0)
    k = min(topk, N)
    dyn = torch.clamp(iou.topk(k, 1).values.sum(1).to(torch.int32), min=1).long()
    y = torch.sqrt(torch.sigmoid(pcls) * torch.sigmoid(pobj)[:, None])
    logit = torch.log(y / (1.0 - y))
    cls_cost = bce_logits(logit, 0.0).sum(-1)[None, :] - logit.T[tcls.long()]
    cost = cls_cost + 3.0 * -torch.log(iou + 1e-8)
    cost = torch.where(pairs, cost, BIG)
    cost = cost + torch.arange(N, dtype=torch.float32, device=cost.device)[None, :] * 1e-6
    smallest = cost.topk(k, 1, largest=False).values                          # ascending
    kth = smallest.gather(1, (dyn - 1)[:, None])
    match = (cost <= kth) & (cost < BIG / 2)
    twice = match.sum(0) > 1
    best = torch.zeros_like(match)
    best[cost.argmin(0), torch.arange(N, device=cost.device)] = True
    match = torch.where(twice[None, :], best, match)
    return match.any(0) & ok, match.to(torch.uint8).argmax(0)


def yolo_loss(preds: Sequence[torch.Tensor], targets: torch.Tensor, tmask: torch.Tensor,
              num_classes: int, strides, anchors, image_size: int, threshold: float = 4.0,
              gamma: float = 1.5, alpha: float = 0.25) -> torch.Tensor:
    """The loss of raw head maps ``(bs, h, w, na, no)`` a level (fp32) against
    labels ``(bs, max_gt, 5)`` ``[cls, cx, cy, w, h]`` in fractions and their
    mask ``(bs, max_gt)``."""
    dev = preds[0].device
    targets, tmask = targets.to(dev, torch.float32), tmask.to(dev, torch.bool)
    bs, S = targets.shape[0], float(image_size)
    levels = []
    for p, s, anc in zip(preds, strides, anchors):
        _, h, w, na, no = p.shape
        af = torch.tensor(anc, dtype=torch.float32, device=dev) / float(s)
        slots = [candidates(targets[b], tmask[b], h, w, af, threshold) for b in range(bs)]
        gt, an, gi, gj, ok = (torch.stack(v) for v in zip(*slots))              # (bs, C)
        flat = p.reshape(bs, h * w * na, no)
        cell = (gj * w + gi) * na + an
        pc = torch.gather(flat, 1, cell[..., None].expand(-1, -1, no)).float()  # (bs, C, no)
        levels.append(dict(p=p, gt=gt, an=an, gi=gi, gj=gj, ok=ok, pc=pc, af=af[an],
                           h=h, w=w, na=na, stride=float(s)))

    # SimOTA on the detached decode of every level's candidates
    with torch.no_grad():
        boxes, objs, clss, oks = [], [], [], []
        for L in levels:
            q = L["pc"]
            grid = torch.stack([L["gi"], L["gj"]], -1).float()
            xy = (torch.sigmoid(q[..., :2]) * 2.0 - 0.5 + grid) * L["stride"]
            wh = (torch.sigmoid(q[..., 2:4]) * 2.0) ** 2 * L["af"] * L["stride"]
            boxes.append(torch.cat([xy - wh / 2, xy + wh / 2], -1))
            objs.append(q[..., 4])
            clss.append(q[..., 5:])
            oks.append(L["ok"])
        pbox, pobj, pcls, ok = (torch.cat(v, 1) for v in (boxes, objs, clss, oks))
        txywh = targets[..., 1:5] * S
        tbox = torch.cat([txywh[..., :2] - txywh[..., 2:] / 2,
                          txywh[..., :2] + txywh[..., 2:] / 2], -1)
        fg, mg = zip(*(simota(tbox[b], targets[b, :, 0].to(torch.int32), tmask[b], pbox[b],
                              pobj[b], pcls[b], ok[b]) for b in range(bs)))
        fg, mg = torch.stack(fg), torch.stack(mg)

    box_l = obj_l = cls_l = 0.0
    at = 0
    for L in levels:
        C = L["ok"].shape[1]
        sel, gt_of = fg[:, at:at + C] & L["ok"], mg[:, at:at + C]
        at += C
        count = torch.clamp(sel.sum().float(), min=1.0)
        selected = sel.float()
        h, w, na = L["h"], L["w"], L["na"]
        t = torch.gather(targets, 1, gt_of[..., None].expand(-1, -1, 5))         # (bs, C, 5)
        tb = t[..., 1:5] * torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
        tb = torch.cat([tb[..., :2] - torch.stack([L["gi"], L["gj"]], -1).float(),
                        tb[..., 2:]], -1)
        q = L["pc"]
        pb = torch.cat([torch.sigmoid(q[..., :2]) * 2.0 - 0.5,
                        (torch.sigmoid(q[..., 2:4]) * 2.0) ** 2 * L["af"]], -1)
        iou = ciou_xywh(pb, tb)
        box_l = box_l + ((1.0 - iou) * selected).sum() / count
        where = (((torch.arange(bs, device=dev)[:, None] * h + L["gj"]) * w + L["gi"]) * na
                 + L["an"])
        tobj = torch.zeros(bs * h * w * na, dtype=torch.float32, device=dev)
        val = torch.where(sel, torch.clamp(iou.detach(), min=0.0), -1.0)
        tobj = tobj.scatter_reduce(0, where.reshape(-1), val.reshape(-1), "amax")
        tobj = torch.clamp(tobj, min=0.0).reshape(bs, h, w, na)
        obj_l = obj_l + qfocal(L["p"][..., 4].float(), tobj, gamma, alpha).mean() \
            * BALANCE.get(int(L["stride"]), 1.0)
        onehot = torch.nn.functional.one_hot(t[..., 0].long(), num_classes).float()
        cls_l = cls_l + (qfocal(q[..., 5:], onehot, gamma, alpha) * selected[..., None]).sum() \
            / (count * num_classes)
    return (box_l * 0.05 + obj_l * (S * S / 640.0 ** 2)
            + cls_l * 0.5 * (num_classes / 80.0))
