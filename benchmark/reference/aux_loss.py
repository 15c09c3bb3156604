"""The plain reference of the training loss of a net with auxiliary heads
(IAuxDetect): YOLOv7's SimOTA loss with the lead-guided auxiliary
assignment, as the JAX package's ``losses/yolo_loss.py`` states it, written
again an image at a time. It imports nothing of the port.

- Lead heads: candidates at g = 0.5 (find_3_positive: a box's own cell and
  the two neighbours nearer than half a cell), SimOTA on the lead
  predictions at those candidates, the loss on the lead maps; as
  ``yolo_loss.py``'s reference, whose ``candidates``, ``simota``,
  ``ciou_xywh`` and ``qfocal`` this reuses.
- Auxiliary heads: candidates at g = 1.0 (find_5_positive: all four
  neighbours, each nearer than a cell), matched by a second SimOTA pass on
  the **lead** predictions at those cells; the matched targets are applied
  to the auxiliary maps at the same cells (box, objectness against the
  auxiliary prediction's CIoU, classes), at weight 0.25.
- Each level's objectness times its balance, 4, 1, 0.4, 0.1 for strides 8,
  16, 32, 64. Departure from upstream (``ComputeLossAuxOTA``): upstream's
  P6 balance is 4, 1, 0.25, 0.06, and it scales the box, objectness and
  class gains by 3 / nl; the JAX package does neither, and so neither does
  this reference. Upstream's ``hyp.scratch.p6.yaml`` has ``fl_gamma`` 0
  (plain BCE); the configurations here take the repo's QFocal with gamma
  1.5 (``gamma``). Upstream's auxiliary pass matches on the lead
  predictions too, as here.
- The sum over levels is weighted 0.05 (box), H W / 640^2 (objectness) and
  0.5 nc / 80 (classes).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .yolo_loss import BALANCE, candidates, ciou_xywh, qfocal, simota

AUX_WEIGHT = 0.25


def _levels(preds, gather, targets, tmask, strides, anchors, threshold, g):
    """Each level's candidate slots at offset gain ``g``, with the
    predictions of ``gather`` (maps on the same grids) at those cells."""
    dev, bs = targets.device, targets.shape[0]
    levels = []
    for p, q, s, anc in zip(preds, gather, strides, anchors):
        _, h, w, na, no = p.shape
        if tuple(q.shape[1:3]) != (h, w):
            raise ValueError("an auxiliary map's grid differs from its lead map's")
        af = torch.tensor(anc, dtype=torch.float32, device=dev) / float(s)
        slots = [candidates(targets[b], tmask[b], h, w, af, threshold, g) for b in range(bs)]
        gt, an, gi, gj, ok = (torch.stack(v) for v in zip(*slots))              # (bs, C)
        cell = (gj * w + gi) * na + an
        pc = torch.gather(q.reshape(bs, h * w * na, no), 1,
                          cell[..., None].expand(-1, -1, no)).float()           # (bs, C, no)
        levels.append(dict(p=q, gt=gt, an=an, gi=gi, gj=gj, ok=ok, pc=pc, af=af[an],
                           h=h, w=w, na=na, stride=float(s)))
    return levels


@torch.no_grad()
def _match(levels, targets, tmask, size: float):
    """SimOTA, an image at a time, on the detached decode of every level's
    candidates: (foreground (bs, C), ground truth of each (bs, C))."""
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
    txywh = targets[..., 1:5] * size
    tbox = torch.cat([txywh[..., :2] - txywh[..., 2:] / 2, txywh[..., :2] + txywh[..., 2:] / 2],
                     -1)
    fg, mg = zip(*(simota(tbox[b], targets[b, :, 0].to(torch.int32), tmask[b], pbox[b],
                          pobj[b], pcls[b], ok[b]) for b in range(targets.shape[0])))
    return torch.stack(fg), torch.stack(mg)


def _losses(levels, fg, mg, targets, num_classes, gamma, alpha):
    """(box, objectness, classes) summed over levels, before the gains."""
    dev, bs = targets.device, targets.shape[0]
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
            * BALANCE[int(L["stride"])]
        onehot = torch.nn.functional.one_hot(t[..., 0].long(), num_classes).float()
        cls_l = cls_l + (qfocal(q[..., 5:], onehot, gamma, alpha) * selected[..., None]).sum() \
            / (count * num_classes)
    return box_l, obj_l, cls_l


def aux_yolo_loss(preds: Sequence[torch.Tensor], aux_preds: Sequence[torch.Tensor],
                  targets: torch.Tensor, tmask: torch.Tensor, num_classes: int, strides,
                  anchors, image_size: int, threshold: float = 4.0, gamma: float = 1.5,
                  alpha: float = 0.25, aux_weight: float = AUX_WEIGHT
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of the lead maps ``preds`` and the auxiliary maps
    ``aux_preds`` (``(bs, h, w, na, no)`` a level, P3 first, fp32) against
    labels ``(bs, max_gt, 5)`` ``[cls, cx, cy, w, h]`` in fractions and their
    mask; returns it and its parts ``box``, ``obj``, ``cls`` (after the
    gains), ``num_fg`` and ``num_fg_aux`` (the two assignments'
    positives)."""
    dev = preds[0].device
    targets, tmask = targets.to(dev, torch.float32), tmask.to(dev, torch.bool)
    S = float(image_size)
    lead = _levels(preds, preds, targets, tmask, strides, anchors, threshold, 0.5)
    fg, mg = _match(lead, targets, tmask, S)
    box_l, obj_l, cls_l = _losses(lead, fg, mg, targets, num_classes, gamma, alpha)
    # the auxiliary assignment: wider cells, matched on the lead predictions
    wide = _levels(preds, preds, targets, tmask, strides, anchors, threshold, 1.0)
    afg, amg = _match(wide, targets, tmask, S)
    aux = [dict(L, p=A["p"], pc=A["pc"]) for L, A in
           zip(wide, _levels(preds, aux_preds, targets, tmask, strides, anchors, threshold,
                             1.0))]
    abox, aobj, acls = _losses(aux, afg, amg, targets, num_classes, gamma, alpha)
    box_l = (box_l + aux_weight * abox) * 0.05
    obj_l = (obj_l + aux_weight * aobj) * (S * S / 640.0 ** 2)
    cls_l = (cls_l + aux_weight * acls) * 0.5 * (num_classes / 80.0)
    ok = torch.cat([L["ok"] for L in lead], 1)
    aok = torch.cat([L["ok"] for L in wide], 1)
    return box_l + obj_l + cls_l, {"box": box_l, "obj": obj_l, "cls": cls_l,
                                   "num_fg": (fg & ok).sum(), "num_fg_aux": (afg & aok).sum()}
