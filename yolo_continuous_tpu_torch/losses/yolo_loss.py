"""YOLOv7-style SimOTA loss under static shapes, in PyTorch.

Counterpart of ``yolo_continuous_tpu/losses/yolo_loss.py`` (``LossConfig``,
``smooth_bce``, ``_candidates_level``, ``_simota_match``, ``yolo_loss``),
which follows the reference's ``losses/yolo_loss.py:21-387``. The JAX
version's static-shape semantics are kept exactly, with the batch written
out where JAX uses ``vmap``:

- ground truth padded to ``(bs, max_gt, 5)`` plus a mask, and a capacity of
  ``5 * na * max_gt`` candidate cells a level;
- dynamic-k from the ``int32`` truncation of the top-20 IoU sum, then the
  k-th smallest cost as a threshold (``top_k(-cost, k)``), with the
  ``1e-6 * index`` tie-break on the cost;
- a candidate claimed by several ground truths goes to the ``argmin`` of its
  cost column;
- the cls cost by the one-hot decomposition ``sum_c BCE(l_c, 0) - l_cls``;
- obj targets as a deterministic scatter-max (``scatter_reduce_(..., "amax")``);
- ``stop_gradient`` becomes ``.detach()`` at the same places: the
  candidates' decode for matching, the matching itself, the obj targets.

``aux_preds`` (IAuxDetect) are trained with the widened coarse assignment
of the JAX version: find_5_positive cells matched by a second SimOTA pass
on the lead predictions, at ``aux_weight``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops.boxes import bbox_iou, box_iou
from ..parallel.mesh import global_count, global_mean
from .focal import qfocal_loss

_BIG = 1e9


def smooth_bce(eps: float = 0.1) -> Tuple[float, float]:
    """Positive/negative label-smoothing targets; losses/yolo_loss.py:16-18."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def _balance_for_stride(stride: int) -> float:
    """Per-level obj balance ([0.4, 1, 4] for strides [32, 16, 8]; 0.1 at 64)."""
    return {64: 0.1, 32: 0.4, 16: 1.0, 8: 4.0}.get(int(stride), 1.0)


@dataclass(frozen=True)
class LossConfig:
    num_classes: int
    input_size: Tuple[int, int]                    # (H, W) of the net input
    strides: Tuple[int, ...]                       # per pred level
    anchors: Tuple[Tuple[Tuple[float, float], ...], ...]  # per level, px
    max_gt: int = 128
    label_smoothing: float = 0.0
    fl_gamma: float = 1.5
    fl_alpha: float = 0.25
    box_ratio: float = 0.05                        # yolo_loss.py:39
    iou_ratio: float = 1.0                         # gr blend; yolo_loss.py:45,106
    threshold: float = 4.0                         # yolo_loss.py:42
    topk: int = 20                                 # yolo_loss.py:219
    aux_weight: float = 0.25                       # aux-head loss weight (YOLOv7 paper)

    @property
    def obj_ratio(self) -> float:                  # yolo_loss.py:40
        return 1.0 * (self.input_size[0] * self.input_size[1]) / (640.0 ** 2)

    @property
    def cls_ratio(self) -> float:                  # yolo_loss.py:41
        return 0.5 * (self.num_classes / 80.0)


# unit offset stencil [0,0],[1,0],[0,1],[-1,0],[0,-1], scaled by the gain g
_UNIT_OFFSETS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))


_CONSTS: Dict[tuple, torch.Tensor] = {}


def _frozen(values):
    return tuple(map(_frozen, values)) if isinstance(values, (list, tuple)) else float(values)


def _const(values, device) -> torch.Tensor:
    """A small fp32 constant on ``device``, copied there once per value and
    device and kept (read-only): a step then copies nothing from the host,
    which a captured step (``utils/capture.CapturedStep``) could not replay,
    and waits for nothing."""
    key = (_frozen(values), torch.device(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(values, dtype=torch.float32).to(device)
    return _CONSTS[key]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Bool one-hot along a new last axis; an index outside [0, n) gives a
    row of zeros, as ``jax.nn.one_hot`` (and no check that waits for the card)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _candidates_level(tgt, tmask, h, w, anchors_f, threshold, g=0.5):
    """Candidate positives at one level, for a batch.

    tgt: (bs, G, 5) [cls, cx, cy, bw, bh] normalized; tmask: (bs, G) bool;
    anchors_f: (na, 2) in grid units. ``g``: 0.5 selects the centre and the
    two nearest cells (find_3_positive), 1.0 all five (find_5_positive).
    Returns (bs, C) tensors, C = 5 * na * G in (offset, anchor, gt) order:
    gt_idx, a_idx, gi, gj (int64) and mask (bool).
    """
    bs, G = tgt.shape[:2]
    na = anchors_f.shape[0]
    dev = tgt.device
    scale = _const([w, h], dev)
    gxy = tgt[..., 1:3] * scale                                  # (bs,G,2)
    gwh = tgt[..., 3:5] * scale

    # anchor-ratio filter; yolo_loss.py:342-344
    r = gwh[:, None, :, :] / anchors_f[None, :, None, :]         # (bs,na,G,2)
    valid_a = torch.maximum(r, 1.0 / r).amax(-1) < threshold     # (bs,na,G)

    # neighbour-cell conditions; yolo_loss.py:350-354
    gxi = scale - gxy
    jk = (torch.remainder(gxy, 1.0) < g) & (gxy > 1.0)           # x-left, y-up
    lm = (torch.remainder(gxi, 1.0) < g) & (gxi > 1.0)           # x-right, y-down
    off_ok = torch.stack([torch.ones_like(jk[..., 0]), jk[..., 0], jk[..., 1],
                          lm[..., 0], lm[..., 1]], 1)           # (bs,5,G)

    offsets = _const(_UNIT_OFFSETS, dev)
    gij = torch.floor(gxy[:, None, :, :] - g * offsets[None, :, None, :]) \
        .to(torch.int32).long()                                  # (bs,5,G,2)
    gi = gij[..., 0].clamp(0, w - 1)                             # yolo_loss.py:384 clamp
    gj = gij[..., 1].clamp(0, h - 1)

    mask = off_ok[:, :, None, :] & valid_a[:, None, :, :] & tmask[:, None, None, :]  # (bs,5,na,G)
    shape = (bs, 5, na, G)
    gi = gi[:, :, None, :].expand(shape)
    gj = gj[:, :, None, :].expand(shape)
    gt_idx = torch.arange(G, device=dev)[None, None, None, :].expand(shape)
    a_idx = torch.arange(na, device=dev)[None, None, :, None].expand(shape)
    C = 5 * na * G
    return (gt_idx.reshape(bs, C), a_idx.reshape(bs, C), gi.reshape(bs, C),
            gj.reshape(bs, C), mask.reshape(bs, C))


def _simota_match(tbox_xyxy, tcls, tmask, pbox_xyxy, p_obj, p_cls, cand_mask, topk: int):
    """build_targets core (losses/yolo_loss.py:196-258), for a batch.

    Shapes: tbox (bs,G,4) px; tcls (bs,G); tmask (bs,G); pbox (bs,N,4) px;
    p_obj (bs,N); p_cls (bs,N,nc); cand_mask (bs,N).
    Returns fg (bs,N) bool, matched_gt (bs,N) int64.
    """
    G = tbox_xyxy.shape[1]
    N = pbox_xyxy.shape[1]
    nc = p_cls.shape[-1]
    pair_mask = tmask[:, :, None] & cand_mask[:, None, :]          # (bs,G,N)

    pair_iou = torch.where(pair_mask, box_iou(tbox_xyxy, pbox_xyxy), 0.0)
    iou_cost = -torch.log(pair_iou + 1e-8)                         # :216

    # dynamic-k from the top-20 IoU sum; :219-220 (.int() truncates)
    k = min(topk, N)
    top_iou = torch.topk(pair_iou, k, dim=-1).values               # (bs,G,k)
    dynamic_k = top_iou.sum(-1).to(torch.int32).clamp(min=1).long()

    # cls cost via the one-hot decomposition of :223-237
    y = torch.sqrt(torch.sigmoid(p_cls) * torch.sigmoid(p_obj)[..., None])   # (bs,N,nc)
    logit = torch.log(y / (1.0 - y))
    bce0 = logit.clamp(min=0) + torch.log1p(torch.exp(-logit.abs()))        # BCE(l, 0)
    s0 = bce0.sum(-1)                                              # (bs,N)
    cls_idx = tcls.long().clamp(0, nc - 1)                         # JAX clamps its gather
    l_at_cls = torch.gather(logit.transpose(1, 2), 1,
                            cls_idx[:, :, None].expand(-1, -1, N))  # (bs,G,N)
    cls_cost = s0[:, None, :] - l_at_cls

    cost = cls_cost + 3.0 * iou_cost                               # :241
    cost = torch.where(pair_mask, cost, _BIG)
    # deterministic tie-break by candidate index
    cost = cost + torch.arange(N, dtype=torch.float32, device=cost.device) * 1e-6

    # the dynamic_k smallest costs of each gt: the k-th smallest as a threshold
    neg_top = torch.topk(-cost, k, dim=-1).values                  # (bs,G,k) sorted
    kth_val = torch.gather(-neg_top, 2, (dynamic_k - 1)[..., None])
    matching = (cost <= kth_val) & (cost < _BIG / 2)               # (bs,G,N)

    # conflict resolution; :252-256 (argmin over all gts of the column)
    conflicted = matching.sum(1) > 1                               # (bs,N)
    argmin_g = torch.argmin(cost, dim=1)                           # (bs,N)
    onehot_min = _one_hot(argmin_g, G).transpose(1, 2)             # (bs,G,N)
    matching = torch.where(conflicted[:, None, :], onehot_min, matching)

    fg = matching.any(1) & cand_mask                               # :257
    matched_gt = torch.argmax(matching.to(torch.uint8), dim=1)     # :258, first match
    return fg, matched_gt


def _masked_mean(x, mask, count):
    return torch.sum(x * mask) / torch.clamp(count, min=1.0)


def yolo_loss(preds: Sequence[torch.Tensor], targets: torch.Tensor, tmask: torch.Tensor,
              cfg: LossConfig, aux_preds: Sequence[torch.Tensor] = (),
              on_aux: Optional[Callable[[], None]] = None):
    """Total training loss. Returns (scalar, dict of parts).

    preds: per level (bs, h, w, na, no) raw logits (the heads' views);
    targets: (bs, max_gt, 5) [cls, cx, cy, w, h] normalized; tmask: (bs,
    max_gt) bool; aux_preds: IAuxDetect's coarse maps on the same grids;
    on_aux: called once where the auxiliary pass starts (the train step's
    ``step_aux`` mark), never without ``aux_preds``.
    Parts: ``box``, ``obj``, ``cls`` (0-d tensors) and ``num_fg``; with
    ``aux_preds`` also ``num_fg_aux``, the widened assignment's positives.
    """
    nl = len(cfg.strides)
    dev = preds[0].device
    targets = targets.to(device=dev, dtype=torch.float32)
    tmask = tmask.to(device=dev, dtype=torch.bool)
    bs = targets.shape[0]
    img_size = float(cfg.input_size[0])  # yolo_loss.py:153 uses image H
    bidx = torch.arange(bs, device=dev)[:, None]

    # gt boxes in px (xywh -> xyxy); :153-156
    txywh = targets[:, :, 1:5] * img_size
    tbox_xyxy = torch.cat([txywh[..., :2] - txywh[..., 2:] / 2,
                           txywh[..., :2] + txywh[..., 2:] / 2], -1)
    tcls = targets[:, :, 0].to(torch.int32)

    def build_cands(gather_preds, g):
        """Candidate cells at offset gain g, with ``gather_preds`` gathered
        at those cells."""
        cand = []
        for i in range(nl):
            h, w = preds[i].shape[1], preds[i].shape[2]
            anchors_f = _const(cfg.anchors[i], dev) / float(cfg.strides[i])
            gt_idx, a_idx, gi, gj, mask = _candidates_level(
                targets, tmask, h, w, anchors_f, cfg.threshold, g)
            gp = gather_preds[i]
            if tuple(gp.shape[1:3]) != (h, w):
                raise ValueError(f"level {i}: gather map grid {tuple(gp.shape[1:3])} "
                                 f"!= lead ({h}, {w})")
            p_cand = gp[bidx, gj, gi, a_idx].float()               # (bs, C, no)
            cand.append(dict(gt=gt_idx, a=a_idx, gi=gi, gj=gj, mask=mask, p=p_cand,
                             anchors_f=anchors_f[a_idx[0]], h=h, w=w,
                             stride=float(cfg.strides[i])))
        return cand

    def match_cands(cand):
        """Decode the candidates (no gradient) and run SimOTA; per-level fg
        and matched gt, and the flat fg and mask."""
        pbox_all, pobj_all, pcls_all, mask_all = [], [], [], []
        for c in cand:
            p = c["p"].detach()
            sxy = torch.sigmoid(p[..., 0:2]) * 2.0 - 0.5
            pxy = (sxy + torch.stack([c["gi"], c["gj"]], -1)) * c["stride"]              # :190
            pwh = (torch.sigmoid(p[..., 2:4]) * 2.0) ** 2 * c["anchors_f"] * c["stride"]  # :191
            pbox_all.append(torch.cat([pxy - pwh / 2, pxy + pwh / 2], -1))
            pobj_all.append(p[..., 4])
            pcls_all.append(p[..., 5:])
            mask_all.append(c["mask"])
        mask_all = torch.cat(mask_all, 1)
        fg, matched_gt = _simota_match(tbox_xyxy, tcls, tmask, torch.cat(pbox_all, 1),
                                       torch.cat(pobj_all, 1), torch.cat(pcls_all, 1),
                                       mask_all, cfg.topk)
        sizes = [c["mask"].shape[1] for c in cand]
        return fg.split(sizes, 1), matched_gt.split(sizes, 1), fg, mask_all

    cand = build_cands(preds, 0.5)          # find_3_positive; yolo_loss.py:294
    fg_lvl, mg_lvl, fg, mask_all = match_cands(cand)

    cp, cn = smooth_bce(cfg.label_smoothing)        # yolo_loss.py:44

    def level_losses(preds_lvl, cand_lvl, fg_lvl, mg_lvl):
        box_total, obj_total, cls_total = [], [], []
        for i, (pl, c) in enumerate(zip(preds_lvl, cand_lvl)):
            sel = fg_lvl[i] & c["mask"]                             # (bs,C)
            count = global_count(sel.sum().float())     # over the global batch under a mesh
            self_f = sel.float()
            h, w, stride = c["h"], c["w"], c["stride"]
            na = pl.shape[3]
            mg = mg_lvl[i]

            tsel = torch.gather(targets, 1, mg[..., None].expand(-1, -1, 5))   # (bs,C,5)
            scale = _const([w, h, w, h], dev)
            tbox_f = tsel[..., 1:5] * scale                         # :97
            grid = torch.stack([c["gi"], c["gj"]], -1).float()
            tbox_f = torch.cat([tbox_f[..., 0:2] - grid, tbox_f[..., 2:4]], -1)  # :98

            p = c["p"]
            pxy = torch.sigmoid(p[..., 0:2]) * 2.0 - 0.5            # :92
            pwh = (torch.sigmoid(p[..., 2:4]) * 2.0) ** 2 * c["anchors_f"]  # :93
            iou = bbox_iou(torch.cat([pxy, pwh], -1), tbox_f, x1y1x2y2=False, ciou=True)  # :101
            box_total.append(_masked_mean(1.0 - iou, self_f, count))

            # obj targets: deterministic scatter-max of the gr-blended
            # detached IoU, tobj = (1-gr) + gr*iou; :105-106
            iou_d = iou.detach().clamp(min=0.0)
            tval = (1.0 - cfg.iou_ratio) + cfg.iou_ratio * iou_d
            flat_idx = ((bidx * h + c["gj"]) * w + c["gi"]) * na + c["a"]
            vals = torch.where(sel, tval, -1.0)
            tobj = torch.zeros(bs * h * w * na, dtype=torch.float32, device=dev)
            tobj.scatter_reduce_(0, flat_idx.reshape(-1), vals.reshape(-1), "amax")
            tobj = tobj.clamp(min=0.0).reshape(bs, h, w, na)
            obj_elem = qfocal_loss(pl[..., 4].float(), tobj, cfg.fl_gamma, cfg.fl_alpha)
            obj_total.append(global_mean(obj_elem) * _balance_for_stride(stride))

            # cls loss; :109-112
            t = cn + (cp - cn) * _one_hot(tsel[..., 0].to(torch.int32),
                                          cfg.num_classes).float()
            cls_elem = qfocal_loss(p[..., 5:], t, cfg.fl_gamma, cfg.fl_alpha)
            cls_total.append(torch.sum(cls_elem * self_f[..., None]) /
                             (torch.clamp(count, min=1.0) * cfg.num_classes))
        return sum(box_total), sum(obj_total), sum(cls_total)

    box_l, obj_l, cls_l = level_losses(preds, cand, fg_lvl, mg_lvl)

    aux_parts = {}
    if aux_preds:
        # YOLOv7's coarse-to-fine assignment: widened cells, a second SimOTA
        # match on the LEAD predictions, targets applied to the aux maps
        if on_aux is not None:
            on_aux()
        cost_cand = build_cands(preds, 1.0)
        afg_lvl, amg_lvl, afg, amask_all = match_cands(cost_cand)
        aux_parts["num_fg_aux"] = (afg & amask_all).sum()
        aux_cand = [dict(cc, p=ac["p"]) for cc, ac in
                    zip(cost_cand, build_cands(aux_preds, 1.0))]
        abox, aobj, acls = level_losses(aux_preds, aux_cand, afg_lvl, amg_lvl)
        box_l = box_l + cfg.aux_weight * abox
        obj_l = obj_l + cfg.aux_weight * aobj
        cls_l = cls_l + cfg.aux_weight * acls

    box_l = box_l * cfg.box_ratio       # :118-120
    obj_l = obj_l * cfg.obj_ratio
    cls_l = cls_l * cfg.cls_ratio
    loss = box_l + obj_l + cls_l        # :122
    return loss, {"box": box_l, "obj": obj_l, "cls": cls_l,
                  "num_fg": (fg & mask_all).sum(), **aux_parts}
