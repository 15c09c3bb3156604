"""SimOTA training loss for the IBin head (bin + residual box regression).

Counterpart of ``yolo_continuous_tpu/losses/bin_loss.py`` (``_bin_layout``,
``_decode_wh_ratio``, ``bin_yolo_loss``): the reference's IBin head
(``nets/ibin.py``) wired into the SimOTA machinery of
``losses/yolo_loss.py`` (``_candidates_level``, ``_simota_match``,
``_masked_mean``, ``_balance_for_stride``), in the order of the JAX
version's operations and with its ``stop_gradient`` points as ``.detach()``:

- channels per anchor (nets/ibin.py:20-21, 57-70): [x, y, w reg + 21 bins,
  h reg + 21 bins, obj, cls...];
- matching, obj and cls terms as the standard loss (obj targets the
  detached IoU itself, no gr blend);
- the box term: CIoU on the decoded boxes plus
  ``sigmoid_bin_training_loss`` on the w/h ratios (target gt_wh / anchor,
  clipped to the bin range [0, 4]), both at ``box_ratio``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops.boxes import bbox_iou
from ..parallel.mesh import global_count, global_mean
from ..ops.sigmoid_bin import SigmoidBinCfg, sigmoid_bin_decode, sigmoid_bin_training_loss
from .focal import qfocal_loss
from .yolo_loss import (LossConfig, _balance_for_stride, _candidates_level, _const, _masked_mean,
                        _one_hot, _simota_match, smooth_bce)

WH_BIN = SigmoidBinCfg(bin_count=21, vmin=0.0, vmax=4.0)  # nets/ibin.py:17-18


def _bin_layout(no_bin: int, nc: int) -> dict:
    n = WH_BIN.length  # 22
    if no_bin != nc + 3 + 2 * n:
        raise ValueError(f"IBin maps have {no_bin} channels an anchor, not {nc + 3 + 2 * n}")
    return dict(w=slice(2, 2 + n), h=slice(2 + n, 2 + 2 * n), obj=2 + 2 * n,
                cls=slice(3 + 2 * n, 3 + 2 * n + nc))


def _decode_wh_ratio(p: torch.Tensor, lay: dict):
    """Sigmoided bins -> decoded (w_ratio, h_ratio); nets/ibin.py:62-63."""
    return (sigmoid_bin_decode(torch.sigmoid(p[..., lay["w"]]), WH_BIN),
            sigmoid_bin_decode(torch.sigmoid(p[..., lay["h"]]), WH_BIN))


def bin_yolo_loss(preds: Sequence[torch.Tensor], targets: torch.Tensor, tmask: torch.Tensor,
                  cfg: LossConfig):
    """Total IBin training loss. Returns (scalar, parts): ``box``, ``obj``,
    ``cls``, ``bin`` (0-d tensors) and ``num_fg``.

    preds: per level (bs, h, w, na, nc + 3 + 44) raw logits (the heads'
    views); targets (bs, max_gt, 5) [cls, cx, cy, w, h] normalized; tmask
    (bs, max_gt) bool."""
    nl = len(cfg.strides)
    dev = preds[0].device
    targets = targets.to(device=dev, dtype=torch.float32)
    tmask = tmask.to(device=dev, dtype=torch.bool)
    bs = targets.shape[0]
    img_size = float(cfg.input_size[0])
    nc = cfg.num_classes
    lay = _bin_layout(preds[0].shape[-1], nc)
    bidx = torch.arange(bs, device=dev)[:, None]

    cand = []
    for i in range(nl):
        h, w = preds[i].shape[1], preds[i].shape[2]
        anchors_f = _const(cfg.anchors[i], dev) / float(cfg.strides[i])
        gt_idx, a_idx, gi, gj, mask = _candidates_level(targets, tmask, h, w, anchors_f,
                                                        cfg.threshold)
        cand.append(dict(gt=gt_idx, a=a_idx, gi=gi, gj=gj, mask=mask,
                         p=preds[i][bidx, gj, gi, a_idx].float(), anchors_f=anchors_f[a_idx[0]],
                         h=h, w=w, stride=float(cfg.strides[i])))

    # candidate boxes in px for the cost (no gradient)
    pbox_all, pobj_all, pcls_all, mask_all = [], [], [], []
    for c in cand:
        p = c["p"].detach()
        sxy = torch.sigmoid(p[..., 0:2]) * 2.0 - 0.5
        pxy = (sxy + torch.stack([c["gi"], c["gj"]], -1)) * c["stride"]
        wr, hr = _decode_wh_ratio(p, lay)
        pwh = torch.stack([wr, hr], -1) * c["anchors_f"] * c["stride"]
        pbox_all.append(torch.cat([pxy - pwh / 2, pxy + pwh / 2], -1))
        pobj_all.append(p[..., lay["obj"]])
        pcls_all.append(p[..., lay["cls"]])
        mask_all.append(c["mask"])
    mask_all = torch.cat(mask_all, 1)

    txywh = targets[:, :, 1:5] * img_size
    tbox_xyxy = torch.cat([txywh[..., :2] - txywh[..., 2:] / 2,
                           txywh[..., :2] + txywh[..., 2:] / 2], -1)
    tcls = targets[:, :, 0].to(torch.int32)
    fg, matched_gt = _simota_match(tbox_xyxy, tcls, tmask, torch.cat(pbox_all, 1),
                                   torch.cat(pobj_all, 1), torch.cat(pcls_all, 1), mask_all,
                                   cfg.topk)
    sizes = [c["mask"].shape[1] for c in cand]
    fg_lvl, mg_lvl = fg.split(sizes, 1), matched_gt.split(sizes, 1)

    cp, cn = smooth_bce(cfg.label_smoothing)
    box_t, obj_t, cls_t, bin_t = [], [], [], []
    for i, c in enumerate(cand):
        sel = fg_lvl[i] & c["mask"]
        sel_f = sel.float()
        count = global_count(sel.sum().float())    # over the global batch under a mesh
        h, w, stride = c["h"], c["w"], c["stride"]
        na = preds[i].shape[3]
        p = c["p"]

        tsel = torch.gather(targets, 1, mg_lvl[i][..., None].expand(-1, -1, 5))
        tbox_f = tsel[..., 1:5] * _const([w, h, w, h], dev)
        grid = torch.stack([c["gi"], c["gj"]], -1).float()
        tbox_f = torch.cat([tbox_f[..., 0:2] - grid, tbox_f[..., 2:4]], -1)

        # CIoU on the decoded boxes (the residual carries the gradient)
        pxy = torch.sigmoid(p[..., 0:2]) * 2.0 - 0.5
        wr, hr = _decode_wh_ratio(p, lay)
        pwh = torch.stack([wr, hr], -1) * c["anchors_f"]
        iou = bbox_iou(torch.cat([pxy, pwh], -1), tbox_f, x1y1x2y2=False, ciou=True)
        box_t.append(_masked_mean(1.0 - iou, sel_f, count))

        # SigmoidBin on the w/h ratios (sigmoid_bin.py:65-96)
        t_w = tbox_f[..., 2] / c["anchors_f"][..., 0]
        t_h = tbox_f[..., 3] / c["anchors_f"][..., 1]
        lw, _ = sigmoid_bin_training_loss(p[..., lay["w"]], t_w.clamp(WH_BIN.vmin, WH_BIN.vmax),
                                          WH_BIN, mask=sel_f)
        lh, _ = sigmoid_bin_training_loss(p[..., lay["h"]], t_h.clamp(WH_BIN.vmin, WH_BIN.vmax),
                                          WH_BIN, mask=sel_f)
        bin_t.append(lw + lh)

        # obj targets: deterministic scatter-max of the detached IoU
        iou_d = iou.detach().clamp(min=0.0)
        flat_idx = ((bidx * h + c["gj"]) * w + c["gi"]) * na + c["a"]
        tobj = torch.zeros(bs * h * w * na, dtype=torch.float32, device=dev)
        tobj.scatter_reduce_(0, flat_idx.reshape(-1), torch.where(sel, iou_d, -1.0).reshape(-1),
                             "amax")
        tobj = tobj.clamp(min=0.0).reshape(bs, h, w, na)
        obj_elem = qfocal_loss(preds[i][..., lay["obj"]].float(), tobj, cfg.fl_gamma, cfg.fl_alpha)
        obj_t.append(global_mean(obj_elem) * _balance_for_stride(stride))

        t = cn + (cp - cn) * _one_hot(tsel[..., 0].to(torch.int32), nc).float()
        cls_elem = qfocal_loss(p[..., lay["cls"]], t, cfg.fl_gamma, cfg.fl_alpha)
        cls_t.append(torch.sum(cls_elem * sel_f[..., None]) / (torch.clamp(count, min=1.0) * nc))

    box_l = sum(box_t) * cfg.box_ratio
    obj_l = sum(obj_t) * cfg.obj_ratio
    cls_l = sum(cls_t) * cfg.cls_ratio
    bin_l = sum(bin_t) * cfg.box_ratio
    loss = box_l + obj_l + cls_l + bin_l
    return loss, {"box": box_l, "obj": obj_l, "cls": cls_l, "bin": bin_l,
                  "num_fg": (fg & mask_all).sum()}
