"""The numbers that decide ``correct``: the program's outputs against the
plain reference's. Each function returns plain floats; the limits live in
``benchmark/limits/<workload>.json``."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from .postprocess import box_iou

# a reference leaf whose first gradient is under this share of the median
# leaf's gradient moves by round-off alone (a bias under a following
# BatchNorm): it is left out of the comparison of changes
STILL_LEAF = 1e-3


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: Optional[Iterable[str]] = None) -> List[float]:
    """Per leaf, |prog - ref| / max(ref, median ref): the gap between the two
    norms of a leaf, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    keys = list(ref if keys is None else keys)
    med = float(np.median([ref[k] for k in keys]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], keys=None, n: int = 5):
    """The ``n`` leaves of the widest gaps: (gap, name, program's norm,
    reference's norm)."""
    keys = list(ref if keys is None else keys)
    med = float(np.median([ref[k] for k in keys]))
    rows = [(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k, prog[k], ref[k]) for k in keys]
    return sorted(rows, reverse=True)[:n]


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= STILL_LEAF * med]


def detection_gaps(prog: Sequence, ref: Sequence, iou_min: float = 0.5) -> Dict[str, float]:
    """The kept detections of a batch of images against the reference's.

    ``prog[i]`` and ``ref[i]``: the kept detections of image i, (boxes xyxy
    (k, 4), scores (k,), classes (k,)), in the same box space. The reference's
    detections, in the order of their scores, each take the program's
    detection of the same class, not yet taken, that overlaps it most, if
    their IoU is ``iou_min`` or more. A matched pair's gap is the larger of
    1 - IoU and the relative gap of the scores. ``det_gap`` is the widest gap
    of a pair, ``missed`` the share of the reference's detections left
    without a match, ``extra`` the share of the program's.
    """
    gaps, n_ref, n_prog, missed, extra = [0.0], 0, 0, 0, 0
    for (pb, ps, pc), (rb, rs, rc) in zip(prog, ref):
        n_ref, n_prog = n_ref + len(rs), n_prog + len(ps)
        if not len(rs) or not len(ps):
            missed, extra = missed + len(rs), extra + len(ps)
            continue
        iou = box_iou(rb.double(), pb.double())
        iou = torch.where(rc.long()[:, None] == pc.long()[None, :], iou,
                          torch.full_like(iou, -1.0)).cpu().numpy()
        r_s, p_s = rs.double().cpu().numpy(), ps.double().cpu().numpy()
        free = np.ones(len(p_s), bool)
        for r in np.argsort(-r_s, kind="stable"):
            row = np.where(free, iou[r], -1.0)
            j = int(row.argmax())
            if row[j] < iou_min:
                missed += 1
                continue
            free[j] = False
            gaps.append(max(1.0 - row[j], abs(p_s[j] - r_s[r]) / max(r_s[r], 1e-12)))
        extra += int(free.sum())
    return {"det_gap": float(max(gaps)), "missed": missed / max(n_ref, 1),
            "extra": extra / max(n_prog, 1)}
