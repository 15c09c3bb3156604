"""Fixed-capacity class-aware non-maximum suppression on tensors.

Counterpart of ``yolo_continuous_tpu/ops/nms.py``:

1. score = obj * max(cls) (``detect.py:108-111``), threshold filter,
2. top-K selection (static capacity ``max_det``),
3. class-aware greedy suppression (the torchvision per-class keep-set),
4. optional letterbox un-mapping (``detect.py:147-165``).

Outputs have fixed shapes (boxes, scores, classes, valid). Steps 1, 2 and
the xywh -> xyxy conversion are torch ops, as they are XLA ops outside
Pallas in JAX. Step 3 is ``suppress``: CUDA tensors go to kernel K1
(K <= 1024) or K2 (K > 1024), split as ``nms.py:100-109``
(``kernels/nms.py``, ``csrc/nms.cu``); CPU tensors go to the plain version
``suppress_plain``, the fixpoint of ``_fixpoint_suppress``. The batch is
written out where JAX uses ``vmap``. On CUDA K may be at most ``K2_MAX``
(28,544, above a 640 px plan's 25,200 candidates); above it ``suppress``
raises a ValueError. The plain path has no limit.

``nms_single`` and ``batched_nms`` are JAX's jitted functions
(``_nms_single_jit``, ``_batched_nms_jit``, ``ops/nms.py:141-178``), one
compiled program per static ``(max_det, per_class)``. On a CUDA tensor the
port replays one captured CUDA graph (``utils/capture.CapturedCall``) per
``(device, shape, dtype, conf_thres, iou_thres, max_det, per_class)``:
kernels K1 and K2 take ``iou_thres`` as a launch argument, which the capture
bakes into the graph, so both thresholds key it where JAX traces them. The
graphs stay in a cache of the ``NMS_GRAPHS`` most recently used keys
(``_compiled``); a capture that fails raises ``CaptureError`` and nothing
runs in its place. A CPU tensor takes the eager function. ``nms_core`` is
the eager function on any device: what a caller that captures its own
graph calls inside it (``Detector.infer_eager``), since one capture cannot
hold another.

IoU is ``box_iou``'s ``inter / union``, as JAX's XLA route
(``ops/boxes.py:75``), which is the oracle of the JAX tests. JAX's TPU
kernels divide by ``union + 1e-9`` (``kernels/nms_pallas.py:43,114``), which
decides some pairs of small boxes differently at the threshold; the port
keeps the XLA route (``csrc/nms.cu`` says more, and
``tests/test_torch_port_nms.py`` pins such a pair).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.capture import CapturedCall
from .boxes import box_iou

# The compiled NMS's cache: at most this many captured graphs, the most
# recently used kept. A server or a bench calls one or two keys; eight
# leave room for a validation's and a demo's thresholds beside them.
NMS_GRAPHS = 8
_graphs: "OrderedDict[tuple, CapturedCall]" = OrderedDict()
_graphs_lock = threading.Lock()       # a CapturedCall takes one caller at a time


def _greedy_suppress(iou: torch.Tensor, same_class: torch.Tensor, valid: torch.Tensor,
                     iou_thres: float) -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted candidates (sequential oracle):
    element i is kept iff no kept j < i suppresses it."""
    k = iou.shape[0]
    suppress = (iou > iou_thres) & same_class
    idx = torch.arange(k, device=iou.device)
    keep = valid.clone()
    for i in range(k):
        if keep[i]:
            keep &= ~(suppress[i] & (idx > i))
    return keep


def _fixpoint_suppress(iou: torch.Tensor, same_class: torch.Tensor, valid: torch.Tensor,
                       iou_thres: float) -> torch.Tensor:
    """Exact greedy NMS as a dataflow fixpoint, batched over leading axes.

    keep_{t+1}[j] = valid[j] & not any_i (sup[i, j] & keep_t[i]), with
    sup[i, j] = higher-scored i would suppress j; converges to the greedy
    keep-set in (max chain depth + 1) iterations."""
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    sup = ((iou > iou_thres) & same_class & (idx[None, :] > idx[:, None])).float()
    keep, prev, it = valid, torch.zeros_like(valid), 0
    while it < k and bool((keep != prev).any()):
        hit = (keep.float().unsqueeze(-2) @ sup).squeeze(-2) > 0.5
        keep, prev, it = valid & ~hit, keep, it + 1
    return keep


def suppress_plain(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
                   iou_thres: float) -> torch.Tensor:
    """Plain version of kernels K1/K2: ``(B, K, 4)`` xyxy boxes, ``(B, K)``
    classes and valid -> ``(B, K)`` keep."""
    iou = box_iou(boxes, boxes)
    same_class = classes[..., :, None] == classes[..., None, :]
    return _fixpoint_suppress(iou, same_class, valid, iou_thres)


def suppress(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
             iou_thres: float) -> torch.Tensor:
    """Keep-set of score-sorted candidates: kernel K1/K2 for CUDA tensors,
    ``suppress_plain`` for CPU tensors."""
    if boxes.device.type == "cuda":
        from ..kernels.nms import K1_MAX, K2_MAX, nms_suppress, nms_suppress_tiled
        if boxes.shape[1] > K2_MAX:
            raise ValueError(f"NMS on CUDA takes at most K2_MAX = {K2_MAX} candidates an image "
                             f"(max_det), got {boxes.shape[1]}: the sweep of kernel K2 keeps two "
                             "32-row chunks of its mask in a block's shared memory")
        args = (boxes.contiguous(), classes.to(torch.int32).contiguous(), valid.contiguous())
        if boxes.shape[1] > K1_MAX:
            # the (K, K) bitmask of K1 outgrows shared memory; beyond that,
            # the fixpoint kernel recomputes IoUs per sweep
            return nms_suppress_tiled(*args, iou_thres)
        return nms_suppress(*args, iou_thres)
    if boxes.device.type != "cpu":
        raise ValueError(f"NMS runs on CUDA (kernel) or CPU (plain) tensors, got {boxes.device}")
    return suppress_plain(boxes, classes, valid, iou_thres)


def top_candidates(pred: torch.Tensor, conf_thres: float, k: int):
    """``(bs, N, 5+nc)`` -> the score-sorted top ``k`` candidates of each
    image: boxes xyxy ``(bs, k, 4)``, scores, int32 classes, valid."""
    pred = pred.float()
    bs = pred.shape[0]
    obj = pred[..., 4]
    cls_conf, cls_id = pred[..., 5:].max(dim=-1)
    score = obj * cls_conf                      # detect.py:111,133
    ranked = torch.where(score >= conf_thres, score, torch.full_like(score, -1.0))
    top_scores, top_idx = torch.topk(ranked, k, dim=-1)
    valid = top_scores > 0.0
    boxes_xywh = torch.gather(pred[..., :4], 1, top_idx[..., None].expand(bs, k, 4))
    boxes = torch.cat([boxes_xywh[..., :2] - boxes_xywh[..., 2:] / 2,
                       boxes_xywh[..., :2] + boxes_xywh[..., 2:] / 2], dim=-1)  # detect.py:98-103
    classes = torch.gather(cls_id, 1, top_idx).to(torch.int32)
    return boxes, top_scores, classes, valid


def nms_core(pred: torch.Tensor, conf_thres: float, iou_thres: float, max_det: int,
             per_class: bool = True):
    """Batched post-process, eager on the tensor's device: ``(bs, N, 5+nc)``
    -> fixed ``max_det`` slots (boxes, scores, classes, valid)."""
    k = min(max_det, pred.shape[1])
    boxes, top_scores, classes, valid = top_candidates(pred, conf_thres, k)
    keep = suppress(boxes, classes if per_class else torch.zeros_like(classes), valid, iou_thres)
    if k < max_det:  # pad up to the static capacity
        padn = max_det - k
        boxes = F.pad(boxes, (0, 0, 0, padn))
        top_scores = F.pad(top_scores, (0, padn))
        classes = F.pad(classes, (0, padn))
        keep = F.pad(keep, (0, padn))
    return boxes, top_scores, classes, keep


def _single_core(pred, conf_thres, iou_thres, max_det, per_class):
    return tuple(t[0] for t in nms_core(pred[None], conf_thres, iou_thres, max_det, per_class))


def _replays(pred) -> bool:
    """Whether ``pred`` takes the compiled route: a CUDA tensor."""
    return isinstance(pred, torch.Tensor) and pred.device.type == "cuda"


def _compiled(core, pred: torch.Tensor, conf_thres: float, iou_thres: float, max_det: int,
              per_class: bool):
    """``core(pred, ...)`` through the graph captured for this key (captured
    at the key's first call: a warm-up, the capture, then a replay). Outside
    inference mode, so that a graph made under one serves calls made outside
    it (its static buffers are ordinary tensors); no autograd either way."""
    key = (core.__name__, pred.device, tuple(pred.shape), pred.dtype, float(conf_thres),
           float(iou_thres), int(max_det), bool(per_class))
    with _graphs_lock, torch.inference_mode(False), torch.no_grad():
        call = _graphs.get(key)
        if call is None:
            call = CapturedCall(lambda p: core(p, key[4], key[5], key[6], key[7]), pred)
            _graphs[key] = call
            while len(_graphs) > NMS_GRAPHS:
                _graphs.popitem(last=False)
        _graphs.move_to_end(key)
        return call(pred)


def nms_single(pred: torch.Tensor, conf_thres: float = 0.5, iou_thres: float = 0.4,
               max_det: int = 300, per_class: bool = True):
    """One image ``(N, 5+nc)`` -> (boxes_xyxy (max_det, 4), scores, classes,
    valid): a replay of the compiled NMS on CUDA, eager on the CPU."""
    if _replays(pred):
        return _compiled(_single_core, pred, conf_thres, iou_thres, max_det, per_class)
    return _single_core(pred, conf_thres, iou_thres, max_det, per_class)


def batched_nms(pred: torch.Tensor, conf_thres: float = 0.5, iou_thres: float = 0.4,
                max_det: int = 300, per_class: bool = True):
    """``(bs, N, 5+nc)`` -> (boxes (bs, max_det, 4), scores, classes, valid):
    a replay of the compiled NMS on CUDA, eager (``nms_core``) on the CPU."""
    if _replays(pred):
        return _compiled(nms_core, pred, conf_thres, iou_thres, max_det, per_class)
    return nms_core(pred, conf_thres, iou_thres, max_det, per_class)


def yolo_correct_boxes_np(boxes_xyxy, input_shape, image_shapes, letterbox_image: bool = True):
    """Host-side (numpy) twin of :func:`yolo_correct_boxes`, batched over
    leading axes of ``boxes_xyxy`` (..., N, 4) with ``image_shapes`` (..., 2)."""
    boxes_xyxy = np.asarray(boxes_xyxy, np.float32)
    input_shape = np.asarray(input_shape, np.float32)            # (2,)
    image_shapes = np.asarray(image_shapes, np.float32)          # (..., 2)
    img = image_shapes[..., None, :]                             # (..., 1, 2)
    box_yx = ((boxes_xyxy[..., 0:2] + boxes_xyxy[..., 2:4]) / 2)[..., ::-1]
    box_hw = (boxes_xyxy[..., 2:4] - boxes_xyxy[..., 0:2])[..., ::-1]
    if letterbox_image:
        new_shape = np.round(img * np.min(input_shape / img, axis=-1, keepdims=True))
        offset = (input_shape - new_shape) / 2.0 / input_shape
        scale = input_shape / new_shape
        box_yx = (box_yx - offset) * scale
        box_hw = box_hw * scale
    boxes = np.concatenate([box_yx - box_hw / 2.0, box_yx + box_hw / 2.0], axis=-1)
    return boxes * np.concatenate([img, img], axis=-1)


def yolo_correct_boxes(boxes_xyxy: torch.Tensor, input_shape, image_shape,
                       letterbox_image: bool = True) -> torch.Tensor:
    """Map normalized net-space boxes back to original-image pixels (y1x1y2x2).

    Mirrors ``detect.py:147-165`` (y/x order, scaled by the original image
    shape)."""
    box_yx = ((boxes_xyxy[..., 0:2] + boxes_xyxy[..., 2:4]) / 2).flip(-1)
    box_hw = (boxes_xyxy[..., 2:4] - boxes_xyxy[..., 0:2]).flip(-1)
    dev = boxes_xyxy.device
    input_shape = torch.as_tensor(input_shape, dtype=torch.float32, device=dev)
    image_shape = torch.as_tensor(image_shape, dtype=torch.float32, device=dev)
    if letterbox_image:
        new_shape = torch.round(image_shape * torch.min(input_shape / image_shape))
        offset = (input_shape - new_shape) / 2.0 / input_shape
        scale = input_shape / new_shape
        box_yx = (box_yx - offset) * scale
        box_hw = box_hw * scale
    boxes = torch.cat([box_yx - box_hw / 2.0, box_yx + box_hw / 2.0], dim=-1)
    return boxes * torch.cat([image_shape, image_shape], dim=-1)
