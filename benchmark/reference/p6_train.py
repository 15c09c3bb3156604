"""The plain reference of the first steps of a training cell whose net has
auxiliary heads (``p6_model.P6Yolo``, ``aux_loss.aux_yolo_loss``).

As ``train.run_steps``, whose batch plans, staging, augmentation, schedule
(``hyper``) and EMA this reuses: fp32 weights, optimizer, EMA and loss, the
augmentation's pixels in fp64, the body in the configuration's precision,
TF32 off. SGD with Nesterov momentum over three groups: BatchNorm scales
(no weight decay), biases and the implicit rows (no weight decay, the
biases' rate: the JAX package's grouping; upstream ``train_aux.py`` puts the
implicit rows with the BatchNorm scales, which differs only in the warm-up's
rate, and no cell warms up), and every other weight (decayed).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import augment as A
from .aux_loss import aux_yolo_loss
from .p6_model import P6Yolo
from .train import batch_plans, ema_decay, hyper, staged_batch


def label_groups(model: torch.nn.Module) -> Dict[str, str]:
    bn_scales = {f"{n}.weight" for n, m in model.named_modules()
                 if isinstance(m, torch.nn.BatchNorm2d)}
    return {n: ("bn_scale" if n in bn_scales
                else "bias" if n.endswith((".bias", ".implicit")) else "weight")
            for n, _ in model.named_parameters()}


def run_steps(cfg: dict, train: dict, seed: int, files: List[bytes], boxes: List[np.ndarray],
              weights: Dict[str, torch.Tensor], steps: int = 3, device="cuda",
              fp8: bool = False, body_dtype=torch.float32, batches=None) -> dict:
    """The first ``steps`` steps, as ``train.run_steps`` returns them, and
    ``num_fg`` and ``num_fg_aux``, each step's lead and auxiliary
    positives."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    size, B, MB = cfg["image_size"], train["batch"], train["max_boxes"]
    model = P6Yolo(cfg).to(device)
    model.load_state_dict({k: v.to(device) for k, v in weights.items()}, strict=True)
    model.set_fp8(fp8).train()
    groups = label_groups(model)
    params = dict(model.named_parameters())
    bufs = {n: torch.zeros_like(p) for n, p in params.items()}
    ema = {k: v.detach().clone() for k, v in model.state_dict().items() if v.is_floating_point()}
    aug = A.params(train["enhance"], size)
    per_epoch = max(len(files) // B, 1)
    plans = batch_plans(len(files), seed, B, steps, train["enhance"]["mosaic"],
                        train["enhance"]["mix-up"])
    nl = len(model.strides)
    out = {"loss": [], "grad": {}, "augmented": [], "num_fg": [], "num_fg_aux": []}
    for step, (rows, mosaic, mixup) in enumerate(plans):
        batch = staged_batch(rows, files, boxes, size, MB, device)
        images, labels, lmask = A.augment(A.draws(seed, step, B, aug), *batch, mosaic, mixup,
                                          aug, MB)
        out["augmented"].append(tuple(t.cpu() for t in (images, labels, lmask)))
        del batch
        if batches is not None:
            images, labels, lmask = (t.to(device) for t in batches[step])
        model.zero_grad(set_to_none=True)
        maps = model(images.permute(0, 3, 1, 2).contiguous(), body_dtype)
        loss, parts = aux_yolo_loss(maps[:nl], maps[nl:], labels, lmask, cfg["num_classes"],
                                    model.strides, model.anchors, size, train["anchor_t"],
                                    train["focal_gamma"], train["focal_alpha"])
        del maps
        loss.backward()
        out["loss"].append(float(loss.detach()))
        out["num_fg"].append(int(parts["num_fg"]))
        out["num_fg_aux"].append(int(parts["num_fg_aux"]))
        lr_w, lr_b, momentum = hyper(train, step, per_epoch)
        with torch.no_grad():
            for n, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if groups[n] == "weight":
                    g = g + train["weight_decay"] * p
                if step == 0:
                    out["grad"][n] = g.clone()
                bufs[n].mul_(momentum).add_(g)
                lr = lr_b if groups[n] == "bias" else lr_w
                p.sub_(lr * (g + momentum * bufs[n]))
            d = ema_decay(step + 1)
            live = model.state_dict()
            for k, e in ema.items():
                e.mul_(d).add_((1.0 - d) * live[k])
        del images, labels, lmask, loss, parts
    out["params"] = {n: p.detach() for n, p in params.items()}
    out["ema"] = ema
    return out
