"""The plain reference of a training cell's first steps: fp32 weights,
optimizer, EMA and loss, the augmentation's pixels in fp64, the body in the
configuration's precision (``model.PlainYolo.forward``), TF32 off.

From the files the benchmark wrote, the seed and the initial weights, it works
out again what the program derives: each step's batch plan (the dataset's
shuffle, mosaic and mixup draws from ``RandomState([seed, epoch])``), the
staged canvases (``staging.stage``), the augmentation's draws and the
augmented batch (``augment``), the SimOTA loss (``yolo_loss``), SGD with
Nesterov momentum over three groups (BatchNorm scales and biases without
weight decay, biases at their own rate), the learning rates of the warm-up
and the epoch's decay (``hyper``, upstream ``train.py:63-102``), and the EMA
with its ramped decay ``0.9999 (1 - exp(-updates / 2000))`` over every
floating entry of the state dict. Each is written from the JAX package's
statement of it; none is the port's code.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import augment as A
from .model import PlainYolo
from .staging import decode_rgb, stage
from .yolo_loss import yolo_loss


def batch_plans(n: int, seed: int, batch: int, steps: int, mosaic_prob: float,
                mixup_prob: float):
    """The first ``steps`` batches of epoch 0: per sample its 4 tile indices
    and its mosaic and mixup flags."""
    rng = np.random.RandomState([seed & 0x7FFFFFFF, 0])
    order = rng.permutation(n)
    plans = []
    for s in range(steps):
        rows, mos, mix = [], [], []
        for i in order[s * batch:(s + 1) * batch].tolist():
            use_mosaic = bool(rng.rand() < mosaic_prob)
            use_mixup = bool(use_mosaic and rng.rand() < mixup_prob)
            idxs = [i]
            if use_mosaic:
                idxs = rng.randint(0, n, 3).tolist() + [i]
                rng.shuffle(idxs)
            rows.append(idxs if use_mosaic else [i] * 4)
            mos.append(use_mosaic)
            mix.append(use_mixup)
        plans.append((rows, np.array(mos, bool), np.array(mix, bool)))
    return plans


def hyper(train: dict, step: int, steps_per_epoch: int) -> Tuple[float, float, float]:
    """(weights' and BatchNorm's learning rate, biases' learning rate,
    momentum) of ``step``: the epoch's rate ``lrI * lf(epoch)`` (upstream
    ``learningrate_scheduler.py:33-97``, ``y1 = 1``, ``y2 = lrF``); during the
    warm-up (``warm_up.py:12-21``) ramps from 0 (biases from
    ``warmup_bias_lr``) and from ``warmup_momentum``."""
    epochs, lr0, y2 = max(int(train["epochs"]), 1), train["lrI"], float(train["lrF"])
    epoch = step // steps_per_epoch
    x = min(epoch, epochs - 1)
    lf = {"Linear": lambda: y2 - (y2 - 1.0) * (1.0 - x / max(epochs - 1, 1)),
          "InverseTime": lambda: y2 - (y2 - 1.0) / (1 + 0.1 * x),
          "Exponential": lambda: y2 - (y2 - 1.0) * math.pow(0.96, x),
          "Natural_Exponential": lambda: y2 - (y2 - 1.0) * math.exp(-0.04 * x),
          "Cosine": lambda: y2 - (y2 - 1.0) * (1 + math.cos(x * math.pi / epochs)) / 2,
          }.get(train["decay"], lambda: x)()
    limit = max(train["warmup_max_iter"], steps_per_epoch * train["warmup_epochs"])
    if train["warmup"] and epoch < train["warmup_epochs"] and step < limit:
        ramp = min(max(step / limit, 0.0), 1.0)
        return (lr0 * ramp, train["warmup_bias_lr"] + (lr0 - train["warmup_bias_lr"]) * ramp,
                train["warmup_momentum"] + (train["momentum"] - train["warmup_momentum"]) * ramp)
    return lr0 * lf, lr0 * lf, train["momentum"]


def staged_batch(rows, files: List[bytes], boxes: List[np.ndarray], size: int,
                 max_boxes: int, device):
    """(tiles (B, 4, S, S, 3) u8, metas (B, 4, 5), boxes (B, 4, MB, 5), masks)."""
    cache: Dict[int, tuple] = {}
    B = len(rows)
    tiles = torch.empty((B, 4, size, size, 3), dtype=torch.uint8, device=device)
    metas = np.zeros((B, 4, 5), np.float32)
    bx = np.zeros((B, 4, max_boxes, 5), np.float32)
    bm = np.zeros((B, 4, max_boxes), bool)
    for b, row in enumerate(rows):
        for t, j in enumerate(row):
            if j not in cache:
                cache[j] = stage(decode_rgb(files[j]), size, device=device)
            tiles[b, t], metas[b, t] = cache[j]
            k = min(len(boxes[j]), max_boxes)
            bx[b, t, :k], bm[b, t, :k] = boxes[j][:k], True
    to = (lambda a: torch.from_numpy(a).to(device))
    return tiles, to(metas), to(bx), to(bm)


def label_groups(model: torch.nn.Module) -> Dict[str, str]:
    bn_scales = {f"{n}.weight" for n, m in model.named_modules()
                 if isinstance(m, torch.nn.BatchNorm2d)}
    return {n: ("bn_scale" if n in bn_scales else "bias" if n.endswith(".bias") else "weight")
            for n, _ in model.named_parameters()}


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> float:
    u = torch.tensor(float(updates), dtype=torch.float32)
    return float(decay * (1.0 - torch.exp(-u / tau)))


def run_steps(cfg: dict, train: dict, seed: int, files: List[bytes], boxes: List[np.ndarray],
              weights: Dict[str, torch.Tensor], steps: int = 3, device="cuda",
              fp8: bool = False, body_dtype=torch.float32, batches=None) -> dict:
    """The first ``steps`` steps of a training cell, the body in
    ``body_dtype`` on fp32 weights (``model.PlainYolo.forward``). Returns
    each step's augmented batch (on the host), each step's loss, each
    parameter's first gradient as the optimizer takes it, and the state
    after the last step. With ``batches`` (a batch a step: images, labels,
    mask) the steps are taken on those instead of its own augmented batches,
    which it still works out and returns. cuDNN runs its deterministic
    algorithms, as the program's trainer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    size, B, MB = cfg["image_size"], train["batch"], train["max_boxes"]
    model = PlainYolo(cfg).to(device)
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
    out = {"loss": [], "grad": {}, "augmented": []}
    for step, (rows, mosaic, mixup) in enumerate(plans):
        batch = staged_batch(rows, files, boxes, size, MB, device)
        images, labels, lmask = A.augment(A.draws(seed, step, B, aug), *batch, mosaic, mixup,
                                          aug, MB)
        out["augmented"].append(tuple(t.cpu() for t in (images, labels, lmask)))
        if batches is not None:
            images, labels, lmask = (t.to(device) for t in batches[step])
        model.zero_grad(set_to_none=True)
        loss = yolo_loss(model(images.permute(0, 3, 1, 2).contiguous(), body_dtype), labels,
                         lmask, cfg["num_classes"], model.strides, model.anchors, size,
                         train["anchor_t"], train["focal_gamma"], train["focal_alpha"])
        loss.backward()
        out["loss"].append(float(loss.detach()))
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
        del images, labels, lmask, loss
    out["params"] = {n: p.detach() for n, p in params.items()}
    out["ema"] = ema
    return out
