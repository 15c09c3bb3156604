"""The reference's 3-param-group optimizer, on torch.optim.

Counterpart of ``yolo_continuous_tpu/train/optimizer.py`` (``main/optimizer.py:20-52``):

- ``bn_scale``: BatchNorm weights (pg0, no weight decay);
- ``weight``: every other weight (pg1, weight decay);
- ``bias``: biases (pg2, no decay; their own warm-up ramp) and, the JAX
  package's deliberate fix, the ``implicit`` parameters of ImplicitA/M,
  which the reference leaves untrained.

SGD with Nesterov momentum, or Adam with ``betas=(momentum, 0.999)``. The
JAX version states torch semantics (weight decay added to the gradient,
then the momentum update), so ``torch.optim`` is the same function; its
``foreach`` form updates the ~400 tensors of yolov7 in a few launches per
group. Learning rates and momentum change every step (``set_hyper``, from
``ops/schedules.StepHyper``).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

GROUPS = ("bn_scale", "weight", "bias")


def label_params(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> 'bn_scale' | 'weight' | 'bias'."""
    bn_scales = {f"{name}.weight" for name, m in model.named_modules()
                 if isinstance(m, nn.BatchNorm2d)}
    labels = {}
    for name, _ in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in bn_scales:
            labels[name] = "bn_scale"   # pg0 (main/optimizer.py:37-38)
        elif leaf in ("bias", "implicit"):
            labels[name] = "bias"       # pg2 (:35-36), and the implicit fix
        else:
            labels[name] = "weight"     # pg1 (:39-40)
    return labels


def make_optimizer(plan, model: nn.Module) -> torch.optim.Optimizer:
    """SGD-Nesterov (or Adam, plan key ``adam``) over the three groups, weight
    decay (``weight_decay``) on ``weight`` only. The learning rates start at
    0; ``set_hyper`` sets them before every step."""
    labels = label_params(model)
    wd = float(plan.weight_decay)
    groups = [dict(params=[p for n, p in model.named_parameters() if labels[n] == g], label=g,
                   weight_decay=wd if g == "weight" else 0.0) for g in GROUPS]
    if plan.adam:
        return torch.optim.Adam(groups, lr=0.0, betas=(float(plan.momentum), 0.999), eps=1e-8,
                                foreach=True)
    return torch.optim.SGD(groups, lr=0.0, momentum=float(plan.momentum), nesterov=True,
                           foreach=True)


def set_hyper(optimizer: torch.optim.Optimizer, lr_w: float, lr_b: float, mom: float) -> None:
    """One step's learning rates (``lr_b`` for the bias group, ``lr_w`` for
    the others) and momentum (SGD's momentum, Adam's beta1)."""
    for g in optimizer.param_groups:
        g["lr"] = float(lr_b if g["label"] == "bias" else lr_w)
        if "betas" in g:
            g["betas"] = (float(mom), g["betas"][1])
        else:
            g["momentum"] = float(mom)
