"""The reference's 3-param-group optimizer, as foreach ops on device scalars.

Counterpart of ``yolo_continuous_tpu/train/optimizer.py`` (``main/optimizer.py:20-52``):

- ``bn_scale``: BatchNorm weights (pg0, no weight decay);
- ``weight``: every other weight (pg1, weight decay);
- ``bias``: biases (pg2, no decay; their own warm-up ramp) and, the JAX
  package's deliberate fix, the ``implicit`` parameters of ImplicitA/M,
  which the reference leaves untrained.

SGD with Nesterov momentum, or Adam with ``betas=(momentum, 0.999)``, in
JAX's formulas (``optimizer.py:85-121``): weight decay added to the
gradient, then ``buf = m * buf + g``, ``d = g + m * buf``, ``p -= lr * d``;
Adam's bias-corrected moments with eps outside the square root. The
learning rates and the momentum change every step (``ops/schedules``'
warm-up ramps all three), so ``step`` reads them from a device tensor
``hyper = (lr_w, lr_b, mom, ...)``, as JAX feeds them to its jitted step
as runtime scalars: a captured step (``utils/capture.CapturedStep``)
replays with each step's values, where ``torch.optim`` would bake its
Python floats into the graph. The ``foreach`` ops update the ~400 tensors
of yolov7 in a few launches per group.

The buffers are made at construction, as zeros (JAX's ``init``), so every
step takes the same branch (``0 * m + g = g`` exactly), and a load copies
into them (``load_state_dict``): a captured step reads them by address.
The state dict keeps ``torch.optim``'s layout (``momentum_buffer``; Adam's
``step``, ``exp_avg``, ``exp_avg_sq``), so checkpoints that
``torch.optim.SGD`` and ``Adam`` wrote load too.
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


class Optimizer(torch.optim.Optimizer):
    """SGD-Nesterov (or Adam) over ``groups`` (each with a ``label`` and a
    ``weight_decay``); ``step(hyper)`` reads ``hyper[0]`` (lr of every group
    but ``bias``), ``hyper[1]`` (lr of ``bias``) and ``hyper[2]`` (SGD's
    momentum, Adam's beta1) on the parameters' device. Parameters without a
    gradient are left alone, as ``torch.optim`` does."""

    def __init__(self, groups, adam: bool, beta2: float = 0.999, eps: float = 1e-8):
        super().__init__(groups, dict(weight_decay=0.0))
        self.adam, self.beta2, self.eps = bool(adam), float(beta2), float(eps)
        params = [p for g in self.param_groups for p in g["params"]]
        if self.adam:
            # one step count (fp32, on the card) for all: torch.optim keeps one
            # a parameter, and its state dict does here too
            self._t = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for p in params:
            if self.adam:
                self.state[p] = {"step": self._t, "exp_avg": torch.zeros_like(p),
                                 "exp_avg_sq": torch.zeros_like(p)}
            else:
                self.state[p] = {"momentum_buffer": torch.zeros_like(p)}

    def load_state_dict(self, state_dict) -> None:
        """``torch.optim``'s load, its values copied into the buffers made at
        construction; a parameter it holds no state for (a checkpoint saved
        before the first step of ``torch.optim.SGD``) gets zeros."""
        held = {p: dict(s) for p, s in self.state.items()}
        super().load_state_dict(state_dict)
        for bufs in held.values():
            for buf in bufs.values():
                buf.zero_()
        for p, bufs in held.items():
            for k, v in self.state[p].items():
                if k in bufs:
                    bufs[k].copy_(v)
            self.state[p] = bufs

    @torch.no_grad()
    def step(self, hyper: torch.Tensor) -> None:
        lr_w, lr_b, mom = hyper[0], hyper[1], hyper[2]
        if self.adam:
            self._t.add_(1.0)
            bc1 = 1.0 - torch.pow(mom, self._t)           # fp32, as JAX's mom ** t
            bc2 = 1.0 - torch.pow(self.beta2, self._t)
            one_minus_mom = 1.0 - mom
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            lr = lr_b if group["label"] == "bias" else lr_w
            if self.adam:
                m = [self.state[p]["exp_avg"] for p in params]
                v = [self.state[p]["exp_avg_sq"] for p in params]
                torch._foreach_mul_(m, mom)                    # m = mom m + (1 - mom) g
                torch._foreach_add_(m, torch._foreach_mul(grads, one_minus_mom))
                gg = torch._foreach_mul(grads, 1.0 - self.beta2)   # (1 - b2) g g
                torch._foreach_mul_(gg, grads)
                torch._foreach_mul_(v, self.beta2)
                torch._foreach_add_(v, gg)
                den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
                torch._foreach_add_(den, self.eps)
                d = torch._foreach_mul(torch._foreach_div(m, bc1), lr)
                torch._foreach_div_(d, den)                    # lr mhat / (sqrt(vhat) + eps)
            else:
                bufs = [self.state[p]["momentum_buffer"] for p in params]
                torch._foreach_mul_(bufs, mom)                 # buf = m buf + g
                torch._foreach_add_(bufs, grads)
                d = torch._foreach_mul(bufs, mom)              # d = g + m buf
                torch._foreach_add_(d, grads)
                torch._foreach_mul_(d, lr)
            torch._foreach_sub_(params, d)


def make_optimizer(plan, model: nn.Module) -> Optimizer:
    """SGD-Nesterov (or Adam, plan key ``adam``) over the three groups, weight
    decay (``weight_decay``) on ``weight`` only. The plan's ``momentum`` is
    the schedule's (``ops/schedules.LRSchedule``), fed through ``hyper``."""
    labels = label_params(model)
    wd = float(plan.weight_decay)
    groups = [dict(params=[p for n, p in model.named_parameters() if labels[n] == g], label=g,
                   weight_decay=wd if g == "weight" else 0.0) for g in GROUPS]
    return Optimizer(groups, adam=bool(plan.adam))
