"""Exponential moving average of the model state, updated every step.

Counterpart of ``yolo_continuous_tpu/train/ema.py`` (``main/model_ema.py:31-57``):
ramped decay ``d = decay * (1 - exp(-updates / tau))`` (0.9999, 2000) over
every floating-point entry of the state dict, the parameters and the BN
running statistics. The EMA is a copy: nothing aliases the live tensors.

An update has a host half and a device half, so that a captured train step
(``utils/capture.CapturedStep``) replays the device half with each step's
decay: ``advance`` counts the update and returns its ramp (host, fp32, as
JAX's ``ema_update``), and ``apply`` reads ``d`` and ``1 - d`` from a device
tensor. ``update`` does both.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0):
    """(d, 1 - d) after ``updates`` updates, each computed in fp32 as the JAX
    ``ema_update`` does."""
    u = torch.tensor(float(updates), dtype=torch.float32)
    d = decay * (1.0 - torch.exp(-u / tau))
    return d.item(), (1.0 - d).item()


class ModelEMA:
    """``tree``: name -> fp32 copy of each floating-point state-dict entry;
    ``updates``: the counter."""

    def __init__(self, model: nn.Module, decay: float = 0.9999, tau: float = 2000.0):
        self.decay, self.tau = float(decay), float(tau)
        self.tree: Dict[str, torch.Tensor] = {
            k: v.detach().clone() for k, v in model.state_dict().items() if v.is_floating_point()}
        self.updates = 0

    def advance(self):
        """Count one update; its (d, 1 - d), host floats."""
        self.updates += 1
        return ema_decay(self.updates, self.decay, self.tau)

    @torch.no_grad()
    def apply(self, model: nn.Module, coef: torch.Tensor) -> None:
        """e <- e * d + (1 - d) * p for every entry (JAX's order of rounding),
        d = coef[0] and 1 - d = coef[1] on the model's device (foreach: a
        few launches)."""
        live = model.state_dict()
        ema = list(self.tree.values())
        torch._foreach_mul_(ema, coef[0])
        torch._foreach_add_(ema, torch._foreach_mul([live[k] for k in self.tree], coef[1]))

    def update(self, model: nn.Module) -> None:
        """``advance`` and ``apply``."""
        coef = torch.tensor(self.advance(), dtype=torch.float32)
        self.apply(model, coef.to(next(iter(self.tree.values())).device))

    def state_dict(self) -> dict:
        return {"tree": self.tree, "updates": self.updates}

    def load_state_dict(self, state: dict) -> None:
        for k, v in state["tree"].items():
            self.tree[k].copy_(v)
        self.updates = int(state["updates"])
