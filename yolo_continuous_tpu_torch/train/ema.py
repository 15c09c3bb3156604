"""Exponential moving average of the model state, updated every step.

Counterpart of ``yolo_continuous_tpu/train/ema.py`` (``main/model_ema.py:31-57``):
ramped decay ``d = decay * (1 - exp(-updates / tau))`` (0.9999, 2000) over
every floating-point entry of the state dict, the parameters and the BN
running statistics. The EMA is a copy: nothing aliases the live tensors.
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

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        """e <- d * e + (1 - d) * p for every entry (foreach: a few launches)."""
        self.updates += 1
        d, one_minus_d = ema_decay(self.updates, self.decay, self.tau)
        live = model.state_dict()
        ema = list(self.tree.values())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, [live[k] for k in self.tree], alpha=one_minus_d)

    def state_dict(self) -> dict:
        return {"tree": self.tree, "updates": self.updates}

    def load_state_dict(self, state: dict) -> None:
        for k, v in state["tree"].items():
            self.tree[k].copy_(v)
        self.updates = int(state["updates"])
