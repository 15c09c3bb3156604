"""Focal / Quality-Focal losses around an elementwise BCE-with-logits.

Counterpart of ``yolo_continuous_tpu/losses/focal.py`` (``focal_loss.py:5-29``
and ``quality_focal_loss.py:5-28`` of the reference). The formulas, and the
order of their operations, are the JAX package's.
"""
from __future__ import annotations

import torch


def bce_with_logits(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Elementwise BCEWithLogits, numerically stable (torch formula)."""
    return pred.clamp(min=0) - pred * true + torch.log1p(torch.exp(-pred.abs()))


def _safe_pow(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """x**gamma with a zero (not NaN) gradient at x == 0: the double where
    of the JAX version."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, safe ** gamma, torch.zeros_like(x))


def focal_loss(pred: torch.Tensor, true: torch.Tensor, gamma: float = 1.5,
               alpha: float = 0.25) -> torch.Tensor:
    """Elementwise focal loss; focal_loss.py:18-22."""
    loss = bce_with_logits(pred, true)
    pred_prob = torch.sigmoid(pred)
    p_t = true * pred_prob + (1 - true) * (1 - pred_prob)
    alpha_factor = true * alpha + (1 - true) * (1 - alpha)
    modulating = _safe_pow(1.0 - p_t, gamma)
    return loss * alpha_factor * modulating


def qfocal_loss(pred: torch.Tensor, true: torch.Tensor, gamma: float = 1.5,
                alpha: float = 0.25) -> torch.Tensor:
    """Elementwise quality focal loss; quality_focal_loss.py:18-21."""
    loss = bce_with_logits(pred, true)
    pred_prob = torch.sigmoid(pred)
    alpha_factor = true * alpha + (1 - true) * (1 - alpha)
    modulating = _safe_pow((true - pred_prob).abs(), gamma)
    return loss * alpha_factor * modulating
