"""SigmoidBin: bin classification + residual regression of one scalar.

Counterpart of ``yolo_continuous_tpu/ops/sigmoid_bin.py`` (``SigmoidBinCfg``,
``sigmoid_bin_decode``; parity target ``losses/sigmoid_bin.py:6-63``). The
IBin head predicts box w/h this way. Layout per value:
``[reg, bin_0 ... bin_{count-1}]`` (length = count + 1).

The decode and the training loss (``sigmoid_bin_training_loss``,
``losses/sigmoid_bin.py:65-96``, which ``losses/bin_loss.py`` uses). The
JAX config's knobs ``reg_scale``, ``use_fw_regression``,
``use_loss_regression``, ``bce_weight`` and ``smooth_eps`` are not ported:
no caller sets them away from their defaults (2, on, on, 1, 0), which the
functions here compute.
"""
from __future__ import annotations

from dataclasses import dataclass

from typing import Optional

import torch

from ..losses.focal import bce_with_logits

# The residual spans one step either side of the bin centre (JAX default).
REG_SCALE = 2.0


@dataclass(frozen=True)
class SigmoidBinCfg:
    bin_count: int = 10
    vmin: float = 0.0
    vmax: float = 1.0

    @property
    def length(self) -> int:
        return self.bin_count + 1

    @property
    def scale(self) -> float:
        return float(self.vmax - self.vmin)

    @property
    def step(self) -> float:
        return self.scale / self.bin_count

    def bins(self, device=None) -> torch.Tensor:
        """Bin centres, fp32; sigmoid_bin.py:33-38."""
        start = self.vmin + (self.scale / 2.0) / self.bin_count
        return start + self.step * torch.arange(self.bin_count, dtype=torch.float32, device=device)


def sigmoid_bin_decode(pred: torch.Tensor, cfg: SigmoidBinCfg) -> torch.Tensor:
    """Inference decode; sigmoid_bin.py:49-63.

    ``pred[..., 0]`` is already sigmoided (the IBin decode sigmoids the whole
    map first). The bin is the first maximum of the sigmoided bins."""
    pred_reg = (pred[..., 0] * REG_SCALE - REG_SCALE / 2.0) * cfg.step
    bin_idx = torch.argmax(pred[..., 1:1 + cfg.bin_count], dim=-1)
    return torch.clamp(pred_reg + cfg.bins(pred.device)[bin_idx], cfg.vmin, cfg.vmax)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot along a new last axis."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def sigmoid_bin_training_loss(pred: torch.Tensor, target: torch.Tensor, cfg: SigmoidBinCfg,
                              mask: Optional[torch.Tensor] = None):
    """BCE over the bins + MSE on the regressed value; sigmoid_bin.py:65-96.

    pred: (..., length) raw logits; target: (...,) values in [vmin, vmax];
    mask: optional (...,) weights of the static-shape pipeline (the masked
    sums over ``denom * bin_count`` and ``denom``, denom = max(sum(mask),
    1)). The target bin is the first nearest centre (``argmin`` takes the
    first minimum, as JAX's). Returns (loss scalar, decoded value clipped
    to the range)."""
    bins = cfg.bins(pred.device)
    sig = 1.0 / (1.0 + torch.exp(-pred[..., 0]))
    pred_reg = (sig * REG_SCALE - REG_SCALE / 2.0) * cfg.step
    pred_bin = pred[..., 1:1 + cfg.bin_count]
    bin_idx = torch.argmin((target[..., None] - bins).abs(), dim=-1)
    result = pred_reg + bins[bin_idx]
    bce = bce_with_logits(pred_bin, _one_hot(bin_idx, cfg.bin_count))
    mse = (result - target) ** 2
    if mask is None:
        loss = bce.mean() + mse.mean()
    else:
        m = mask.float()
        denom = torch.clamp(m.sum(), min=1.0)
        loss = (bce * m[..., None]).sum() / (denom * cfg.bin_count) + (mse * m).sum() / denom
    return loss, torch.clamp(result, cfg.vmin, cfg.vmax)
