"""SigmoidBin: bin classification + residual regression of one scalar.

Counterpart of ``yolo_continuous_tpu/ops/sigmoid_bin.py`` (``SigmoidBinCfg``,
``sigmoid_bin_decode``; parity target ``losses/sigmoid_bin.py:6-63``). The
IBin head predicts box w/h this way. Layout per value:
``[reg, bin_0 ... bin_{count-1}]`` (length = count + 1).

Only the inference decode is here. The JAX config's loss-only fields
(``use_loss_regression``, ``bce_weight``, ``smooth_eps``) and its
``use_fw_regression``/``reg_scale`` knobs, which no caller sets away from
their defaults, come with the training loss in the train slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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
