"""Detection head ``Detect`` (PyTorch port of ``yolo_continuous_tpu/nn/heads.py``).

The head returns the raw maps in the JAX layout ``(bs, h, w, na, no)``,
built as a view of the NCHW conv output (no copy):
``view(bs, na, no, h, w).permute(0, 3, 4, 1, 2)``. The decode kernel reads
that strided view directly. Output order is P5, P4, P3
(``nets/detect.py:27-38``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import LogitConv

HEAD_NAMES = ("Detect", "IDetect", "IAuxDetect", "IBin")


def head_view(y: torch.Tensor, na: int, no: int) -> torch.Tensor:
    """NCHW ``(bs, na*no, h, w)`` -> the view ``(bs, h, w, na, no)``."""
    bs, _, h, w = y.shape
    return y.view(bs, na, no, h, w).permute(0, 3, 4, 1, 2)


class Detect(nn.Module):
    """Plain per-level 1x1 convs; nets/detect.py:4-38.

    Input: [P3, P4, P5] features. Output: [P5, P4, P3] raw maps."""

    def __init__(self, nc: int, na: int, ch: Sequence[int]):
        super().__init__()
        self.nc, self.na, self.no = nc, na, nc + 5
        self.yolo_head_P3 = LogitConv(ch[0], na * self.no)
        self.yolo_head_P4 = LogitConv(ch[1], na * self.no)
        self.yolo_head_P5 = LogitConv(ch[2], na * self.no)

    def forward(self, xs):
        p3 = self.yolo_head_P3(xs[0])
        p4 = self.yolo_head_P4(xs[1])
        p5 = self.yolo_head_P5(xs[2])
        return [head_view(p, self.na, self.no) for p in (p5, p4, p3)]


def head_output_order(head_name: str, nl: int) -> Tuple[int, ...]:
    """Map output index -> pyramid level (0=P3 ... nl-1=P5) for each head type."""
    if head_name == "Detect":
        return tuple(reversed(range(nl)))  # P5-first (nets/detect.py:27-38)
    return tuple(range(nl))  # P3-first (nets/idetect.py:29-45)
