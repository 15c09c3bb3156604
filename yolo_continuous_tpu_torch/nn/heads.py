"""Detection heads Detect / IDetect / IAuxDetect / IBin (PyTorch port of
``yolo_continuous_tpu/nn/heads.py``).

Every head returns the raw maps in the JAX layout ``(bs, h, w, na, no)``,
built as a view of the NCHW conv output (no copy):
``view(bs, na, no, h, w).permute(0, 3, 4, 1, 2)``. The decode kernels read
that strided view directly. Detect outputs P5, P4, P3
(``nets/detect.py:27-38``); the I-heads output P3-first, in input order
(``nets/idetect.py:29-45``). Module names give the reference's state_dict
keys: ``ia.{i}.implicit``, ``m.{i}.weight``, ``im.{i}.implicit``, ``m2.{i}``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import ImplicitA, ImplicitM, LogitConv

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


class IDetect(nn.Module):
    """Implicit-knowledge head; nets/idetect.py:7-50: per level
    ImplicitA -> 1x1 LogitConv -> ImplicitM. Output order = input order."""

    def __init__(self, nc: int, na: int, ch: Sequence[int], no: int = 0):
        super().__init__()
        self.nc, self.na, self.no = nc, na, no or nc + 5
        self.ia = nn.ModuleList(ImplicitA(c) for c in ch)
        self.m = nn.ModuleList(LogitConv(c, na * self.no) for c in ch)
        self.im = nn.ModuleList(ImplicitM(na * self.no) for _ in ch)

    def forward(self, xs):
        return [head_view(im(m(ia(x))), self.na, self.no)
                for x, ia, m, im in zip(xs, self.ia, self.m, self.im)]


class IAuxDetect(IDetect):
    """IDetect + auxiliary 1x1 convs; nets/iaux_detect.py:7-54.

    xs = [P3, P4, P5, A3, A4, A5]; returns 6 maps, leads then auxes. Eval
    consumers use the first nl (nets/iaux_detect.py:40-49)."""

    def __init__(self, nc: int, na: int, ch: Sequence[int]):
        nl = len(ch) // 2
        super().__init__(nc, na, ch[:nl])
        self.m2 = nn.ModuleList(LogitConv(c, na * self.no) for c in ch[nl:])

    def forward(self, xs):
        nl = len(self.m)
        leads = super().forward(xs[:nl])
        return leads + [head_view(m2(x), self.na, self.no) for x, m2 in zip(xs[nl:], self.m2)]


class IBin(IDetect):
    """Bin-regression head; nets/ibin.py:8-79. no = nc + 3 + 2 (bins + 1):
    [x, y, w residual + bins, h residual + bins, obj, cls...]."""

    def __init__(self, nc: int, na: int, ch: Sequence[int], bin_count: int = 21):
        super().__init__(nc, na, ch, no=nc + 3 + 2 * (bin_count + 1))
        self.bin_count = bin_count


def head_output_order(head_name: str, nl: int) -> Tuple[int, ...]:
    """Map output index -> pyramid level (0=P3 ... nl-1=P5) for each head type."""
    if head_name == "Detect":
        return tuple(reversed(range(nl)))  # P5-first (nets/detect.py:27-38)
    return tuple(range(nl))  # P3-first (nets/idetect.py:29-45)
