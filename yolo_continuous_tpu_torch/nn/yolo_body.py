"""The hard-coded YOLOv7 model family (the reference's alternative model path).

Counterpart of ``yolo_continuous_tpu/nn/yolo_body.py`` (``BConv``,
``Block``, ``Transition``, ``Backbone``, ``YoloBody`` with phi ``l`` and
``x``, ``LayoutBody``; parity targets ``nets/backbone.py:17-145``,
``nets/yolo_net.py:219-327``, ``nets/layout.py:18-57``), NCHW. Module names
are the torch reference's (``backbone.stem.0``, ``backbone.dark3.1.cv3.2``,
``rep_conv_1.rbr_dense.0``, ``yolo_head_P3``), so
``tools/jax_weights.body_state_dict_from_jax`` loads with ``strict=True``.

``BConv``'s BatchNorm is eps 1e-3 with flax momentum 0.97 (torch momentum
0.03), its SiLU applied after it; SPPCSPC and the RepConvs keep eps 1e-5.
The heads are ``layers.LogitConv`` (fp32 logits, or ``head_dtype``), the
outputs P5 first as ``(bs, h, w, na, 5 + nc)`` views. ``LayoutBody``
flattens its features in JAX's NHWC order before the dense layer.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .heads import head_view
from .layers import (SPPCSPC, BatchNorm2d, BodyConv2d, BodyLinear, LogitConv, RepConv, mp,
                     upsample_nearest_2x)


class BConv(nn.Module):
    """backbone.py:17-29 Conv: Conv2d + BN(eps 1e-3, momentum 0.03) + SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = BodyConv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = BatchNorm2d(c2, eps=1e-3, flax_momentum=0.97)

    def forward(self, x):
        return torch.nn.functional.silu(self.bn(self.conv(x)))


class Block(nn.Module):
    """E-ELAN block; backbone.py:32-55."""

    def __init__(self, c1: int, c2: int, c3: int, n: int = 4, e: float = 1.0,
                 ids: Sequence[int] = (-1,)):
        super().__init__()
        c_ = int(c2 * e)
        self.ids = tuple(ids)
        self.cv1 = BConv(c1, c_, 1, 1)
        self.cv2 = BConv(c1, c_, 1, 1)
        self.cv3 = nn.ModuleList(BConv(c_ if i == 0 else c2, c2, 3, 1) for i in range(n))
        widths = [c_, c_] + [c2] * n
        self.cv4 = BConv(sum(widths[i] for i in self.ids), c3, 1, 1)

    def forward(self, x):
        x2 = self.cv2(x)
        xs = [self.cv1(x), x2]
        for cv in self.cv3:
            x2 = cv(x2)
            xs.append(x2)
        return self.cv4(torch.cat([xs[i] for i in self.ids], dim=1))


class Transition(nn.Module):
    """maxpool || strided-conv downsample; backbone.py:67-83."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = BConv(c1, c2, 1, 1)
        self.cv2 = BConv(c1, c2, 1, 1)
        self.cv3 = BConv(c2, c2, 3, 2)

    def forward(self, x):
        return torch.cat([self.cv3(self.cv2(x)), self.cv1(mp(x, 2))], dim=1)


class Backbone(nn.Module):
    """stem -> dark2..dark5 -> (P3, P4, P5); backbone.py:86-145."""

    def __init__(self, transition_channels: int, block_channels: int, n: int, phi: str = "l",
                 c_in: int = 3):
        super().__init__()
        t, b = transition_channels, block_channels
        ids = {"l": (-1, -3, -5, -6), "x": (-1, -3, -5, -7, -8)}[phi]
        self.stem = nn.Sequential(BConv(c_in, t, 3, 1), BConv(t, 2 * t, 3, 2),
                                  BConv(2 * t, 2 * t, 3, 1))
        self.dark2 = nn.Sequential(BConv(2 * t, 4 * t, 3, 2), Block(4 * t, 2 * b, 8 * t, n, 1.0, ids))
        self.dark3 = nn.Sequential(Transition(8 * t, 4 * t), Block(8 * t, 4 * b, 16 * t, n, 1.0, ids))
        self.dark4 = nn.Sequential(Transition(16 * t, 8 * t),
                                   Block(16 * t, 8 * b, 32 * t, n, 1.0, ids))
        self.dark5 = nn.Sequential(Transition(32 * t, 16 * t),
                                   Block(32 * t, 8 * b, 32 * t, n, 1.0, ids))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        feat1 = self.dark3(self.dark2(self.stem(x)))
        feat2 = self.dark4(feat1)
        return feat1, feat2, self.dark5(feat2)


class YoloBody(nn.Module):
    """backbone + SPPCSPC + PAN + RepConv + heads; yolo_net.py:219-327.

    phi 'l': RepConv pyramid convs; phi 'x': plain BConvs (yolo_net.py:231).
    ``forward`` returns the raw maps P5, P4, P3 (yolo_net.py:315-327)."""

    def __init__(self, num_classes: int, phi: str = "l", anchors_per_level: int = 3):
        super().__init__()
        t = {"l": 32, "x": 40}[phi]                     # yolo_net.py:225
        panet = {"l": 32, "x": 64}[phi]                 # :227
        e = {"l": 2, "x": 1}[phi]                       # :228
        n = {"l": 4, "x": 6}[phi]                       # :229
        ids = {"l": (-1, -2, -3, -4, -5, -6), "x": (-1, -3, -5, -7, -8)}[phi]   # :230
        self.na, self.no = anchors_per_level, 5 + num_classes
        self.dtype = torch.float32

        def pyr_conv(c1, c2):                           # :231, 266-268
            return RepConv(c1, c2, 3, 1) if phi == "l" else BConv(c1, c2, 3, 1)

        self.backbone = Backbone(t, 32, n, phi)
        self.sppcspc = SPPCSPC(32 * t, 16 * t)
        self.conv_for_P5 = BConv(16 * t, 8 * t)
        self.conv_for_feat2 = BConv(32 * t, 8 * t)
        self.conv3_for_upsample1 = Block(16 * t, 4 * panet, 8 * t, n, e, ids)
        self.conv_for_P4 = BConv(8 * t, 4 * t)
        self.conv_for_feat1 = BConv(16 * t, 4 * t)
        self.conv3_for_upsample2 = Block(8 * t, 2 * panet, 4 * t, n, e, ids)
        self.down_sample1 = Transition(4 * t, 4 * t)
        self.conv3_for_downsample1 = Block(16 * t, 4 * panet, 8 * t, n, e, ids)
        self.down_sample2 = Transition(8 * t, 8 * t)
        self.conv3_for_downsample2 = Block(32 * t, 8 * panet, 16 * t, n, e, ids)
        self.rep_conv_1 = pyr_conv(4 * t, 8 * t)
        self.rep_conv_2 = pyr_conv(8 * t, 16 * t)
        self.rep_conv_3 = pyr_conv(16 * t, 32 * t)
        no = anchors_per_level * self.no
        self.yolo_head_P3 = LogitConv(8 * t, no)
        self.yolo_head_P4 = LogitConv(16 * t, no)
        self.yolo_head_P5 = LogitConv(32 * t, no)

    def forward(self, x):
        x = x.to(self.dtype)
        feat1, feat2, feat3 = self.backbone(x)
        p5 = self.sppcspc(feat3)
        p4 = torch.cat([self.conv_for_feat2(feat2), upsample_nearest_2x(self.conv_for_P5(p5))], 1)
        p4 = self.conv3_for_upsample1(p4)
        p3 = torch.cat([self.conv_for_feat1(feat1), upsample_nearest_2x(self.conv_for_P4(p4))], 1)
        p3 = self.conv3_for_upsample2(p3)
        p4 = self.conv3_for_downsample1(torch.cat([self.down_sample1(p3), p4], 1))
        p5 = self.conv3_for_downsample2(torch.cat([self.down_sample2(p4), p5], 1))
        out2 = self.yolo_head_P3(self.rep_conv_1(p3))
        out1 = self.yolo_head_P4(self.rep_conv_2(p4))
        out0 = self.yolo_head_P5(self.rep_conv_3(p5))
        return [head_view(o, self.na, self.no) for o in (out0, out1, out2)]


class LayoutBody(nn.Module):
    """backbone + SPPCSPC -> flatten -> Dense(16); the layout (chip-grab)
    model, nets/layout.py:18-57. ``image_size`` fixes the dense layer's
    input (flax infers it at init)."""

    def __init__(self, phi: str = "l", out_features: int = 16, image_size: int = 416):
        super().__init__()
        t = {"l": 4, "x": 40}[phi]                      # layout.py:25 uses tiny widths
        n = {"l": 4, "x": 6}[phi]
        self.dtype = torch.float32
        self.backbone = Backbone(t, 16, n, phi)
        self.sppcspc = SPPCSPC(32 * t, 16 * t)
        self.conv_for_P5 = BConv(16 * t, 8 * t)
        side = image_size // 32
        self.dense = BodyLinear(8 * t * side * side, out_features)

    def forward(self, x):
        p5 = self.conv_for_P5(self.sppcspc(self.backbone(x.to(self.dtype))[2]))
        return self.dense(p5.permute(0, 2, 3, 1).flatten(1))
