"""The plain reference model of a P6 net with auxiliary heads (YOLOv7-W6), in
plain PyTorch.

Written from the upstream ``models/common.py`` and ``models/yolo.py``
(WongKinYiu/yolov7) for the rows of ``configs/yolov7-w6.json``: ``ReOrg``
(space to depth, 2x), ``Conv``, ``Concat``, ``SPPCSPC``, ``nn.Upsample``
(nearest, 2x) and ``IAuxDetect`` over four levels; each row's width times
the configuration's ``width_multiple``, rounded up to a multiple of 8. The
body's pieces are ``model.py``'s (``PlainConv2d``, ``PlainBN``, ``Conv``,
``SPPCSPC``), so the precision and the fp8 control are the same as for the
P5 nets.

``IAuxDetect`` is upstream's: the lead maps ``im(m(ia(x)))`` (an additive
implicit row on the body's input, in the body's dtype; the 1x1 logits in
fp32; a multiplicative implicit row on the logits, in fp32), the auxiliary
maps ``m2(x)`` with no implicit rows. ``forward`` returns the four lead maps
P3 first and then the four auxiliary maps, each ``(bs, h, w, na, no)``;
level i takes anchor row i (``anchors_mask`` orders the rows for ``Detect``
heads only). Parameter names follow the upstream ones, so one state dict
loads into this model and into the port.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from .model import Conv, PlainConv2d, SPPCSPC, _arg, _Cat, _Up


class ReOrg(nn.Module):
    """Space to depth: the four phases (rows then columns: [::2, ::2],
    [1::2, ::2], [::2, 1::2], [1::2, 1::2]) stacked on the channels."""

    def forward(self, x):
        return torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                          x[..., 1::2, 1::2]], 1)


class ImplicitA(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.implicit = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x):
        return x + self.implicit.to(x.dtype)


class ImplicitM(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.implicit = nn.Parameter(torch.ones(1, c, 1, 1))

    def forward(self, x):
        return x * self.implicit.to(x.dtype)


def _view(y, na, no):
    bs, _, h, w = y.shape
    return y.view(bs, na, no, h, w).permute(0, 3, 4, 1, 2)


class IAuxDetect(nn.Module):
    """Lead heads on the first half of ``ch``, auxiliary heads on the second."""

    def __init__(self, nc, na, ch):
        super().__init__()
        nl = len(ch) // 2
        self.na, self.no, self.nl = na, nc + 5, nl
        self.ia = nn.ModuleList(ImplicitA(c) for c in ch[:nl])
        self.m = nn.ModuleList(PlainConv2d(c, na * self.no, 1) for c in ch[:nl])
        self.im = nn.ModuleList(ImplicitM(na * self.no) for _ in ch[:nl])
        self.m2 = nn.ModuleList(PlainConv2d(c, na * self.no, 1) for c in ch[nl:])
        for m in list(self.m) + list(self.m2):
            m.logits = True

    def forward(self, xs, aux: bool = True):
        leads = [_view(im(m(ia(x))), self.na, self.no)
                 for x, ia, m, im in zip(xs[:self.nl], self.ia, self.m, self.im)]
        if not aux:
            return leads
        return leads + [_view(m2(x), self.na, self.no) for x, m2 in zip(xs[self.nl:], self.m2)]


class P6Yolo(nn.Module):
    """The net of a P6 configuration with an ``IAuxDetect`` row: its
    ``backbone`` and ``head`` rows, ``num_classes`` and ``anchors`` (one row
    a level, P3 first)."""

    def __init__(self, cfg: dict):
        super().__init__()
        nc = cfg["num_classes"]
        na = len(cfg["anchors"][0]) // 2
        gw = float(cfg.get("width_multiple", 1.0))
        # a row's width times the width multiple, up to a multiple of 8
        width = (lambda c: int(math.ceil(c * gw / 8) * 8))
        ch: List[int] = []
        self.froms, layers = [], []
        rows = list(cfg["backbone"]) + list(cfg["head"])
        for i, (f, n, m, args) in enumerate(rows):
            if n != 1:
                raise ValueError("the reference builds rows of one repeat")
            args = [_arg(a, nc) for a in args]
            c_in = (lambda j: cfg.get("image_chan", 3) if i == 0 else ch[j])
            if m == "ReOrg":
                c2, layer = 4 * c_in(f), ReOrg()
            elif m == "Conv":
                c2 = width(args[0])
                k, s = (args + [1, 1])[1:3]
                layer = Conv(c_in(f), c2, k, s)
            elif m == "SPPCSPC":
                c2 = width(args[0])
                layer = SPPCSPC(c_in(f), c2)
            elif m == "nn.Upsample":
                c2, layer = ch[f], _Up()
            elif m == "Concat":
                c2, layer = sum(ch[j] for j in f), _Cat()
            elif m == "IAuxDetect":
                c2, layer = 0, IAuxDetect(nc, na, [ch[j] for j in f])
                # the rows that feed the auxiliary heads alone (upstream's
                # training form; the deployed net drops them)
                self.aux_rows = set(f[len(f) // 2:])
            else:
                raise ValueError(f"the P6 reference has no row {m!r}")
            self.froms.append(f)
            layers.append(layer)
            ch.append(c2)
        self.model = nn.ModuleList(layers)
        flat = [float(v) for row in cfg["anchors"] for v in row]
        pairs = [(flat[2 * j], flat[2 * j + 1]) for j in range(len(flat) // 2)]
        self.anchors = tuple(tuple(pairs[lv * na + a] for a in range(na))
                             for lv in range(len(cfg["anchors"])))
        self.strides = tuple(8 * 2 ** lv for lv in range(len(cfg["anchors"])))

    def set_fp8(self, on: bool) -> "P6Yolo":
        for m in self.modules():
            if isinstance(m, PlainConv2d):
                m.fp8 = on
        return self

    def forward(self, x: torch.Tensor, body_dtype=torch.float32, aux: bool = True):
        """Raw maps of images ``x`` (bs, 3, H, W): the lead maps, then (with
        ``aux``) the auxiliary maps; the body in ``body_dtype``, the logits in
        fp32. Without ``aux`` the rows that feed only the auxiliary heads do
        not run (the deployed form)."""
        x = x.to(body_dtype)
        outs: List = []
        last = len(self.model) - 1
        for i, (f, m) in enumerate(zip(self.froms, self.model)):
            if not aux and i in self.aux_rows:
                outs.append(None)
                continue
            if i == 0 or f == -1:
                inp = x if i == 0 else outs[-1]
            elif isinstance(f, int):
                inp = outs[f]
            else:
                inp = [outs[j] for j in f]
            x = m(inp, aux) if i == last else m(inp)
            outs.append(x)
        return x


def forward_flops(cfg: dict, batch: int = 1, aux: bool = True) -> float:
    """The forward's floating-point operations (2 a multiply-add of every
    convolution), counted on the ``meta`` device at the configuration's
    image size: the training form (lead and auxiliary heads), or without
    ``aux`` the deployed form."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        model = P6Yolo(cfg).eval()
        x = torch.empty(batch, cfg.get("image_chan", 3), cfg["image_size"], cfg["image_size"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x, aux=aux)
    return float(counter.get_total_flops())


def state_shapes(cfg: dict) -> Sequence:
    """(name, shape, dtype) of every entry of the model's state dict."""
    with torch.device("meta"):
        sd = P6Yolo(cfg).state_dict()
    return [(k, tuple(v.shape), v.dtype) for k, v in sd.items()]
