"""The plain reference model: a YOLOv7 net from its rows, in plain PyTorch.

Written from the upstream ``models/common.py`` and ``models/yolo.py``
(WongKinYiu/yolov7) for the rows the benchmark's configurations use:
``Conv`` (conv, BatchNorm, activation), ``Concat``, ``MP`` (2 x 2 max pool),
``SP`` (stride-1 max pool), ``SPPCSPC``, ``RepConv`` (train form: 3 x 3 and
1 x 1 branches with BatchNorm, and a BatchNorm identity where the shapes
allow), ``nn.Upsample`` (nearest, 2x) and ``Detect`` (a 1 x 1 conv a level).
Parameter names follow the upstream ones, so one state dict loads into this
model and into the port. ``forward`` returns the head's raw maps P5 first,
each ``(bs, h, w, na, no)``. BatchNorm (``PlainBN``) has eps 1e-5 and a
running average of 0.9 old, 0.1 new, with the unbiased batch variance.

``forward(x, body_dtype=torch.bfloat16)`` computes the body in the precision
that the configurations state (bf16 convolutions of the fp32 weights;
BatchNorm's statistics in fp32, folded to a bf16 scale and shift; bf16
activations, pools and concatenations) with fp32 head logits: the
reference on the card, whose controls are one step below it (the
program's int8 path for a request; for a training step, ``set_fp8``: each
convolution's input and weight rounded to float8 e4m3 with a per-tensor
scale, amax to 448, and computed in fp32). On the CPU the tests run it in
fp32, as the port runs there.

Max pools route a tie's gradient as the configurations' reference framework
(JAX) does: a 2 x 2 pool as a max over the reshaped window (split evenly),
a stride-1 pool as a (k, 1) then a (1, k) pool, and SPPCSPC's 9 and 13 as
5 x 5 pools in a cascade. The values are those of the direct pools; only
the subgradient at exact ties (flat letterbox fill) is chosen.
"""
from __future__ import annotations

import ast
import re
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_LEAKY = re.compile(r"(?:nn\.)?LeakyReLU\(([-+0-9.eE]+)\)")
E4M3_MAX = 448.0


def _arg(a, nc):
    if not isinstance(a, str):
        return a
    s = a.strip()
    if s == "None":
        return None
    if s in ("nc", "num_classes"):
        return nc
    m = _LEAKY.fullmatch(s)
    if m:
        return ("leaky", float(m.group(1)))
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def act_fn(x, act):
    if act is True:
        return F.silu(x)
    if isinstance(act, tuple) and act[0] == "leaky":
        return F.leaky_relu(x, act[1])
    raise ValueError(f"unknown activation {act!r}")


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with one scale for the tensor, back in fp32."""
    scale = E4M3_MAX / t.detach().abs().amax().clamp_min(1e-12)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class PlainConv2d(nn.Conv2d):
    """A convolution in its input's dtype (the fp32 weight cast to it); with
    ``fp8``, its input and weight through float8 e4m3; with ``logits``, a
    head's convolution: its bf16 operands widened and summed in fp32."""
    fp8 = False
    logits = False

    def forward(self, x):
        if self.fp8:
            return self._conv_forward(fp8_round(x), fp8_round(self.weight),
                                      self.bias).to(torch.float32 if self.logits else x.dtype)
        w = self.weight.to(x.dtype)
        if self.logits:
            return self._conv_forward(x.float(), w.float(), self.bias)
        return self._conv_forward(x, w, None if self.bias is None else self.bias.to(x.dtype))


class PlainBN(nn.BatchNorm2d):
    """BatchNorm: the statistics (in training the batch's, in fp32: the mean
    and max(E[x^2] - E[x]^2, 0) over N, H and W) folded in fp32 to a scale
    and a shift that multiply and add in the input's dtype; in training the
    running statistics move by a tenth towards the batch's, the variance
    unbiased."""

    def __init__(self, c):
        super().__init__(c, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if self.training:
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                n = x.numel() / x.shape[1]
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var * (n / max(n - 1.0, 1.0)))
        else:
            mean, var = self.running_mean, self.running_var
        inv = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Conv(nn.Module):
    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True):
        super().__init__()
        self.conv = PlainConv2d(c1, c2, k, s, k // 2 if p is None else p, groups=g, bias=False)
        self.bn = PlainBN(c2)
        self.act = act

    def forward(self, x):
        return act_fn(self.bn(self.conv(x)), self.act)


class SPPCSPC(nn.Module):
    def __init__(self, c1, c2, e=0.5, k=(5, 9, 13)):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = k
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(c_, c_, 3)
        self.cv4 = Conv(c_, c_, 1)
        self.cv5 = Conv(4 * c_, c_, 1)
        self.cv6 = Conv(c_, c_, 3)
        self.cv7 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        pools, prev = [], x1
        for _ in self.k:            # 5, 9, 13 as a cascade of 5 x 5 pools
            prev = sp(prev, 5)
            pools.append(prev)
        y1 = self.cv6(self.cv5(torch.cat([x1] + pools, 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))


class RepConv(nn.Module):
    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        self.rbr_dense = nn.Sequential(PlainConv2d(c1, c2, 3, s, 1, bias=False),
                                       PlainBN(c2))
        self.rbr_1x1 = nn.Sequential(PlainConv2d(c1, c2, 1, s, 0, bias=False),
                                     PlainBN(c2))
        self.rbr_identity = (PlainBN(c1)
                             if c1 == c2 and s == 1 else None)

    def forward(self, x):
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return F.silu(y)


class Detect(nn.Module):
    def __init__(self, nc, na, ch):
        super().__init__()
        self.na, self.no = na, nc + 5
        self.yolo_head_P3 = PlainConv2d(ch[0], na * self.no, 1)
        self.yolo_head_P4 = PlainConv2d(ch[1], na * self.no, 1)
        self.yolo_head_P5 = PlainConv2d(ch[2], na * self.no, 1)
        for m in (self.yolo_head_P3, self.yolo_head_P4, self.yolo_head_P5):
            m.logits = True

    def forward(self, xs):
        outs = [self.yolo_head_P5(xs[2]), self.yolo_head_P4(xs[1]), self.yolo_head_P3(xs[0])]
        return [y.view(y.shape[0], self.na, self.no, *y.shape[2:]).permute(0, 3, 4, 1, 2)
                for y in outs]


def sp(x, k):
    """Stride-1 max pool, padded with -inf, as a (k, 1) then a (1, k) pool."""
    x = F.max_pool2d(x, (k, 1), 1, (k // 2, 0))
    return F.max_pool2d(x, (1, k), 1, (0, k // 2))


def mp(x):
    """2 x 2 max pool as a max over the reshaped window: a tie's gradient is
    split evenly over it."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        return F.max_pool2d(x, 2, 2)
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax((3, 5))


class _Pool(nn.Module):
    def __init__(self, k, s):
        super().__init__()
        self.k, self.s = k, s

    def forward(self, x):
        return sp(x, self.k) if self.s == 1 else mp(x)


class _Up(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")


class _Cat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


class PlainYolo(nn.Module):
    """The net of a configuration (``configs/<name>.json``): its ``backbone``
    and ``head`` rows, ``num_classes``, ``anchors`` and ``anchors_mask``."""

    def __init__(self, cfg: dict):
        super().__init__()
        nc = cfg["num_classes"]
        na = len(cfg["anchors"][0]) // 2
        ch: List[int] = []
        self.froms, layers = [], []
        for i, (f, n, m, args) in enumerate(list(cfg["backbone"]) + list(cfg["head"])):
            if n != 1:
                raise ValueError("the reference builds rows of one repeat")
            args = [_arg(a, nc) for a in args]
            c_in = (lambda j: 3 if i == 0 else ch[j])
            if m == "Conv":
                c2 = args[0]
                k, s = (args + [1, 1])[1:3]
                p = args[3] if len(args) > 3 else None
                g = args[4] if len(args) > 4 else 1
                act = args[5] if len(args) > 5 else True
                layer = Conv(c_in(f), c2, k, s, p, g, act)
            elif m == "RepConv":
                c2 = args[0]
                layer = RepConv(c_in(f), c2, args[1], args[2])
            elif m == "SPPCSPC":
                c2 = args[0]
                layer = SPPCSPC(c_in(f), c2)
            elif m == "MP":
                c2, layer = ch[f], _Pool(2, 2)
            elif m == "SP":
                c2, layer = ch[f], _Pool(args[0] if args else 3, 1)
            elif m == "nn.Upsample":
                c2, layer = ch[f], _Up()
            elif m == "Concat":
                c2, layer = sum(ch[j] for j in f), _Cat()
            elif m == "Detect":
                c2, layer = 0, Detect(nc, na, [ch[j] for j in f])
            else:
                raise ValueError(f"the reference has no row {m!r}")
            self.froms.append(f)
            layers.append(layer)
            ch.append(c2)
        self.model = nn.ModuleList(layers)
        mask = cfg["anchors_mask"]
        flat = [float(v) for row in cfg["anchors"] for v in row]
        pairs = [(flat[2 * j], flat[2 * j + 1]) for j in range(len(flat) // 2)]
        # P5 first, as the maps
        self.anchors = tuple(tuple(pairs[j] for j in mask[lv]) for lv in range(len(mask)))
        self.strides = (32, 16, 8)

    def set_fp8(self, on: bool) -> "PlainYolo":
        for m in self.modules():
            if isinstance(m, PlainConv2d):
                m.fp8 = on
        return self

    def forward(self, x: torch.Tensor, body_dtype=torch.float32):
        """Raw maps of images ``x`` (bs, 3, H, W); the body in ``body_dtype``
        (convolutions, BatchNorm, activations, pools), the head's logits in
        fp32."""
        x = x.to(body_dtype)
        outs: List = []
        for i, (f, m) in enumerate(zip(self.froms, self.model)):
            if i == 0 or f == -1:
                inp = x if i == 0 else outs[-1]
            elif isinstance(f, int):
                inp = outs[f]
            else:
                inp = [outs[j] for j in f]
            x = m(inp)
            outs.append(x)
        return x


def forward_flops(cfg: dict, batch: int = 1) -> float:
    """The forward's floating-point operations (2 a multiply-add of every
    convolution), counted on the ``meta`` device at the configuration's
    image size."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        model = PlainYolo(cfg).eval()
        x = torch.empty(batch, 3, cfg["image_size"], cfg["image_size"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    return float(counter.get_total_flops())


def state_shapes(cfg: dict) -> Sequence:
    """(name, shape, dtype) of every entry of the model's state dict."""
    with torch.device("meta"):
        sd = PlainYolo(cfg).state_dict()
    return [(k, tuple(v.shape), v.dtype) for k, v in sd.items()]
