"""YAML-driven model builder (PyTorch port of ``yolo_continuous_tpu/nn/builder.py``).

``parse_arg``, ``LayerSpec``, ``ModelSpec`` and ``build_model_spec`` are a
copy of the JAX package's pure-Python spec code, so the spec is equal for
every ``cfg/net/*.yaml`` (tests/test_torch_port_spec.py). ``YoloModel``
walks the same save-list as ``YoloModel._walk`` (``builder.py:350-364``),
in NCHW, with the reference's module names (``model.{i}.conv.weight``,
``model.{head}.yolo_head_P3.weight``, ...), so a state_dict from
``tools/jax_weights.state_dict_from_jax`` loads with ``strict=True``.

The port builds the rows that yolov7, yolov7-tiny and yolov7-aux use (Conv,
MP, SP, Concat, nn.Upsample, SPPCSPC, RepConv) and every head (Detect,
IDetect, IAuxDetect, IBin). Any other row raises ``NotImplementedError``
naming its ROADMAP item.
"""
from __future__ import annotations

import ast
import copy
import math
import re
from dataclasses import dataclass
from typing import Any, Tuple, Union

import torch
from torch import nn

from . import layers as L
from .heads import HEAD_NAMES, Detect, IAuxDetect, IBin, IDetect, head_output_order


def make_divisible(x, divisor):
    return math.ceil(x / divisor) * divisor


# ---------------------------------------------------------------------------
# arg parsing (replaces eval(); nets/yolo.py:22-28)
# ---------------------------------------------------------------------------

_LEAKY_RE = re.compile(r"nn\.LeakyReLU\(\s*([0-9.eE+-]+)\s*\)")


def parse_arg(a, nc=None, anchors=None):
    if not isinstance(a, str):
        return a
    s = a.strip()
    if s == "None":
        return None
    if s in ("nc", "num_classes"):
        return nc
    if s == "anchors":
        return anchors
    m = _LEAKY_RE.fullmatch(s)
    if m:
        return ("leaky_relu", float(m.group(1)))
    if s in ("nn.SiLU()", "SiLU()"):
        return "silu"
    if s in ("nn.ReLU()", "ReLU()"):
        return "relu"
    if s in ("nn.Identity()", "Identity()"):
        return "identity"
    if s in ("nn.Hardswish()",):
        return "hardswish"
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s  # e.g. 'nearest'


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


# ---------------------------------------------------------------------------
# channel / stride propagation (nets/yolo.py:30-87)
# ---------------------------------------------------------------------------

# modules whose first YAML arg is c2 and that receive (c1, c2, ...) —
# nets/yolo.py:31-39
CONV_LIKE = {
    "nn.Conv2d", "Conv", "RobustConv", "RobustConv2", "dw_conv", "DWConv", "GhostConv",
    "RepConv", "DownC", "SPP", "SPPF", "SPPCSPC", "GhostSPPCSPC", "Focus", "Stem",
    "GhostStem", "Bottleneck", "BottleneckCSPA", "BottleneckCSPB", "BottleneckCSPC",
    "RepBottleneck", "RepBottleneckCSPA", "RepBottleneckCSPB", "RepBottleneckCSPC",
    "Res", "ResCSPA", "ResCSPB", "ResCSPC", "RepRes", "RepResCSPA", "RepResCSPB",
    "RepResCSPC", "ResX", "ResXCSPA", "ResXCSPB", "ResXCSPC", "RepResX",
    "RepResXCSPA", "RepResXCSPB", "RepResXCSPC", "Ghost", "GhostCSPA", "GhostCSPB",
    "GhostCSPC",
}

# modules that get the repeat count n inserted as args[2] — nets/yolo.py:45-54
CSP_LIKE = {
    "DownC", "SPPCSPC", "GhostSPPCSPC",
    "BottleneckCSPA", "BottleneckCSPB", "BottleneckCSPC",
    "RepBottleneckCSPA", "RepBottleneckCSPB", "RepBottleneckCSPC",
    "ResCSPA", "ResCSPB", "ResCSPC", "RepResCSPA", "RepResCSPB", "RepResCSPC",
    "ResXCSPA", "ResXCSPB", "ResXCSPC", "RepResXCSPA", "RepResXCSPB", "RepResXCSPC",
    "GhostCSPA", "GhostCSPB", "GhostCSPC",
}


@dataclass(frozen=True)
class LayerSpec:
    i: int
    f: Union[int, Tuple[int, ...]]
    n: int
    name: str
    args: Tuple[Any, ...]   # parsed args EXCLUDING c1/c2 bookkeeping (raw YAML order)
    c1: Union[int, Tuple[int, ...]]
    c2: int


@dataclass(frozen=True)
class ModelSpec:
    layers: Tuple[LayerSpec, ...]
    save: Tuple[int, ...]
    nc: int
    na: int
    head_name: str
    head_index: int
    # per OUTPUT level, in the head's output order:
    strides: Tuple[int, ...]
    anchors: Tuple[Tuple[Tuple[float, float], ...], ...]  # px @ config image size
    bin_count: int = 21


def _layer_stride_factor(name: str, args, c_in_stride: float) -> float:
    """Output stride relative to input for one layer."""
    if name in ("Conv", "nn.Conv2d", "RepConv", "RobustConv", "dw_conv", "DWConv",
                "GhostConv", "Focus"):
        s = 1
        if name == "nn.Conv2d":
            s = args[1] if len(args) > 1 else 1
        else:
            s = args[1] if len(args) > 1 else 1
        s = s if isinstance(s, int) else 1
        return float(s) * (2.0 if name == "Focus" else 1.0)
    if name == "RobustConv2":
        s = args[1] if len(args) > 1 else 4
        return float(s) / float(s)  # strided conv then deconv of same factor -> x1
    if name == "MP":
        k = args[0] if args else 2
        return float(k)
    if name == "DownC":
        k = args[1] if len(args) > 1 else 2
        return float(k)
    if name == "Stem" or name == "GhostStem":
        return 4.0
    if name == "ReOrg" or name == "Contract":
        g = args[0] if args else 2
        return float(g if name == "Contract" else 2)
    if name == "Expand":
        g = args[0] if args else 2
        return 1.0 / float(g)
    if name == "nn.Upsample":
        scale = args[1] if len(args) > 1 else 2
        return 1.0 / float(scale)
    if name == "Ghost":
        s = args[1] if len(args) > 1 else 1
        return float(s) if isinstance(s, int) else 1.0
    return 1.0


def build_model_spec(
    model_cfg: dict,
    image_chan: int,
    anchors,
    num_classes: int,
    anchors_mask=None,
) -> ModelSpec:
    """Interpret a net YAML (backbone + head rows) into a static ModelSpec.

    Mirrors the channel bookkeeping of ``parse_model`` (nets/yolo.py:15-87)
    row by row; additionally tracks spatial strides.
    """
    d = copy.deepcopy(model_cfg)
    gd, gw = d["depth_multiple"], d["width_multiple"]
    anchors_rows = [list(a) for a in anchors]
    na = len(anchors_rows[0]) // 2 if isinstance(anchors_rows[0], list) else 3
    no = na * (num_classes + 5)

    ch = [image_chan]
    strides = [1.0]
    specs = []
    save = set()
    head_name, head_index, head_from = None, -1, None
    bin_count = 21

    rows = list(d["backbone"]) + list(d["head"])
    for i, (f, n, m, args) in enumerate(rows):
        name = m if isinstance(m, str) else m.__name__
        args = [parse_arg(a, nc=num_classes, anchors=anchors_rows) for a in args]
        n = max(round(n * gd), 1) if n > 1 else n  # depth gain (nets/yolo.py:30)

        fs = tuple(f) if isinstance(f, list) else f
        if name in CONV_LIKE:
            c1 = ch[fs]
            c2 = args[0]
            if c2 != no:  # nets/yolo.py:41-42
                c2 = make_divisible(c2 * gw, 8)
            rest = args[1:]
            if name in CSP_LIKE:
                # args.insert(2, n); n = 1 (nets/yolo.py:52-54)
                rest = [n] + rest
                n_repeat = 1
            else:
                n_repeat = n
            spec_args = tuple(_tuplify(v) for v in rest)
            specs.append(LayerSpec(i, fs, n_repeat, name, spec_args, c1, c2))
        elif name == "nn.BatchNorm2d":
            c1 = c2 = ch[fs]
            specs.append(LayerSpec(i, fs, n, name, (), c1, c2))
        elif name in ("Concat", "Chuncat"):
            c2 = sum(ch[x] for x in fs)
            specs.append(LayerSpec(i, fs, n, name, tuple(args), tuple(ch[x] for x in fs), c2))
        elif name == "Shortcut":
            c2 = ch[fs[0]]
            specs.append(LayerSpec(i, fs, n, name, tuple(args), tuple(ch[x] for x in fs), c2))
        elif name == "Foldcut":
            c1 = ch[fs]
            c2 = c1 // 2
            specs.append(LayerSpec(i, fs, n, name, tuple(args), c1, c2))
        elif name in HEAD_NAMES:
            ch_list = tuple(ch[x] for x in fs)
            head_name, head_index, head_from = name, i, fs
            if name == "IBin" and len(args) > 2 and isinstance(args[2], int):
                bin_count = args[2]
            c2 = no
            specs.append(LayerSpec(i, fs, n, name, tuple(_tuplify(v) for v in args), ch_list, c2))
        elif name == "ReOrg":
            c1 = ch[fs]
            c2 = c1 * 4
            specs.append(LayerSpec(i, fs, n, name, tuple(args), c1, c2))
        elif name == "Contract":
            c1 = ch[fs]
            c2 = c1 * args[0] ** 2
            specs.append(LayerSpec(i, fs, n, name, tuple(args), c1, c2))
        elif name == "Expand":
            c1 = ch[fs]
            c2 = c1 // args[0] ** 2
            specs.append(LayerSpec(i, fs, n, name, tuple(args), c1, c2))
        else:  # MP, SP, nn.Upsample, ImplicitA/M, TransformerBlock, ... (nets/yolo.py:75-76)
            c1 = ch[fs] if isinstance(fs, int) else ch[fs[0]]
            c2 = c1
            specs.append(LayerSpec(i, fs, n, name, tuple(_tuplify(v) for v in args), c1, c2))

        # stride propagation (extra vs reference: needed for head metadata)
        s_in = strides[fs] if isinstance(fs, int) else strides[fs[0]]
        s_out = s_in * _layer_stride_factor(
            name, args[1:] if name in CONV_LIKE else args, s_in)

        save.update(x % i for x in ([fs] if isinstance(fs, int) else fs) if x != -1)
        if i == 0:  # nets/yolo.py:84-86: ch[j] = layer j's output from here on
            ch = []
            strides = []
        ch.append(c2)
        strides.append(s_out)

    if head_name is None:
        raise ValueError("net YAML has no Detect/IDetect/IAuxDetect/IBin row")

    # strides[j] = output stride of layer j (after the i==0 reset above)
    nl = len(anchors_rows)
    in_strides = [int(round(strides[x])) for x in head_from]
    order = head_output_order(head_name, nl)
    flat = [v for row in anchors_rows for v in row]
    flat_pairs = [(float(flat[2 * j]), float(flat[2 * j + 1])) for j in range(len(flat) // 2)]
    if head_name == "Detect":
        # anchors via anchors_mask, P5-first (detect.py:42-43, yolo_loss.py:31-32)
        mask = anchors_mask if anchors_mask is not None else [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
        out_anchors = tuple(tuple(flat_pairs[j] for j in mask[lv]) for lv in range(nl))
        out_strides = tuple(in_strides[order[lv]] for lv in range(nl))
    else:
        # anchor row i with input level i, output order = input order (idetect.py:17-20)
        rows_pairs = [
            tuple((float(r[2 * j]), float(r[2 * j + 1])) for j in range(len(r) // 2))
            for r in anchors_rows
        ]
        out_anchors = tuple(rows_pairs[lv] for lv in range(nl))
        out_strides = tuple(in_strides[lv] for lv in range(nl))

    return ModelSpec(
        layers=tuple(specs),
        save=tuple(sorted(save)),
        nc=num_classes,
        na=na,
        head_name=head_name,
        head_index=head_index,
        strides=out_strides,
        anchors=out_anchors,
        bin_count=bin_count,
    )


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _def(args, idx, default):
    return args[idx] if len(args) > idx and args[idx] is not None else default


def _defn(args, idx, default):
    """Like _def but None stays None only for padding-style args."""
    return args[idx] if len(args) > idx else default


_LATER_ZOO = "ROADMAP.md Queue 1 item 15 (the rest of the module zoo)"


def _make_layer(s: LayerSpec, spec: ModelSpec, fused_tails: bool = False) -> nn.Module:
    name, a = s.name, s.args

    def repeat(make):
        if s.n == 1:
            return make()
        return nn.Sequential(*[make() for _ in range(s.n)])

    if name == "Conv":
        return repeat(lambda: L.Conv(s.c1, s.c2, _def(a, 0, 1), _def(a, 1, 1),
                                     _defn(a, 2, None), _def(a, 3, 1),
                                     _defn(a, 4, True), fused_tail=fused_tails))
    if name == "RepConv":
        return repeat(lambda: L.RepConv(s.c1, s.c2, _def(a, 0, 3), _def(a, 1, 1),
                                        _defn(a, 2, None), _def(a, 3, 1),
                                        _defn(a, 4, True), _def(a, 5, False)))
    if name == "SPPCSPC":
        return L.SPPCSPC(s.c1, s.c2, _def(a, 0, 1), _def(a, 1, False),
                         _def(a, 2, 1), _def(a, 3, 0.5), _def(a, 4, (5, 9, 13)))
    if name == "MP":
        return L.MP(_def(a, 0, 2))
    if name == "SP":
        return L.SP(_def(a, 0, 3), _def(a, 1, 1))
    if name == "Concat":
        return L.Concat()
    if name == "nn.Upsample":
        if _def(a, 1, 2) != 2:
            raise ValueError("only 2x nearest upsample is used by the reference configs")
        return L.Upsample2x()
    if name == "Detect":
        return Detect(spec.nc, spec.na, s.c1)
    if name == "IDetect":
        return IDetect(spec.nc, spec.na, s.c1)
    if name == "IAuxDetect":
        return IAuxDetect(spec.nc, spec.na, s.c1)
    if name == "IBin":
        return IBin(spec.nc, spec.na, s.c1, spec.bin_count)
    raise NotImplementedError(
        f"module {name!r} at layer {s.i} is not ported yet: {_LATER_ZOO}")


class YoloModel(nn.Module):
    """Static save-list interpreter (nets/yolo.py:95-153), NCHW.

    ``forward(x (bs, 3, H, W))`` returns the head's raw maps, each a
    ``(bs, h, w, na, no)`` fp32 view, in the head's order (P5 first for
    Detect, P3 first for the I-heads). The body runs in the dtype given to
    ``set_dtype`` (fp32 until then). ``fused_tails`` goes to the net's
    ``Conv`` rows only, as JAX ``builder.py:378-381`` (never to the Convs
    inside SPPCSPC): eligible ones run as K5 in eval mode
    (``layers.Conv``).
    """

    def __init__(self, spec: ModelSpec, fused_tails: bool = False):
        super().__init__()
        self.spec = spec
        self.dtype = torch.float32
        self.model = nn.ModuleList([_make_layer(s, spec, fused_tails) for s in spec.layers])

    def set_dtype(self, dtype: torch.dtype, cast_weights: bool = True) -> "YoloModel":
        """The body runs in ``dtype``; BN statistics and head stay fp32, the
        head multiplies in ``dtype`` (layers.LogitConv). ``cast_weights``
        (serving) casts the body convs' weights once; without it (training)
        they stay fp32 master weights, cast on every call
        (``layers.BodyConv2d``)."""
        self.dtype = dtype
        for m in self.modules():
            if isinstance(m, L.BodyConv2d) and cast_weights:
                m.to(dtype)
            elif isinstance(m, L.LogitConv):
                m.mult_dtype = dtype
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "YoloModel":
        """Seeded random init as the JAX package's: conv kernels
        normal(0, 0.02) (nets/yolo.py:120), BN scale normal(1, 0.02),
        ImplicitA normal(0, 0.02), ImplicitM normal(1, 0.02)."""
        for m in self.modules():
            if isinstance(m, (L.ImplicitA, L.ImplicitM)):
                mean = 1.0 if isinstance(m, L.ImplicitM) else 0.0
                m.implicit.normal_(mean, 0.02, generator=generator)
            elif isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.normal_(1.0, 0.02, generator=generator)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        return self

    def forward(self, x: torch.Tensor):
        saved = {}
        out = x.to(self.dtype)
        for s, m in zip(self.spec.layers, self.model):
            if s.f != -1:
                # negative indices are relative to the current layer
                if isinstance(s.f, int):
                    out = saved[s.f % s.i]
                else:
                    out = [out if j == -1 else saved[j % s.i] for j in s.f]
            out = m(out)
            if s.i in self.spec.save:
                saved[s.i] = out
        return out
