"""YAML-driven model builder (PyTorch port of ``yolo_continuous_tpu/nn/builder.py``).

``parse_arg``, ``LayerSpec``, ``ModelSpec`` and ``build_model_spec`` are a
copy of the JAX package's pure-Python spec code, so the spec is equal for
every ``cfg/net/*.yaml`` (tests/test_torch_port_spec.py). ``YoloModel``
walks the same save-list as ``YoloModel._walk`` (``builder.py:350-364``),
in NCHW, with the reference's module names (``model.{i}.conv.weight``,
``model.{head}.yolo_head_P3.weight``, ...), so a state_dict from
``tools/jax_weights.state_dict_from_jax`` loads with ``strict=True``.

``YoloModel`` builds every row that JAX ``YoloModel._run_layer`` takes
(``builder.py:367-494``): the module zoo of ``nn/layers.py``, repeats
``n > 1`` as ``nn.Sequential`` (``model.{i}.{r}``), the CSP rows with ``n``
inserted into their ``m`` chain, and every head. ``model_info``,
``model_gflops`` and ``format_model_info`` are the ``Model.print_info``
table of ``builder.py:508-611``, read off the torch model. One deliberate
difference: the JAX ``format_model_info`` drops the GFLOPs figure when
counting raises; the port lets the error through.
"""
from __future__ import annotations

import ast
import copy
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

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


_CSP_INNER = {"Bottleneck": "bottleneck", "RepBottleneck": "rep_bottleneck", "Res": "res",
              "RepRes": "rep_res", "ResX": "resx", "RepResX": "rep_resx", "Ghost": "ghost"}


def _in_channels(s: LayerSpec, spec: ModelSpec) -> int:
    """Channels reaching row ``s``: the sum over its inputs (the spec keeps
    only the first input's for rows that are not concatenations)."""
    if isinstance(s.f, int):
        return s.c1

    def out_ch(j):
        j = s.i - 1 if j == -1 else j % s.i
        return spec.layers[j].c2
    return sum(out_ch(j) for j in s.f)


def _make_layer(s: LayerSpec, spec: ModelSpec, fused_tails: bool = False) -> nn.Module:
    """One row as JAX ``YoloModel._run_layer`` builds it."""
    name, a = s.name, s.args

    def repeat(make):
        if s.n == 1:
            return make()
        if s.c1 != s.c2:
            # the reference builds every repeat from (c1, c2), so its second
            # takes c2 channels where it expects c1; flax infers the input
            raise ValueError(f"layer {s.i}: {s.n} repeats of {name} from {s.c1} to {s.c2} "
                             "channels; the port repeats only c1 == c2 rows")
        return nn.Sequential(*[make() for _ in range(s.n)])

    if name == "Conv":
        return repeat(lambda: L.Conv(s.c1, s.c2, _def(a, 0, 1), _def(a, 1, 1),
                                     _defn(a, 2, None), _def(a, 3, 1),
                                     _defn(a, 4, True), fused_tail=fused_tails))
    if name == "nn.Conv2d":
        return L.BiasConv2d(s.c1, s.c2, _def(a, 0, 1), _def(a, 1, 1), _def(a, 2, 0), bias=True)
    if name in ("dw_conv", "DWConv"):
        return repeat(lambda: L.DWConv(s.c1, s.c2, _def(a, 0, 1), _def(a, 1, 1), _defn(a, 2, True)))
    if name in ("RobustConv", "RobustConv2"):
        cls = L.RobustConv if name == "RobustConv" else L.RobustConv2
        return repeat(lambda: cls(s.c1, s.c2, _def(a, 0, 7), _def(a, 1, 1 if cls is L.RobustConv
                                                                       else 4),
                                  _defn(a, 2, None), _def(a, 3, 1), _defn(a, 4, True),
                                  _def(a, 5, 1e-6)))
    if name == "GhostConv":
        return repeat(lambda: L.GhostConv(s.c1, s.c2, _def(a, 0, 1), _def(a, 1, 1), _def(a, 2, 1),
                                          _defn(a, 3, True)))
    if name == "RepConv":
        return repeat(lambda: L.RepConv(s.c1, s.c2, _def(a, 0, 3), _def(a, 1, 1),
                                        _defn(a, 2, None), _def(a, 3, 1),
                                        _defn(a, 4, True), _def(a, 5, False)))
    if name == "DownC":
        return L.DownC(s.c1, s.c2, _def(a, 0, 1), _def(a, 1, 2))
    if name == "SPP":
        return L.SPP(s.c1, s.c2, _def(a, 0, (5, 9, 13)))
    if name == "SPPF":
        return L.SPPF(s.c1, s.c2, _def(a, 0, 5))
    if name in ("SPPCSPC", "GhostSPPCSPC"):
        return L.SPPCSPC(s.c1, s.c2, _def(a, 0, 1), _def(a, 1, False), _def(a, 2, 1),
                         _def(a, 3, 0.5), _def(a, 4, (5, 9, 13)), ghost=name == "GhostSPPCSPC")
    if name == "Focus":
        return repeat(lambda: L.Focus(s.c1, s.c2, _def(a, 0, 1), _def(a, 1, 1), _defn(a, 2, None),
                                      _def(a, 3, 1), _defn(a, 4, True)))
    if name in ("Stem", "GhostStem"):
        return L.Stem(s.c1, s.c2, ghost=name == "GhostStem")
    if name in ("Bottleneck", "RepBottleneck"):
        return repeat(lambda: L.Bottleneck(s.c1, s.c2, _def(a, 0, True), _def(a, 1, 1),
                                           _def(a, 2, 0.5), name == "RepBottleneck"))
    if name in ("Res", "RepRes", "ResX", "RepResX"):
        g = 32 if "X" in name else 1
        return repeat(lambda: L.Res(s.c1, s.c2, _def(a, 0, True), _def(a, 1, g),
                                    _def(a, 2, 0.5), name.startswith("Rep")))
    if name == "Ghost":
        return repeat(lambda: L.Ghost(s.c1, s.c2, _def(a, 0, 3), _def(a, 1, 1)))
    if name[-4:] in ("CSPA", "CSPB", "CSPC") and name[:-4] in _CSP_INNER:
        topo, base = name[-1], name[:-4]
        return L.CSP(topo, s.c1, s.c2, _def(a, 0, 1), _def(a, 1, topo != "B"),
                     _def(a, 2, 32 if "X" in base else 1), _def(a, 3, 0.5), _CSP_INNER[base])
    if name == "MP":
        return L.Shape(L.mp, _def(a, 0, 2))
    if name == "SP":
        return L.Shape(L.sp, _def(a, 0, 3), _def(a, 1, 1))
    if name == "ReOrg":
        return L.Shape(L.reorg)
    if name == "Concat":
        return L.Shape(L.concat)
    if name == "Chuncat":
        return L.Shape(L.chuncat)
    if name == "Shortcut":
        return L.Shape(L.shortcut)
    if name == "Foldcut":
        return L.Shape(L.foldcut)
    if name in ("Contract", "Expand"):
        return L.Shape(L.contract if name == "Contract" else L.expand, _def(a, 0, 2))
    if name == "nn.Upsample":
        if _def(a, 1, 2) != 2:
            raise ValueError("only 2x nearest upsample is used by the reference configs")
        return L.Shape(L.upsample_nearest_2x)
    if name == "nn.BatchNorm2d":
        return L.BN(s.c2)
    if name == "ImplicitA":
        return L.ImplicitA(s.c2)
    if name == "ImplicitM":
        return L.ImplicitM(s.c2)
    if name == "TransformerBlock":
        return L.TransformerBlock(*a)
    if name == "Classify":
        return L.Classify(_in_channels(s, spec), s.c2, _def(a, 0, 1), _def(a, 1, 1),
                          _defn(a, 2, None), _def(a, 3, 1))
    if name == "Detect":
        return Detect(spec.nc, spec.na, s.c1)
    if name == "IDetect":
        return IDetect(spec.nc, spec.na, s.c1)
    if name == "IAuxDetect":
        return IAuxDetect(spec.nc, spec.na, s.c1)
    if name == "IBin":
        return IBin(spec.nc, spec.na, s.c1, spec.bin_count)
    raise ValueError(f"unknown module {name!r} at layer {s.i}")


class YoloModel(nn.Module):
    """Static save-list interpreter (nets/yolo.py:95-153), NCHW.

    ``forward(x (bs, 3, H, W))`` returns the head's raw maps, each a
    ``(bs, h, w, na, no)`` fp32 view, in the head's order (P5 first for
    Detect, P3 first for the I-heads). The body runs in the dtype given to
    ``set_dtype`` (fp32 until then). ``fused_tails`` goes to the net's
    ``Conv`` rows only, as JAX ``builder.py:378-381`` (never to the Convs
    inside SPPCSPC): eligible ones run as K5 in eval mode
    (``layers.Conv``).

    ``bn_remat`` (plan key ``bn_remat``; JAX ``builder.py:335-346``): in train
    mode every BatchNorm and activation tail runs under a per-block
    checkpoint that keeps only the conv output (``layers.bn_tail_remat``);
    the same ops in the same order, so the loss and the gradients are
    bit-equal to the plain forward's.

    ``remat_ctx`` (set by the ``Trainer``'s ``remat``; None by default): in
    train mode each row runs under its own ``checkpoint`` with this
    ``context_fn`` (``layers.remat_context_fn``), so the backward recomputes
    the forward a row at a time and only the rows' outputs stay saved.

    ``quant_mode`` (None, "calib" or "int8"; JAX ``builder.py:339-348``)
    applies in eval mode only: every ``layers.Conv`` of the net, nested ones
    too, records its input's max-abs ("calib") or runs int8 ("int8", after
    ``set_int8_weights``). In train mode the model computes what it computes
    without a mode. ``quant_state`` / ``load_quant_state`` read and write
    the recorded amax values, keyed ``<module name>.amax``.
    """

    def __init__(self, spec: ModelSpec, fused_tails: bool = False, quant_mode=None,
                 bn_remat: bool = False):
        super().__init__()
        if quant_mode not in (None, "calib", "int8"):
            raise ValueError(f"quant_mode must be None, 'calib' or 'int8', got {quant_mode!r}")
        self.spec = spec
        self.dtype = torch.float32
        self.quant_mode = quant_mode
        self.bn_remat = bool(bn_remat)
        self.remat_ctx = None
        self.model = nn.ModuleList([_make_layer(s, spec, fused_tails) for s in spec.layers])

    def set_dtype(self, dtype: torch.dtype, cast_weights: bool = True,
                  head_dtype: torch.dtype = torch.float32) -> "YoloModel":
        """The body runs in ``dtype``; BN statistics and head stay fp32, the
        head multiplies in ``dtype`` and emits ``head_dtype`` logits
        (layers.LogitConv; JAX ``YoloModel.head_dtype``). ``cast_weights``
        (serving) casts the body convs' weights once; without it (training)
        they stay fp32 master weights, cast on every call
        (``layers.BodyConv2d``)."""
        return set_dtype(self, dtype, cast_weights, head_dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "YoloModel":
        """Seeded random init as the JAX package's: conv kernels
        normal(0, 0.02) (nets/yolo.py:120), BN scale normal(1, 0.02),
        ImplicitA normal(0, 0.02), ImplicitM normal(1, 0.02); linear and
        attention kernels normal(0, 0.02), biases 0."""
        return init_weights(self, generator)

    def quant_convs(self):
        """(name, Conv) of every quantized Conv, in module order."""
        return [(n, m) for n, m in self.named_modules() if isinstance(m, L.Conv)]

    def quant_state(self) -> Dict[str, torch.Tensor]:
        """The recorded activation max-abs of every Conv, ``<name>.amax``."""
        return {f"{n}.amax": m.amax.detach().clone() for n, m in self.quant_convs()}

    def load_quant_state(self, state: Dict[str, torch.Tensor]) -> "YoloModel":
        """Set every Conv's amax from ``quant_state``'s keys (all of them)."""
        convs = dict(self.quant_convs())
        want = {f"{n}.amax" for n in convs}
        if set(state) != want:
            raise KeyError(f"quant state keys differ: missing {sorted(want - set(state))[:5]}, "
                           f"unexpected {sorted(set(state) - want)[:5]}")
        for key, value in state.items():
            m = convs[key[: -len(".amax")]]
            m.amax = torch.as_tensor(value, dtype=torch.float32).to(m.amax.device).reshape(())
        return self

    def set_int8_weights(self, state_dict: Optional[Dict[str, torch.Tensor]] = None
                         ) -> "YoloModel":
        """Derive every Conv's ``wq`` and ``sw`` from fp32 weights: those of
        ``state_dict`` (the served weights before a bf16 cast), else the
        model's own, which must still be fp32."""
        for n, m in self.quant_convs():
            m.set_int8_weights(m.conv.weight if state_dict is None
                               else state_dict[f"{n}.conv.weight"])
        return self

    @torch.no_grad()
    def calibrate(self, x: torch.Tensor) -> "YoloModel":
        """One calibration pass in eval mode: every Conv raises its amax to
        the max-abs of its input (a running max over calls)."""
        if self.training:
            raise RuntimeError("calibrate runs in eval mode")
        with L.quant_ctx("calib"):
            self._walk(x)
        return self

    def forward(self, x: torch.Tensor):
        with L.bn_tail_remat(self.bn_remat and self.training), \
                L.quant_ctx(None if self.training else self.quant_mode):
            return self._walk(x)

    def _walk(self, x: torch.Tensor):
        saved = {}
        out = x.to(self.dtype)
        for s, m in zip(self.spec.layers, self.model):
            if s.f != -1:
                # negative indices are relative to the current layer
                if isinstance(s.f, int):
                    out = saved[s.f % s.i]
                else:
                    out = [out if j == -1 else saved[j % s.i] for j in s.f]
            if self.remat_ctx is not None and self.training:
                from torch.utils.checkpoint import checkpoint
                out = checkpoint(m, out, use_reentrant=False, context_fn=self.remat_ctx)
            else:
                out = m(out)
            if s.i in self.spec.save:
                saved[s.i] = out
        return out


def set_dtype(model: nn.Module, dtype: torch.dtype, cast_weights: bool = True,
              head_dtype: torch.dtype = torch.float32) -> nn.Module:
    """``YoloModel.set_dtype`` for any model of the port (also
    ``nn/yolo_body.py``'s)."""
    model.dtype = dtype
    for m in model.modules():
        if isinstance(m, L.BodyConv2d) and cast_weights:
            m.to(dtype)
        elif isinstance(m, L.LogitConv):
            m.mult_dtype, m.out_dtype = dtype, head_dtype
    return model


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """``YoloModel.init_weights`` for any model of the port."""
    for m in model.modules():
        if isinstance(m, (L.ImplicitA, L.ImplicitM)):
            mean = 1.0 if isinstance(m, L.ImplicitM) else 0.0
            m.implicit.normal_(mean, 0.02, generator=generator)
        elif isinstance(m, (nn.Conv2d, nn.Linear, L.ConvTranspose)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.MultiheadAttention):
            m.in_proj_weight.normal_(0.0, 0.02, generator=generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.normal_(1.0, 0.02, generator=generator)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model


def build_model(model_cfg, anchors, num_classes, image_chan=3, anchors_mask=None) -> YoloModel:
    """cfg dict -> YoloModel (cf. Model.__init__, nets/yolo.py:95-112)."""
    return YoloModel(build_model_spec(model_cfg, image_chan, anchors, num_classes, anchors_mask))


def model_info(model: YoloModel):
    """Per-layer table rows of ``Model.print_info`` (nets/yolo.py:127-141):
    [index, from, n, params, module, arguments] per YAML row, and a summary.
    Counts the ``nn.Parameter``s of each row's module, as JAX counts its
    ``params`` tree: BN running statistics are buffers here and
    ``batch_stats`` there, and neither is counted."""
    rows, total = [], 0
    for s, m in zip(model.spec.layers, model.model):
        n_params = sum(p.numel() for p in m.parameters())
        total += n_params
        rows.append({"i": s.i, "from": s.f, "n": s.n, "params": n_params,
                     "module": s.name, "arguments": list(s.args), "out_ch": s.c2})
    return rows, {"layers": len(model.spec.layers), "parameters": total}


def model_gflops(model: YoloModel, image_size: int = 640) -> float:
    """Convolution and matmul GFLOPs of one inference forward of one image at
    ``image_size``, as JAX counts them off the jaxpr: 2 * out * (cin/g * kh *
    kw) a convolution, 2 * out * k a matmul. ``FlopCounterMode`` counts the
    same over a forward of the model's spec built on the meta device (shapes
    only, no memory, no kernel)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        meta = YoloModel(model.spec).eval()
        x = torch.zeros(1, model.spec.layers[0].c1, image_size, image_size)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        meta(x)
    return counter.get_total_flops() / 1e9


def format_model_info(model: YoloModel, image_size: int = 640) -> str:
    """JAX ``format_model_info``'s text. Unlike JAX, which drops the GFLOPs
    figure when its count raises, an error of ``model_gflops`` propagates."""
    rows, summary = model_info(model)
    lines = [f"{'':>3}{'from':>18}{'n':>3}{'params':>10}  {'module':<22}{'arguments'}"]
    for r in rows:
        lines.append(f"{r['i']:>3}{str(r['from']):>18}{r['n']:>3}"
                     f"{r['params']:>10}  {r['module']:<22}{r['arguments']}")
    lines.append(f"Model Summary: {summary['layers']} layers, {summary['parameters']} parameters, "
                 f"{model_gflops(model, image_size):.1f} GFLOPs @ {image_size}px")
    return "\n".join(lines)
