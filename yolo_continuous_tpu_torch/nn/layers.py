"""The module zoo in PyTorch (NCHW).

Counterpart of ``yolo_continuous_tpu/nn/layers.py``: every block of the
reference zoo ``nets/common.py`` that the JAX package builds. Module and
attribute names follow the torch reference, so the state_dict keys are the
ones ``tools/torch_import.export_state_dict`` writes: ``conv.weight``,
``bn.running_var``, ``rbr_dense.0.weight``, ``m.0.cv1.conv.weight``, ...
(``tools/jax_weights.py`` adds the attention rule that export lacks).

Numerics follow the JAX package, not torch defaults, where they differ:

- BatchNorm at inference folds its statistics as ``_normalize`` does
  (``layers.py:263-266``): ``inv = scale * rsqrt(var + 1e-5)`` and
  ``shift = bias - mean * inv`` in fp32, then ``x * inv + shift`` in the
  body dtype.
- ``LogitConv`` (``layers.py:160-193``) rounds input and weight to the body
  dtype but multiplies and accumulates in fp32, so the head logits are
  never rounded to bf16.
- BatchNorm in train mode takes its statistics as ``_batch_stats`` does
  (``layers.py:254-260``): fp32 mean and ``max(E[x^2] - E[x]^2, 0)`` over
  (N, H, W), normalizes with the same fold, and updates the running
  statistics with flax momentum 0.9 and the unbiased variance.
- ``mp`` in training is a max over a reshaped 2 x 2 window
  (``layers.py:295-308``): the values of a max pool, and a gradient split
  evenly over ties.
- ``sp`` pads with -inf and ``sp_pyramid`` cascades the (5, 9, 13) ladder
  (``layers.py:324-361``); the values equal the direct pools.

- The shape ops (``reorg``, ``contract``, ``expand``, ``chuncat``) give
  JAX's NHWC channel order in NCHW, so the next conv's weights act on the
  same channels.
- A biased convolution (``BiasConv2d``: the deploy-form RepConv, the
  ``nn.Conv2d`` row, RobustConv's 1x1, Classify) rounds the convolution to
  the body dtype and then adds the bias in that dtype, as flax's biased
  ``nn.Conv`` does; a bias in cuDNN's fp32 epilogue would round once.
- ``TransformerLayer`` attends over the axis flax's attention takes as its
  length (the batch axis of the ``(tokens, batch, c)`` input, as the JAX
  version computes it), not over the tokens.

Parameters and BN statistics are fp32. Every body convolution
(``BodyConv2d``) casts its weight to its input's dtype, so a bf16 body
trains on fp32 master weights, as flax's ``dtype=bf16, param_dtype=fp32``.
For serving, ``YoloModel.set_dtype`` casts the weights themselves once.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.fused_conv import fused_pointwise_conv

# True -> SiLU (the reference default), a str name, or ("leaky_relu", slope)
# parsed from YAML strings like "nn.LeakyReLU(0.1)".
ActSpec = Union[bool, None, str, Tuple[str, float]]

BN_EPS = 1e-5
# Input channels from which a fused-tail Conv takes kernel K5 (JAX default).
FUSED_TAIL_MIN_CIN = 512


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same' padding for odd kernels; mirrors nets/common.py:7-11."""
    if p is None:
        p = k // 2 if isinstance(k, int) else [x // 2 for x in k]
    return p


def apply_act(x: torch.Tensor, act: ActSpec) -> torch.Tensor:
    """The activation specs of JAX ``apply_act`` (``layers.py:115-128``)."""
    if act is True or act == "silu":
        return F.silu(x)
    if isinstance(act, tuple) and act[0] == "leaky_relu":
        return F.leaky_relu(x, negative_slope=act[1])
    if act == "leaky_relu":
        return F.leaky_relu(x, negative_slope=0.01)
    if act == "relu":
        return F.relu(x)
    if act == "hardswish":
        return F.hardswish(x)
    if act in (False, None, "identity"):
        return x
    raise ValueError(f"unknown activation spec {act!r}")


BN_MOMENTUM = 0.9   # flax's momentum: running = 0.9 * running + 0.1 * batch


def batch_stats(x: torch.Tensor):
    """Per-channel mean and biased variance of NCHW ``x`` over (N, H, W), in
    fp32, as JAX ``_batch_stats``: ``max(E[x^2] - E[x]^2, 0)``."""
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
    return mean, var


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's numerics (eps 1e-5), ``_BNCore``.

    Both modes fold ``inv = weight * rsqrt(var + eps)`` and ``shift = bias -
    mean * inv`` in fp32 and compute ``x * inv + shift`` in the input's dtype:
    eval with the running statistics, train with ``batch_stats`` (gradients
    flow through them). Train mode also updates the running statistics as
    flax does: ``0.9 * running + 0.1 * batch``, the variance unbiased by
    ``n / (n - 1)``. ``num_batches_tracked`` is left as it is (JAX has none).
    ``eps`` and ``flax_momentum`` change for the YoloBody family (1e-3, 0.97).
    """

    def __init__(self, c: int, eps: float = BN_EPS, flax_momentum: float = BN_MOMENTUM):
        super().__init__(c, eps=eps, momentum=1.0 - flax_momentum)
        self.flax_momentum = flax_momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = batch_stats(x)
            with torch.no_grad():
                n = x.numel() / x.shape[1]
                m = self.flax_momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                unbiased = var * (n / max(n - 1.0, 1.0))
                self.running_var.copy_(m * self.running_var + (1 - m) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class BodyConv2d(nn.Conv2d):
    """A body convolution: its weight is cast to the input's dtype on every
    call (a no-op once ``YoloModel.set_dtype`` has cast it), so fp32 master
    weights train a bf16 body."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class BiasConv2d(BodyConv2d):
    """A biased body convolution, as flax's biased ``nn.Conv``: the
    convolution is rounded to the input's dtype and the bias, cast to that
    dtype, is added after it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        return y + self.bias.to(x.dtype)[:, None, None]


class BodyLinear(nn.Linear):
    """flax ``nn.Dense`` in the body dtype: the weight cast to the input's
    dtype a call, the bias added after the product in that dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class LogitConv(nn.Conv2d):
    """1x1 detection-head conv: products of body-dtype values, fp32 logits.

    Input and weight are rounded to ``mult_dtype`` (the body dtype) and then
    widened to fp32 for the convolution, so the sum and the stored logits
    are fp32, as ``preferred_element_type=float32`` gives in JAX. A bf16
    ``F.conv2d`` would round the logits themselves to bf16. ``out_dtype``
    (the Detector's ``head_dtype``) rounds the fp32 sum and adds the bias in
    that dtype, as JAX's ``preferred_element_type=head_dtype``.
    """

    def __init__(self, c1: int, c2: int):
        super().__init__(c1, c2, 1, bias=True)
        self.mult_dtype = torch.float32
        self.out_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.mult_dtype).float()
        x = x.to(self.mult_dtype).float()
        if self.out_dtype == torch.float32:
            return F.conv2d(x, w, self.bias.float())
        return F.conv2d(x, w).to(self.out_dtype) + self.bias.to(self.out_dtype)[:, None, None]


class Conv(nn.Module):
    """Conv2d + BN + act; nets/common.py:97-109 (no int8 branch).

    ``fused_tail=True`` (serving option, JAX ``layers.py:501-511``): in
    eval mode a 1x1, stride-1, ungrouped SiLU instance with C_in >=
    ``FUSED_TAIL_MIN_CIN`` runs as one fused conv + folded BN + SiLU
    (``kernels/fused_conv.py``, kernel K5 on CUDA). BN folds in fp32 and the
    result is rounded once to the body dtype, not after the conv and again
    after BN as below. The parameters are the same either way.
    """

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, g: int = 1, act: ActSpec = True,
                 fused_tail: bool = False):
        super().__init__()
        self.conv = BodyConv2d(c1, c2, k, s, autopad(k, p), groups=g, bias=False)
        self.bn = BatchNorm2d(c2)
        self.act = act
        self.fused_tail = fused_tail and k == 1 and s == 1 and g == 1 and act is True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_tail and not self.training and x.shape[1] >= FUSED_TAIL_MIN_CIN:
            bn = self.bn
            inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * inv
            w = self.conv.weight.to(x.dtype).reshape(self.conv.out_channels, -1)
            return fused_pointwise_conv(x.contiguous(), w, inv, shift)
        return apply_act(self.bn(self.conv(x)), self.act)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(None, 2, 'nearest')."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def mp(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """MP: maxpool k=s=2; nets/common.py:25-31.

    Where a gradient is recorded, as JAX ``max_pool`` (``layers.py:295-308``):
    a max over the reshaped window where the sides divide by k, whose
    gradient splits a tie evenly (``F.max_pool2d`` gives it all to one
    element). Without one, the pool: the same values in less time (on an
    H100 the reduction took 1.9 ms of a yolov7 @640 bs16 request)."""
    b, c, h, w = x.shape
    if torch.is_grad_enabled() and x.requires_grad and h % k == 0 and w % k == 0:
        return x.reshape(b, c, h // k, k, w // k, k).amax((3, 5))
    return F.max_pool2d(x, k, k)


def sp(x: torch.Tensor, k: int = 3, s: int = 1) -> torch.Tensor:
    """SP: stride-1 maxpool, same-pad with -inf; nets/common.py:34-40.

    Separable (k,1) then (1,k), as the JAX version; exact for max."""
    if s == 1 and k > 1:
        p = k // 2
        x = F.max_pool2d(x, (k, 1), 1, (p, 0))
        return F.max_pool2d(x, (1, k), 1, (0, p))
    return F.max_pool2d(x, k, s, k // 2)


def sp_pyramid(x: torch.Tensor, ks: Sequence[int]):
    """[sp(x, k) for k in ks], as a cascade where the ladder allows it
    (stride-1 max windows compose by radius addition)."""
    outs, prev, prev_r = [], x, 0
    for k in tuple(ks):
        r = (k - 1) // 2
        step = r - prev_r
        if k % 2 == 1 and step > 0:
            prev = sp(prev, 2 * step + 1)
            prev_r = r
            outs.append(prev)
        else:   # non-monotone/even ladder: direct pool, no cascade
            outs.append(sp(x, k))
    return outs


def concat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat(dimension=1): channel concat; nets/common.py:54-60."""
    return torch.cat(list(xs), dim=1)


def reorg(x: torch.Tensor) -> torch.Tensor:
    """ReOrg: space-to-depth 2x, nets/common.py:43-51; the four phases in
    JAX's channel order (rows then columns: [::2, ::2], [1::2, ::2],
    [::2, 1::2], [1::2, 1::2])."""
    return torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                      x[..., 1::2, 1::2]], dim=1)


def chuncat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """nets/common.py:63-75: every input's first channel half, then every
    second half."""
    halves = [torch.chunk(x, 2, dim=1) for x in xs]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=1)


def shortcut(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """nets/common.py:78-84."""
    return xs[0] + xs[1]


def foldcut(x: torch.Tensor) -> torch.Tensor:
    """nets/common.py:87-94: the sum of the two channel halves."""
    x1, x2 = torch.chunk(x, 2, dim=1)
    return x1 + x2


def contract(x: torch.Tensor, gain: int = 2) -> torch.Tensor:
    """Contract w/h into channels, nets/common.py:787-798; output channel
    ``(s1 * gain + s2) * c + ch``, JAX's (s1, s2, c) order."""
    n, c, h, w = x.shape
    s = gain
    x = x.reshape(n, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, s * s * c, h // s, w // s)


def expand(x: torch.Tensor, gain: int = 2) -> torch.Tensor:
    """Expand channels into w/h, nets/common.py:801-812; input channels split
    as (s1, s2, c'), JAX's order."""
    n, c, h, w = x.shape
    s = gain
    x = x.reshape(n, s, s, c // s ** 2, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // s ** 2, h * s, w * s)


class Shape(nn.Module):
    """A parameter-free row (MP, SP, ReOrg, Concat, ...): ``fn(x, *args)``."""

    def __init__(self, fn, *args):
        super().__init__()
        self.fn, self.args = fn, args

    def forward(self, x):
        return self.fn(x, *self.args)


class BN(nn.Module):
    """The ``nn.BatchNorm2d`` row: JAX nests its ``_BNCore`` as ``bn``, so the
    key is ``model.{i}.bn.weight``."""

    def __init__(self, c: int):
        super().__init__()
        self.bn = BatchNorm2d(c)

    def forward(self, x):
        return self.bn(x)


class DWConv(nn.Module):
    """dw_conv: groups = gcd(c1, c2); nets/common.py:20-22."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act: ActSpec = True):
        super().__init__()
        self.conv = Conv(c1, c2, k, s, None, math.gcd(c1, c2), act)

    def forward(self, x):
        return self.conv(x)


def _layer_scale(m: nn.Module, c2: int, init: float) -> None:
    m.gamma = nn.Parameter(torch.full((c2,), float(init))) if init > 0 else None


def _scale(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return x if m.gamma is None else x * m.gamma.to(x.dtype)[:, None, None]


class RobustConv(nn.Module):
    """depthwise k + biased pointwise 1x1 + layer scale; nets/common.py:112-124."""

    def __init__(self, c1: int, c2: int, k: int = 7, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act: ActSpec = True, layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.conv_dw = Conv(c1, c1, k, s, p, c1, act)
        self.conv1x1 = BiasConv2d(c1, c2, 1, 1, 0, bias=True)
        _layer_scale(self, c2, layer_scale_init_value)

    def forward(self, x):
        return _scale(self, self.conv1x1(self.conv_dw(x)))


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with kernel = stride = s, 'VALID', biased.

    The weight is ``(c2, c1, s, s)``: the flax kernel ``(s, s, c1, c2)`` as
    ``tools/torch_import`` exports any 4-D kernel, which is not the layout of
    torch's ``ConvTranspose2d`` ``(c1, c2, s, s)``. Flax does not flip the
    kernel: output pixel ``(i * s + a, j * s + b)`` takes input ``(i, j)``
    times kernel tap ``(s - 1 - a, s - 1 - b)``, so torch's transposed
    convolution gets the kernel transposed and flipped. The bias is added
    after the convolution in the input's dtype, as flax does."""

    def __init__(self, c1: int, c2: int, s: int):
        super().__init__()
        self.s = s
        self.weight = nn.Parameter(torch.zeros(c2, c1, s, s))
        self.bias = nn.Parameter(torch.zeros(c2))

    def forward(self, x):
        w = self.weight.to(x.dtype).transpose(0, 1).flip((2, 3))
        y = F.conv_transpose2d(x, w, None, stride=self.s)
        return y + self.bias.to(x.dtype)[:, None, None]


class RobustConv2(nn.Module):
    """strided depthwise + transposed-conv upsample + layer scale;
    nets/common.py:127-139."""

    def __init__(self, c1: int, c2: int, k: int = 7, s: int = 4, p: Optional[int] = None,
                 g: int = 1, act: ActSpec = True, layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.conv_strided = Conv(c1, c1, k, s, p, c1, act)
        self.conv_deconv = ConvTranspose(c1, c2, s)
        _layer_scale(self, c2, layer_scale_init_value)

    def forward(self, x):
        return _scale(self, self.conv_deconv(self.conv_strided(x)))


class GhostConv(nn.Module):
    """half features + cheap 5x5 depthwise ghosts; nets/common.py:142-152."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: ActSpec = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class Stem(nn.Module):
    """4-conv + pool stem; nets/common.py:155-168 (Stem) and 283-291
    (GhostStem, ``ghost=True``). Its k, s, p, g, act arguments are unused,
    as in JAX."""

    def __init__(self, c1: int, c2: int, ghost: bool = False):
        super().__init__()
        c_ = int(c2 / 2)
        cv = GhostConv if ghost else Conv
        self.cv1 = cv(c1, c_, 3, 2)
        self.cv2 = cv(c_, c_, 1, 1)
        self.cv3 = cv(c_, c_, 3, 2)
        self.cv4 = cv(2 * c_, c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv4(torch.cat([self.cv3(self.cv2(x)), mp(x, 2)], dim=1))


class DownC(nn.Module):
    """conv-downsample || maxpool-conv; nets/common.py:171-182. The pool
    (k == stride) is ``mp``'s, so its gradient splits ties as JAX's does."""

    def __init__(self, c1: int, c2: int, n: int = 1, k: int = 2):
        super().__init__()
        self.k = k
        self.cv1 = Conv(c1, c1, 1, 1)
        self.cv2 = Conv(c1, c2 // 2, 3, k)
        self.cv3 = Conv(c1, c2 // 2, 1, 1)

    def forward(self, x):
        return torch.cat([self.cv2(self.cv1(x)), self.cv3(mp(x, self.k))], dim=1)


class SPP(nn.Module):
    """nets/common.py:185-196."""

    def __init__(self, c1: int, c2: int, k: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(concat([x] + sp_pyramid(x, self.k)))


class SPPF(nn.Module):
    """cascaded SPP; nets/common.py:771-784."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        y1 = sp(x, self.k)
        y2 = sp(y1, self.k)
        return self.cv2(concat([x, y1, y2, sp(y2, self.k)]))


class SPPCSPC(nn.Module):
    """CSP-SPP of the yolov7 head; nets/common.py:248-266 (and the
    GhostSPPCSPC variant, ``ghost=True``: GhostConvs, nets/common.py:269-280)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 g: int = 1, e: float = 0.5, k: Tuple[int, ...] = (5, 9, 13),
                 act: ActSpec = True, ghost: bool = False):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = tuple(k)

        def cv(a, b, kk):
            return GhostConv(a, b, kk, 1) if ghost else Conv(a, b, kk, 1, act=act)
        self.cv1 = cv(c1, c_, 1)
        self.cv2 = cv(c1, c_, 1)
        self.cv3 = cv(c_, c_, 3)
        self.cv4 = cv(c_, c_, 1)
        self.cv5 = cv((1 + len(self.k)) * c_, c_, 1)
        self.cv6 = cv(c_, c_, 3)
        self.cv7 = cv(2 * c_, c2, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = self.cv6(self.cv5(concat([x1] + sp_pyramid(x1, self.k))))
        y2 = self.cv2(x)
        return self.cv7(concat([y1, y2]))


class Bottleneck(nn.Module):
    """Darknet bottleneck, nets/common.py:199-209; ``rep``: RepBottleneck
    (cv2 a RepConv, nets/common.py:617-622)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 rep: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = RepConv(c_, c2, 3, 1, g=g) if rep else Conv(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class Res(nn.Module):
    """ResNet bottleneck, nets/common.py:212-223; ``rep``: RepRes (cv2 a
    RepConv, nets/common.py:649-654)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 rep: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = RepConv(c_, c_, 3, 1, g=g) if rep else Conv(c_, c_, 3, 1, g=g)
        self.cv3 = Conv(c_, c2, 1, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv3(self.cv2(self.cv1(x)))
        return x + y if self.add else y


class Ghost(nn.Module):
    """Ghost bottleneck; nets/common.py:233-245. ``conv`` and ``shortcut``
    are Sequentials, so the keys are ``conv.0``, ``conv.2``, ``shortcut.0``."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = nn.Sequential(DWConv(c1, c1, k, s, act=False),
                                      Conv(c1, c2, 1, 1, act=False)) if s == 2 else nn.Identity()

    def forward(self, x):
        return self.conv(x) + self.shortcut(x)


def _inner_block(kind: str, c_: int, shortcut: bool, g: int) -> nn.Module:
    """The repeated block inside a CSP ``m`` chain, with the reference's e."""
    if kind in ("bottleneck", "rep_bottleneck"):
        return Bottleneck(c_, c_, shortcut, g, e=1.0, rep=kind == "rep_bottleneck")
    if kind in ("res", "rep_res"):
        return Res(c_, c_, shortcut, g, e=0.5, rep=kind == "rep_res")
    if kind == "resx":              # ResXCSP* uses e=1.0 inner (nets/common.py:368-389)
        return Res(c_, c_, shortcut, g, e=1.0)
    if kind == "rep_resx":
        return Res(c_, c_, shortcut, g, e=0.5, rep=True)
    if kind == "ghost":
        return Ghost(c_, c_)
    raise ValueError(kind)


class CSP(nn.Module):
    """The CSP wrappers of nets/common.py:294-413, 625-710, by topology:
    A (cv1 -> m, cv2 beside, cv3 over both), B (c_ = c2, m and cv2 both
    from cv1), C (an extra cv3 after m, cv4 over both)."""

    def __init__(self, topo: str, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, inner: str = "bottleneck"):
        super().__init__()
        self.topo = topo
        c_ = int(c2) if topo == "B" else int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*[_inner_block(inner, c_, shortcut, g) for _ in range(n)])
        self.cv2 = Conv(c_ if topo == "B" else c1, c_, 1, 1)
        if topo == "C":
            self.cv3 = Conv(c_, c_, 1, 1)
            self.cv4 = Conv(2 * c_, c2, 1, 1)
        else:
            self.cv3 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        x1 = self.cv1(x)
        if self.topo == "A":
            return self.cv3(concat([self.m(x1), self.cv2(x)]))
        if self.topo == "B":
            return self.cv3(concat([self.m(x1), self.cv2(x1)]))
        return self.cv4(concat([self.cv3(self.m(x1)), self.cv2(x)]))


class ImplicitA(nn.Module):
    """Learned additive prior; nets/common.py:416-426 (JAX ``layers.py:891-904``).

    Adds in the input's dtype (the body dtype, bf16 on CUDA)."""

    def __init__(self, c: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.implicit.to(x.dtype)


class ImplicitM(nn.Module):
    """Learned multiplicative prior; nets/common.py:429-439 (JAX
    ``layers.py:907-924``). It scales the fp32 logits of ``LogitConv``, so
    the product stays fp32. Drawn around 1 by ``YoloModel.init_weights``
    (the JAX package's deliberate fix; the reference draws around 0)."""

    def __init__(self, c: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.ones(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.implicit.to(x.dtype)


class RepConv(nn.Module):
    """RepVGG-style 3-branch conv; nets/common.py:442-614.

    Train form: conv3x3+BN + conv1x1+BN + (a bare BN identity if c1 == c2
    and s == 1). Deploy form (``deploy=True``): one biased 3x3 conv,
    ``rbr_reparam``, whose weights ``nn/fuse.fuse_repconv`` computes."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 p: Optional[int] = None, g: int = 1, act: ActSpec = True,
                 deploy: bool = False):
        super().__init__()
        if k != 3 or autopad(k, p) != 1:
            raise ValueError("RepConv takes a 3x3 kernel with padding 1")
        self.act, self.deploy = act, deploy
        if deploy:
            self.rbr_reparam = BiasConv2d(c1, c2, 3, s, 1, groups=g, bias=True)
            return
        self.rbr_dense = nn.Sequential(
            BodyConv2d(c1, c2, 3, s, 1, groups=g, bias=False), BatchNorm2d(c2))
        self.rbr_1x1 = nn.Sequential(
            BodyConv2d(c1, c2, 1, s, 0, groups=g, bias=False), BatchNorm2d(c2))
        self.rbr_identity = BatchNorm2d(c1) if (c2 == c1 and s == 1) else None

    def forward(self, x):
        if self.deploy:
            return apply_act(self.rbr_reparam(x), self.act)
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return apply_act(y, self.act)


class Focus(nn.Module):
    """space-to-depth + conv; nets/common.py:759-768."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act: ActSpec = True):
        super().__init__()
        self.conv = Conv(4 * c1, c2, k, s, p, g, act)

    def forward(self, x):
        return self.conv(reorg(x))


class TransformerLayer(nn.Module):
    """LayerNorm-free transformer layer; nets/common.py:713-727.

    x is ``(tokens, batch, c)``. JAX's flax attention takes the last axis
    but one as its length, here the batch axis, and the tokens as a batch:
    torch's attention over the tensor with its first two axes swapped gives
    reading (``attention``). ``ma.in_proj_*`` stack flax's query, key and
    value projections; ``tools/jax_weights.py`` carries the weights across."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.q = BodyLinear(c, c, bias=False)
        self.k = BodyLinear(c, c, bias=False)
        self.v = BodyLinear(c, c, bias=False)
        self.ma = nn.MultiheadAttention(c, num_heads)
        self.fc1 = BodyLinear(c, c, bias=False)
        self.fc2 = BodyLinear(c, c, bias=False)

    def attention(self, q, k, v):
        """``ma`` over the batch axis of ``(tokens, batch, c)``, its weights
        in the input's dtype."""
        ma, dt = self.ma, q.dtype
        out = F.multi_head_attention_forward(
            q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), ma.embed_dim, ma.num_heads,
            ma.in_proj_weight.to(dt), ma.in_proj_bias.to(dt), None, None, False, 0.0,
            ma.out_proj.weight.to(dt), ma.out_proj.bias.to(dt), training=False,
            need_weights=False)[0]
        return out.transpose(0, 1)

    def forward(self, x):
        x = self.attention(self.q(x), self.k(x), self.v(x)) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """ViT block over the spatial grid; nets/common.py:730-756."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int):
        super().__init__()
        self.conv = Conv(c1, c2) if c1 != c2 else None
        self.linear = BodyLinear(c2, c2)
        self.tr = nn.Sequential(*[TransformerLayer(c2, num_heads) for _ in range(num_layers)])
        self.c2 = c2

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, _, h, w = x.shape
        p = x.flatten(2).permute(2, 0, 1)                   # (tokens, batch, c)
        x = self.tr(p + self.linear(p))
        return x.permute(1, 2, 0).reshape(b, self.c2, h, w)


class Classify(nn.Module):
    """global-avg-pool classification head; nets/common.py:815-825."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1):
        super().__init__()
        self.conv = BiasConv2d(c1, c2, k, s, autopad(k, p), groups=g, bias=True)

    def forward(self, x):
        xs = x if isinstance(x, (list, tuple)) else [x]
        z = torch.cat([y.mean((2, 3), keepdim=True) for y in xs], dim=1)
        return self.conv(z).permute(0, 2, 3, 1).flatten(1)
