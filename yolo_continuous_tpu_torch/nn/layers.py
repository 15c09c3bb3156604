"""The yolov7 / yolov7-tiny subset of the module zoo, in PyTorch (NCHW).

Counterpart of ``yolo_continuous_tpu/nn/layers.py``. Module and attribute
names follow the torch reference (``nets/common.py``), so the state_dict
keys are the ones ``tools/torch_import.export_state_dict`` writes:
``conv.weight``, ``bn.running_var``, ``rbr_dense.0.weight``, ...

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

Parameters and BN statistics are fp32. Every body convolution
(``BodyConv2d``) casts its weight to its input's dtype, so a bf16 body
trains on fp32 master weights, as flax's ``dtype=bf16, param_dtype=fp32``.
For serving, ``YoloModel.set_dtype`` casts the weights themselves once.
"""
from __future__ import annotations

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
    """The activations yolov7 and yolov7-tiny use: SiLU, LeakyReLU(slope)."""
    if act is True or act == "silu":
        return F.silu(x)
    if isinstance(act, tuple) and act[0] == "leaky_relu":
        return F.leaky_relu(x, negative_slope=act[1])
    if act in (False, None, "identity"):
        return x
    raise NotImplementedError(f"activation {act!r} is not ported yet "
                              "(ROADMAP.md Queue 1 item 15)")


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
    """

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = batch_stats(x)
            with torch.no_grad():
                n = x.numel() / x.shape[1]
                m = BN_MOMENTUM
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


class LogitConv(nn.Conv2d):
    """1x1 detection-head conv: products of body-dtype values, fp32 logits.

    Input and weight are rounded to ``mult_dtype`` (the body dtype) and then
    widened to fp32 for the convolution, so the sum and the stored logits
    are fp32, as ``preferred_element_type=float32`` gives in JAX. A bf16
    ``F.conv2d`` would round the logits themselves to bf16.
    """

    def __init__(self, c1: int, c2: int):
        super().__init__(c1, c2, 1, bias=True)
        self.mult_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.mult_dtype).float()
        return F.conv2d(x.to(self.mult_dtype).float(), w, self.bias.float())


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


class MP(nn.Module):
    def __init__(self, k: int = 2):
        super().__init__()
        self.k = k

    def forward(self, x):
        return mp(x, self.k)


class SP(nn.Module):
    def __init__(self, k: int = 3, s: int = 1):
        super().__init__()
        self.k, self.s = k, s

    def forward(self, x):
        return sp(x, self.k, self.s)


class Concat(nn.Module):
    def forward(self, xs):
        return concat(xs)


class Upsample2x(nn.Module):
    def forward(self, x):
        return upsample_nearest_2x(x)


class SPPCSPC(nn.Module):
    """CSP-SPP of the yolov7 head; nets/common.py:248-266."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 g: int = 1, e: float = 0.5, k: Tuple[int, ...] = (5, 9, 13),
                 act: ActSpec = True):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.cv2 = Conv(c1, c_, 1, 1, act=act)
        self.cv3 = Conv(c_, c_, 3, 1, act=act)
        self.cv4 = Conv(c_, c_, 1, 1, act=act)
        self.cv5 = Conv((1 + len(self.k)) * c_, c_, 1, 1, act=act)
        self.cv6 = Conv(c_, c_, 3, 1, act=act)
        self.cv7 = Conv(2 * c_, c2, 1, 1, act=act)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = self.cv6(self.cv5(concat([x1] + sp_pyramid(x1, self.k))))
        y2 = self.cv2(x)
        return self.cv7(concat([y1, y2]))


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
    """RepVGG-style 3-branch conv in its train form; nets/common.py:442-614.

    conv3x3+BN + conv1x1+BN + (a bare BN identity if c1 == c2 and s == 1).
    The deploy form (one fused conv) comes with ``nn/fuse.py``'s port."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 p: Optional[int] = None, g: int = 1, act: ActSpec = True,
                 deploy: bool = False):
        super().__init__()
        if k != 3 or autopad(k, p) != 1:
            raise ValueError("RepConv takes a 3x3 kernel with padding 1")
        if deploy:
            raise NotImplementedError(
                "RepConv deploy form is not ported yet (ROADMAP.md Queue 1 item 15)")
        self.act = act
        self.rbr_dense = nn.Sequential(
            BodyConv2d(c1, c2, 3, s, 1, groups=g, bias=False), BatchNorm2d(c2))
        self.rbr_1x1 = nn.Sequential(
            BodyConv2d(c1, c2, 1, s, 0, groups=g, bias=False), BatchNorm2d(c2))
        self.rbr_identity = BatchNorm2d(c1) if (c2 == c1 and s == 1) else None

    def forward(self, x):
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return apply_act(y, self.act)
