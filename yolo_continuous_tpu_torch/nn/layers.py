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

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.bn_act import act_code, activate, bn_act, bn_act_plain, fold
from ..kernels.fused_conv import fused_pointwise_conv
from ..parallel.mesh import (active_mesh, all_reduce_sum, gather_from_model,
                             sharded_conv)
from . import quant as Q

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


# int8 post-training quantization mode (JAX ``layers.py:85-112``): None, or
# "calib" (every Conv records the running max of |x| over its input, then runs
# the float path) or "int8" (every Conv runs ``nn/quant.py``'s integer path).
# Per thread, so that engines serving a float and an int8 model side by side
# never see each other's mode.
_QUANT = threading.local()


@contextlib.contextmanager
def quant_ctx(mode):
    """Conv blocks called in this scope (and this thread) run the int8 path
    ("int8") or record activation scales ("calib"); train mode ignores it."""
    if mode not in (None, "calib", "int8"):
        raise ValueError(f"quant mode must be None, 'calib' or 'int8', got {mode!r}")
    prev = getattr(_QUANT, "mode", None)
    _QUANT.mode = mode
    try:
        yield
    finally:
        _QUANT.mode = prev


def quant_mode():
    """The quant mode of the current thread's scope."""
    return getattr(_QUANT, "mode", None)


# Recomputation (JAX ``layers.py:47-80``, ``train_loop.py:50-74``). In
# ``bn_tail_remat`` scope each train-mode BatchNorm computes its statistics,
# normalize and activation inside a per-block checkpoint that saves only its
# input (the conv output); the rest, the two (c,) statistics too, is
# recomputed in the backward (JAX saves the statistics; a selective
# checkpoint that kept them runs every op of every tail through a Python
# dispatch mode, which more than doubled a yolov7 @640 step on an H100).
# ``recompute_scope`` marks a forward that a checkpoint recomputes in the
# backward: BatchNorm then leaves its running statistics alone, which the
# first forward updated (JAX is functional and cannot update them twice;
# torch would). Per thread: the backward recomputes on the thread that
# runs it.
_REMAT = threading.local()


@contextlib.contextmanager
def bn_tail_remat(enabled: bool):
    """Train-mode BatchNorm tails called in this scope (and this thread) run
    under the per-block checkpoint."""
    prev = getattr(_REMAT, "bn_tail", False)
    _REMAT.bn_tail = bool(enabled)
    try:
        yield
    finally:
        _REMAT.bn_tail = prev


@contextlib.contextmanager
def recompute_scope():
    """A checkpoint's recomputation of a forward: no running-statistics
    update."""
    prev = getattr(_REMAT, "recompute", False)
    _REMAT.recompute = True
    try:
        yield
    finally:
        _REMAT.recompute = prev


def recomputing() -> bool:
    return getattr(_REMAT, "recompute", False)


@contextlib.contextmanager
def _entered(*scopes):
    with contextlib.ExitStack() as stack:
        for scope in scopes:
            stack.enter_context(scope)
        yield


def remat_context_fn(policy, bn_tail: bool):
    """``checkpoint``'s ``context_fn`` for a row of a model under ``remat``:
    ``policy`` None recomputes everything, else the selective checkpoint
    contexts that save the outputs of the ops in ``policy``; the
    recomputation runs in ``recompute_scope`` and with the model's
    ``bn_tail_remat`` setting, as the first forward did."""
    def context_fn():
        scopes = [recompute_scope(), bn_tail_remat(bn_tail)]
        if policy is None:
            return contextlib.nullcontext(), _entered(*scopes)
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        forward, recompute = create_selective_checkpoint_contexts(policy)
        return forward, _entered(recompute, *scopes)
    return context_fn


def apply_act(x: torch.Tensor, act: ActSpec) -> torch.Tensor:
    """The activation specs of JAX ``apply_act`` (``layers.py:115-128``)."""
    return activate(x, *act_code(act))


BN_MOMENTUM = 0.9   # flax's momentum: running = 0.9 * running + 0.1 * batch


def batch_stats(x: torch.Tensor):
    """Per-channel mean and biased variance of NCHW ``x`` over (N, H, W), in
    fp32, as JAX ``_batch_stats``: ``max(E[x^2] - E[x]^2, 0)``. Under an
    active mesh (``parallel/mesh.use_mesh``) over the global batch: the two
    means summed over "data" with their gradient, divided by its size."""
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    mean2 = (xf * xf).mean((0, 2, 3))
    mesh = active_mesh()
    if mesh is not None:
        both = all_reduce_sum(torch.stack([mean, mean2]), mesh.data_group)
        both = both / float(mesh.shape["data"])
        mean, mean2 = both[0], both[1]
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return mean, var


def _bn_train(x, weight, bias, eps: float, act):
    """Train-mode BatchNorm and activation: (output, mean, var)."""
    mean, var = batch_stats(x)
    inv, shift = fold(weight, bias, mean, var, eps)
    return apply_act(x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None],
                     act), mean, var


def _recompute_contexts():
    return contextlib.nullcontext(), recompute_scope()


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's numerics (eps 1e-5), ``_BNCore``.

    Both modes fold ``inv = weight * rsqrt(var + eps)`` and ``shift = bias -
    mean * inv`` in fp32 and compute ``x * inv + shift`` in the input's dtype:
    eval with the running statistics, train with ``batch_stats`` (gradients
    flow through them). Eval on a CUDA tensor is one launch of
    ``kernels/bn_act.py``'s kernel (fold, apply and activation, bit-equal to
    ``bn_act_plain``) on the map made NCHW-contiguous; its wrapper refuses a
    dtype other than bf16, fp16 or fp32. Eval keeps the plain expression on a
    CPU tensor, and on the card only where autograd has to flow (grad mode on
    and x or the affine parameters requiring grad, as in ``model.eval();
    model(x)`` outside ``no_grad``), since the kernel has no backward. Train
    mode also updates the running statistics as flax does: ``0.9 * running +
    0.1 * batch``, the variance unbiased by ``n / (n - 1)``. ``num_batches_tracked`` is left as it is (JAX has none).
    ``eps`` and ``flax_momentum`` change for the YoloBody family (1e-3, 0.97).
    """

    def __init__(self, c: int, eps: float = BN_EPS, flax_momentum: float = BN_MOMENTUM):
        super().__init__(c, eps=eps, momentum=1.0 - flax_momentum)
        self.flax_momentum = flax_momentum

    def forward(self, x: torch.Tensor, act: ActSpec = None) -> torch.Tensor:
        """BatchNorm, then the activation ``act`` (none by default)."""
        if not self.training:
            args = (self.weight, self.bias, self.running_mean, self.running_var, self.eps, act)
            grad = torch.is_grad_enabled() and (
                x.requires_grad or self.weight.requires_grad or self.bias.requires_grad)
            if x.device.type != "cuda" or grad:
                return bn_act_plain(x, *args)
            return bn_act(x.contiguous(), *args)
        if getattr(_REMAT, "bn_tail", False):
            from torch.utils.checkpoint import checkpoint
            out, mean, var = checkpoint(_bn_train, x, self.weight, self.bias, self.eps, act,
                                        use_reentrant=False, context_fn=_recompute_contexts)
        else:
            out, mean, var = _bn_train(x, self.weight, self.bias, self.eps, act)
        if not recomputing():
            with torch.no_grad():
                mesh = active_mesh()
                n = x.numel() / x.shape[1] * (mesh.shape["data"] if mesh is not None else 1)
                m = self.flax_momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                unbiased = var * (n / max(n - 1.0, 1.0))
                self.running_var.copy_(m * self.running_var + (1 - m) * unbiased)
        return out


class BodyConv2d(nn.Conv2d):
    """A body convolution: its weight is cast to the input's dtype on every
    call (a no-op once ``YoloModel.set_dtype`` has cast it), so fp32 master
    weights train a bf16 body. With ``mesh`` set (``parallel/mesh.shard_params``)
    the weight is this rank's slice of the output channels and the output is
    gathered whole (``parallel/mesh.sharded_conv``)."""

    mesh = None

    def _local(self, x, w, groups):
        return F.conv2d(x, w, None, self.stride, self.padding, self.dilation, groups)

    def conv_nobias(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.mesh is not None:
            return sharded_conv(self._local, x, w, self.mesh, self.groups)
        return self._conv_forward(x, w, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_nobias(x)


class BiasConv2d(BodyConv2d):
    """A biased body convolution, as flax's biased ``nn.Conv``: the
    convolution is rounded to the input's dtype and the bias, cast to that
    dtype, is added after it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_nobias(x) + self.bias.to(x.dtype)[:, None, None]


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

    mesh = None     # sharded output channels, as BodyConv2d's

    def __init__(self, c1: int, c2: int):
        super().__init__(c1, c2, 1, bias=True)
        self.mult_dtype = torch.float32
        self.out_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.mult_dtype).float()
        x = x.to(self.mult_dtype).float()
        if self.mesh is not None:
            y = sharded_conv(lambda a, b, g: F.conv2d(a, b), x, w, self.mesh, 1)
            return y.to(self.out_dtype) + self.bias.to(self.out_dtype)[:, None, None]
        if self.out_dtype == torch.float32:
            return F.conv2d(x, w, self.bias.float())
        return F.conv2d(x, w).to(self.out_dtype) + self.bias.to(self.out_dtype)[:, None, None]


class Conv(nn.Module):
    """Conv2d + BN + act; nets/common.py:97-109.

    In eval mode under ``quant_ctx`` (JAX ``layers.py:470-500``), before any
    other branch: "calib" records the running max of ``|x|`` over the input,
    in the body dtype, into the buffer ``amax`` and runs the unfused float
    path (JAX calibrates on a model built without fused tails,
    ``detect_api.py:206-207``);
    "int8" quantizes the input with ``amax`` and multiplies it by ``wq``
    with int32 sums (``nn/quant.py``), scales back by ``sx * sw`` into the
    input's dtype, then BN and the activation. ``wq`` and ``sw`` come from
    the fp32 weights through ``set_int8_weights``; ``amax``, ``wq``, ``sw``
    and ``wq_mat`` are non-persistent buffers, so no state dict holds them
    (``YoloModel.quant_state`` reads the amax values).

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
        self.register_buffer("amax", torch.zeros(()), persistent=False)
        for name in ("wq", "sw", "wq_mat"):
            self.register_buffer(name, None, persistent=False)

    @torch.no_grad()
    def set_int8_weights(self, w: torch.Tensor) -> None:
        """Derive ``wq``, ``sw`` (and the gemm route's ``wq_mat``) from the
        fp32 conv weight ``w``, on this module's device."""
        self.wq, self.sw = Q.quantize_weight(w.to(self.amax.device, torch.float32))
        self.wq_mat = Q.gemm_weight(self.wq) if self.conv.groups == 1 else None

    def int8_accumulators(self, x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
        """The int32 sums (B, Ho, Wo, N) of the int8 branch, ``sx`` being
        ``quant.activation_scale(self.amax)``."""
        if self.wq is None:
            raise RuntimeError("int8 Conv without int8 weights: YoloModel.set_int8_weights "
                               "derives them from the fp32 weights")
        return Q.int8_accumulators(x, sx, self.wq, self.wq_mat, self.conv.stride[0],
                                   self.conv.padding[0], self.conv.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = quant_mode()
        if mode is not None and not self.training:
            if mode == "int8":
                sx = Q.activation_scale(self.amax)
                y = Q.dequantize(self.int8_accumulators(x, sx), sx, self.sw, x.dtype)
                return self.bn(y, self.act)
            self.amax = torch.maximum(self.amax, x.detach().abs().amax().float())
            return self.bn(self.conv(x), self.act)
        if self.fused_tail and not self.training and x.shape[1] >= FUSED_TAIL_MIN_CIN:
            bn = self.bn
            inv, shift = fold(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
            w = self.conv.weight.to(x.dtype).reshape(self.conv.out_channels, -1)
            return fused_pointwise_conv(x.contiguous(), w, inv, shift)
        # the activation inside BatchNorm: it spans the bn_remat checkpoint
        return self.bn(self.conv(x), self.act)


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

    mesh = None     # sharded output channels (axis 0 of the weight), as BodyConv2d's

    def forward(self, x):
        w = self.weight.to(x.dtype).transpose(0, 1).flip((2, 3))
        if self.mesh is not None:
            y = sharded_conv(lambda a, b, g: F.conv_transpose2d(a, b.transpose(0, 1), None,
                                                               stride=self.s),
                             x, w.transpose(0, 1), self.mesh, 1)
        else:
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

    mesh = None     # a sharded implicit is gathered whole before use

    def __init__(self, c: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + _implicit(self).to(x.dtype)


class ImplicitM(nn.Module):
    """Learned multiplicative prior; nets/common.py:429-439 (JAX
    ``layers.py:907-924``). It scales the fp32 logits of ``LogitConv``, so
    the product stays fp32. Drawn around 1 by ``YoloModel.init_weights``
    (the JAX package's deliberate fix; the reference draws around 0)."""

    mesh = None

    def __init__(self, c: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.ones(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * _implicit(self).to(x.dtype)


def _implicit(m: nn.Module) -> torch.Tensor:
    return m.implicit if m.mesh is None else gather_from_model(m.implicit, m.mesh, 1)


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
