"""Eval BatchNorm's fold, apply and activation in one launch: ``bn_act``.

Wrapper of ``csrc/bn_act.cu``, which replaces no TPU kernel: XLA fuses the
JAX package's eval BatchNorm and activation (``nn/layers.py``, ``_BNCore``)
into its neighbours. ``bn_act_plain`` is the port's expression for it, the
CPU path and the oracle: fold the running statistics in fp32, ``inv = w *
rsqrt(var + eps)`` and ``shift = b - mean * inv``, cast both to x's dtype,
then ``x * inv + shift`` in x's dtype (rounded after the product and after
the sum) and the activation. On the card that is about ten launches and
three passes over the map; the kernel is one launch and one pass, bound by
the map's bytes, equal to the plain version bit for bit.

- x ``(N, C, H, W)`` bf16, fp16 or fp32, NCHW-contiguous; the output has
  x's dtype and layout.
- weight, bias, running mean and running variance fp32 ``(C,)``.
- ``act``: an activation spec of ``nn.layers.apply_act`` (``act_code``).

``bn_act.launches`` counts the kernel's launches (``utils/capture.count``: a
captured launch once a replay).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.capture import count
from . import _build

# the kernel's activation codes (csrc/bn_act.cu's Act)
IDENTITY, SILU, RELU, LEAKY, HARDSWISH = range(5)
# x's dtypes, by the kernel's code
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_PLANE = 65535 * 1024 * 4  # NCHW: at most 65535 chunks of 1024 vectors of 4 fp32 a plane


def act_code(act) -> Tuple[int, float]:
    """The kernel's (code, slope) of an activation spec of ``nn.layers.apply_act``
    (JAX ``apply_act``, ``layers.py:115-128``)."""
    if act is True or act == "silu":
        return SILU, 0.0
    if isinstance(act, tuple) and act[0] == "leaky_relu":
        return LEAKY, float(act[1])
    if act == "leaky_relu":
        return LEAKY, 0.01
    if act == "relu":
        return RELU, 0.0
    if act == "hardswish":
        return HARDSWISH, 0.0
    if act in (False, None, "identity"):
        return IDENTITY, 0.0
    raise ValueError(f"unknown activation spec {act!r}")


def activate(x: torch.Tensor, code: int, slope: float = 0.0) -> torch.Tensor:
    """The activation ``code`` as torch ops."""
    if code == SILU:
        return F.silu(x)
    if code == LEAKY:
        return F.leaky_relu(x, negative_slope=slope)
    if code == RELU:
        return F.relu(x)
    if code == HARDSWISH:
        return F.hardswish(x)
    return x


def fold(weight, bias, mean, var, eps: float):
    """``inv = weight * rsqrt(var + eps)`` and ``shift = bias - mean * inv``, fp32."""
    inv = weight * torch.rsqrt(var + eps)
    return inv, bias - mean * inv


def bn_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, eps: float, act) -> torch.Tensor:
    """Eval BatchNorm and activation as torch ops (the module's docstring)."""
    inv, shift = fold(weight, bias, mean, var, eps)
    return activate(x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None],
                    *act_code(act))


def _check(x, weight, bias, mean, var) -> None:
    """Refuse what the kernel does not take: dtype, shape and layout first,
    then the device."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"bn_act: {what}")

    need(x.dtype in DTYPES, f"x must be bf16, fp16 or fp32, got {x.dtype}")
    need(x.dim() == 4, f"x must be (N, C, H, W), got {tuple(x.shape)}")
    n, c, h, w = x.shape
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", mean),
                    ("running_var", var)):
        need(t.dtype == torch.float32 and tuple(t.shape) == (c,) and t.is_contiguous(),
             f"{name} must be contiguous fp32 ({c},), got {t.dtype} {tuple(t.shape)}")
    need(x.is_contiguous(), "x must be NCHW-contiguous")
    need(n * c < 2 ** 31 and h * w <= MAX_PLANE,
         f"at most 2^31 - 1 planes of {MAX_PLANE} values, got {n * c} of {h * w}")
    if x.device.type != "cuda":
        raise ValueError(f"bn_act takes CUDA tensors, got {x.device}")
    need(all(t.device == x.device for t in (weight, bias, mean, var)),
         "every tensor must be on x's device")


def bn_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
           var: torch.Tensor, eps: float, act) -> torch.Tensor:
    """``bn_act_plain`` in one launch on the current stream (the module's
    docstring); raises on what the kernel does not take."""
    _check(x, weight, bias, mean, var)
    code, slope = act_code(act)
    y = torch.empty_like(x)
    n, c, h, w = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library("bn_act").bn_act(
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        var.data_ptr(), float(eps), code, slope, DTYPES[x.dtype], n, c, h * w, stream)
    _build.check(err, "bn_act")
    count(bn_act, int(x.numel() > 0))
    return y


bn_act.launches = 0
