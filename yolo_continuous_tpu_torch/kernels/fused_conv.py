"""K5: fused 1x1 conv + folded BN + SiLU, on NCHW activations.

Wrapper of ``csrc/fused_conv.cu``, which replaces the TPU kernel
``yolo_continuous_tpu/kernels/fused_conv_pallas.py::fused_pointwise_conv``.
``fused_pointwise_conv_plain`` is its plain PyTorch version (the
counterpart of ``xla_pointwise_conv``); ``fused_pointwise_conv`` sends CPU
tensors there and CUDA tensors to the kernel.

It computes ``SiLU((W @ x) * scale + bias)`` per image with an fp32
accumulator and an fp32 epilogue, rounded once to x's dtype:

- x ``(B, C, H, W)`` contiguous, bf16 (tensor cores) or fp32 (FMA, no TF32);
- w ``(N, C)`` in x's dtype (the conv weight without its 1x1 axes);
- scale, bias ``(N,)`` fp32 (the folded BatchNorm);
- returns ``(B, N, H, W)`` in x's dtype.

The activations stay NCHW: each image is a product with output channels as
rows and pixels as columns, so no permute to channels-last and back is
needed.
"""
from __future__ import annotations

import torch

from . import _build

_KERNELS = {torch.bfloat16: "fused_conv_bf16", torch.float32: "fused_conv_f32"}


def fused_pointwise_conv_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """The same function as plain torch ops (fp32 products and sums)."""
    b, c, h, wd = x.shape
    acc = torch.matmul(w.float(), x.float().reshape(b, c, h * wd))     # (B, N, HW)
    y = acc * scale.float()[:, None] + bias.float()[:, None]
    y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(b, w.shape[0], h, wd)


def fused_pointwise_conv_cuda(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """K5 on CUDA tensors; raises on anything it does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv kernel takes CUDA tensors, got {x.device}")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("fused_conv: x, w, scale and bias must share one device")
    if x.dtype not in _KERNELS or w.dtype != x.dtype:
        raise ValueError(f"fused_conv takes bf16 or fp32 x with w of the same type, got "
                         f"{x.dtype} and {w.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("fused_conv takes fp32 scale and bias")
    if x.dim() != 4 or w.dim() != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"fused_conv: x must be (B, C, H, W) and w (N, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n = w.shape[0]
    if tuple(scale.shape) != (n,) or tuple(bias.shape) != (n,):
        raise ValueError(f"fused_conv: scale and bias must be ({n},)")
    if not all(t.is_contiguous() for t in (x, w, scale, bias)):
        raise ValueError("fused_conv takes contiguous tensors")
    b, c, h, wd = x.shape
    out = torch.empty((b, n, h, wd), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _KERNELS[x.dtype]
    err = getattr(_build.library("fused_conv"), fn)(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, c, n, h * wd, stream)
    _build.check(err, fn)
    fused_pointwise_conv_cuda.launches += int(out.numel() > 0)
    return out


fused_pointwise_conv_cuda.launches = 0


def fused_pointwise_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """CUDA tensors go through K5, CPU tensors through the plain version."""
    if x.device.type == "cuda":
        return fused_pointwise_conv_cuda(x, w, scale, bias)
    if x.device.type != "cpu":
        raise ValueError(f"fused_conv runs on CUDA (kernel) or CPU (plain) tensors, got {x.device}")
    return fused_pointwise_conv_plain(x, w, scale, bias)
