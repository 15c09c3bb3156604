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
needed. ``form_for`` says which of the kernel's three forms a call takes;
it reads only type, shape and alignment, so the CPU tests can ask it too.
"""
from __future__ import annotations

import torch

from ..utils.capture import count
from . import _build

# form -> C entry point of csrc/fused_conv.cu
FORMS = {"wgmma": "fused_conv_bf16_wgmma", "mma_sync": "fused_conv_bf16", "fma": "fused_conv_f32"}


def form_for(x: torch.Tensor, w: torch.Tensor) -> str:
    """The form of K5 that ``fused_pointwise_conv_cuda(x, w, ...)`` launches:
    "wgmma" (TMA + wgmma) for bf16 whose C and H*W are multiples of 8 and
    whose x and w are 16-byte aligned, which a TMA tensor map can describe;
    "mma_sync" for other bf16; "fma" for fp32."""
    if x.dtype == torch.float32:
        return "fma"
    c, hw = x.shape[1], x.shape[2] * x.shape[3]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return "wgmma" if c % 8 == 0 and hw % 8 == 0 and aligned else "mma_sync"


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
    """K5 on CUDA tensors, in the form ``form_for`` picks; raises on anything
    it does not take."""
    return launch_form(x, w, scale, bias, form_for(x, w))


def launch_form(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                form: str) -> torch.Tensor:
    """K5 in the given form (``chip_smoke.py`` times the forms side by side);
    counts its launch on ``fused_pointwise_conv_cuda.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv kernel takes CUDA tensors, got {x.device}")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("fused_conv: x, w, scale and bias must share one device")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
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
    if (form == "fma") != (x.dtype == torch.float32):
        raise ValueError(f"fused_conv: form {form!r} does not take {x.dtype}")
    b, c, h, wd = x.shape
    out = torch.empty((b, n, h, wd), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = FORMS[form]
    err = getattr(_build.library("fused_conv"), fn)(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, c, n, h * wd, stream)
    _build.check(err, fn)
    count(fused_pointwise_conv_cuda, int(out.numel() > 0))
    return out


fused_pointwise_conv_cuda.launches = 0


def reciprocal_mismatches(device, lo: int = 0x3F800000, hi: int = 0x7E800000) -> int:
    """Floats d with bit patterns in [lo, hi) (by default every float in
    [1, 2^126), the range the wgmma form's epilogue takes its branch-free
    reciprocal on) where that reciprocal differs from ``__fdiv_rn(1, d)``;
    0 is the proof that the epilogue rounds as ``bn_silu`` does."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    err = _build.library("fused_conv").fused_conv_check_rcp(
        lo, hi, count.data_ptr(), torch.cuda.current_stream(count.device).cuda_stream)
    _build.check(err, "fused_conv_check_rcp")
    return int(count.item())


def fused_pointwise_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """CUDA tensors go through K5, CPU tensors through the plain version."""
    if x.device.type == "cuda":
        return fused_pointwise_conv_cuda(x, w, scale, bias)
    if x.device.type != "cpu":
        raise ValueError(f"fused_conv runs on CUDA (kernel) or CPU (plain) tensors, got {x.device}")
    return fused_pointwise_conv_plain(x, w, scale, bias)
