"""Grid/anchor decoding of raw head maps.

Counterpart of ``yolo_continuous_tpu/ops/decode.py`` (``decode_level``,
``decode_outputs``). Raw maps are ``(bs, h, w, na, no)``; each level
flattens to ``(bs, h*w*na, no)`` rows in (h, w, na) order, the JAX order
(``decode.py:51``) that top-k then ranks.

``decode_level`` is the plain PyTorch version of kernel K3
(``kernels/decode.py``, ``csrc/decode.cu``), ``decode_level_bin`` that of
kernel K4 (``kernels/bin_decode.py``, ``csrc/bin_decode.cu``).
``decode_outputs`` and ``decode_outputs_bin`` send CPU tensors to them and
CUDA tensors to the kernels, after casting the maps to fp32 as JAX does
(``decode.py:37, 83``): a ``head_dtype=bfloat16`` head's maps become fp32
maps with the same strides, which the kernels' TMA form reads.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .sigmoid_bin import SigmoidBinCfg, sigmoid_bin_decode


def _check_device(device: torch.device) -> None:
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"decode runs on CUDA (kernel) or CPU (plain) tensors, got {device}")


def decode_level(pred: torch.Tensor, anchors_px: torch.Tensor, stride: float,
                 normalized: bool = True) -> torch.Tensor:
    """Decode one level (plain version).

    normalized=True reproduces ``detect.py:76-85`` (fractions of the input
    image); normalized=False reproduces ``nets/idetect.py:40-43`` (pixels).
    """
    bs, h, w, na, no = pred.shape
    y = 1.0 / (1.0 + torch.exp(-pred.float()))  # sigmoid over everything (detect.py:48)
    dev = pred.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    anchors_f = anchors_px.to(dev, torch.float32) / stride  # feature units (detect.py:42-43)
    bx = y[..., 0] * 2.0 - 0.5 + gx[None, :, :, None]
    by = y[..., 1] * 2.0 - 0.5 + gy[None, :, :, None]
    bw = (y[..., 2] * 2.0) ** 2 * anchors_f[:, 0]
    bh = (y[..., 3] * 2.0) ** 2 * anchors_f[:, 1]
    box = torch.stack([bx, by, bw, bh], dim=-1)
    if normalized:
        box = box / torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
    else:
        box = box * stride
    out = torch.cat([box, y[..., 4:]], dim=-1)
    return out.reshape(bs, h * w * na, no)


def decode_outputs(preds: Sequence[torch.Tensor], anchors: Sequence, strides: Sequence[float],
                   normalized: bool = True) -> torch.Tensor:
    """All levels -> ``(bs, total, no)``; cf. detect.py:229-230 torch.cat.

    CUDA tensors go through kernel K3; CPU tensors through ``decode_level``."""
    preds = [p.float() for p in preds]
    device = preds[0].device
    _check_device(device)
    if device.type == "cuda":
        from ..kernels.decode import decode_outputs_cuda
        return decode_outputs_cuda(preds, anchors, strides, normalized)
    return torch.cat([decode_level(p, torch.tensor(a, dtype=torch.float32), float(s), normalized)
                      for p, a, s in zip(preds, anchors, strides)], dim=1)


def decode_level_bin(pred: torch.Tensor, anchors_px: torch.Tensor, stride: float,
                     bin_count: int = 21, normalized: bool = True) -> torch.Tensor:
    """IBin in-head decode (nets/ibin.py:46-75), plain version ->
    ``(bs, h*w*na, 5+nc)``.

    w/h come from the SigmoidBin argmax + residual over the sigmoided bins,
    scaled by the pixel anchors; xy/obj/cls as usual."""
    cfgb = SigmoidBinCfg(bin_count=bin_count, vmin=0.0, vmax=4.0)
    n = cfgb.length
    bs, h, w, na, _ = pred.shape
    y = 1.0 / (1.0 + torch.exp(-pred.float()))
    dev = pred.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    anchors = anchors_px.to(dev, torch.float32)
    bx = (y[..., 0] * 2.0 - 0.5 + gx[None, :, :, None]) * stride
    by = (y[..., 1] * 2.0 - 0.5 + gy[None, :, :, None]) * stride
    bw = sigmoid_bin_decode(y[..., 2:2 + n], cfgb) * anchors[:, 0]
    bh = sigmoid_bin_decode(y[..., 2 + n:2 + 2 * n], cfgb) * anchors[:, 1]
    box = torch.stack([bx, by, bw, bh], dim=-1)
    if normalized:
        s = float(stride)
        box = box / torch.tensor([w * s, h * s, w * s, h * s], dtype=torch.float32, device=dev)
    out = torch.cat([box, y[..., 2 + 2 * n:]], dim=-1)
    return out.reshape(bs, h * w * na, out.shape[-1])


def decode_outputs_bin(preds: Sequence[torch.Tensor], anchors: Sequence,
                       strides: Sequence[float], bin_count: int = 21,
                       normalized: bool = True) -> torch.Tensor:
    """All IBin levels -> ``(bs, total, 5+nc)``.

    CUDA tensors go through kernel K4; CPU tensors through ``decode_level_bin``."""
    preds = [p.float() for p in preds]
    device = preds[0].device
    _check_device(device)
    if device.type == "cuda":
        from ..kernels.bin_decode import decode_outputs_bin_cuda
        return decode_outputs_bin_cuda(preds, anchors, strides, bin_count, normalized)
    return torch.cat([decode_level_bin(p, torch.tensor(a, dtype=torch.float32), float(s),
                                       bin_count, normalized)
                      for p, a, s in zip(preds, anchors, strides)], dim=1)
