"""int8 post-training quantization of a ``Conv``: scales, integer products, routes.

Counterpart of the int8 branch of JAX ``layers.Conv`` (``layers.py:470-500``),
symmetric PTQ:

- activations per tensor: ``sx = max(amax, 1e-12) / 127`` from the amax that
  a calibration pass recorded, ``xq = clip(round(x / sx), -127, 127)`` with
  ``x`` widened to fp32 and rounding half to even (``torch.round`` and
  ``jnp.round`` agree);
- weights per output channel, from the **fp32** weights:
  ``sw = max(max|W| / 127, 1e-12)`` over (c_in, kh, kw) and
  ``wq = clip(round(W / sw), -127, 127)``;
- the integer convolution with int32 accumulators, then
  ``(acc.float() * (sx * sw)).to(dtype)``.

The integer products are exact in every route, so every route gives the same
int32 accumulators (127^2 * K < 2^31 is checked before a call).

Routes (``route_for`` picks one from shapes alone, before any launch; a shape
that none takes raises, and nothing falls back):

- CPU tensors: ``plain``, the oracle: an fp64 ``F.conv2d`` of the integer
  values (exact while 127^2 * K < 2^53), cast to int32.
- CUDA, ``groups == 1``:
  - ``gemm``: an im2col of the zero-padded NHWC int8 activation, taps
    major and channels minor, zero-padded to K a multiple of 8 and to more
    than 16 rows, times the weight matrix padded to N a multiple of 8, in
    one ``torch._int_mm`` (cuBLAS int8 GEMM, int32 out). A 1x1 stride-1
    conv whose C_in is a multiple of 8 multiplies the activation itself.
    Taken while the im2col holds at most ``IM2COL_BYTES``.
  - ``taps``: one ``torch._int_mm`` per tap of the kh x kw window, each on
    that tap's strided view copied to a (M, C_in padded to 8) matrix,
    summed in int32. Taken when the im2col would be larger; each tap's
    matrix must fit ``IM2COL_BYTES``.
- CUDA, ``groups > 1``: ``f64``, the plain version's fp64 convolution on the
  card.
- ``127^2 * K >= 2^31`` (K = C_in / groups * kh * kw) raises in every route:
  an int32 accumulator could overflow.
"""
from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.capture import count

QMAX = 127
MAX_K = (2 ** 31 - 1) // (QMAX * QMAX)      # 133,144: the longest sum int32 holds exactly
IM2COL_BYTES = 1 << 30                      # the int8 im2col of the gemm route, at most
# calls of each route since the last reset (chip_smoke.py counts a request's;
# counted through utils/capture.count, once per replay of a captured call)
route_calls = collections.Counter()


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def _div_qmax(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as a true division. The divisor is a tensor on ``t``'s
    device: CUDA divides by a Python number as a product with its
    reciprocal, which can differ from the quotient in the last bit."""
    return t / torch.full((), float(QMAX), device=t.device)


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """``sx``: the fp32 per-tensor scale of a recorded ``amax``."""
    return _div_qmax(torch.clamp(amax.float(), min=1e-12))


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 weight (N, C/g, kh, kw) -> (wq int8 of that shape, sw fp32 (N,))."""
    if w.dtype != torch.float32:
        raise TypeError(f"int8 weights are derived from the fp32 weights, got {w.dtype}")
    sw = torch.clamp(_div_qmax(w.abs().amax((1, 2, 3))), min=1e-12)
    wq = torch.clamp(torch.round(w / sw[:, None, None, None]), -QMAX, QMAX).to(torch.int8)
    return wq, sw


def gemm_weight(wq: torch.Tensor) -> torch.Tensor:
    """wq (N, C, kh, kw) -> the gemm route's (N padded to 8, K padded to 8)
    int8 matrix, K ordered taps major and channels minor as the im2col."""
    n, c, kh, kw = wq.shape
    k = c * kh * kw
    out = torch.zeros((_up8(n), _up8(k)), dtype=torch.int8, device=wq.device)
    out[:n, :k] = wq.permute(0, 2, 3, 1).reshape(n, k)
    return out


def _out_size(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def route_for(x_shape, w_shape, stride: int, padding: int, groups: int,
              device_type: str = "cuda") -> str:
    """The route that ``int8_accumulators`` takes for these shapes (see the
    module's docstring); raises ValueError for a shape that none takes."""
    b, c, h, w = x_shape
    n, cg, kh, kw = w_shape
    if c != cg * groups or n % groups:
        raise ValueError(f"int8 conv: x {tuple(x_shape)} and w {tuple(w_shape)} do not fit "
                         f"groups={groups}")
    k = cg * kh * kw
    if k > MAX_K:
        raise ValueError(f"int8 conv: K = {k} products a sum can overflow int32 "
                         f"(127^2 * K >= 2^31 above K = {MAX_K})")
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"int8 conv: no route on {device_type}")
    if groups > 1:
        return "f64"
    m = b * _out_size(h, kh, stride, padding) * _out_size(w, kw, stride, padding)
    rows = max(m, 17)
    if rows * _up8(k) <= IM2COL_BYTES:
        return "gemm"
    if rows * _up8(c) <= IM2COL_BYTES:
        return "taps"
    raise ValueError(f"int8 conv: one tap's matrix ({rows} x {_up8(c)} int8) exceeds "
                     f"IM2COL_BYTES = {IM2COL_BYTES}")


def quantize_input(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``clip(round(x.float() / sx), -127, 127)``, still fp32 (exact integers)."""
    return x.to(torch.float32, copy=True).div_(sx).round_().clamp_(-QMAX, QMAX)


def accumulators_plain(x: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, stride: int,
                       padding: int, groups: int) -> torch.Tensor:
    """The oracle: the int32 accumulators (B, Ho, Wo, N) as an fp64 convolution
    of the integer values, exact because 127^2 * K < 2^53."""
    route_for(x.shape, wq.shape, stride, padding, groups, "cpu")
    acc = F.conv2d(quantize_input(x, sx).double(), wq.double(), None, stride, padding, 1, groups)
    return acc.to(torch.int32).permute(0, 2, 3, 1)


def _int_mm(a: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (N, K)^T with int32 sums; M > 16, K and N multiples of 8."""
    return torch._int_mm(a, b_rows.t())


def _padded_nhwc(x: torch.Tensor, sx: torch.Tensor, padding: int) -> torch.Tensor:
    """The quantized activation as zero-padded NHWC int8 (B, H+2p, W+2p, C)."""
    b, c, h, w = x.shape
    xp = torch.zeros((b, h + 2 * padding, w + 2 * padding, c), dtype=torch.int8,
                     device=x.device)
    xp[:, padding:padding + h, padding:padding + w].copy_(
        quantize_input(x, sx).permute(0, 2, 3, 1))
    return xp


def accumulators_cuda(x: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                      wq_mat: Optional[torch.Tensor], stride: int, padding: int, groups: int,
                      route: Optional[str] = None) -> torch.Tensor:
    """The int32 accumulators (B, Ho, Wo, N) on the card, by ``route_for``'s
    route (``route`` forces one, which must take the shape); ``wq_mat`` is
    ``gemm_weight(wq)`` (``groups == 1``)."""
    if x.device.type != "cuda":
        raise ValueError("accumulators_cuda takes CUDA tensors")
    picked = route_for(x.shape, wq.shape, stride, padding, groups)
    if route is not None and route != picked:
        if not (route == "taps" and picked == "gemm"):
            raise ValueError(f"int8 conv: route {route!r} does not take this shape "
                             f"(route_for picks {picked!r})")
        picked = route
    count(route_calls, key=picked)
    if picked == "f64":
        acc = F.conv2d(quantize_input(x, sx).double(), wq.double(), None, stride, padding, 1,
                       groups)
        return acc.to(torch.int32).permute(0, 2, 3, 1)
    b, c, h, w = x.shape
    n, _, kh, kw = wq.shape
    ho, wo = _out_size(h, kh, stride, padding), _out_size(w, kw, stride, padding)
    m, rows = b * ho * wo, max(b * ho * wo, 17)
    xp = _padded_nhwc(x, sx, padding)

    def tap(dy, dx):
        return xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]

    if picked == "gemm":
        kp = wq_mat.shape[1]
        if kh == kw == 1 and stride == 1 and c == kp and m == rows:
            a = xp.reshape(m, c)                       # the activation is the im2col
        else:
            a = torch.empty((rows, kp), dtype=torch.int8, device=x.device)
            if kp > c * kh * kw:
                a[:, c * kh * kw:].zero_()
            a[m:].zero_()
            cols = a[:m].view(b, ho, wo, kp)
            for dy in range(kh):
                for dx in range(kw):
                    t = dy * kw + dx
                    cols[..., t * c:(t + 1) * c].copy_(tap(dy, dx))
        return _int_mm(a, wq_mat)[:m, :n].view(b, ho, wo, n)
    cp, np_ = _up8(c), _up8(n)
    acc = None
    a = torch.zeros((rows, cp), dtype=torch.int8, device=x.device)
    wt = torch.zeros((np_, cp), dtype=torch.int8, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            a[:m].view(b, ho, wo, cp)[..., :c].copy_(tap(dy, dx))
            wt[:n, :c] = wq[:, :, dy, dx]
            part = _int_mm(a, wt)
            acc = part if acc is None else acc.add_(part)
    return acc[:m, :n].view(b, ho, wo, n)


def int8_accumulators(x: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                      wq_mat: Optional[torch.Tensor], stride: int, padding: int,
                      groups: int) -> torch.Tensor:
    """int32 accumulators (B, Ho, Wo, N) of the quantized ``x`` (NCHW, any float
    dtype) and ``wq``: the plain version for CPU tensors, a card route for
    CUDA tensors."""
    if x.device.type == "cpu":
        route_calls["plain"] += 1
        return accumulators_plain(x, sx, wq, stride, padding, groups)
    return accumulators_cuda(x, sx, wq, wq_mat, stride, padding, groups)


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """int32 (B, Ho, Wo, N) -> ``(acc.float() * (sx * sw)).to(dtype)`` as a
    contiguous NCHW tensor (one kernel: the product in fp32, rounded on the
    store)."""
    b, ho, wo, n = acc.shape
    out = torch.empty((b, n, ho, wo), dtype=dtype, device=acc.device)
    torch.mul(acc, sx * sw, out=out.permute(0, 2, 3, 1))
    return out
