"""The augmentation's warps on CUDA tensors: ``warp_tiles``.

Wrapper of ``csrc/augment.cu``, which replaces no TPU kernel: JAX's
``augment_batch`` warps each staging canvas by
``jax.image.scale_and_translate``, two dense weight matrices a warp applied
by matrix products, and the port's plain version
(``ops/augment.py``: ``warp_canvas``, then the LR flip or the mosaic's
quadrant select, then ``random_hsv``) does the same in fp32. The kernel
computes one path of the train augmentation in one launch: each output pixel
from the window of source pixels its triangle filter covers, the quadrant's
tile of a mosaic, the flips as index mirrors, and the HSV gain jitter, in
fp32 (no TF32, no tensor cores). It sums in another order than the matrix
products, so it is not bit-equal to the plain version: its outputs differ in
their last bits, and where a red pixel's green and blue tie, the hue, which
the gain multiplies modulo 180, can jump. ``ops/augment.py::_augment`` sends
CUDA tensors here and CPU tensors to the plain version.

A path's arguments, for n samples of q warps each (q = 1: the single path;
q = 4: the mosaic):

- ``pool``: u8 staging canvases ``(P, H, W, 3)``, and ``tile_idx`` (``(B,
  T)`` int64) the canvases of each batch row: row b's tile t is
  ``pool[tile_idx[b, t]]`` (assembled ``(B, T, H, W, 3)`` tiles are the pool
  ``tiles.flatten(0, 1)`` under the index ``arange(B * T).view(B, T)``). The
  single path warps tile 0, the mosaic tiles 0..3. An index outside the pool
  reads NaN (the kernel reads no byte outside it; the host cannot see the
  values without waiting for the card).
- ``warps``: fp32 ``(n, q, 4)`` [ky, kx, ty, tx] of each warp:
  ``out(y, x) = canvas((y - ty) / ky, (x - tx) / kx)``.
- ``flip``: bool ``(n, q)``; q = 1 mirrors the output (the LR flip after the
  paste), q = 4 mirrors each tile before its resize.
- ``hsv``: fp32 ``(n, 3)`` HSV draws in U(-1, 1), ``gains`` the (hue, sat,
  val) magnitudes: gains ``u * g + 1``.
- ``rows``: int64 ``(n,)`` batch rows of the samples, and ``out`` the fp32
  ``(B, size, size, 3)`` images they are written into (a row outside the
  batch is written nowhere).
- ``cut``: fp32 ``(n, 2)`` [cutx, cuty] of a mosaic; none for the single path.

``warp_tiles.launches`` counts the kernel's launches (``utils/capture.count``:
a captured launch once a replay).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.capture import count
from . import _build

MAX_SAMPLES = 65535           # a launch's grid.z


def _check(pool, tile_idx, warps, flip, hsv, rows, out, cut) -> None:
    """Refuse what the kernel does not take: shapes, dtypes, layouts and the
    sizes its indices cover first, then the device."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"warp_tiles: {what}")

    need(pool.dtype == torch.uint8, f"pool must be u8, got {pool.dtype}")
    need(pool.dim() == 4 and pool.shape[-1] == 3,
         f"pool must be (P, H, W, 3), got {tuple(pool.shape)}")
    need(tile_idx.dtype == torch.int64 and tile_idx.dim() == 2,
         f"tile_idx must be (B, T) int64, got {tile_idx.dtype} {tuple(tile_idx.shape)}")
    B, T = tile_idx.shape
    need(warps.dtype == torch.float32 and warps.dim() == 3 and warps.shape[1:] in ((1, 4), (4, 4)),
         f"warps must be (n, 1 or 4, 4) fp32, got {warps.dtype} {tuple(warps.shape)}")
    n, q = warps.shape[:2]
    need(T >= q, f"a path of {q} warps a sample needs as many tiles, got {T}")
    need(flip.dtype == torch.bool and tuple(flip.shape) == (n, q),
         f"flip must be ({n}, {q}) bool, got {flip.dtype} {tuple(flip.shape)}")
    need(hsv.dtype == torch.float32 and tuple(hsv.shape) == (n, 3),
         f"hsv must be ({n}, 3) fp32, got {hsv.dtype} {tuple(hsv.shape)}")
    need(rows.dtype == torch.int64 and tuple(rows.shape) == (n,),
         f"rows must be ({n},) int64, got {rows.dtype} {tuple(rows.shape)}")
    size = out.shape[1] if out.dim() == 4 else -1
    need(out.dtype == torch.float32 and tuple(out.shape) == (B, size, size, 3),
         f"out must be ({B}, size, size, 3) fp32, got {out.dtype} {tuple(out.shape)}")
    need((cut is None) == (q == 1), "a mosaic (4 warps) takes its cut lines, a single path none")
    need(cut is None or (cut.dtype == torch.float32 and tuple(cut.shape) == (n, 2)),
         f"cut must be ({n}, 2) fp32, got {None if cut is None else (cut.dtype, tuple(cut.shape))}")
    need(n <= MAX_SAMPLES and size * size * 3 < 2 ** 31,
         f"at most {MAX_SAMPLES} samples of under 2^31 values, got {n} of size {size}")
    parts = [t for t in (pool, tile_idx, warps, flip, hsv, rows, out, cut) if t is not None]
    need(all(t.is_contiguous() for t in parts), "takes contiguous tensors")
    if pool.device.type != "cuda":
        raise ValueError(f"warp_tiles takes CUDA tensors, got {pool.device}")
    need(all(t.device == pool.device for t in parts), "every tensor must be on the pool's device")


def warp_tiles(pool: torch.Tensor, tile_idx: torch.Tensor, warps: torch.Tensor,
               flip: torch.Tensor, hsv: torch.Tensor, gains: Tuple[float, float, float],
               rows: torch.Tensor, out: torch.Tensor,
               cut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One path of the train augmentation (the module's docstring): the n
    samples' warped, flipped, HSV-jittered images, fp32 on 0..255, written
    into ``out`` at ``rows``; returns ``out``. One launch on the current
    stream."""
    _check(pool, tile_idx, warps, flip, hsv, rows, out, cut)
    n, q = warps.shape[:2]
    B, T = tile_idx.shape
    H, W = pool.shape[1:3]
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = _build.library("augment").warp_tiles(
        pool.data_ptr(), pool.shape[0], tile_idx.data_ptr(), T, rows.data_ptr(),
        warps.data_ptr(), flip.data_ptr(), None if cut is None else cut.data_ptr(),
        hsv.data_ptr(), *(float(g) for g in gains), out.data_ptr(), n, q, B, H, W,
        out.shape[1], stream)
    _build.check(err, "warp_tiles")
    count(warp_tiles, int(n > 0))
    return out


warp_tiles.launches = 0
