"""The JPEG stager: decode on the host, ``stage_letterbox`` on CUDA tensors.

Wrapper of ``csrc/staging.cu``, which replaces the resize and letterbox of
the JAX package's host library ``native/staging.cpp`` (reached through
``yolo_continuous_tpu/data/native_loader.py::stage_batch_native``): a
bilinear resize and a centred letterbox of fill 128 onto fixed staging
canvases, after a libjpeg decode. Two steps:

- ``decode(datas, device)``: files' contents -> ``Decoded``, the RGB pixels
  of every file in one flat u8 buffer on ``device`` (``imdecode``, then
  ``upload``, which a caller with pixels already decoded calls alone). cv2
  decodes in a pool of threads (it lets go of the interpreter lock) with the
  EXIF orientation ignored, as libjpeg ignores it, which gives libjpeg's
  pixels; bytes that do not start with the JPEG SOI marker fail, as libjpeg
  refuses them. To the card the buffer goes from pinned memory in one copy
  that the host does not wait for.
- ``stage_letterbox(src, geo, size)``: one canvas ``(size, size, 3)`` u8 a
  row of the geometry table ``geo`` (``GEO_COLS`` int64 columns, built by
  ``canvas_row``) in one launch. ``stage_letterbox_plain`` is the same resize
  in torch fp32, operation for operation; the wrapper sends CPU tensors there.

The decode is the same on both devices, and the kernel equals its plain
version bit for bit, so the card stages what the CPU stages, and what JAX's
library stages. (Not nvJPEG: its 4:2:0 chroma upsampling is not libjpeg's.)

The geometry is ``staging.cpp::stage_one``'s, in fp32 (``letterbox_geometry``):
``r = min(S / iw, S / ih)``, ``nw = max(int(iw * r), 1)``, the same for
``nh``, and the offsets ``(S - nw) // 2``, ``(S - nh) // 2``. fp32 is not
Python's fp64: (iw, ih) = (133, 65) at S = 640 gives ``nw = 639``.

A CUDA tensor always goes through the kernel; a build or launch failure
raises. ``stage_letterbox.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import _build

# columns of a geometry row (csrc/staging.cu::kGeoCols)
GEO_COLS = 8      # src byte offset, iw, ih, nw, nh, ox, oy, fill
MAX_CANVASES = 65535          # a launch's grid.y
ALIGN = 256                   # each decoded image starts on this boundary of the buffer
_SOI = b"\xff\xd8"


class Decoded(NamedTuple):
    """Decoded files: ``src`` (flat u8 tensor) holds file i's RGB pixels at
    ``offsets[i]``, ``dims[i] = (width, height)``; ``ok[i]`` is False for a
    file that did not decode (its dims are 0)."""
    src: torch.Tensor
    offsets: np.ndarray
    dims: np.ndarray
    ok: np.ndarray


def letterbox_geometry(iw: int, ih: int, size: int):
    """``(r, nw, nh, ox, oy)`` of an ``iw`` x ``ih`` image on a ``size``
    canvas, computed in fp32 as ``native/staging.cpp::stage_one``."""
    f32 = np.float32
    r = min(f32(size) / f32(iw), f32(size) / f32(ih))
    nw, nh = max(int(f32(iw) * r), 1), max(int(f32(ih) * r), 1)
    return r, nw, nh, (size - nw) // 2, (size - nh) // 2


def canvas_row(decoded: Optional[Decoded], i: int, size: int, fill: int):
    """The geometry row of a canvas that stages file ``i`` of ``decoded``,
    and its meta ``[iw, ih, r, ox, oy]`` (fp32); with ``decoded`` None, a
    canvas of ``fill`` alone (and no meta)."""
    if decoded is None:
        return [0, 0, 0, 0, 0, 0, 0, fill], None
    iw, ih = (int(v) for v in decoded.dims[i])
    r, nw, nh, ox, oy = letterbox_geometry(iw, ih, size)
    meta = np.array([iw, ih, r, ox, oy], np.float32)
    return [int(decoded.offsets[i]), iw, ih, nw, nh, ox, oy, fill], meta


# ---------------------------------------------------------------- decode

def _imdecode(data: Optional[bytes]) -> Optional[np.ndarray]:
    """BGR pixels of one file, or None where libjpeg would refuse it."""
    from ..ops.preprocess import _need_cv2, cv2
    _need_cv2("the JPEG stager")
    if data is None or not data.startswith(_SOI):
        return None
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)


_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _threads() -> ThreadPoolExecutor:
    """The decode threads: as many as JAX's library takes (the cores, at
    most 8), made at first use."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(min(max(os.cpu_count() or 1, 1), 8),
                                       thread_name_prefix="jpeg-decode")
        return _pool


def imdecode(datas: Sequence[Optional[bytes]]) -> List[Optional[np.ndarray]]:
    """Files' contents (None for a file that could not be read) -> each
    file's BGR pixels, or None where libjpeg would refuse it; cv2 in the
    decode threads."""
    return list(_threads().map(_imdecode, datas))


def upload(bgr: Sequence[Optional[np.ndarray]], device="cuda") -> Decoded:
    """BGR pixels (None for a file that did not decode) -> ``Decoded`` on
    ``device``: the decode threads write RGB straight into one host buffer
    (pinned for the card), which goes to the card in one non-blocking copy on
    the current stream."""
    from ..ops.preprocess import cv2
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"decode runs on cuda or cpu, got {device}")
    ok = np.array([im is not None for im in bgr], bool)
    dims = np.array([(im.shape[1], im.shape[0]) if im is not None else (0, 0) for im in bgr],
                    np.int64).reshape(-1, 2)
    offsets, at = [], 0
    for w, h in dims:
        offsets.append(at)
        at += -(-int(w * h * 3) // ALIGN) * ALIGN
    offsets = np.asarray(offsets, np.int64)
    host = torch.empty(max(at, 1), dtype=torch.uint8, pin_memory=device.type == "cuda")
    flat = host.numpy()

    def to_rgb(i):
        w, h = dims[i]
        cv2.cvtColor(bgr[i], cv2.COLOR_BGR2RGB,
                     dst=flat[offsets[i]:offsets[i] + w * h * 3].reshape(h, w, 3))

    list(_threads().map(to_rgb, np.nonzero(ok)[0]))
    src = host if device.type == "cpu" else host.to(device, non_blocking=True)
    return Decoded(src, offsets, dims, ok)


def decode(datas: Sequence[Optional[bytes]], device="cuda") -> Decoded:
    """Files' contents (None for a file that could not be read) ->
    ``Decoded`` on ``device`` (``imdecode``, then ``upload``)."""
    return upload(imdecode(datas), device)


def read_files(paths: Sequence[str]) -> List[Optional[bytes]]:
    """Each file's bytes, or None where it cannot be opened (``stage_one``
    fails such a file, as it fails one it cannot decode)."""
    out = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                out.append(f.read())
        except OSError:
            out.append(None)
    return out


# ---------------------------------------------------------------- stage_letterbox

def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    """``std::lround`` of non-negative fp32 values: ``v - trunc(v)`` is
    exact, so this never rounds twice (``torch.round`` rounds half to even)."""
    t = torch.trunc(v)
    return t + (v - t >= 0.5).to(v.dtype)


def _resize_plain(img: torch.Tensor, nw: int, nh: int) -> torch.Tensor:
    """``staging.cpp::resize_bilinear`` of ``img`` (ih, iw, 3) u8 to (nh, nw,
    3), in fp32 with its operation order, on ``img``'s device."""
    ih, iw = img.shape[:2]
    f32, dev = torch.float32, img.device
    sx = torch.tensor(np.float32(iw) / np.float32(nw), dtype=f32, device=dev)
    sy = torch.tensor(np.float32(ih) / np.float32(nh), dtype=f32, device=dev)

    def axis(n, scale, limit):
        f = (torch.arange(n, dtype=f32, device=dev) + 0.5) * scale - 0.5
        i0 = torch.floor(f)
        w = f - i0
        i0 = i0.long()
        return i0.clamp(0, limit - 1), (i0 + 1).clamp(0, limit - 1), w

    y0, y1, wy = axis(nh, sy, ih)
    x0, x1, wx = axis(nw, sx, iw)
    src = img.to(f32)
    v00, v01 = src[y0][:, x0], src[y0][:, x1]
    v10, v11 = src[y1][:, x0], src[y1][:, x1]
    wy, wx = wy[:, None, None], wx[None, :, None]
    ay, ax = 1 - wy, 1 - wx
    v = v00 * ay * ax + v01 * ay * wx + v10 * wy * ax + v11 * wy * wx
    return _round_half_away(v).to(torch.uint8)


def stage_letterbox_plain(src: torch.Tensor, geo, size: int,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``stage_letterbox``: the canvases (n, size, size,
    3) u8 of the geometry rows ``geo`` (n, GEO_COLS), from the decoded RGB
    pixels ``src`` (flat u8), on ``src``'s device."""
    geo = torch.as_tensor(geo).cpu().tolist()
    if out is None:
        out = torch.empty((len(geo), size, size, 3), dtype=torch.uint8, device=src.device)
    for c, (off, iw, ih, nw, nh, ox, oy, fill) in enumerate(geo):
        out[c] = fill
        if nw > 0:
            img = src[off:off + iw * ih * 3].reshape(ih, iw, 3)
            out[c, oy:oy + nh, ox:ox + nw] = _resize_plain(img, nw, nh)
    return out


def _check(src: torch.Tensor, geo: torch.Tensor, size: int, out: torch.Tensor):
    if src.device.type != "cuda":
        raise ValueError(f"stage_letterbox takes CUDA tensors, got {src.device}")
    if geo.device != src.device or out.device != src.device:
        raise ValueError("stage_letterbox: src, geo and out must share one device")
    if src.dtype != torch.uint8 or out.dtype != torch.uint8 or geo.dtype != torch.int64:
        raise ValueError(f"stage_letterbox takes u8 src and out and an int64 geometry, got "
                         f"{src.dtype}, {out.dtype}, {geo.dtype}")
    if geo.dim() != 2 or geo.shape[1] != GEO_COLS:
        raise ValueError(f"stage_letterbox: geo must be (n, {GEO_COLS}), got {tuple(geo.shape)}")
    if tuple(out.shape) != (geo.shape[0], size, size, 3):
        raise ValueError(f"stage_letterbox: out must be ({geo.shape[0]}, {size}, {size}, 3), "
                         f"got {tuple(out.shape)}")
    if not (src.is_contiguous() and geo.is_contiguous() and out.is_contiguous()):
        raise ValueError("stage_letterbox takes contiguous tensors")
    if geo.shape[0] > MAX_CANVASES or size * size * 3 >= 2 ** 31:
        raise ValueError(f"stage_letterbox takes at most {MAX_CANVASES} canvases of under "
                         f"2^31 bytes, got {geo.shape[0]} of size {size}")


def stage_letterbox(src: torch.Tensor, geo: torch.Tensor, size: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The canvases (n, size, size, 3) u8 of the geometry rows ``geo`` (n,
    GEO_COLS) int64, from the decoded RGB pixels ``src`` (flat u8), written
    into ``out`` if given. CPU tensors take the plain version; CUDA tensors
    the kernel, one launch a call on the current stream."""
    if src.device.type == "cpu":
        return stage_letterbox_plain(src, geo, size, out)
    if out is None:
        out = torch.empty((geo.shape[0], size, size, 3), dtype=torch.uint8, device=src.device)
    _check(src, geo, size, out)
    if geo.shape[0] == 0:
        return out
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = _build.library("staging").stage_letterbox(src.data_ptr(), geo.data_ptr(),
                                                    out.data_ptr(), geo.shape[0], size, stream)
    _build.check(err, "stage_letterbox")
    stage_letterbox.launches += 1
    return out


stage_letterbox.launches = 0
