"""K3: fused grid/anchor decode of the head levels, on CUDA tensors.

Wrapper of ``csrc/decode.cu``, which replaces the TPU kernel
``yolo_continuous_tpu/kernels/decode_pallas.py::decode_level_pallas``. Its
plain PyTorch version is ``ops/decode.py::decode_level``; ``ops/decode.py::
decode_outputs`` sends CPU tensors there and CUDA tensors here.

The kernel reads each level as the head gives it: the ``(bs, h, w, na, no)``
fp32 view of the NCHW conv output, with no ``.contiguous()`` copy. All
levels are written into one ``(bs, rows, no)`` buffer at their row offsets,
so no concatenation follows. It has two forms, and ``form_for`` says which
a call takes before the launch, from shapes, strides and data pointers only
(so the CPU tests can ask it too):

- "tma": one launch for all levels of a request, each level's map read by
  TMA as 4-D ``(h*w, no, na, bs)``. It takes maps that are exactly the
  head's permuted view of a contiguous NCHW tensor, with ``h*w % 4 == 0``
  and a 16-byte aligned base, for at most 4 levels;
- "strided": one launch per level, through any strides (channels-last maps,
  other shapes).

Both give the same bits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from ..utils.capture import count
from . import _build

# copies of csrc/decode_tma.cuh's kMaxLevels, kP and kSmemPerBlock
MAX_TMA_LEVELS = 4
TILE_PIXELS = 32                    # pixels per tile of the TMA form
TMA_SMEM_BYTES = 227 * 1024         # shared memory a block may have
FORMS = ("tma", "strided")


class Level(NamedTuple):
    """One row of the TMA form's level table."""
    ptr: int                        # base of the level's map
    h: int
    w: int
    na: int
    row0: int                       # its first output row
    stride: float
    anchors: tuple                  # na (w, h) pairs, flat, in the unit the kernel takes


def level_table(preds: Sequence[torch.Tensor], anchors: Sequence, strides: Sequence[float],
                feature_units: bool = True) -> list:
    """Levels in the order of ``preds`` (Detect: P5 first; the I-heads: P3
    first), with their row offsets in the output. Anchors in feature units
    (pixels / stride, rounded in fp32 as the plain version rounds them) for
    K3, in pixels for K4."""
    table, row0 = [], 0
    for p, a, s in zip(preds, anchors, strides):
        _, h, w, na, _ = p.shape
        if feature_units:   # an fp32 division, as the plain version's
            af = (torch.tensor(a, dtype=torch.float32) / float(s)).flatten().tolist()
        else:
            af = [float(v) for pair in a for v in pair]
        table.append(Level(p.data_ptr(), h, w, na, row0, float(s), tuple(af)))
        row0 += h * w * na
    return table


def _is_head_view(p: torch.Tensor) -> bool:
    """``p`` is ``(bs, h, w, na, no)`` with exactly the strides of
    ``head_view`` of a contiguous NCHW tensor (strides of size-1 dims do not
    address anything and are not compared)."""
    if p.dim() != 5:
        return False
    bs, h, w, na, no = p.shape
    want = (na * no * h * w, w, 1, no * h * w, h * w)
    return all(n == 1 or s == ws for n, s, ws in zip(p.shape, p.stride(), want))


def tma_smem_bytes(na: int, no: int, no_out: int) -> int:
    """Shared memory that the TMA form's block needs at its least 2 stages,
    term for term ``smem_bytes`` of csrc/decode_tma.cuh: 128 bytes to align
    the ring, 2 input stages of ``[na][no][TILE_PIXELS]`` floats (each
    rounded up to 128 bytes), 2 output runs of ``TILE_PIXELS * na * no_out``
    floats plus 4 of alignment slack (each rounded up to 4 floats), and an
    8-byte mbarrier a stage. ``na`` is the most anchors of any level."""
    stage_bytes = -(-TILE_PIXELS * no * na * 4 // 128) * 128
    out_floats = -(-(TILE_PIXELS * na * no_out + 4) // 4) * 4
    return 128 + 2 * stage_bytes + 2 * out_floats * 4 + 8 * 2


def form_for(preds: Sequence[torch.Tensor], no_out: int = 0) -> str:
    """The form that ``decode_outputs_cuda(preds, ...)`` (K3) or
    ``decode_outputs_bin_cuda`` (K4, with its ``no_out`` output columns)
    launches: "tma" when there are at most 4 levels and every map is the
    head's view of a contiguous NCHW tensor with ``h*w % 4 == 0``, a 16-byte
    aligned base and at most 256 columns (a TMA box's limit), and the block
    fits in shared memory (``tma_smem_bytes``); else "strided"."""
    if not 1 <= len(preds) <= MAX_TMA_LEVELS:
        return "strided"
    for p in preds:
        if not _is_head_view(p) or p.element_size() != 4:
            return "strided"
        _, h, w, _, no = p.shape
        if (h * w) % 4 or p.data_ptr() % 16 or no > 256:
            return "strided"
    na, no = max(p.shape[3] for p in preds), preds[0].shape[-1]
    return "tma" if tma_smem_bytes(na, no, no_out or no) <= TMA_SMEM_BYTES else "strided"


def pack_levels(table: Sequence[Level]):
    """The level table as the C entry points take it (csrc/decode_tma.cuh):
    per level 5 ints (pointer, h, w, na, row0) and 17 floats (stride, 8
    anchor pairs)."""
    ints = [v for lv in table for v in (lv.ptr, lv.h, lv.w, lv.na, lv.row0)]
    floats = []
    for lv in table:
        floats += [lv.stride, *lv.anchors] + [0.0] * (16 - len(lv.anchors))
    return (ctypes.c_longlong * len(ints))(*ints), (ctypes.c_float * len(floats))(*floats)


def check_head_maps(preds: Sequence[torch.Tensor], anchors: Sequence, strides: Sequence[float],
                    what: str) -> None:
    """Raise unless ``preds`` are fp32 ``(bs, h, w, na, no)`` maps on one CUDA
    device, with one set of 1..8 anchors and one stride per level."""
    if not preds or len(preds) != len(anchors) or len(preds) != len(strides):
        raise ValueError(f"{what} needs one anchor set and one stride per level")
    p0 = preds[0]
    bs, no = p0.shape[0], p0.shape[-1]
    for p, a in zip(preds, anchors):
        if p.device.type != "cuda" or p.device != p0.device:
            raise ValueError(f"{what} kernel takes tensors on one CUDA device, got {p.device}")
        if p.dtype != torch.float32:
            raise ValueError(f"{what} kernel takes float32 head maps, got {p.dtype}")
        if p.dim() != 5 or p.shape[0] != bs or p.shape[-1] != no or p.shape[3] != len(a):
            raise ValueError(f"head map {tuple(p.shape)} is not (bs, h, w, na={len(a)}, no={no})")
        if not 1 <= len(a) <= 8:
            raise ValueError(f"{what} kernel takes 1..8 anchors")


def decode_outputs_cuda(preds: Sequence[torch.Tensor], anchors: Sequence, strides: Sequence[float],
                        normalized: bool = True) -> torch.Tensor:
    """Raw head maps ``[(bs, h, w, na, no)]`` on one CUDA device ->
    ``(bs, sum(h*w*na), no)`` fp32 rows in (level, h, w, na) order, in the
    form ``form_for`` picks.

    ``anchors``: per level, ``na`` (w, h) pairs in input pixels. ``launches``
    counts the kernel launches: one a call in the TMA form, one a level in
    the strided form."""
    return launch_form(preds, anchors, strides, normalized, form_for(preds))


def launch_form(preds: Sequence[torch.Tensor], anchors: Sequence, strides: Sequence[float],
                normalized: bool, form: str) -> torch.Tensor:
    """K3 in the given form (``chip_smoke.py`` and the tests run the forms
    side by side); counts on ``decode_outputs_cuda.launches``. Raises for a
    form that does not take these maps."""
    check_head_maps(preds, anchors, strides, "decode")
    if form not in FORMS or (form == "tma" and form_for(preds) != "tma"):
        raise ValueError(f"decode: form {form!r} does not take these head maps")
    p0 = preds[0]
    bs, no = p0.shape[0], p0.shape[-1]
    if no < 5:
        raise ValueError(f"decode kernel takes no >= 5, got {no}")
    rows = sum(p.shape[1] * p.shape[2] * p.shape[3] for p in preds)
    out = torch.empty((bs, rows, no), device=p0.device, dtype=torch.float32)
    lib = _build.library("decode")
    stream = torch.cuda.current_stream(p0.device).cuda_stream
    table = level_table(preds, anchors, strides)
    if form == "tma":
        err = lib.decode_levels_tma(len(table), *pack_levels(table), out.data_ptr(), bs, no,
                                    out.stride(0), int(normalized), stream)
        _build.check(err, "decode_levels_tma")
        count(decode_outputs_cuda, int(out.numel() > 0))
        return out
    for p, lv in zip(preds, table):
        anchors_wh = (ctypes.c_float * len(lv.anchors))(*lv.anchors)
        err = lib.decode_level(p.data_ptr(), out.data_ptr(), bs, lv.h, lv.w, lv.na, no, *p.stride(),
                               out.stride(0), lv.row0, anchors_wh, int(normalized), lv.stride,
                               stream)
        _build.check(err, "decode_level")
        count(decode_outputs_cuda, 1)
    return out


decode_outputs_cuda.launches = 0
