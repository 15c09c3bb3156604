"""The yardstick's operation and byte counts, from shapes alone.

- ``forward_flops``: the plain reference model's forward on the ``meta``
  device (2 a multiply-add of every convolution), per image.
- K3 (``decode_levels_tma``): every fp32 value of the head's maps read once
  and every decoded fp32 row written once.
- K1 (``nms_suppress``): 13 fp32 operations an IoU test that the inputs
  need (pairs of valid candidates of one class), and its inputs read and
  keep-mask written once.
- ``stage_letterbox``: the decoded RGB bytes of every tile read once and
  every canvas written once.
"""
from __future__ import annotations

from functools import lru_cache
import json

IOU_TEST_OPS = 13


@lru_cache(maxsize=None)
def _flops(cfg_json: str) -> float:
    from reference.model import forward_flops
    return forward_flops(json.loads(cfg_json), 1)


def forward_flops(cfg: dict) -> float:
    return _flops(json.dumps(cfg, sort_keys=True))


def k3_bytes(batch: int, rows: int, no: int) -> float:
    return 2.0 * batch * rows * no * 4


def k1_bytes(batch: int, k: int) -> float:
    # boxes (4 fp32), class (int32), valid (u8) read; keep (u8) written
    return float(batch * k * (16 + 4 + 1 + 1))


def iou_pairs(classes_valid) -> int:
    """Pairs of valid candidates of one class over images: ``classes_valid``
    is a list of each image's classes of its valid candidates."""
    from collections import Counter
    return sum(n * (n - 1) // 2 for img in classes_valid for n in Counter(img).values())


def stage_letterbox_bytes(tiles: int, iw: int, ih: int, size: int) -> float:
    return float(tiles * (iw * ih * 3 + size * size * 3))


def head_rows(size: int, strides=(8, 16, 32), na: int = 3) -> int:
    return sum((size // s) ** 2 * na for s in strides)
