"""The native JPEG stager (counterpart of ``yolo_continuous_tpu/data/native_loader.py``).

JAX stages through its C++ library (``native/staging.cpp``: libjpeg
decode, bilinear resize, centred letterbox of fill 128, in a thread pool).
The port decodes on the host (cv2 in a pool of threads: libjpeg's pixels)
and, on the card, one launch of ``stage_letterbox`` (``csrc/staging.cu``,
through ``kernels/staging.py``) writes every canvas; on the CPU its plain
version does. Both give the C++ library's canvases and metas bit for bit.

The names are JAX's: ``available``, ``ensure_built`` and
``stage_batch_native``. On the card nothing falls back: a stager that does
not build or launch raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..kernels import _build, staging


def ensure_built(quiet: bool = True) -> bool:
    """Build the card's stager (``csrc/staging.cu``) if it is not built;
    returns whether it is (False where there is no nvcc)."""
    try:
        _build.build(["staging"])
    except (RuntimeError, OSError) as e:
        if not quiet:
            print(f"native stager: {e}")
        return False
    return True


def available() -> bool:
    """Whether the card's stager runs here: a CUDA device and the library
    built and loaded."""
    if not torch.cuda.is_available():
        return False
    try:
        _build.library("staging")
        return True
    except (RuntimeError, OSError):
        return False


def stage_batch_native(paths: List[Optional[str]], size: int = 640, fill: int = 128,
                       device="cuda", out: Optional[torch.Tensor] = None,
                       cache: Optional[Dict[str, np.ndarray]] = None):
    """paths -> (tiles (n, S, S, 3) u8, metas (n, 5) f32, ok (n,) bool).

    metas rows are ``[iw, ih, scale, ox, oy]``, as JAX's. On CUDA the tiles
    are a CUDA tensor (written into ``out`` if given), staged on the current
    stream in one launch; on the CPU a numpy array from the plain version. A
    file that does not decode has ``ok`` False, a canvas of ``fill`` and a
    zero meta; a None path is an empty slot (a batch's unused mosaic tile): a
    canvas of zeros, a zero meta and ``ok`` False. Each distinct file is
    decoded once a call. ``cache``, a dict, keeps decoded pixels on the host
    by path: a path found there is not read or decoded again, and the files
    this call decodes are added."""
    device = torch.device(device)
    files = list(dict.fromkeys(p for p in paths if p is not None))
    known = {} if cache is None else cache
    todo = [p for p in files if p not in known]
    fresh = dict(zip(todo, staging.imdecode(staging.read_files(todo))))
    if cache is not None:
        cache.update((p, im) for p, im in fresh.items() if im is not None)
    decoded = staging.upload([fresh[p] if p in fresh else known[p] for p in files], device)
    at = {p: i for i, p in enumerate(files)}
    rows, metas = [], np.zeros((len(paths), 5), np.float32)
    ok = np.zeros((len(paths),), bool)
    for i, p in enumerate(paths):
        ok[i] = p is not None and decoded.ok[at[p]]
        if ok[i]:
            row, metas[i] = staging.canvas_row(decoded, at[p], size, fill)
        else:
            row = staging.canvas_row(None, 0, size, 0 if p is None else fill)[0]
        rows.append(row)
    geo = torch.tensor(rows, dtype=torch.int64).reshape(-1, staging.GEO_COLS)
    if device.type == "cuda":
        from ..ops.augment import to_device
        geo = to_device(geo, device)
    tiles = staging.stage_letterbox(decoded.src, geo, size, out)
    return (tiles if device.type == "cuda" else tiles.numpy()), metas, ok
