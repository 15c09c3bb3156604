"""K1 and K2: class-aware greedy NMS keep-sets, on CUDA tensors.

Wrappers of ``csrc/nms.cu``, which replaces the TPU kernels of
``yolo_continuous_tpu/kernels/nms_pallas.py``: ``nms_suppress`` (K1) for
``pallas_suppress``, K <= 1024; ``nms_suppress_tiled`` (K2) for
``pallas_suppress_tiled``, K > 1024. Their plain PyTorch version is
``ops/nms.py::suppress_plain``; ``ops/nms.py::suppress`` sends CPU tensors
there and CUDA tensors here, split at K = 1024 as ``ops/nms.py:100-109``.

Both take a batch of score-sorted top-K candidates: boxes ``(B, K, 4)``
fp32 xyxy, classes ``(B, K)`` int32, valid ``(B, K)`` bool, and return keep
``(B, K)`` bool. K1 runs one thread-block cluster per image in one launch:
its CTAs build the suppression bitmask into the leader CTA's shared memory,
which then sweeps it; ``cluster_size`` picks the CTAs an image before the
launch. K2 first builds the bitmask across all SMs into a scratch tensor
that its wrapper allocates, then sweeps it with one CTA per image.
"""
from __future__ import annotations

import torch

from ..utils.capture import count
from . import _build

K1_MAX = 1024   # K1 keeps a K x K bitmask in the leader's shared memory: 144 KB at 1024
# K2's sweep keeps a ring of 32-row chunks of the mask beside the keep words:
# 2 chunks still fit at K2_MAX (k2_ring); its mask is 102 MB an image there
K2_MAX = 28544
K2_MAX_RING = 6
# copies of csrc/nms.cu's kMaxCluster, kKeepWords, kTileStride and kSmemPerBlock
K1_MAX_CLUSTER = 8              # CTAs an image: the portable cluster size
K1_KEEP_WORDS = 36
K1_TILE_STRIDE = 36              # a mask tile's 32 row words, padded
SMEM_PER_BLOCK = 227 * 1024


def k1_smem_bytes(k: int) -> int:
    """Shared memory of a K1 CTA, ``csrc/nms.cu::k1_smem_bytes``: a box, an
    area and a class a candidate, the keep words, and the leader's mask, a
    padded tile for every pair of row and column words: 172,176 bytes at
    K1_MAX."""
    words = (k + 31) // 32
    return k * (16 + 4 + 4) + 4 * K1_KEEP_WORDS + 4 * K1_TILE_STRIDE * words * words


def cluster_size(batch: int, k: int, sm_count: int) -> int:
    """CTAs a K1 image takes: K1_MAX_CLUSTER, halved while the batch's CTAs
    would outnumber the SMs, or a CTA would get no 32 x 32 tile of the
    mask's upper triangle. At least 1."""
    words = (k + 31) // 32
    tiles = words * (words + 1) // 2
    c = K1_MAX_CLUSTER
    while c > 1 and (batch * c > sm_count or c > tiles):
        c //= 2
    return c


def mask_words(k: int) -> int:
    """uint32 words of one row of K2's mask: ceil(K/32), rounded up to 4
    (``csrc/nms.cu::mask_stride``)."""
    return ((k + 31) // 32 + 3) // 4 * 4


def k2_sweep_smem(k: int, ring: int) -> int:
    """Shared memory of K2's sweep, ``csrc/nms.cu::k2_sweep_smem``: ``ring``
    chunks of 32 mask rows, then one keep word a mask word."""
    return ring * 32 * mask_words(k) * 4 + mask_words(k) * 4


def k2_ring(k: int) -> int:
    """Chunks in K2's sweep ring, ``csrc/nms.cu::k2_ring``: the most, at most
    K2_MAX_RING, that fit in a block's shared memory; 0 where two do not."""
    ring = K2_MAX_RING
    while ring >= 2 and k2_sweep_smem(k, ring) > SMEM_PER_BLOCK:
        ring -= 1
    return ring if ring >= 2 else 0


def _check(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor, k_max: int, what: str):
    if boxes.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got {boxes.device}")
    if classes.device != boxes.device or valid.device != boxes.device:
        raise ValueError(f"{what}: boxes, classes and valid must share one device")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"{what}: boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    b, k = boxes.shape[:2]
    if tuple(classes.shape) != (b, k) or tuple(valid.shape) != (b, k):
        raise ValueError(f"{what}: classes and valid must be (B, K) = ({b}, {k})")
    if boxes.dtype != torch.float32 or classes.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"{what} takes float32 boxes, int32 classes and bool valid, got "
                         f"{boxes.dtype}, {classes.dtype}, {valid.dtype}")
    if not (boxes.is_contiguous() and classes.is_contiguous() and valid.is_contiguous()):
        raise ValueError(f"{what} takes contiguous tensors")
    if boxes.data_ptr() % 16:
        raise ValueError(f"{what}: boxes must be 16-byte aligned")
    if k > k_max:
        raise ValueError(f"{what} takes K <= {k_max}, got {k}")


def _launch(fn: str, boxes, classes, valid, iou_thres: float, scratch=None,
            cluster=None) -> torch.Tensor:
    """One C entry point of ``csrc/nms.cu``; K2's take the mask ``scratch``,
    K1's the ``cluster`` size."""
    keep = torch.empty(valid.shape, device=valid.device, dtype=torch.bool)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    ptrs = (boxes.data_ptr(), classes.data_ptr(), valid.data_ptr(), keep.data_ptr())
    if scratch is not None:
        ptrs += (scratch.data_ptr(), scratch.numel() * scratch.element_size())
    if cluster is not None:
        ptrs += (cluster,)
    err = getattr(_build.library("nms"), fn)(*ptrs, boxes.shape[0], boxes.shape[1],
                                             float(iou_thres), stream)
    _build.check(err, fn)
    return keep


def tiled_scratch(boxes: torch.Tensor) -> torch.Tensor:
    """K2's mask: (B, K, mask_words(K)) uint32 words (as int32), 32 MB at
    K = 4096 x 16 images and 79 MB an image at 25,200."""
    b, k = boxes.shape[:2]
    return torch.empty((b, k, mask_words(k)), device=boxes.device, dtype=torch.int32)


def nms_suppress(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
                 iou_thres: float) -> torch.Tensor:
    """K1 (K <= 1024): a cluster of ``cluster_size`` CTAs an image builds the
    bitmask into the leader's shared memory, which sweeps it 32 rows at a
    time. One launch a call."""
    _check(boxes, classes, valid, K1_MAX, "nms_suppress")
    sms = torch.cuda.get_device_properties(boxes.device).multi_processor_count
    keep = _launch("nms_suppress", boxes, classes, valid, iou_thres,
                   cluster=cluster_size(boxes.shape[0], boxes.shape[1], sms))
    count(nms_suppress, int(boxes.numel() > 0))
    return keep


def nms_suppress_tiled(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
                       iou_thres: float) -> torch.Tensor:
    """K2: the bitmask across all SMs, then a sweep of it, one CTA per image
    (any K <= K2_MAX)."""
    _check(boxes, classes, valid, K2_MAX, "nms_suppress_tiled")
    keep = _launch("nms_suppress_tiled", boxes, classes, valid, iou_thres,
                   scratch=tiled_scratch(boxes))
    count(nms_suppress_tiled, int(boxes.numel() > 0))
    return keep


nms_suppress.launches = 0
nms_suppress_tiled.launches = 0
