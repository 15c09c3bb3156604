"""Host-side dataset: annotation parsing, decode, staging, batching.

Counterpart of ``yolo_continuous_tpu/data/dataset.py`` (which imports no
JAX; the port keeps its own copy). For the same seed every output is bit
for bit the JAX package's: ``sample``, ``batch``, ``batch_plan``,
``staged_pool``, ``epoch_batches``, ``epoch_plans``, ``n_tiles``.

Parity targets of the JAX module:
- annotation-line format ``path x1,y1,x2,y2,cls ...``
  (``dataset/yolo_dataset.py:44-58``, ``tools/gen_annotation.py:18-36``)
- the sampling policy of ``YoloDataset2`` (``dataset/yolo_dataset_git.py``):
  mosaic with prob ``mosaic_prob`` during the first
  ``special_aug_ratio`` of epochs (``:54``), mixup with ``mixup_prob``
  after mosaic (``:60``), deterministic letterbox for val.

The host only decodes JPEGs and letterboxes them onto fixed staging
canvases; every randomized augmentation runs on the device
(``ops/augment.py``). The loader emits fixed-shape numpy batches:
  tiles (B,4,S,S,3) u8, metas (B,4,5), boxes (B,4,MB,5), masks (B,4,MB),
  mosaic/mixup flags (B,)
and ``PrefetchLoader`` keeps a batch ahead in a background thread.

Staging, as JAX's (``use_native``): the native stager
(``data/native_loader.py``) or cv2 (``stage_image``, ``INTER_CUBIC``). JAX
takes its C++ library wherever it builds; the port takes the card's stager
(a threaded decode on the host, then one ``stage_letterbox`` launch a
batch) when the dataset's ``device`` is CUDA, and cv2 on the CPU unless
``use_native=True`` asks for the stager's plain version. Both give the C++
library's canvases bit for bit. A file the stager cannot decode is staged
with cv2, as JAX stages it. Tiles staged on the card stay there (a CUDA u8
tensor); metas, boxes, masks and flags are numpy. With ``cache_images`` the
native path keeps each file's decoded pixels in host memory and stages them
again (JAX keeps its library's canvases): the same batches, and nothing of
the cache on the card.

Deliberate differences from the JAX module: the card's choice does not
depend on what builds (a CUDA dataset whose stager does not build raises;
nothing moves quietly to cv2). And ``PrefetchLoader`` re-raises an
exception of its worker thread (a missing image, say) in the consuming
thread; the JAX loader ends the epoch early and silently.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..kernels import _build
from ..ops.preprocess import cv2, stage_image
from .native_loader import stage_batch_native

POOL_CHUNK = 64     # images the native stager stages at a time into the pool


@dataclass
class Annotation:
    path: str
    boxes: np.ndarray  # (n, 5) [x1, y1, x2, y2, cls] px


def parse_annotation_lines(lines: Sequence[str]) -> List[Annotation]:
    """``img.jpg x1,y1,x2,y2,cls ...`` -> records (yolo_dataset.py:44-58)."""
    out = []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        boxes = np.array([[int(v) for v in b.split(",")] for b in parts[1:]],
                         np.float32).reshape(-1, 5)
        out.append(Annotation(path=parts[0], boxes=boxes))
    return out


def load_annotation_file(path: str) -> List[Annotation]:
    with open(path, encoding="utf-8") as f:
        return parse_annotation_lines(f.readlines())


def _read_rgb(path: str) -> np.ndarray:
    """Decode to RGB uint8 (training and prediction both run on RGB)."""
    if cv2 is None:
        raise RuntimeError("reading images needs OpenCV (cv2)")
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class YoloDataset:
    """Index-file dataset emitting device-ready staged batches."""

    def __init__(
        self,
        annotations: Sequence[Annotation],
        image_size: int = 640,
        max_boxes: int = 128,
        mosaic: bool = True,
        mixup: bool = True,
        mosaic_prob: float = 0.5,
        mixup_prob: float = 0.5,
        epoch_length: int = 100,
        special_aug_ratio: float = 0.7,   # yolo_dataset_git.py:54
        train: bool = True,
        seed: int = 0,
        use_native: bool = None,
        cache_images: bool = False,
        device=None,
    ):
        self.annotations = list(annotations)
        self.size = image_size
        self.max_boxes = max_boxes
        self.mosaic = mosaic
        self.mixup = mixup
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.epoch_length = epoch_length
        self.special_aug_ratio = special_aug_ratio
        self.train = train
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.epoch_now = 0
        self._cache: dict = {}      # cv2 canvases and metas by index (cache_images)
        self._decoded: dict = {}    # the native stager's decoded pixels by path (cache_images)
        # where staged tiles live; the native stager by default exactly where
        # that is the card, and there it must build
        self.device = torch.device(device if device is not None else "cpu")
        self.use_native = self.device.type == "cuda" if use_native is None else bool(use_native)
        if self.use_native and self.device.type == "cuda":
            _build.library("staging")
        # optional in-RAM cache: cv2 keeps staged canvases (~S*S*3 bytes an
        # image), the native stager decoded pixels (iw*ih*3 bytes an image),
        # both on the host; only for datasets that fit in memory
        self.cache_images = cache_images

    def __len__(self):
        return len(self.annotations)

    def reseed(self, epoch: int):
        """Deterministic per-epoch rng: the shuffle order and the
        mosaic/mixup tile plans depend only on (seed, epoch), so a
        resumed run replays the same remaining-epoch sequence an
        uninterrupted run produces (Trainer.run calls this at every
        epoch start)."""
        self.epoch_now = epoch
        self.rng = np.random.RandomState([self.seed & 0x7FFFFFFF, epoch])

    # -- single staged sample ---------------------------------------------
    def _boxes(self, idx: int):
        ann = self.annotations[idx]
        boxes = np.zeros((self.max_boxes, 5), np.float32)
        mask = np.zeros((self.max_boxes,), bool)
        n = min(len(ann.boxes), self.max_boxes)
        if n:
            boxes[:n] = ann.boxes[:n]
            mask[:n] = True
        return boxes, mask

    def _staged(self, idx: int):
        if self.cache_images and idx in self._cache:
            canvas, meta_v = self._cache[idx]
            return (canvas, meta_v) + self._boxes(idx)
        canvas, meta = stage_image(_read_rgb(self.annotations[idx].path), self.size)
        meta_v = np.array([meta.iw, meta.ih, meta.scale, meta.ox, meta.oy],
                          np.float32)
        if self.cache_images:
            self._cache[idx] = (canvas, meta_v)
        return (canvas, meta_v) + self._boxes(idx)

    def sample(self, idx: int):
        """One sample -> (tiles (4,S,S,3), metas (4,5), boxes, masks,
        mosaic_flag, mixup_flag)."""
        S, MB = self.size, self.max_boxes
        tiles = np.zeros((4, S, S, 3), np.uint8)
        metas = np.zeros((4, 5), np.float32)
        metas[:, :3] = 1.0  # harmless defaults for unused tiles
        boxes = np.zeros((4, MB, 5), np.float32)
        masks = np.zeros((4, MB), bool)

        idxs, use_mosaic, use_mixup = self._tile_plan(idx)
        for t, j in enumerate(idxs):
            tiles[t], metas[t], boxes[t], masks[t] = self._staged(j)
        return tiles, metas, boxes, masks, use_mosaic, use_mixup

    def _tile_plan(self, idx: int):
        """Decide mosaic/mixup + which annotation feeds each tile slot."""
        use_mosaic = bool(
            self.train and self.mosaic and self.rng.rand() < self.mosaic_prob
            and self.epoch_now < self.epoch_length * self.special_aug_ratio)
        use_mixup = bool(self.train and use_mosaic and self.mixup
                         and self.rng.rand() < self.mixup_prob)
        idxs = [idx]
        if use_mosaic:
            extra = self.rng.randint(0, len(self.annotations), 3).tolist()
            idxs = extra + [idx]
            self.rng.shuffle(idxs)
        return idxs, use_mosaic, use_mixup

    @property
    def n_tiles(self) -> int:
        """4 tile slots when mosaic can fire this phase, else 1 (less
        host->device traffic; ops/augment handles both)."""
        mosaic_possible = (self.train and self.mosaic
                           and self.epoch_now < self.epoch_length
                           * self.special_aug_ratio)
        return 4 if mosaic_possible else 1

    def batch(self, indices: Sequence[int]):
        nt = self.n_tiles
        if self.use_native:
            return self._batch_native(indices, nt)
        outs = [self.sample(i) for i in indices]
        out = (np.stack([o[0] for o in outs]),
               np.stack([o[1] for o in outs]),
               np.stack([o[2] for o in outs]),
               np.stack([o[3] for o in outs]),
               np.array([o[4] for o in outs], bool),
               np.array([o[5] for o in outs], bool))
        if nt == 1:
            tiles, metas, boxes, masks, mosaic, mixup = out
            out = (tiles[:, :1], metas[:, :1], boxes[:, :1], masks[:, :1],
                   np.zeros_like(mosaic), np.zeros_like(mixup))
        return out

    def _batch_native(self, indices: Sequence[int], nt: int):
        """``batch`` through the native stager: the (B, nt) tile slots in one
        ``stage_batch_native`` call (one decode, one launch), unused slots as
        zeros. Files the stager cannot decode are staged with cv2 by
        ``_staged``, as JAX stages them, and copied into their slots after."""
        B, S = len(indices), self.size
        plans = [self._tile_plan(i) for i in indices]
        slots = [list(idxs) + [None] * (nt - len(idxs)) for idxs, _, _ in plans]
        flat = [j for row in slots for j in row]
        tiles, metas, ok = stage_batch_native(
            [None if j is None else self.annotations[j].path for j in flat], S, 128,
            self.device, cache=self._decoded if self.cache_images else None)
        tiles = torch.as_tensor(tiles).view(B, nt, S, S, 3)
        metas = metas.reshape(B, nt, 5)
        metas[np.array([[j is None for j in row] for row in slots], bool)] = (1, 1, 1, 0, 0)
        boxes = np.zeros((B, nt, self.max_boxes, 5), np.float32)
        masks = np.zeros((B, nt, self.max_boxes), bool)
        for k, j in enumerate(flat):
            b, t = divmod(k, nt)
            if j is None:
                continue
            if not ok[k]:
                canvas, metas[b, t], _, _ = self._staged(j)
                tiles[b, t] = _on(torch.as_tensor(canvas), self.device)
            boxes[b, t], masks[b, t] = self._boxes(j)
        mosaic = np.array([p[1] for p in plans], bool)
        mixup = np.array([p[2] for p in plans], bool)
        return (_host_or_device(tiles), metas, boxes, masks, mosaic, mixup)

    # -- device-cache mode ---------------------------------------------------
    def staged_pool(self):
        """Stage every image once -> (tiles (N,S,S,3) u8, metas (N,5),
        boxes (N,MB,5), masks (N,MB)) for ``ops.augment.
        augment_batch_from_pool``. Staging is deterministic per image, so
        the pool is valid for the whole run: it goes to the device once and
        steps are fed with ``batch_plan`` index batches. Device cost:
        N*S*S*3 bytes (+ boxes); the caller gates on dataset size (the
        ``device_cache`` plan key)."""
        N, S, MB = len(self.annotations), self.size, self.max_boxes
        tiles = np.zeros((N, S, S, 3), np.uint8)
        metas = np.zeros((N, 5), np.float32)
        boxes = np.zeros((N, MB, 5), np.float32)
        masks = np.zeros((N, MB), bool)
        for j in range(N):
            boxes[j], masks[j] = self._boxes(j)
        if not self.use_native:
            for j in range(N):
                tiles[j], metas[j], _, _ = self._staged(j)
            return tiles, metas, boxes, masks
        # through the same stager as the batches: the pool must equal them
        tiles = torch.empty((N, S, S, 3), dtype=torch.uint8, device=self.device)
        for j0 in range(0, N, POOL_CHUNK):
            j1 = min(j0 + POOL_CHUNK, N)
            _, metas[j0:j1], ok = stage_batch_native(
                [a.path for a in self.annotations[j0:j1]], S, 128, self.device,
                out=tiles[j0:j1], cache=self._decoded if self.cache_images else None)
            for j in range(j0, j1):
                if not ok[j - j0]:
                    canvas, metas[j], _, _ = self._staged(j)
                    tiles[j] = _on(torch.as_tensor(canvas), self.device)
        return _host_or_device(tiles), metas, boxes, masks

    def batch_plan(self, indices: Sequence[int]):
        """Index-only analogue of `batch`: (tile_idx (B, n_tiles) int32,
        mosaic (B,), mixup (B,)). Draws the same per-sample rng stream as
        `batch` (`_tile_plan`), so a run is reproducible across modes.
        Non-mosaic samples repeat their index into every tile slot; only
        slot 0 feeds the single-image path."""
        B = len(indices)
        nt = self.n_tiles
        tile_idx = np.zeros((B, 4), np.int32)
        mosaic = np.zeros((B,), bool)
        mixup = np.zeros((B,), bool)
        for b, i in enumerate(indices):
            idxs, um, ux = self._tile_plan(i)
            tile_idx[b] = idxs if um else [i, i, i, i]
            mosaic[b], mixup[b] = um, ux
        if nt == 1:
            return tile_idx[:, :1], np.zeros_like(mosaic), np.zeros_like(mixup)
        return tile_idx, mosaic, mixup

    # -- epoch iteration ---------------------------------------------------
    def _epoch_order(self, batch_size: int, shuffle: bool, drop_last: bool):
        n = len(self.annotations)
        order = self.rng.permutation(n) if shuffle else np.arange(n)
        stop = n - (n % batch_size) if drop_last else n
        for s in range(0, stop, batch_size):
            idx = order[s:s + batch_size]
            if len(idx) < batch_size:  # pad final partial batch by wrapping
                idx = np.concatenate([idx, order[:batch_size - len(idx)]])
            yield idx

    def epoch_batches(self, batch_size: int, shuffle: bool = True,
                      drop_last: bool = True):
        for idx in self._epoch_order(batch_size, shuffle, drop_last):
            yield self.batch(idx)
        self.epoch_now += 1

    def epoch_plans(self, batch_size: int, shuffle: bool = True,
                    drop_last: bool = True):
        """Device-cache epoch iterator: yields `batch_plan` tuples with
        the same rng stream/shuffle semantics as `epoch_batches`."""
        for idx in self._epoch_order(batch_size, shuffle, drop_last):
            yield self.batch_plan(idx)
        self.epoch_now += 1


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; to the card by a copy that does not make the host
    wait (``ops.augment.to_device``)."""
    from ..ops.augment import to_device
    return to_device(t, device)


def _host_or_device(tiles: torch.Tensor):
    """Staged tiles as the loader emits them: numpy on the CPU, the CUDA
    tensor on the card."""
    return tiles.numpy() if tiles.device.type == "cpu" else tiles


class InfiniteLoader:
    """Endless batch iterator that re-shuffles per epoch without restarting
    workers — the role of InfiniteDataLoader/RepeatSampler
    (dataset/infinite_dataLoader.py:4-36). ``take(n)`` yields n batches.
    """

    def __init__(self, dataset: "YoloDataset", batch_size: int,
                 shuffle: bool = True, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        while True:
            yield from self.dataset.epoch_batches(self.batch_size,
                                                  self.shuffle, self.drop_last)

    def take(self, n: int):
        it = iter(self)
        for _ in range(n):
            yield next(it)


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchLoader:
    """Runs ``gen_fn()`` in a background thread, ``depth`` items ahead.

    An exception of the worker is raised again in the consuming thread, at
    the item where it happened (the JAX loader ends the epoch early and
    silently instead). A consumer that stops early stops the worker."""

    def __init__(self, gen_fn, depth: int = 2):
        self.gen_fn = gen_fn
        self.depth = depth

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        done, stop = object(), threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.gen_fn():
                    if not put(item):
                        return
            except BaseException as e:  # handed to the consumer, raised there
                put(_WorkerError(e))
                return
            put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, _WorkerError):
                    raise item.exc
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
