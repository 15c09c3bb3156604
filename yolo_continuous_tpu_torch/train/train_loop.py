"""Training: the train step, the epoch loop, checkpoints and mAP validation.

Counterpart of ``yolo_continuous_tpu/train/train_loop.py`` (``Trainer``:
``init_state``, ``warm_start``, ``loss_from_outputs``, ``train_step_fn``,
the eval loss, ``augment``, ``run``, ``validate_map``; ``train``). One
``train_step`` runs, in the order of the JAX step:
forward in train mode (BN on batch statistics, running statistics updated)
-> ``yolo_loss`` (IBin heads: ``losses/bin_loss.bin_yolo_loss``, as JAX
``train_loop.py:166-168``) -> backward -> optimizer step -> EMA update ->
step + 1. Nets of 4 levels (P6) train as the 3-level ones do; the
IAuxDetect aux loss runs on every level.

``run`` trains from the plan as JAX ``train_loop.py:231-409`` does: the
datasets (``data/dataset.py``), the device augmentation
(``ops/augment.py``, parameters drawn on the CPU from ``(seed, step)``, so
a resumed run and a CUDA run draw what an uninterrupted CPU run draws), the
step's learning rates from ``LRSchedule``, warm start, resume from the
``.last`` checkpoint, the device-resident pool (``device_cache``) or a
prefetch thread, one host sync an epoch, the ``.last`` save every epoch,
the best-train-loss gate with its val-loss pass and save, and the
``val_map_every`` mAP gate on the EMA weights (``.bestmap``). Checkpoints
are the port's (``train/checkpoint.py``): ``<save_path stem>.train.pt``
(the best), with ``.last`` and ``.bestmap`` appended beside it.

The state is a dict ``{"model", "opt", "ema", "step"}`` of live torch
objects, updated in place where JAX returns a new tree (no copy of the
weights a step). The body runs in bf16 on CUDA and fp32 on the CPU on fp32
master weights (``nn/layers.BodyConv2d``); the head logits and the loss are
fp32. No autocast: its rounding differs from JAX's. TF32 is off on CUDA, as
in the ``Detector``, and cuDNN runs deterministic algorithms
(``cudnn.deterministic``, no ``benchmark``): its default weight-gradient
algorithms sum with atomics, and JAX's trainer promises exact resume
(``train_loop.py:15``), which a kill-and-resume on the card keeps bit for bit.

On CUDA ``run`` steps through ``jitted_train_step()``, JAX's name for its
compiled step: the step captured as one CUDA graph per input shape and
dtype (``utils/capture.CapturedStep``; its first call is the warm-up and a
real step) and replayed, so that the host's work a step is a few copies
and one graph launch; the val losses go through ``jitted_eval_loss()``
(``CapturedCall``). The scalars that change every step (the learning
rates, the momentum, the EMA's decay) reach the graph as one device tensor
(``_hyper``); the counters stay on the host. ``train_step`` is the eager
step, the counterpart of JAX's pure ``train_step_fn`` and the oracle of
the replays; the CPU runs it. Under a mesh the rule is the group's
backend: over NCCL the graph holds the step's collectives, as JAX's one
program holds GSPMD's; over gloo, whose collectives run on the host, both
compiled functions are the eager ones (``_captures``).

The augmentation is compiled too, as JAX jits ``augment_batch`` and
``augment_batch_from_pool`` (``jitted_augment()``): on CUDA one
``CapturedCall`` per key, the key being the source (the device pool or
host-assembled tiles), train or eval mode, the AugConfig and ``max_gt``,
and the layout of the graph's small input: the draw record (whose mosaic
rows, the samples whose mosaic flag is set, number n = 0..B: the mosaic
runs on those samples only, where JAX runs it on all and selects) with the
batch's metas, boxes and masks, or its tile indices, as one fp32 vector
sent in one copy and split inside the graph. The graphs replay one at a
time on the step's stream, so they share one memory pool and one static
buffer for the tiles (copied in on the step's stream, 78.6 MB at 16 x 4 x
640 x 640 x 3) and one set of static outputs, so that nothing of a graph
stays live in the pool between captures; the pool path's graphs read the
device pool by address and go when ``run`` releases it (at its end), as
they do on ``init_state``.
``augment`` is the eager function, the oracle and the CPU's.

Without the device pool, the prefetch thread stages each batch with the
dataset's stager (on CUDA the native one, ``data/native_loader.py``: a
threaded decode and ``stage_letterbox``) on a stream of its own; the step's
stream waits on the batch's event, so the host never waits for the card
there.

Memory and parallelism, as JAX ``train_loop.py:50-74, 79-102``:

- ``remat`` (plan key, or the argument): the forward is recomputed in the
  backward, a row of the model at a time (each under its own checkpoint:
  one checkpoint over the whole forward would recompute every activation
  at once at the start of the backward and save no memory). ``True``/"full"
  recomputes all of it; "conv" saves the outputs of convolutions and
  matrix products and recomputes the rest (selective checkpointing);
  "dots" saves the matrix products only. A recomputed forward leaves the
  BN running statistics alone (``layers.recompute_scope``).
- ``bn_remat`` (plan key): each BatchNorm and activation tail under its own
  checkpoint (``YoloModel(bn_remat=True)``); bit-equal numerics.
- ``mesh`` (``parallel/mesh.make_mesh``): ``train_step`` on this rank's
  slice of the global batch (``shard_batch``), on a model and state that
  ``shard_params`` sharded. BatchNorm statistics and the loss's normalizers
  are taken over the global batch, the gradients summed over "data", and
  the reported loss parts are the global batch's; so is ``eval_loss``, the
  same number on every rank. ``run`` trains on one device, as JAX's, and
  refuses a mesh.
- ``xla_opts`` (XLA compiler options shipped with the TPU compile) has no
  meaning for CUDA: a plan that sets it is refused.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config.plan import TrainPlan, cvt_cfg
from ..data.dataset import PrefetchLoader, YoloDataset, load_annotation_file
from ..detect_api import resolve_device
from ..losses.bin_loss import bin_yolo_loss
from ..losses.yolo_loss import LossConfig, yolo_loss
from ..nn import layers as L
from ..nn.builder import YoloModel, build_model_spec, format_model_info
from ..ops.augment import (BatchDraw, aug_config_from_plan, augment_batch,
                           augment_batch_from_pool, draw_batch, flat_record, record_from_flat,
                           record_layout, to_device)
from ..ops.schedules import LRSchedule
from ..parallel.mesh import sum_gradients, use_mesh
from ..tools.jax_weights import state_dict_from_jax
from ..utils import trace
from ..utils.capture import CapturedCall, CapturedStep, CaptureError
from .checkpoint import (TRAIN_SUFFIX, jax_weights, load_checkpoint, read_jax_msgpack,
                         save_checkpoint, serving_state_dict, train_checkpoint_path, try_load)
from .ema import ModelEMA
from .optimizer import make_optimizer


def remat_policy(name):
    """The ops whose outputs a ``remat`` policy saves (the rest is recomputed
    in the backward), as JAX's named policies: ``True``/"full" saves nothing
    (None: the whole forward is checkpointed); "conv" the convolutions and
    matrix products; "dots" the matrix products."""
    aten = torch.ops.aten
    dots = [aten.mm.default, aten.bmm.default, aten.addmm.default]
    if name is True or name == "full":
        return None
    if name == "conv":
        return [aten.convolution.default] + dots
    if name == "dots":
        return dots
    raise ValueError(f"unknown remat policy {name!r} (use True/'full', 'conv' or 'dots')")


class Trainer:
    """Builds the model, loss and optimizer of a TrainPlan and steps them.

    Runs on ``cuda`` by default and raises without a CUDA device; pass
    ``device="cpu"`` for the CPU (the tests do). With ``mesh``, on the
    mesh's device. ``remat`` overrides the plan key."""

    def __init__(self, plan: TrainPlan, device="cuda", dtype: Optional[torch.dtype] = None,
                 mesh=None, remat=None):
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.plan = plan
        self.remat = plan.cfg.get("remat", False) if remat is None else remat
        self.bn_remat = bool(plan.cfg.get("bn_remat", False))
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.spec = build_model_spec(cvt_cfg(plan.model_cfg), plan.image_chan, plan.anchors,
                                     plan.num_labels, plan.anchors_mask)
        self.model = YoloModel(self.spec, bn_remat=self.bn_remat).to(self.device).set_dtype(
            self.dtype, cast_weights=False)
        if self.remat:
            self.model.remat_ctx = L.remat_context_fn(remat_policy(self.remat), self.bn_remat)
        self.nl = len(self.spec.strides)
        self.loss_cfg = LossConfig(
            num_classes=plan.num_labels,
            input_size=(plan.image_size, plan.image_size),
            strides=self.spec.strides,
            anchors=self.spec.anchors,
            max_gt=plan.max_boxes,
            fl_gamma=plan.focal_gamma,
            fl_alpha=plan.focal_alpha,
            iou_ratio=plan.iou_loss_ratio,
            threshold=plan.anchor_t,
        )
        self.aug_cfg = aug_config_from_plan(plan)
        if plan.cfg.get("host_sync_every"):
            raise NotImplementedError(
                "host_sync_every is not ported: on CUDA the launch queue bounds the work in "
                "flight (ROADMAP.md, deliberate differences)")
        if plan.cfg.get("xla_opts"):
            raise NotImplementedError(
                "xla_opts is not ported: XLA compiler options have no meaning for CUDA "
                "(ROADMAP.md, deliberate differences)")
        # one record per epoch of the last run(): loss, lr, img/s, step,
        # augment and data-wait times (see run)
        self.epoch_stats: List[Dict[str, Any]] = []
        self._drop_graphs()

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0, state_dict=None) -> Dict[str, Any]:
        """Weights drawn on the CPU from ``torch.Generator().manual_seed(seed)``
        (the same on every device), or ``state_dict``; a fresh optimizer and
        EMA, step 0."""
        if state_dict is None:
            gen = torch.Generator().manual_seed(seed)
            state_dict = YoloModel(self.spec).init_weights(gen).state_dict()
        self.model.load_state_dict(state_dict, strict=True)
        self._drop_graphs()
        return {"model": self.model, "opt": make_optimizer(self.plan, self.model),
                "ema": ModelEMA(self.model, self.plan.ema_decay, self.plan.ema_tau),
                "step": 0}

    def warm_start(self, src: str, state: Dict[str, Any], log=print) -> Dict[str, Any]:
        """Weights-only warm start (plan key ``init_weights_from``): the
        serving weights of ``src`` into the model, then a fresh optimizer and
        an EMA of them, step 0, in place of ``state``. ``src``: a JAX package
        ``.msgpack`` (its EMA tree), the port's train checkpoint
        (``.train.pt``, its EMA) or a ``.pth`` state dict."""
        if src.endswith(TRAIN_SUFFIX):
            sd = serving_state_dict(load_checkpoint(src))
        elif src.endswith(".pth"):
            sd = torch.load(src, map_location="cpu", weights_only=True)
        else:
            sd = state_dict_from_jax(self.spec, *jax_weights(read_jax_msgpack(src)))
        log(f"warm start: weights from {src}")
        return self.init_state(state_dict=sd)

    # ------------------------------------------------------------------
    def _split_heads(self, outs):
        if self.spec.head_name == "IAuxDetect":
            return outs[: self.nl], outs[self.nl:]
        return outs, ()

    def loss_from_outputs(self, outs, labels, lmask, on_aux=None):
        lead, aux = self._split_heads(outs)
        if self.spec.head_name == "IBin":
            return bin_yolo_loss(lead, labels, lmask, self.loss_cfg)
        return yolo_loss(lead, labels, lmask, self.loss_cfg, aux_preds=aux, on_aux=on_aux)

    def _inputs(self, images, labels, lmask):
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        x = x.permute(0, 3, 1, 2).contiguous()             # (bs, H, W, 3) -> NCHW
        return (x, torch.as_tensor(labels, dtype=torch.float32, device=self.device),
                torch.as_tensor(lmask, dtype=torch.bool, device=self.device))

    # ------------------------------------------------------------------
    def _hyper(self, state, lr_w: float, lr_b: float, mom: float) -> torch.Tensor:
        """The step's scalars as one fp32 tensor on the device, copied without
        waiting for the card: lr_w, lr_b, mom (``optimizer.Optimizer.step``)
        and the EMA's (d, 1 - d) for this update, whose counter advances
        here, on the host."""
        vals = torch.tensor([lr_w, lr_b, mom, *state["ema"].advance()], dtype=torch.float32)
        if self.device.type == "cuda":
            vals = vals.pin_memory()
        return vals.to(self.device, non_blocking=True)

    def _update(self, state, images, labels, lmask, hyper) -> Dict[str, torch.Tensor]:
        """The device half of a step, in place on ``state``'s tensors: forward
        in train mode, loss, backward, the optimizer and the EMA, with the
        scalars of ``hyper``. What a captured step records; the loss and its
        parts, detached. Each phase starts with its mark (``utils/trace``)."""
        dev = self.device
        trace.mark("step_forward", dev)
        x, labels, lmask = self._inputs(images, labels, lmask)
        model, opt = state["model"], state["opt"]
        model.train()
        with use_mesh(self.mesh):     # the backward too: a recomputed forward reduces
            outs = model(x)
            trace.mark("step_loss", dev)
            loss, parts = self.loss_from_outputs(outs, labels, lmask,
                                                 on_aux=lambda: trace.mark("step_aux", dev))
            opt.zero_grad(set_to_none=True)
            trace.mark("step_backward", dev)
            loss.backward()
        if self.mesh is not None:
            trace.mark("step_sync", dev)
            sum_gradients(model, self.mesh)
            loss, parts = self._global_parts(loss, parts)
        trace.mark("step_optimizer", dev)
        opt.step(hyper)
        trace.mark("step_ema", dev)
        state["ema"].apply(model, hyper[3:])
        trace.mark("step_end", dev)
        return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    def train_step(self, state, images, labels, lmask, lr_w: float, lr_b: float, mom: float):
        """One step of ``Trainer.train_step_fn``, eager: images (bs, H, W, 3)
        float 0..1, labels (bs, max_gt, 5), lmask (bs, max_gt). Returns (state,
        {"loss", "box", "obj", "cls", "num_fg"}, "num_fg_aux" for IAuxDetect
        heads and "bin" for IBin heads),
        values as 0-d tensors."""
        metrics = self._update(state, images, labels, lmask, self._hyper(state, lr_w, lr_b, mom))
        state["step"] += 1
        return state, metrics

    def _captures(self) -> bool:
        """Whether the compiled functions replay CUDA graphs: on CUDA, with no
        mesh or a mesh whose groups are NCCL. A gloo collective runs on the
        host, which no graph can hold, so a gloo mesh (the CPU, or gloo ranks
        on the card) takes the eager functions. Decided before any launch;
        nothing falls back after a failed capture."""
        if self.device.type != "cuda":
            return False
        return self.mesh is None or dist.get_backend(self.mesh.data_group) == "nccl"

    def jitted_train_step(self):
        """The compiled step (JAX's ``jitted_train_step``), ``train_step``'s
        signature. On CUDA ``_replayed_step``: one ``CapturedStep`` per input
        shape and dtype, which under an NCCL mesh holds the step's
        collectives. On the CPU and under a gloo mesh, ``train_step``
        itself (``_captures``)."""
        return self._replayed_step if self._captures() else self.train_step

    def jitted_eval_loss(self):
        """The compiled eval loss (JAX's ``jitted_eval_loss``), ``eval_loss``'s
        signature. On CUDA one ``CapturedCall`` per input shape and dtype,
        with its collective under an NCCL mesh; on the CPU and under a gloo
        mesh ``eval_loss`` (``_captures``)."""
        return self._replayed_eval_loss if self._captures() else self.eval_loss

    def jitted_augment(self):
        """The compiled augmentation (JAX's jitted ``augment_batch`` and
        ``augment_batch_from_pool``), ``augment``'s signature. On CUDA
        ``_replayed_augment``: one ``CapturedCall`` per key (see the module's
        docstring), all of them in one shared memory pool. On the CPU and
        under a gloo mesh, ``augment`` itself (``_captures``)."""
        return self._replayed_augment if self._captures() else self.augment

    def _drop_graphs(self) -> None:
        """Forget every captured step and eval loss: they read the tensors of
        the state they were captured with by address. ``init_state`` (and
        so ``warm_start``) makes a new optimizer and EMA and drops them; a
        call with another state dict drops them too. ``try_load`` loads in
        place, and they stay. ``init_state`` drops the augmentation's graphs
        as well."""
        self._graphs, self._graph_state = {}, None
        self._drop_augment_graphs()

    def _drop_augment_graphs(self) -> None:
        """Forget the augmentation's graphs, their shared pool and static
        buffers, and the device pool that the pool path's graphs read."""
        self._aug_graphs, self._aug_pool, self._aug_source = {}, None, None
        self._aug_inputs, self._aug_outputs = {}, {}

    def _graphs_for(self, state) -> dict:
        if state is not self._graph_state:
            self._graphs, self._graph_state = {}, state
        return self._graphs

    @staticmethod
    def _shape_key(kind: str, *tensors) -> tuple:
        return (kind,) + tuple((tuple(t.shape), t.dtype) for t in tensors)

    def _replayed_step(self, state, images, labels, lmask, lr_w: float, lr_b: float,
                       mom: float):
        """``train_step`` through the step captured for these inputs' shapes
        and dtypes; its first call is the warm-up and a real step."""
        inputs = tuple(map(torch.as_tensor, (images, labels, lmask)))
        hyper = self._hyper(state, lr_w, lr_b, mom)
        graphs = self._graphs_for(state)
        key = self._shape_key("train_step", *inputs)
        if key not in graphs:
            graphs[key] = CapturedStep(lambda *a: self._update(state, *a), *(
                t.to(self.device) for t in inputs), hyper)
        metrics = graphs[key](*inputs, hyper)
        state["step"] += 1
        return state, metrics

    def _replayed_eval_loss(self, state, images, labels, lmask) -> torch.Tensor:
        inputs = tuple(map(torch.as_tensor, (images, labels, lmask)))
        graphs = self._graphs_for(state)
        key = self._shape_key("eval_loss", *inputs)
        if key not in graphs:
            graphs[key] = CapturedCall(lambda *a: self.eval_loss(state, *a),
                                       *(t.to(self.device) for t in inputs))
        return graphs[key](*inputs)

    @torch.no_grad()
    def _global_parts(self, loss, parts):
        """The loss and its parts of the global batch: the ranks'
        contributions summed over "data", in one collective."""
        vals = [loss] + list(parts.values())
        flat = torch.stack([v.detach().float() for v in vals])
        dist.all_reduce(flat, group=self.mesh.data_group)
        out = [f.to(v.dtype) for f, v in zip(flat, vals)]
        return out[0], dict(zip(parts, out[1:]))

    @torch.no_grad()
    def eval_loss(self, state, images, labels, lmask) -> torch.Tensor:
        """The loss of the current weights with the running BN statistics.
        Under a mesh, of the global batch: the normalizers are taken over
        "data" and the ranks' shares summed, so every rank returns the same
        number."""
        x, labels, lmask = self._inputs(images, labels, lmask)
        model = state["model"].eval()
        with use_mesh(self.mesh):
            loss, _ = self.loss_from_outputs(model(x), labels, lmask)
        if self.mesh is not None:
            loss = self._global_parts(loss, {})[0]
        return loss

    # ------------------------------------------------------------------
    def _pinned(self, batch):
        """A host batch with its arrays in pinned tensors (on CUDA; tiles the
        stager left on the card stay there, and the mosaic and mixup flags
        stay numpy on the host)."""
        if self.device.type != "cuda":
            return batch
        return tuple(torch.from_numpy(a).pin_memory() if isinstance(a, np.ndarray) else a
                     for a in batch[:4]) + tuple(batch[4:])

    def _staged_batches(self, ds: YoloDataset):
        """An epoch's batches as the prefetch thread stages them, each with
        the CUDA event that follows its staging (None on the CPU): on CUDA
        the thread stages on a stream of its own."""
        plan = self.plan
        batches = ds.epoch_batches(plan.batch_size, plan.shuffle, plan.drop_last)
        if self.device.type != "cuda":
            yield from ((b, None) for b in batches)
            return
        side = torch.cuda.Stream(self.device)
        while True:
            with torch.cuda.stream(side):
                batch = next(batches, None)
                if batch is None:
                    return
                batch = self._pinned(batch)
                ready = torch.cuda.Event()
                ready.record(side)
            yield batch, ready

    def _ready(self, item):
        """A staged batch for the current stream, which waits on its event
        (the host does not); its tiles on the card are marked as used there,
        so their memory is not handed out before the step has read them."""
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            if isinstance(batch[0], torch.Tensor) and batch[0].is_cuda:
                batch[0].record_stream(stream)
        return batch

    def draw(self, host_step: int, n_tiles: int, mosaic, mixup) -> BatchDraw:
        """The augmentation parameters of step ``host_step`` with the batch's
        (B,) host flags, from a CPU generator seeded by ``(plan.seed,
        host_step)`` (the counterpart of JAX's ``fold_in(aug_base,
        host_step)``, ``train_loop.py:342, 360``)."""
        seq = np.random.SeedSequence([self.plan.seed & 0x7FFFFFFF, 0x617567, host_step])
        gen = torch.Generator().manual_seed(int(seq.generate_state(1, np.uint64)[0]))
        return draw_batch(gen, self.aug_cfg, len(mosaic), n_tiles, self.plan.max_boxes,
                          mosaic, mixup)

    def augment(self, draw: Optional[BatchDraw], batch, train: bool = True, pool=None):
        """A host batch of ``YoloDataset.batch`` -> (images, labels, lmask) on
        the device, eager; ``draw`` is None in eval mode. With ``pool`` (the
        device pool, ``YoloDataset.staged_pool`` on the device), ``batch`` is
        an index batch of ``epoch_plans`` and the tiles are read from the
        pool through its indices (``augment_batch_from_pool``)."""
        rec = draw.to(self.device) if draw is not None else None
        kw = dict(cfg=self.aug_cfg, max_gt=self.plan.max_boxes, train=train)
        if pool is not None:
            return augment_batch_from_pool(rec, *pool, to_device(batch[0], self.device), **kw)
        return augment_batch(rec, *(to_device(a, self.device) for a in batch[:4]), **kw)

    def _replayed_augment(self, draw: Optional[BatchDraw], batch, train: bool = True,
                          pool=None):
        """``augment`` through the graph captured for its key (the module's
        docstring): the small inputs go as one fp32 vector, from pinned
        memory without a host wait, and the tiles into the shared static
        buffer of their shape; the graph's results into shared static
        outputs, of which the call returns clones."""
        small = (batch[0],) if pool is not None else tuple(batch[1:4])
        rec = ((draw,) if train else ()) + tuple(torch.as_tensor(a) for a in small)
        flat, layout = flat_record(rec), record_layout(rec)
        if self.device.type == "cuda":
            flat = flat.pin_memory()
        inputs = (flat,)
        if pool is None:
            tiles = torch.as_tensor(batch[0])
            inputs += (tiles,)
        elif pool is not self._aug_source:
            # the pool path's graphs read the device pool they were made with
            self._aug_graphs = {k: c for k, c in self._aug_graphs.items() if not k[0]}
            self._aug_source = pool
        key = (pool is not None, train, self.aug_cfg, self.plan.max_boxes, layout,
               *((tuple(t.shape), t.dtype) for t in inputs[1:]))
        call = self._aug_graphs.get(key)
        if call is None:
            if self._aug_pool is None:
                self._aug_pool = CapturedCall.new_pool()
            examples = [to_device(t, self.device) for t in inputs]
            for t in examples[1:]:
                if (t.shape, t.dtype) not in self._aug_inputs:
                    self._aug_inputs[t.shape, t.dtype] = torch.empty_like(t)
            statics = [torch.empty_like(examples[0])] + [self._aug_inputs[t.shape, t.dtype]
                                                         for t in examples[1:]]
            try:
                call = CapturedCall(self._augment_fn(layout, train, pool), *examples,
                                    pool=self._aug_pool, inputs=statics,
                                    outputs=self._aug_outputs)
            except CaptureError:
                self._aug_pool = None       # a failed capture leaves its pool unusable
                raise
            self._aug_graphs[key] = call
        return call(*inputs)

    def _augment_fn(self, layout, train: bool, pool):
        """The function a graph of ``_replayed_augment`` captures: the record
        rebuilt from the flat vector, then the eager augmentation."""
        kw = dict(cfg=self.aug_cfg, max_gt=self.plan.max_boxes, train=train)

        def fn(flat, *tiles):
            rec = record_from_flat(flat, layout)
            draw, small = (rec[0], rec[1:]) if train else (None, rec)
            if pool is not None:
                return augment_batch_from_pool(draw, *pool, *small, **kw)
            return augment_batch(draw, *tiles, *small, **kw)
        return fn

    # ------------------------------------------------------------------
    def run(self, log=print) -> Dict[str, Any]:
        """Full training per the plan; mirrors train.py:54-121 and JAX
        ``Trainer.run``. Returns the final state. ``self.epoch_stats`` gets
        one record per epoch: ``step_ms`` (wall time a step), ``data_wait_ms``
        (host time waiting for the next batch, the mean and
        ``data_wait_ms_steps`` each step's), and on CUDA ``augment_ms`` and
        ``train_step_ms`` (CUDA events a step) and ``max_memory_allocated``,
        and those of the compiled augmentation: ``augment_captures`` (its
        graphs captured in the epoch), ``augment_graphs`` (held at its end)
        and ``augment_pool_gib`` (their shared pool). Every augmentation
        goes through ``jitted_augment()``, whose graphs go at the end."""
        plan = self.plan
        if self.mesh is not None:
            raise ValueError("Trainer.run trains on one device; a mesh serves train_step")
        train_ds = YoloDataset(
            load_annotation_file(plan.train_indexes), plan.image_size,
            plan.max_boxes, plan.mosaic, plan.mixup, plan.mosaic_prob,
            plan.mixup_prob, plan.epochs, plan.special_aug_ratio,
            train=True, seed=plan.seed, cache_images=plan.cache_images, device=self.device)
        val_ds = YoloDataset(
            load_annotation_file(plan.val_indexes), plan.image_size,
            plan.max_boxes, train=False, seed=plan.seed,
            cache_images=plan.cache_images, device=self.device)

        steps_per_epoch = max(len(train_ds) // plan.batch_size, 1)
        sched = LRSchedule(
            plan.learn_initial, plan.learn_final, plan.epochs, plan.decay,
            plan.momentum, plan.warmup, plan.warmup_epochs,
            plan.warmup_max_iter, plan.warmup_momentum, plan.warmup_bias_lr,
            steps_per_epoch)

        state = self.init_state(seed=plan.seed)
        warm_src = plan.cfg.get("init_weights_from")
        if warm_src:
            state = self.warm_start(warm_src, state, log)

        # exact resume prefers the every-epoch 'last' checkpoint; the
        # best-loss checkpoint is the fallback (train_loop.py:270-276)
        best_path = train_checkpoint_path(plan.save_path)
        last_path = best_path + ".last"
        if plan.resume and (try_load(last_path, state) or try_load(best_path, state)):
            log(f"resumed at step {state['step']}")

        # `device_cache` plan key: stage the whole train set once onto the
        # device; a step then ships only (B, T) tile indices. On by default
        # when the pool fits the byte budget (train_loop.py:280-321):
        #   pool_bytes = N * S * S * 3 (u8 canvases)
        #              + N * (max_boxes * 6 + 5) * 4 (boxes/masks/metas)
        # `device_cache: true/false` forces the mode;
        # `device_cache_budget_mb` (default 2048) gates the auto path and
        # guards an explicit opt-in on an oversized dataset.
        device_cache = plan.cfg.get("device_cache", None)
        budget_mb = float(plan.cfg.get("device_cache_budget_mb", 2048))
        n_img = len(train_ds)
        pool_mb = (n_img * plan.image_size ** 2 * 3
                   + n_img * (plan.max_boxes * 6 + 5) * 4) / 1e6
        if device_cache is None:
            device_cache = pool_mb <= budget_mb
            if device_cache:
                log(f"device cache auto-enabled ({pool_mb:.0f} MB pool <= "
                    f"{budget_mb:.0f} MB budget)")
        elif device_cache and pool_mb > budget_mb:
            log(f"WARNING: device_cache pool {pool_mb:.0f} MB exceeds the "
                f"{budget_mb:.0f} MB budget (device_cache_budget_mb) — "
                "staging proceeds because the plan forces device_cache; "
                "expect a matching host-RAM/device-memory spike")
        pool = None
        if device_cache:
            t0 = time.time()
            pool = tuple(to_device(a, self.device) for a in train_ds.staged_pool())
            log(f"device cache: {pool[0].shape[0]} staged images -> device "
                f"({pool[0].numel() / 1e6:.0f} MB, {time.time() - t0:.0f}s)")

        host_step = int(state["step"])
        train_step, eval_loss = self.jitted_train_step(), self.jitted_eval_loss()
        augment = self.jitted_augment()
        try:
            return self._epochs(state, train_ds, val_ds, sched, pool, host_step, train_step,
                                eval_loss, augment, steps_per_epoch, log)
        finally:
            self._drop_augment_graphs()       # and with them the device pool they read

    def _epochs(self, state, train_ds, val_ds, sched, pool, host_step, train_step, eval_loss,
                augment, steps_per_epoch, log):
        """``run``'s epochs, from the state it prepared."""
        plan, cuda, device_cache = self.plan, self.device.type == "cuda", pool is not None
        best_path = train_checkpoint_path(plan.save_path)
        last_path = best_path + ".last"
        best_map = -math.inf
        history = []
        # a resumed run trains the remaining epochs of the same schedule
        epoch0 = min(host_step // steps_per_epoch, plan.epochs)
        # `stop_after_epoch`: train only the first E epochs of the
        # plan.epochs schedule (the horizons stay at plan.epochs)
        last_epoch = min(plan.epochs,
                         int(plan.cfg.get("stop_after_epoch") or plan.epochs))
        self.epoch_stats = []
        for epoch in range(epoch0, last_epoch):
            train_ds.reseed(epoch)
            t0 = time.time()
            losses, nsteps, waits, events = [], 0, [], []
            graphs0 = len(self._aug_graphs)
            hyper = sched(host_step)
            if device_cache:
                # index batches are a few hundred bytes: no prefetch thread
                loader = train_ds.epoch_plans(plan.batch_size, plan.shuffle, plan.drop_last)
            else:
                loader = map(self._ready, PrefetchLoader(lambda: self._staged_batches(train_ds)))
            batches = iter(loader)
            while True:
                t_wait = time.perf_counter()
                batch = next(batches, None)
                waits.append(time.perf_counter() - t_wait)
                if batch is None:
                    break
                hyper = sched(host_step)
                marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else []
                if marks:
                    marks[0].record()
                draw = self.draw(host_step, batch[0].shape[1], *batch[-2:])
                images, labels, lmask = augment(draw, batch, True, pool=pool)
                if marks:
                    marks[1].record()
                state, metrics = train_step(state, images, labels, lmask,
                                            hyper.lr_weights, hyper.lr_bias, hyper.momentum)
                if marks:
                    marks[2].record()
                    events.append(marks)
                # the loss stays on the device: one host sync an epoch
                losses.append(metrics["loss"])
                host_step += 1
                nsteps += 1
            mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
            seconds = max(time.time() - t0, 1e-9)
            history.append(mean_loss)
            ips = nsteps * plan.batch_size / seconds
            # hyper is the last step's: the lr actually used this epoch
            log(f"epoch {epoch + 1}/{plan.epochs} loss {mean_loss:.4f} "
                f"lr {hyper.lr_weights:.6f} {ips:.1f} img/s")
            stats = dict(epoch=epoch + 1, loss=mean_loss, lr=hyper.lr_weights, steps=nsteps,
                         seconds=seconds, img_s=ips, step_ms=seconds * 1e3 / max(nsteps, 1),
                         data_wait_ms=sum(waits[:nsteps]) * 1e3 / max(nsteps, 1),
                         data_wait_ms_steps=[w * 1e3 for w in waits[:nsteps]],
                         device_cache=bool(device_cache))
            if events:
                stats["augment_ms"] = float(np.mean([a.elapsed_time(b) for a, b, _ in events]))
                stats["train_step_ms"] = float(np.mean([b.elapsed_time(c) for _, b, c in events]))
                stats["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
            self.epoch_stats.append(stats)

            save_checkpoint(last_path, state)  # crash-safe step-level resume

            # best-train-loss gate -> val pass + save (train.py:103-120)
            if mean_loss <= min(history):
                val_losses = [eval_loss(state, *augment(None, b, False))
                              for b in val_ds.epoch_batches(plan.batch_size, False, False)]
                val_mean = float(torch.stack(val_losses).mean()) if val_losses else 0.0
                save_checkpoint(best_path, state)
                log(f"epoch {epoch + 1} new best {mean_loss:.4f} "
                    f"(val {val_mean:.4f}) -> {best_path}")

            # mAP-gated validation on the EMA weights (val_map_every plan key)
            if plan.val_map_every and (epoch + 1) % plan.val_map_every == 0:
                summary = self.validate_map(state, log=lambda *_: None)
                m = summary.get("mAP@0.5:0.95", 0.0)
                stats["map"] = summary
                line = f"epoch {epoch + 1} val mAP@0.5:0.95 {m:.4f}"
                if m > best_map:
                    best_map = m
                    save_checkpoint(best_path + ".bestmap", state)
                    line += f" (best) -> {best_path}.bestmap"
                log(line)
            if events and self._aug_graphs:
                # the compiled augmentation: its graphs (train and eval) made
                # this epoch and held at its end, and their shared pool
                stats.update(augment_captures=len(self._aug_graphs) - graphs0,
                             augment_graphs=len(self._aug_graphs),
                             augment_pool_gib=sum(c.pool_bytes for c in
                                                  self._aug_graphs.values()) / 2 ** 30)
        return state

    def validate_map(self, state, log=print, **kw) -> dict:
        """mAP of the current EMA weights over ``plan.val_indexes``, through
        the port's ``Detector`` on the trainer's device (kernels K3 and K1 on
        CUDA)."""
        from ..detect_api import Detector
        from ..eval.validate import validate
        weights = serving_state_dict({"model": state["model"].state_dict(),
                                      "ema": state["ema"].state_dict()})
        det = Detector(self.plan, device=self.device, dtype=self.dtype, state_dict=weights)
        return validate(self.plan, detector=det, log=log, **kw)


def train(train_cfg_file: str, verbose: bool = False, device="cuda", **kw):
    """Public API mirroring ``train.py:23``: train from a plan YAML on
    ``device`` and return the final state. ``verbose`` prints the per-layer
    parameter table first (``nn/builder.format_model_info``, GFLOPs at the
    plan's image size)."""
    plan = TrainPlan(train_cfg_file)
    trainer = Trainer(plan, device=device, **kw)
    if verbose:
        print(format_model_info(trainer.model, plan.image_size))
    return trainer.run()
