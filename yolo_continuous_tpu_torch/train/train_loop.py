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
in the ``Detector``.

Not ported yet: ``remat``, ``bn_remat``, ``xla_opts`` and the mesh
(ROADMAP.md Queue 1 item 19); the perspective augmentation (item 16).
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config.plan import TrainPlan, cvt_cfg
from ..data.dataset import PrefetchLoader, YoloDataset, load_annotation_file
from ..detect_api import resolve_device
from ..losses.bin_loss import bin_yolo_loss
from ..losses.yolo_loss import LossConfig, yolo_loss
from ..nn.builder import YoloModel, build_model_spec, format_model_info
from ..ops.augment import (BatchDraw, aug_config_from_plan, augment_batch,
                           augment_batch_from_pool, draw_batch, to_device)
from ..ops.schedules import LRSchedule
from ..tools.jax_weights import state_dict_from_jax
from .checkpoint import (TRAIN_SUFFIX, jax_weights, load_checkpoint, read_jax_msgpack,
                         save_checkpoint, serving_state_dict, train_checkpoint_path, try_load)
from .ema import ModelEMA
from .optimizer import make_optimizer, set_hyper


class Trainer:
    """Builds the model, loss and optimizer of a TrainPlan and steps them.

    Runs on ``cuda`` by default and raises without a CUDA device; pass
    ``device="cpu"`` for the CPU (the tests do)."""

    def __init__(self, plan: TrainPlan, device="cuda", dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.plan = plan
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.spec = build_model_spec(cvt_cfg(plan.model_cfg), plan.image_chan, plan.anchors,
                                     plan.num_labels, plan.anchors_mask)
        self.model = YoloModel(self.spec).to(self.device).set_dtype(self.dtype,
                                                                    cast_weights=False)
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
        if self.aug_cfg.use_perspective:
            raise NotImplementedError("the perspective augmentation (plan key use_perspective) "
                                      "is not ported yet (ROADMAP.md Queue 1 item 16)")
        if plan.cfg.get("host_sync_every"):
            raise NotImplementedError(
                "host_sync_every is not ported: on CUDA the launch queue bounds the work in "
                "flight (ROADMAP.md, deliberate differences)")
        # one record per epoch of the last run(): loss, lr, img/s, step,
        # augment and data-wait times (see run)
        self.epoch_stats: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0, state_dict=None) -> Dict[str, Any]:
        """Weights drawn on the CPU from ``torch.Generator().manual_seed(seed)``
        (the same on every device), or ``state_dict``; a fresh optimizer and
        EMA, step 0."""
        if state_dict is None:
            gen = torch.Generator().manual_seed(seed)
            state_dict = YoloModel(self.spec).init_weights(gen).state_dict()
        self.model.load_state_dict(state_dict, strict=True)
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

    def loss_from_outputs(self, outs, labels, lmask):
        lead, aux = self._split_heads(outs)
        if self.spec.head_name == "IBin":
            return bin_yolo_loss(lead, labels, lmask, self.loss_cfg)
        return yolo_loss(lead, labels, lmask, self.loss_cfg, aux_preds=aux)

    def _inputs(self, images, labels, lmask):
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        x = x.permute(0, 3, 1, 2).contiguous()             # (bs, H, W, 3) -> NCHW
        return (x, torch.as_tensor(labels, dtype=torch.float32, device=self.device),
                torch.as_tensor(lmask, dtype=torch.bool, device=self.device))

    # ------------------------------------------------------------------
    def train_step(self, state, images, labels, lmask, lr_w: float, lr_b: float, mom: float):
        """One step of ``Trainer.train_step_fn``: images (bs, H, W, 3) float
        0..1, labels (bs, max_gt, 5), lmask (bs, max_gt). Returns (state,
        {"loss", "box", "obj", "cls", "num_fg"}, and "bin" for IBin heads),
        values as 0-d tensors."""
        x, labels, lmask = self._inputs(images, labels, lmask)
        model, opt = state["model"], state["opt"]
        model.train()
        loss, parts = self.loss_from_outputs(model(x), labels, lmask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        set_hyper(opt, lr_w, lr_b, mom)
        opt.step()
        state["ema"].update(model)
        state["step"] += 1
        return state, {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    @torch.no_grad()
    def eval_loss(self, state, images, labels, lmask) -> torch.Tensor:
        """The loss of the current weights with the running BN statistics."""
        x, labels, lmask = self._inputs(images, labels, lmask)
        model = state["model"].eval()
        loss, _ = self.loss_from_outputs(model(x), labels, lmask)
        return loss

    # ------------------------------------------------------------------
    def _pinned(self, batch):
        """A host batch with its arrays in pinned tensors (on CUDA; the
        mosaic and mixup flags stay numpy on the host)."""
        if self.device.type != "cuda":
            return batch
        return tuple(torch.from_numpy(a).pin_memory() for a in batch[:4]) + tuple(batch[4:])

    def draw(self, host_step: int, n_tiles: int, mosaic, mixup) -> BatchDraw:
        """The augmentation parameters of step ``host_step`` with the batch's
        (B,) host flags, from a CPU generator seeded by ``(plan.seed,
        host_step)`` (the counterpart of JAX's ``fold_in(aug_base,
        host_step)``, ``train_loop.py:342, 360``)."""
        seq = np.random.SeedSequence([self.plan.seed & 0x7FFFFFFF, 0x617567, host_step])
        gen = torch.Generator().manual_seed(int(seq.generate_state(1, np.uint64)[0]))
        return draw_batch(gen, self.aug_cfg, len(mosaic), n_tiles, self.plan.max_boxes,
                          mosaic, mixup)

    def augment(self, draw: Optional[BatchDraw], batch, train: bool = True):
        """A host batch of ``YoloDataset.batch`` -> (images, labels, lmask) on
        the device; ``draw`` is None in eval mode."""
        dev = [to_device(a, self.device) for a in batch[:4]]
        return augment_batch(draw.to(self.device) if draw is not None else None, *dev,
                             cfg=self.aug_cfg, max_gt=self.plan.max_boxes, train=train)

    # ------------------------------------------------------------------
    def run(self, log=print) -> Dict[str, Any]:
        """Full training per the plan; mirrors train.py:54-121 and JAX
        ``Trainer.run``. Returns the final state. ``self.epoch_stats`` gets
        one record per epoch: ``step_ms`` (wall time a step), ``data_wait_ms``
        (host time waiting for the next batch, the mean and
        ``data_wait_ms_steps`` each step's), and on CUDA ``augment_ms`` and
        ``train_step_ms`` (CUDA events a step) and ``max_memory_allocated``."""
        plan = self.plan
        cuda = self.device.type == "cuda"
        train_ds = YoloDataset(
            load_annotation_file(plan.train_indexes), plan.image_size,
            plan.max_boxes, plan.mosaic, plan.mixup, plan.mosaic_prob,
            plan.mixup_prob, plan.epochs, plan.special_aug_ratio,
            train=True, seed=plan.seed, cache_images=plan.cache_images)
        val_ds = YoloDataset(
            load_annotation_file(plan.val_indexes), plan.image_size,
            plan.max_boxes, train=False, seed=plan.seed,
            cache_images=plan.cache_images)

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

        best_map = -math.inf
        history = []

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
            pool = tuple(torch.from_numpy(a).to(self.device) for a in train_ds.staged_pool())
            log(f"device cache: {pool[0].shape[0]} staged images -> device "
                f"({pool[0].numel() / 1e6:.0f} MB, {time.time() - t0:.0f}s)")

        host_step = int(state["step"])
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
            hyper = sched(host_step)
            if device_cache:
                # index batches are a few hundred bytes: no prefetch thread
                loader = train_ds.epoch_plans(plan.batch_size, plan.shuffle, plan.drop_last)
            else:
                loader = PrefetchLoader(lambda: map(self._pinned, train_ds.epoch_batches(
                    plan.batch_size, plan.shuffle, plan.drop_last)))
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
                if device_cache:
                    images, labels, lmask = augment_batch_from_pool(
                        draw.to(self.device), *pool, to_device(batch[0], self.device),
                        cfg=self.aug_cfg, max_gt=plan.max_boxes, train=True)
                else:
                    images, labels, lmask = self.augment(draw, batch, True)
                if marks:
                    marks[1].record()
                state, metrics = self.train_step(state, images, labels, lmask,
                                                 hyper.lr_weights, hyper.lr_bias,
                                                 hyper.momentum)
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
                val_losses = [self.eval_loss(state, *self.augment(None, b, False))
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
