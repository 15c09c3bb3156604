"""The train step: forward, SimOTA loss, backward, 3-group optimizer, EMA.

Counterpart of ``yolo_continuous_tpu/train/train_loop.py`` (``Trainer``:
``init_state``, ``warm_start``, ``loss_from_outputs``, ``train_step_fn``,
the eval loss). One ``train_step`` runs, in the order of the JAX step:
forward in train mode (BN on batch statistics, running statistics updated)
-> ``yolo_loss`` -> backward -> optimizer step -> EMA update -> step + 1.

The state is a dict ``{"model", "opt", "ema", "step"}`` of live torch
objects, updated in place where JAX returns a new tree (no copy of the
weights a step). The body runs in bf16 on CUDA and fp32 on the CPU on fp32
master weights (``nn/layers.BodyConv2d``); the head logits and the loss are
fp32. No autocast: its rounding differs from JAX's. TF32 is off on CUDA, as
in the ``Detector``.

Not ported yet: ``Trainer.run``, ``validate_map`` and the ``train`` CLI wait
for the data pipeline and the evaluator (ROADMAP.md Queue 1 items 12-13);
the IBin loss (``bin_yolo_loss``) for item 14; ``remat``, ``bn_remat`` and
``xla_opts`` for item 19.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config.plan import TrainPlan, cvt_cfg
from ..detect_api import resolve_device
from ..losses.yolo_loss import LossConfig, yolo_loss
from ..nn.builder import YoloModel, build_model_spec
from ..tools.jax_weights import state_dict_from_jax
from .checkpoint import (TRAIN_SUFFIX, jax_weights, load_checkpoint, read_jax_msgpack,
                         serving_state_dict)
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
        if self.spec.head_name == "IBin":
            raise NotImplementedError("training an IBin head (bin_yolo_loss) is not ported yet "
                                      "(ROADMAP.md Queue 1 item 14)")
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
        {"loss", "box", "obj", "cls", "num_fg"}), values as 0-d tensors."""
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
