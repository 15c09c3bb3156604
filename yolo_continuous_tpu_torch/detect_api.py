"""Single-image / batched inference API on PyTorch.

Counterpart of ``yolo_continuous_tpu/detect_api.py`` (``Detector`` with
``fuse``, ``head_dtype``, ``fused_tails`` and ``reload_weights``;
``TargetBox``, ``generate_colors``, ``predict``): forward (with the
``fused_tails`` option, kernel K5 on CUDA), grid decode (kernel K3 on CUDA;
IBin heads: kernel K4), class-aware NMS (kernels K1/K2 on CUDA), letterbox
un-mapping. Everything up to the fixed-size NMS result stays on the device.

Runs on ``cuda`` by default and raises if there is no CUDA device; pass
``device="cpu"`` for the plain CPU path (the tests do). ``quantize=True``
serves the Conv body in int8 (``nn/quant.py``) after ``calibrate``.

Deliberate fix kept from the JAX package: prediction runs on RGB, as
training does (the reference predicts on cv2's BGR, ``detect.py:23``).
"""
from __future__ import annotations

import colorsys
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config.plan import TrainPlan, check_file, cvt_cfg
from .nn.builder import YoloModel, build_model_spec, format_model_info
from .nn.fuse import deploy_spec, fuse_model_params
from .ops.decode import decode_outputs, decode_outputs_bin
from .ops.nms import batched_nms, yolo_correct_boxes
from .ops.preprocess import cv2, letterbox
from .tools.jax_weights import state_dict_from_jax
from .tools.torch_import import load_torch_checkpoint
from .train.checkpoint import (jax_weights, load_checkpoint, read_jax_msgpack, serving_state_dict,
                               train_checkpoint_path)


@dataclass
class TargetBox:
    """Detection record; utils/target_box.py:8-38."""
    left: int
    top: int
    right: int
    bottom: int
    score: float
    label: str
    color: Tuple[int, int, int]

    def get_topleft(self):
        return (self.left, self.top)

    def get_bottomright(self):
        return (self.right, self.bottom)

    def __str__(self):
        info = "-" * 20 + type(self).__name__ + "-" * 20 + "\r\n"
        for key, value in self.__dict__.items():
            info += "%20s :\t%s\r\n" % (key, value)
        return info


def generate_colors(n: int) -> List[Tuple[int, int, int]]:
    """HSV wheel label colors; utils/helper_cv.py:60-64."""
    out = []
    for i in range(n):
        r, g, b = colorsys.hsv_to_rgb(i / n, 1.0, 1.0)
        out.append((int(r * 255), int(g * 255), int(b * 255)))
    return out


def resolve_device(device) -> torch.device:
    """``cuda`` (the default of every entry point) or ``cpu``; no quiet fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on the GPU by "
                           "default; pass device='cpu' for the plain CPU path")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    return device


def weights_candidates(save_path: str) -> Tuple[str, str, str]:
    """The files a plan's weights are read from, in order: a ``.pth`` beside
    ``save_path``, the port's train checkpoint, the JAX ``.msgpack`` at
    ``save_path`` itself."""
    return (os.path.splitext(save_path)[0] + ".pth", train_checkpoint_path(save_path), save_path)


def weights_source(save_path: str) -> Optional[str]:
    """The file that ``saved_weights(save_path, ...)`` reads, or None."""
    return next((p for p in weights_candidates(save_path) if os.path.exists(p)), None)


def saved_weights(save_path: str, spec, use_ema: bool = True):
    """The state dict saved for a plan, or None: the first file of
    ``weights_candidates`` that exists (EMA weights unless ``not use_ema``)."""
    path = weights_source(save_path)
    pth, train_ckpt, _ = weights_candidates(save_path)
    if path is None:
        return None
    if path == pth:     # a reference state dict, its names resolved as the JAX importer does
        return load_torch_checkpoint(pth, spec)
    if path == train_ckpt:
        return serving_state_dict(load_checkpoint(train_ckpt), use_ema)
    return state_dict_from_jax(spec, *jax_weights(read_jax_msgpack(path), use_ema))


class Detector:
    """A plan's model with its weights, serving end-to-end inference.

    Weights, the first of: ``state_dict``; a ``.pth`` state dict beside the
    plan's ``save_path``; the port's train checkpoint there
    (``train/checkpoint.train_checkpoint_path``); the JAX package's
    checkpoint at ``save_path`` itself (``.msgpack``, read without flax);
    else a random init seeded by ``seed``, as JAX serves its init when no
    file exists. From a train checkpoint ``use_ema`` (default) takes the EMA
    weights, as the JAX ``Detector`` does, else the raw ones. The body
    runs in ``dtype`` (bf16 on CUDA, fp32 on the CPU, as
    ``detect_api.py:93-94``); the head logits are fp32.

    ``fused_tails`` runs the eligible 1x1 Convs as one fused conv + BN +
    SiLU (``layers.Conv``; kernel K5 on CUDA); it defaults to the plan's
    ``fused_tails`` key (off), as ``detect_api.py:100-102``.

    ``fuse=True`` serves the RepConv deploy form (``detect_api.py:130-139``):
    the weights found above, loaded into the train-form model in fp32, are
    re-parameterized by ``nn/fuse.fuse_model_params`` and served by the
    model of ``deploy_spec``. ``head_dtype`` (default fp32) is the dtype of
    the head's logits (``layers.LogitConv``); the decode casts the maps to
    fp32 before its kernel, as JAX does. ``reload_weights`` swaps in a
    checkpoint's weights for the next call; ``read_weights`` and
    ``swap_weights`` are its two halves, so that a server holds its lock
    only for the swap.

    ``quantize=True`` (default: the plan's ``quantize`` key, as
    ``detect_api.py:103-105``) serves every body ``Conv`` in symmetric int8
    (``layers.Conv``, ``nn/quant.py``): per-channel weight scales from the
    fp32 weights, derived when the weights load (and again on every swap),
    and per-tensor activation scales that ``calibrate`` records (or
    ``load_quant_state`` sets, e.g. from JAX's ``"quant"`` collection through
    ``tools/jax_weights.quant_state_from_jax``). A call before either raises
    ``RuntimeError``. The scales survive ``reload_weights``.

    On CUDA, TF32 is switched off for cuDNN convolutions and cuBLAS
    matmuls: the fp32 head convolution then keeps fp32 products, as the
    JAX reference does (with a bf16 body its inputs are bf16 values, whose
    products TF32 would also hold exactly; with an fp32 body they are not).
    """

    def __init__(self, plan: TrainPlan, device="cuda", dtype: Optional[torch.dtype] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0,
                 fused_tails: Optional[bool] = None, use_ema: bool = True, fuse: bool = False,
                 head_dtype: Optional[torch.dtype] = None, quantize: Optional[bool] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.plan = plan
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.head_dtype = head_dtype or torch.float32
        self.fuse = bool(fuse)
        # the checkpoints' (train) form, and the form served
        self.train_spec = build_model_spec(cvt_cfg(plan.model_cfg), plan.image_chan,
                                           plan.anchors, plan.num_labels, plan.anchors_mask)
        self.spec = deploy_spec(self.train_spec) if self.fuse else self.train_spec
        self.nl = len(self.spec.strides)
        if fused_tails is None:
            fused_tails = bool(plan.cfg.get("fused_tails", False))
        self.fused_tails = bool(fused_tails)
        if quantize is None:
            quantize = bool(plan.cfg.get("quantize", False))
        self.quantize = bool(quantize)
        self.calibrated = False
        if state_dict is None:
            state_dict = saved_weights(plan.save_path, self.train_spec, use_ema)
        if state_dict is None:
            state_dict = YoloModel(self.train_spec).init_weights(
                torch.Generator().manual_seed(seed)).state_dict()
        model = YoloModel(self.spec, fused_tails=self.fused_tails,
                          quant_mode="int8" if self.quantize else None)
        model.load_state_dict(self._served(state_dict), strict=True)
        model = model.to(self.device).eval()
        if self.quantize:
            model.set_int8_weights()            # from the fp32 weights, before the cast
        self.model = model.set_dtype(self.dtype, head_dtype=self.head_dtype)

    def _served(self, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A train-form state dict -> the served model's: checked against the
        train-form model and, under ``fuse``, re-parameterized from its fp32
        copy on the CPU."""
        if not self.fuse:
            return state_dict
        template = YoloModel(self.train_spec)
        template.load_state_dict(state_dict, strict=True)
        return fuse_model_params(self.train_spec, template.state_dict())

    def read_weights(self, path: Optional[str] = None,
                     use_ema: bool = True) -> Optional[Dict[str, torch.Tensor]]:
        """The served (fp32, CPU; re-parameterized under ``fuse``) state dict of
        the weights saved at ``path`` (default: the plan's ``save_path``),
        read through the constructor's order of sources (``saved_weights``),
        or None when no checkpoint is there. Touches nothing served."""
        state_dict = saved_weights(path or self.plan.save_path, self.train_spec, use_ema)
        return None if state_dict is None else self._served(state_dict)

    def swap_weights(self, served: Dict[str, torch.Tensor]) -> None:
        """Load ``read_weights``'s state dict in place (and, with
        ``quantize``, derive the int8 weights from its fp32 values); the
        activation scales stay."""
        self.model.load_state_dict(served, strict=True)
        if self.quantize:
            self.model.set_int8_weights(served)

    def reload_weights(self, path: Optional[str] = None, use_ema: bool = True) -> bool:
        """Swap in the weights saved at ``path`` (default: the plan's
        ``save_path``), in place: the next call serves them. Returns False,
        and keeps the weights, when no checkpoint is there
        (``detect_api.py:145-197``)."""
        served = self.read_weights(path, use_ema)
        if served is None:
            return False
        self.swap_weights(served)
        return True

    def _input(self, images) -> torch.Tensor:
        """images (bs, H, W, 3) float 0..1 -> (bs, 3, H, W) in the body dtype."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        return x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.contiguous_format)

    def calibrate(self, images, batches: int = 1) -> Dict[str, torch.Tensor]:
        """Record the int8 activation scales (``detect_api.py:199-218``):
        ``images`` is one (bs, H, W, 3) float 0..1 batch or an iterable of
        them; every Conv's amax becomes the running max of its input's
        max-abs over them, on top of the amax already held. Returns the
        scales (``YoloModel.quant_state``). ``batches`` is JAX's argument,
        unused there too: every batch given is used."""
        if not self.quantize:
            raise RuntimeError("calibrate() requires Detector(quantize=True)")
        for batch in [images] if hasattr(images, "shape") else list(images):
            self.model.calibrate(self._input(batch))
        self.calibrated = True
        return self.model.quant_state()

    def load_quant_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Set the activation scales from ``quant_state`` keys (JAX's through
        ``tools/jax_weights.quant_state_from_jax``), in place of calibrating."""
        self.model.load_quant_state(state)
        self.calibrated = True

    @torch.inference_mode()
    def forward(self, images) -> List[torch.Tensor]:
        """images (bs, H, W, 3) float 0..1 -> raw maps [(bs, h, w, na, no)] in
        ``head_dtype`` (IAuxDetect: the leads only, iaux_detect.py:52)."""
        if self.quantize and not self.calibrated:
            raise RuntimeError("Detector(quantize=True) needs calibrate(images) before "
                               "inference: the int8 path reads the recorded activation scales")
        return self.model(self._input(images))[: self.nl]

    @torch.inference_mode()
    def __call__(self, images, conf_thres: float = 0.5, nms_thres: float = 0.4,
                 max_det: int = 300):
        """images (bs, H, W, 3) float 0..1 -> (boxes_xyxy_norm, scores,
        classes, valid), fixed-shape, on the detector's device."""
        maps, spec = self.forward(images), self.spec
        if spec.head_name == "IBin":
            pred = decode_outputs_bin(maps, spec.anchors, spec.strides, spec.bin_count,
                                      normalized=True)
        else:
            pred = decode_outputs(maps, spec.anchors, spec.strides, normalized=True)
        return batched_nms(pred, conf_thres, nms_thres, max_det)


def predict(cfg_file: str, image_path: str, conf_threshold: float = 0.3,
            nms_threshold: float = 0.3, detector: Optional[Detector] = None,
            save_path: Optional[str] = None, show: bool = False, verbose: bool = False,
            device="cuda") -> List[TargetBox]:
    """Public API mirroring ``detect.py:208-265``: prints and returns the
    TargetBox records; optionally renders boxes to ``save_path``. ``verbose``
    prints the per-layer parameter table first (Model.print_info,
    nets/yolo.py:127-141)."""
    if cv2 is None:
        raise RuntimeError("predict needs OpenCV (cv2) to read and draw images")
    plan = TrainPlan(check_file(cfg_file))
    det = detector or Detector(plan, device=device)
    if verbose:
        print(format_model_info(det.model, plan.image_size))
    size = (plan.image_size, plan.image_size)

    bgr = cv2.imread(image_path)
    if bgr is None:
        raise FileNotFoundError(image_path)
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    img, _, _ = letterbox(rgb, size, color=(114, 114, 114), scale_fill=False)
    images = torch.from_numpy(img).float()[None] / 255.0

    boxes, scores, classes, valid = det(images, conf_threshold, nms_threshold)
    boxes = yolo_correct_boxes(boxes[0], size, bgr.shape[:2], True).cpu().numpy()
    scores, classes, valid = scores[0].cpu().numpy(), classes[0].cpu().numpy(), valid[0].cpu().numpy()

    colors = generate_colors(plan.num_labels)
    target_boxes: List[TargetBox] = []
    h0, w0 = bgr.shape[:2]
    for i in np.where(valid)[0]:
        y1, x1, y2, x2 = boxes[i]  # yolo_correct_boxes emits y1x1y2x2
        tb = TargetBox(max(0, int(np.floor(x1))), max(0, int(np.floor(y1))),
                       min(w0, int(np.floor(x2))), min(h0, int(np.floor(y2))),
                       float(scores[i]), plan.labels[int(classes[i])], colors[int(classes[i])])
        print(tb)
        target_boxes.append(tb)

    if save_path or show:
        canvas = bgr.copy()
        for tb in target_boxes:
            cv2.rectangle(canvas, tb.get_topleft(), tb.get_bottomright(), tb.color, 1)
            info = "{} {:.2f}".format(tb.label, tb.score)
            cv2.putText(canvas, info, (tb.left, max(tb.top - 2, 10)),
                        cv2.FONT_HERSHEY_PLAIN, 1, (255, 255, 255))
        if save_path:
            cv2.imwrite(save_path, canvas)
        if show:  # pragma: no cover (headless env)
            cv2.imshow("Predict", canvas)
            cv2.waitKey()
    return target_boxes
