"""Export a trained checkpoint as a reference ``state_dict`` (``.pth``)
(counterpart of ``yolo_continuous_tpu/tools/torch_export.py``).

Users who train with the port drop the weights into the reference's
``nets/yolo.Model`` (its ``detect.py:175`` ``load_state_dict`` path); the
port's ``Detector`` serves the file too (a ``.pth`` beside the plan's
``save_path`` is the first weights it reads). The port's modules carry the
reference's names and layouts, so the export is the model's state dict. The
EMA weights are exported by default: what evaluation and serving use. The
checkpoint is the port's ``.train.pt`` beside ``save_path`` or, where there
is none, the JAX package's ``.msgpack`` at ``save_path`` (read without jax
or flax, in ``detect_api.saved_weights``'s order).

    python -m yolo_continuous_tpu_torch.tools.torch_export plan.yaml out.pth
    python -m yolo_continuous_tpu_torch.tools.torch_export plan.yaml out.pth --raw
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import torch


def export_checkpoint(plan, out_path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """Read the plan's checkpoint (the port's ``.train.pt`` beside
    ``save_path``, else the JAX ``.msgpack`` at ``save_path``) and write its
    weights (EMA unless ``use_ema`` is false) as a ``.pth`` state dict of
    fp32 CPU tensors; returns it."""
    from ..train.checkpoint import (jax_weights, load_checkpoint, read_jax_msgpack,
                                    serving_state_dict, train_checkpoint_path)
    ckpt = train_checkpoint_path(plan.save_path)
    if os.path.exists(ckpt):
        sd = serving_state_dict(load_checkpoint(ckpt), use_ema)
    elif os.path.exists(plan.save_path):
        from ..config.plan import cvt_cfg
        from ..nn.builder import build_model_spec
        from .jax_weights import state_dict_from_jax
        spec = build_model_spec(cvt_cfg(plan.model_cfg), plan.image_chan, plan.anchors,
                                plan.num_labels, plan.anchors_mask)
        sd = state_dict_from_jax(spec, *jax_weights(read_jax_msgpack(plan.save_path), use_ema))
    else:
        raise FileNotFoundError(f"no checkpoint at {ckpt} or {plan.save_path}")
    sd = {k: torch.as_tensor(v).detach().cpu().clone() for k, v in sd.items()}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.save(sd, out_path)
    return sd


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export a checkpoint as a torch reference state_dict")
    ap.add_argument("cfg", help="train-plan YAML (locates the checkpoint)")
    ap.add_argument("out", help="output .pth path")
    ap.add_argument("--raw", action="store_true",
                    help="export the raw weights instead of the EMA")
    args = ap.parse_args(argv)
    from ..config.plan import TrainPlan, check_file
    plan = TrainPlan(check_file(args.cfg))
    sd = export_checkpoint(plan, args.out, use_ema=not args.raw)
    print(f"exported {len(sd)} tensors ({'raw' if args.raw else 'EMA'}) -> {args.out}")


if __name__ == "__main__":
    main()
