"""Validation CLI of the PyTorch port: mAP over the plan's val set (mirrors
the root ``val.py``).

Usage:
    python -m yolo_continuous_tpu_torch.val cfg/voc_train.yaml [--conf 0.01] [--nms 0.4] \\
        [--max-images N] [--quantize [--calib-images 16]] [--device cuda|cpu]

``--quantize`` evaluates the int8 serving path: ``Detector(quantize=True)``
calibrated on the first ``--calib-images`` letterboxed val images.
"""
import argparse

import numpy as np
import torch

from .config.plan import TrainPlan, check_file
from .data.dataset import _read_rgb, load_annotation_file
from .detect_api import Detector
from .eval.validate import validate
from .ops.preprocess import letterbox


def calibrated_detector(plan: TrainPlan, n_images: int, device="cuda", log=print) -> Detector:
    """``Detector(plan, quantize=True)`` calibrated on the first ``n_images``
    val images, letterboxed as served (the root ``val.py:36-51``)."""
    detector = Detector(plan, device=device, quantize=True)
    size = (plan.image_size, plan.image_size)
    imgs = [letterbox(_read_rgb(ann.path), size, (114, 114, 114))[0]
            for ann in load_annotation_file(plan.val_indexes)[:n_images]]
    detector.calibrate(torch.from_numpy(np.stack(imgs)).float() / 255.0)
    log(f"int8 calibration: {len(imgs)} val images")
    return detector


def main(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate mAP on the val set (PyTorch port)")
    ap.add_argument("cfg", nargs="?", default="cfg/voc_train.yaml")
    ap.add_argument("--conf", type=float, default=0.01)
    ap.add_argument("--nms", type=float, default=0.4)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--quantize", action="store_true",
                    help="evaluate the int8 PTQ serving path (calibrates on the first "
                         "--calib-images val images)")
    ap.add_argument("--calib-images", type=int, default=16,
                    help="val images used for int8 calibration")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    plan = TrainPlan(check_file(args.cfg))
    detector = (calibrated_detector(plan, args.calib_images, args.device)
                if args.quantize else None)
    return validate(plan, detector=detector, conf_thres=args.conf, nms_thres=args.nms,
                    max_images=args.max_images, device=args.device)


if __name__ == "__main__":
    main()
