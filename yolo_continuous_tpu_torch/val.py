"""Validation CLI of the PyTorch port: mAP over the plan's val set (mirrors
the root ``val.py``).

Usage:
    python -m yolo_continuous_tpu_torch.val cfg/voc_train.yaml [--conf 0.01] [--nms 0.4] \\
        [--max-images N] [--device cuda|cpu]
"""
import argparse

from .config.plan import TrainPlan, check_file
from .eval.validate import validate


def main(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate mAP on the val set (PyTorch port)")
    ap.add_argument("cfg", nargs="?", default="cfg/voc_train.yaml")
    ap.add_argument("--conf", type=float, default=0.01)
    ap.add_argument("--nms", type=float, default=0.4)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--quantize", action="store_true",
                    help="the int8 serving path (not ported yet: ROADMAP item 18)")
    ap.add_argument("--calib-images", type=int, default=16,
                    help="val images used for int8 calibration")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.quantize:
        raise NotImplementedError("int8 serving (Detector(quantize=True), calibrate) is not "
                                  "ported yet (ROADMAP.md Queue 1 item 18)")
    plan = TrainPlan(check_file(args.cfg))
    return validate(plan, conf_thres=args.conf, nms_thres=args.nms,
                    max_images=args.max_images, device=args.device)


if __name__ == "__main__":
    main()
