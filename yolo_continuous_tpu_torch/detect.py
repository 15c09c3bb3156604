"""Single-image inference CLI of the PyTorch port (mirrors the root ``detect.py``).

Usage:
    python -m yolo_continuous_tpu_torch.detect cfg/chip_tiny.yaml resource/horses.jpg \\
        --conf 0.3 --nms 0.3 [--save out.jpg] [--device cuda|cpu] [--verbose]
"""
import argparse

from .detect_api import predict


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run single-image inference (PyTorch port)")
    ap.add_argument("cfg", nargs="?", default="cfg/chip_tiny.yaml")
    ap.add_argument("image", nargs="?", default="resource/horses.jpg")
    ap.add_argument("--conf", type=float, default=0.3)
    ap.add_argument("--nms", type=float, default=0.3)
    ap.add_argument("--save", default=None, help="write rendered image here")
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--verbose", action="store_true",
                    help="print the per-layer param table (Model.print_info parity)")
    args = ap.parse_args(argv)
    return predict(args.cfg, args.image, conf_threshold=args.conf, nms_threshold=args.nms,
                   save_path=args.save, show=args.show, verbose=args.verbose, device=args.device)


if __name__ == "__main__":
    main()
