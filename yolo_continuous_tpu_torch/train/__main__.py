"""Training CLI of the PyTorch port (mirrors the root ``train.py``).

Usage:
    python -m yolo_continuous_tpu_torch.train [cfg/voc_train.yaml] [--device cuda|cpu]
"""
import argparse

from ..config.plan import check_file
from .train_loop import train


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a detector from a plan YAML (PyTorch port)")
    ap.add_argument("cfg", nargs="?", default="cfg/voc_train.yaml",
                    help="train-plan YAML (default: cfg/voc_train.yaml)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--verbose", action="store_true",
                    help="print the per-layer param table first")
    args = ap.parse_args(argv)
    return train(check_file(args.cfg), verbose=args.verbose, device=args.device)


if __name__ == "__main__":
    main()
