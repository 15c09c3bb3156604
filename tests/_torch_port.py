"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Weights are the JAX package's own trees, redrawn with numpy from a seed at
a scale that keeps activations O(1) through the depth, so head maps depend
on the input and detection scores are spread (the stock 0.02-std init
gives near-constant maps and exactly tied scores).
"""
import numpy as np

ANCHORS = [[12, 16, 19, 36, 40, 28], [36, 75, 76, 55, 72, 146],
           [142, 110, 192, 243, 459, 401]]

# (C_in, C_out, H, W) of the 24 fused-tail Convs of cfg/net/yolov7.yaml at
# 640 px, in call order: the shapes that kernel K5 takes on the main path
YOLOV7_640_FUSED_TAILS = [
    (512, 512, 80, 80), (512, 256, 40, 40), (512, 256, 80, 80), (512, 256, 40, 40),
    (512, 256, 40, 40), (1024, 1024, 40, 40), (1024, 512, 20, 20), (1024, 512, 40, 40),
    (1024, 256, 20, 20), (1024, 256, 20, 20), (1024, 1024, 20, 20), (512, 256, 20, 20),
    (1024, 256, 40, 40), (512, 256, 40, 40), (512, 256, 40, 40), (1024, 256, 40, 40),
    (512, 128, 80, 80), (512, 128, 80, 80), (512, 256, 40, 40), (512, 256, 40, 40),
    (1024, 256, 40, 40), (1024, 512, 20, 20), (1024, 512, 20, 20), (2048, 512, 20, 20)]


def lively(tree, rs: np.random.RandomState, parent: str = ""):
    """Redraw every leaf of a JAX params / batch_stats tree (nested dicts).

    ``implicit`` leaves: ImplicitA (``ia*``) ~ 0.1 randn, ImplicitM (``im*``)
    ~ 1 + 0.1 randn."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if hasattr(v, "items"):
            out[k] = lively(v, rs, k)
            continue
        shape = np.shape(v)
        if k == "kernel":        # HWIO: fan-in is every axis but the last
            out[k] = rs.randn(*shape) * np.sqrt(1.0 / np.prod(shape[:-1]))
        elif k == "scale":
            out[k] = 1.0 + 0.1 * rs.randn(*shape)
        elif k in ("bias", "mean"):
            out[k] = 0.1 * rs.randn(*shape)
        elif k == "var":
            out[k] = rs.rand(*shape) + 0.5
        elif k == "implicit" and parent.startswith(("ia", "im")):
            out[k] = (1.0 if parent.startswith("im") else 0.0) + 0.1 * rs.randn(*shape)
        else:
            raise KeyError(f"unexpected leaf {k!r}")
        out[k] = out[k].astype(np.float32)
    return out


def min_score_gap(scores, k: int) -> float:
    """Smallest gap between neighbouring top-(k+1) scores of each row: the
    precondition that torch.topk and lax.top_k rank the same candidates."""
    s = -np.sort(-np.asarray(scores, np.float64), axis=-1)[..., : k + 1]
    return float(np.min(s[..., :-1] - s[..., 1:]))


def tiny_head_net(head: str) -> dict:
    """A minimal 3-level net ending in ``head`` (tests/test_head_variants.py)."""
    backbone = [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                [-1, 1, "Conv", [64, 3, 2]]]              # P3 = 2, P4 = 3, P5 = 4
    if head == "IAuxDetect":
        hd = [[2, 1, "Conv", [16, 1, 1]], [3, 1, "Conv", [32, 1, 1]],
              [4, 1, "Conv", [64, 1, 1]], [[2, 3, 4, 5, 6, 7], 1, "IAuxDetect", ["nc", "anchors"]]]
    else:
        hd = [[[2, 3, 4], 1, head, ["nc", "anchors"]]]
    return {"depth_multiple": 1.0, "width_multiple": 1.0, "backbone": backbone, "head": hd}


def tiny_plan_cfg(head: str, size: int) -> dict:
    """A plan dict for ``tiny_head_net(head)``: 2 classes, no checkpoint."""
    return {"device": "cpu", "train": "x", "val": "x", "epochs": 1, "batch_size": 2,
            "image_size": size, "image_chan": 3, "enhance": False, "shuffle": False,
            "pin_memory": False, "drop_last": True, "workers": 0, "labels": ["a", "b"],
            "enhance_cfg": "cfg/enhance/enhance.yaml", "model_cfg": tiny_head_net(head),
            "anchors": ANCHORS, "anchors_mask": [[6, 7, 8], [3, 4, 5], [0, 1, 2]],
            "adam": False, "decay": "Linear", "lrI": 0.01, "lrF": 0.01, "momentum": 0.9,
            "weight_decay": 5e-4, "warmup": False, "warmup_epochs": 1, "warmup_max_iter": 10,
            "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "focal_gamma": 1.5,
            "focal_alpha": 0.25, "resume": False, "save_dir": "/nonexistent/",
            "save_name": head.lower(), "max_boxes": 8}


def ibin_logits(rs: np.random.RandomState, lead, nc: int, bin_count: int = 21):
    """Raw IBin maps ``lead + (nc + 3 + 2 (bins + 1),)`` whose top two bins of
    every value are a logit apart (one random bin raised above the rest)."""
    n = bin_count + 1
    p = (rs.randn(*lead, nc + 3 + 2 * n) * 2.0).astype(np.float32)
    for off in (3, 3 + n):
        bins = np.clip(p[..., off:off + bin_count], -3.0, 3.0)
        win = rs.randint(0, bin_count, lead)[..., None]
        np.put_along_axis(bins, win, bins.max(-1, keepdims=True) + 1.0, -1)
        p[..., off:off + bin_count] = bins
    return p


def min_bin_gap(raw, bin_count: int = 21) -> float:
    """Smallest gap between the top two sigmoided bins of any w/h value of raw
    IBin maps: the precondition that every argmax picks the same bin whatever
    ulps exp() is off by."""
    n = bin_count + 1
    s = 1.0 / (1.0 + np.exp(-np.asarray(raw, np.float64)))
    gaps = []
    for off in (3, 3 + n):
        top2 = -np.sort(-s[..., off:off + bin_count], axis=-1)[..., :2]
        gaps.append(np.min(top2[..., 0] - top2[..., 1]))
    return float(min(gaps))
