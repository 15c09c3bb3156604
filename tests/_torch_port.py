"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Weights are the JAX package's own trees, redrawn with numpy from a seed at
a scale that keeps activations O(1) through the depth, so head maps depend
on the input and detection scores are spread (the stock 0.02-std init
gives near-constant maps and exactly tied scores).
"""
import numpy as np

ANCHORS = [[12, 16, 19, 36, 40, 28], [36, 75, 76, 55, 72, 146],
           [142, 110, 192, 243, 459, 401]]


def lively(tree, rs: np.random.RandomState):
    """Redraw every leaf of a JAX params / batch_stats tree (nested dicts)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if hasattr(v, "items"):
            out[k] = lively(v, rs)
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
        else:
            raise KeyError(f"unexpected leaf {k!r}")
        out[k] = out[k].astype(np.float32)
    return out


def min_score_gap(scores, k: int) -> float:
    """Smallest gap between neighbouring top-(k+1) scores of each row: the
    precondition that torch.topk and lax.top_k rank the same candidates."""
    s = -np.sort(-np.asarray(scores, np.float64), axis=-1)[..., : k + 1]
    return float(np.min(s[..., :-1] - s[..., 1:]))
